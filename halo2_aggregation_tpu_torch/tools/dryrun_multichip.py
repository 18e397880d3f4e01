"""The verifier's production step over a mesh of ranks, held to the host
verifier bit for bit.

    python3 -m halo2_aggregation_tpu_torch.tools.dryrun_multichip --device cpu --world 8
    python3 -m halo2_aggregation_tpu_torch.tools.dryrun_multichip --device cuda
    python3 -m halo2_aggregation_tpu_torch.tools.dryrun_multichip --device cuda --world 4

The counterpart of `__graft_entry__.py::dryrun_multichip`: real k = 9
proofs of the simple example made by the port's host prover and parsed on
the host, then `parallel/batch_verify.py`'s two formulations of the step,
`shmap_verify_algebra_fast` and `sharded_verify_algebra_fast`, on every rank
of one process group; every rank's quads must equal the host
`verify_proof`'s, and `sharded_field_algebra`'s h_eval must equal the
single-process `field_algebra`'s.

* `--device cpu`: one gloo group of `--world` ranks over `make_mesh`'s
  mesh (4 x 2 at world 8, the JAX dry run's), one proof a dp shard (B = dp)
  unless `--batch` says otherwise, as the JAX dry run; the plain kernels.
* `--device cuda`: `run_card`, what one card shows: world 1 over NCCL (mesh
  1 x 1), then world 2 over gloo, two ranks sharing the card (meshes 2 x 1
  and 1 x 2; NCCL refuses two ranks on one device), at B = `--batch` (128),
  each with `sharded_msm` of a random column at 2^16 points against one
  `ops/msm.py::msm`, every rank's kernel launches and `check_aggregate` on
  the quads.  `chip_smoke.py`'s `parallel` phase runs the same function.
* `--device cuda --world N`, N > 1: `run_cards`, one rank a card over NCCL
  (N cards or more must be visible, or it raises before any rank starts):
  the same checks on `make_mesh`'s mesh, N x 1 and 1 x N, with where each
  rank's tensors and kernels ran (`check_placement`), then the scale-out:
  the step at B = 128 N over N x 1 against world 1 at B = 128 and 128 N,
  and `sharded_msm` at 2^21 over the N ranks against one card's `msm`,
  each a median of repeats after a warm-up.
The kernels are built here before the ranks start.

Prints the cards (`nvidia-smi`'s name and power limit, and its topology on
the card), one JSON line a group, then `dryrun_multichip ok`.  A failed rank
or check exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.curve_ops import AffinePoint, JacPoint

#: the two inner witnesses (constant=7, a, b) and their seeds, as in the JAX dry run
WITNESSES = [(2, 3), (4, 5)]
MSM_LOG_N = 16
BATCH = 128  # proofs of the card run: the batch of chip_smoke.py's main phase
SCALE_MSM_LOG_N = 21  # the scale-out's MSM: the outer proof's commitment size
REPEATS = 10  # timed steps of the scale-out, after one warm-up
#: the main path's kernels, by the names the profiler gives their launches
LIBRARY_KERNELS = ("fa_tape_kernel", "ec_win_kernel", "jac_sum_kernel")
#: each rank's launches on the card: a formulation runs K2, K1, the lanes'
#: segmented sum and the mp partials' one; a sharded MSM K7 and one sum
FAST_LAUNCHES = {"ec_win": 1, "fa_tape": 1, "jac_segment_sum": 2, "msm_s5": 0}
MSM_LAUNCHES = {"ec_win": 0, "fa_tape": 0, "jac_segment_sum": 1, "msm_s5": 1}


def make_proofs(k: int):
    """(params, vk, protos) with protos [(instances, proof bytes)], from the
    port's host keygen and prover."""
    from ..models import simple_example as se
    from ..plonk import kzg
    from ..plonk.keygen import keygen
    from ..plonk.prover import create_proof

    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in WITNESSES:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=k)
        pub = [c.public_output()]
        protos.append(([pub], create_proof(params, pk, asg, [pub], seed=70 + a)))
    return params, vk, protos


def random_column(device, log_n: int = MSM_LOG_N, seed: int = 0):
    """(points, scalars): the SRS's 2^log_n Lagrange points as an
    AffinePoint on `device` and 2^log_n random scalars below 2^252."""
    from ..plonk import kzg
    from ..plonk.kzg import DeviceSRS

    points = DeviceSRS(kzg.setup(log_n), device).points
    limbs = np.random.default_rng(seed).integers(0, 1 << 32, size=(1 << log_n, 8), dtype=np.uint32)
    limbs[:, 7] >>= 4
    return points, torch.from_numpy(limbs.view(np.int32)).to(points.x.device)


def _launch_counters() -> dict:
    from ..ops import msm_kernels
    from ..ops.ec_kernels import jac_segment_sum, scalar_mul_win
    from ..plonk.fa_fused import fa_tape_eval

    return {"ec_win": scalar_mul_win, "fa_tape": fa_tape_eval, "jac_segment_sum": jac_segment_sum,
            "msm_s5": msm_kernels.msm_bucket_s5}


def _step_tensors(out: dict) -> list:
    return [c for v in out.values() for c in (v if isinstance(v, JacPoint) else (v,))]


def _event_devices(run) -> dict:
    """{"all": device indices of every CUDA event of `run()` under
    torch.profiler, each of LIBRARY_KERNELS: those of its launches}, each a
    sorted list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    seen = {name: set() for name in ("all", *LIBRARY_KERNELS)}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            seen["all"].add(e.device_index)
            for name in LIBRARY_KERNELS:
                if name in e.name:
                    seen[name].add(e.device_index)
    return {name: sorted(devs) for name, devs in seen.items()}


def rank_run(vk, parsed, shapes, device, msm_column=None, placement=False) -> list:
    """One rank's part: for each mesh shape (dp, mp), or `make_mesh`'s for
    None, both formulations over the batch of `parsed` and
    `sharded_field_algebra`, and with `msm_column` = (points, scalars, nbits)
    on the host, `sharded_msm` over the axis of more ranks.  Returns a record
    a mesh: its shape, the quads as host ints, h_eval, the seconds, this
    rank's timings, its kernel launches and its card (None on the CPU).
    With `placement` (on the card), the record also holds where the step
    ran: the current card, the cards of the tensors each formulation
    returns, and those of every CUDA event of one more call of each under
    torch.profiler (`check_placement` reads them)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    from ..ops import curve_ops as co
    from ..parallel.batch_verify import (
        sharded_field_algebra,
        sharded_verify_algebra_fast,
        shmap_verify_algebra_fast,
    )
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded_msm import sharded_msm
    from ..plonk.verifier_device import batch_proofs, quads_to_ints

    device = resolve_device(device)  # "cuda": the card run_ranks gave this rank
    counters = _launch_counters()
    batch = batch_proofs(vk, parsed, device)
    B = len(parsed)
    card = torch.cuda.current_device() if device.type == "cuda" else None
    recs = []
    for shape in shapes:
        if shape is None:
            mesh = make_mesh(device=device)
        else:
            mesh = init_device_mesh(device.type, tuple(shape), mesh_dim_names=("dp", "mp"))
        shape = tuple(mesh.shape)
        rec = {"mesh": list(shape), "card": card, "quads": {}, "seconds": {}, "timings": {}, "launches": {}}
        where = {"current_device": card, "tensor_devices": set(), "events": {}}
        for name, fn in (("shmap", shmap_verify_algebra_fast), ("sharded", sharded_verify_algebra_fast)):
            for c in counters.values():
                c.launches = 0
            timings = {}
            t0 = time.perf_counter()
            out = fn(mesh, vk, batch, parsed, timings=timings)
            where["tensor_devices"].update(t.device.index for t in _step_tensors(out))
            rec["quads"][name] = quads_to_ints(out)
            rec["seconds"][name] = time.perf_counter() - t0
            rec["timings"][name] = timings
            rec["launches"][name] = {k: c.launches for k, c in counters.items()}
            if placement:
                where["events"][name] = _event_devices(lambda: fn(mesh, vk, batch, parsed))  # noqa: B023
        if placement:
            rec["placement"] = {**where, "tensor_devices": sorted(where["tensor_devices"])}
        rec["h_eval"] = sharded_field_algebra(mesh, vk, batch, B)[0].cpu()
        if msm_column is not None:
            points, scalars, nbits = msm_column
            ax = "dp" if shape[0] > shape[1] else "mp"
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            total = sharded_msm(mesh, ax, AffinePoint(*(c.to(device) for c in points)), scalars.to(device), nbits)
            rec["msm"] = co.jac_to_ints(JacPoint(*(c[None] for c in total)))[0]
            rec["seconds"]["sharded_msm"] = time.perf_counter() - t0
            rec["launches"]["sharded_msm"] = {k: c.launches for k, c in counters.items()}
            rec["msm_axis"] = ax
        recs.append(rec)
    return recs


def parse_all(params, vk, protos, B: int) -> list:
    """The protos cycled to B proofs, each parsed (one transcript replay and
    instance commitment a distinct proof)."""
    from ..plonk.verifier_device import commit_instance, parse_batch

    usable = vk.cs.usable_rows(vk.n)
    parsed = parse_batch(vk, [[commit_instance(params, c, usable) for c in insts] for insts, _ in protos],
                         [proof for _, proof in protos])
    return [parsed[i % len(parsed)] for i in range(B)]


def dryrun(vk, parsed, world: int, shapes, device, *, backend=None, msm_column=None, placement=False):
    """`rank_run` on `world` ranks; returns (records of every rank, seconds)."""
    from ..device import resolve_device
    from ..parallel.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(rank_run, world, device=device, backend=backend,
                      args=(vk, parsed, list(shapes), resolve_device(device).type, msm_column, placement))
    return ranks, time.perf_counter() - t0


def check(ranks, want: list, h_eval=None, msm_want=None) -> None:
    """Every rank's quads of every shape and formulation equal `want` (one
    (e, f, w, zw) a proof); h_eval and the sharded MSM, where given, equal
    theirs.  Raises AssertionError on the first difference."""
    for r, recs in enumerate(ranks):
        for rec in recs:
            for name, quads in rec["quads"].items():
                for i, (got, w) in enumerate(zip(quads, want)):
                    if tuple(got) != tuple(w):
                        raise AssertionError(f"rank {r}, mesh {rec['mesh']}, {name}: quad of proof {i} != host")
                if len(quads) != len(want):
                    raise AssertionError(f"rank {r}, mesh {rec['mesh']}, {name}: {len(quads)} quads, want {len(want)}")
            if h_eval is not None and not torch.equal(rec["h_eval"], h_eval):
                raise AssertionError(f"rank {r}, mesh {rec['mesh']}: sharded h_eval != field_algebra's")
            if msm_want is not None and rec["msm"] != msm_want:
                raise AssertionError(f"rank {r}, mesh {rec['mesh']}: sharded_msm != msm")


def check_launches(ranks) -> None:
    """Every rank's launches on the card: FAST_LAUNCHES a formulation,
    MSM_LAUNCHES a `sharded_msm`."""
    for r, recs in enumerate(ranks):
        for rec in recs:
            for name, want in (("shmap", FAST_LAUNCHES), ("sharded", FAST_LAUNCHES), ("sharded_msm", MSM_LAUNCHES)):
                if rec["launches"][name] != want:
                    raise AssertionError(f"rank {r}, mesh {rec['mesh']} {name}: launches {rec['launches'][name]}")


def check_placement(ranks, world: int) -> None:
    """Rank r saw card r only: its current device, the device of every
    tensor the step returned, of every CUDA event of its profiled calls, and
    of the launches of each of the main path's kernels (which must be among
    them).  `ranks` is `rank_run`'s records of `world` ranks, run with
    `placement`.  Raises AssertionError on the first rank that saw another
    card or whose record shows no launch."""
    if len(ranks) != world:
        raise AssertionError(f"{len(ranks)} ranks' records, world {world}")
    for r, recs in enumerate(ranks):
        for rec in recs:
            where = rec["placement"]
            seen = {"current_device": [where["current_device"]], "tensor_devices": where["tensor_devices"]}
            for name, events in where["events"].items():
                seen.update({f"{name} {kernel} events": devs for kernel, devs in events.items()})
            for what, devs in seen.items():
                if list(devs) != [r]:
                    raise AssertionError(f"rank {r}, mesh {rec['mesh']}: {what} on cards {devs}, want [{r}]")


def scale_run(vk, parsed, shape, device, batches, repeats, msm_log_n=None) -> dict:
    """One rank's part of the scale-out, on a mesh of `shape`: for each B in
    `batches`, both formulations over the first B of `parsed`, one warm-up
    call each (NCCL builds its communicators at the first collective), then
    `repeats` calls, each after a barrier, timed on the host clock to the
    step's last synchronisation.  With `msm_log_n`, `sharded_msm` of
    `random_column`'s 2^msm_log_n points (the SRS from `kzg.setup`'s disk
    cache, which the caller fills) over the axis of more ranks: a warm-up,
    then `repeats` timed calls, then `repeats` of `msm` on this rank's share
    alone.  Returns this rank's card, and a record a B (the warm-up's
    quads, the walls, the timings, the launches of the repeats) and the
    MSM's (its sum, its walls, its share's walls)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    from ..ops import curve_ops as co
    from ..ops.msm import msm
    from ..parallel.batch_verify import _sync, sharded_verify_algebra_fast, shmap_verify_algebra_fast
    from ..parallel.mesh import axis as mesh_axis
    from ..parallel.sharded_msm import sharded_msm
    from ..plonk.verifier_device import batch_proofs, quads_to_ints

    device = resolve_device(device)
    counters = _launch_counters()
    mesh = init_device_mesh(device.type, tuple(shape), mesh_dim_names=("dp", "mp"))

    def timed(run):
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        return out, time.perf_counter() - t0

    card = torch.cuda.current_device() if device.type == "cuda" else None
    res = {"card": card, "mesh": list(shape), "runs": []}
    for B in batches:
        part = parsed[:B]
        batch = batch_proofs(vk, part, device)
        run = {"batch": B, "quads": {}, "walls": {}, "timings": {}, "launches": {}}
        for name, fn in (("shmap", shmap_verify_algebra_fast), ("sharded", sharded_verify_algebra_fast)):
            run["quads"][name] = quads_to_ints(timed(lambda: fn(mesh, vk, batch, part))[0])  # noqa: B023
            for c in counters.values():
                c.launches = 0
            run["walls"][name], run["timings"][name] = [], []
            for _ in range(repeats):
                timings = {}
                run["walls"][name].append(timed(lambda: fn(mesh, vk, batch, part, timings=timings))[1])  # noqa: B023
                run["timings"][name].append(timings)
            run["launches"][name] = {k: c.launches for k, c in counters.items()}
        res["runs"].append(run)
    if msm_log_n is not None:
        points, scalars = random_column(device, msm_log_n)
        ax = "dp" if shape[0] > shape[1] else "mp"
        total, _ = timed(lambda: sharded_msm(mesh, ax, points, scalars))
        res["msm"] = {"n": 1 << msm_log_n, "axis": ax, "sum": co.jac_to_ints(JacPoint(*(c[None] for c in total)))[0],
                      "walls": [timed(lambda: sharded_msm(mesh, ax, points, scalars))[1] for _ in range(repeats)]}
        # this rank's share alone, without the gather and the sum of partials
        size, idx, _ = mesh_axis(mesh, ax)
        lo, hi = idx * (points.x.shape[0] // size), (idx + 1) * (points.x.shape[0] // size)
        share = AffinePoint(*(c[lo:hi] for c in points)), scalars[lo:hi]
        res["msm"]["share_walls"] = [timed(lambda: msm(*share))[1] for _ in range(repeats)]
    return res


def _spread(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def scale_groups(ranks, world: int, want: list, repeats: int) -> list:
    """`scale_run`'s records of `world` ranks -> one group a batch: per
    repeat the slowest rank's wall, proofs/s as B over it (median, min,
    max over the repeats), and per rank its card, its median wall, its
    median timings and `wait`, the median over the repeats of how long its
    partials were ready before the last rank's (prep + device: the part of
    its `collective` that waits for the others).  Checks every rank's
    warm-up quads against `want` (cycled) and the repeats' launches; raises
    AssertionError."""
    groups = []
    for i, run0 in enumerate(ranks[0]["runs"]):
        B = run0["batch"]
        cycled = [want[j % len(want)] for j in range(B)]
        group = {"scale_out": True, "world": world, "mesh": ranks[0]["mesh"], "batch": B,
                 "repeats": repeats, "wall_s": {}, "proofs_per_s": {}, "ranks": []}
        for name in ("shmap", "sharded"):
            for r, res in enumerate(ranks):
                run = res["runs"][i]
                if [tuple(q) for q in run["quads"][name]] != [tuple(w) for w in cycled]:
                    raise AssertionError(f"scale-out rank {r}, B = {B}, {name}: quads != host")
                on_card = res["card"] is not None  # a CPU rank launches nothing: the plain versions
                if on_card and run["launches"][name] != {k: v * repeats for k, v in FAST_LAUNCHES.items()}:
                    raise AssertionError(f"scale-out rank {r}, B = {B}, {name}: launches {run['launches'][name]}")
            slowest = [max(res["runs"][i]["walls"][name][j] for res in ranks) for j in range(repeats)]
            group["wall_s"][name] = _spread(slowest)
            group["proofs_per_s"][name] = _spread([B / w for w in slowest])
        ready = {name: [[t["prep"] + t["device"] for t in res["runs"][i]["timings"][name]] for res in ranks]
                 for name in ("shmap", "sharded")}
        for r, res in enumerate(ranks):
            run = res["runs"][i]
            group["ranks"].append({
                "card": res["card"],
                "wall_s": {name: statistics.median(ws) for name, ws in run["walls"].items()},
                "timings": {name: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
                            for name, ts in run["timings"].items()},
                "wait": {name: statistics.median(max(rs[j] for rs in rd) - rd[r][j] for j in range(repeats))
                         for name, rd in ready.items()},
            })
        groups.append(group)
    return groups


def cards() -> dict:
    """`nvidia-smi`'s name and power limit, one line a card; the links
    between the cards as `nvidia-smi topo -m` and card 0's `nvlink
    --status` give them (each its own error text where nvidia-smi refuses
    it); and which card can reach which card's memory directly
    (`torch.cuda.can_device_access_peer`)."""
    def smi(*args):
        return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)

    def text(*args):
        res = smi(*args)
        out = (res.stdout + res.stderr).strip()
        return out if res.returncode == 0 else f"nvidia-smi {' '.join(args)}: exit {res.returncode}: {out}"

    names = smi("--query-gpu=name,power.limit", "--format=csv,noheader")
    names.check_returncode()
    n = torch.cuda.device_count()
    return {"nvidia_smi": names.stdout.strip().splitlines(), "topo": text("topo", "-m"),
            "nvlink_card0": text("nvlink", "--status", "-i", "0"),
            "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)] for i in range(n)]}


def _references(params, vk, protos, B: int, n_parsed: int, device) -> tuple:
    """What a card run holds its ranks to: `protos` cycled to `n_parsed`
    parsed proofs, `field_algebra`'s h_eval of the first B, and a random
    column at 2^16 as `rank_run`'s `msm_column` (on the host) with one
    `msm` of it.  Builds the kernels first, once, before the ranks start."""
    from ..ops import build
    from ..ops import curve_ops as co
    from ..ops.msm import msm
    from ..plonk.verifier_device import batch_proofs, field_algebra

    build.load_library()
    parsed = parse_all(params, vk, protos, n_parsed)
    h_eval = field_algebra(vk, batch_proofs(vk, parsed[:B], device), B)[0].cpu()
    points, scalars = random_column(device)
    msm_want = co.jac_to_ints(JacPoint(*(c[None] for c in msm(points, scalars))))[0]
    return parsed, h_eval, (AffinePoint(*(c.cpu() for c in points)), scalars.cpu(), 254), msm_want


def _check_group(ranks, want: list, h_eval, msm_want, params) -> None:
    """`check`, `check_launches` and `check_aggregate` on rank 0's quads of
    every mesh; raises AssertionError."""
    from ..plonk.verifier_device import check_aggregate

    check(ranks, want, h_eval, msm_want)
    check_launches(ranks)
    for rec in ranks[0]:
        if check_aggregate(rec["quads"]["shmap"], params) is not True:
            raise AssertionError(f"check_aggregate refused mesh {rec['mesh']}'s quads")


def run_card(params, vk, protos, want: list, device) -> list:
    """The card run: world 1 over NCCL (mesh 1 x 1), then world 2 over gloo
    with two ranks sharing the card (`make_mesh(2)` is 2 x 1, dp >= mp, so
    1 x 2 is built by shape), at B = len(want) proofs (`protos` cycled),
    against `want`, one (e, f, w, zw) a proof.  Checks every rank's quads,
    h_eval against `field_algebra`'s, `sharded_msm` of a random column at
    2^16 against one `msm`, every rank's launches and `check_aggregate` on
    rank 0's quads; raises AssertionError on the first fault.  Returns one
    record a group: meshes, seconds, and per rank its seconds, timings and
    launches."""
    B = len(want)
    parsed, h_eval, column, msm_want = _references(params, vk, protos, B, B, device)
    groups = []
    for world, backend, shapes in ((1, "nccl", [None]), (2, "gloo", [None, (1, 2)])):
        ranks, seconds = dryrun(vk, parsed, world, shapes, device, backend=backend, msm_column=column)
        _check_group(ranks, want, h_eval, msm_want, params)
        groups.append({
            "world": world, "backend": backend, "meshes": [rec["mesh"] for rec in ranks[0]], "batch": B,
            "seconds": seconds, "sharded_msm_n": int(column[1].shape[0]),
            "ranks": [[{"mesh": rec["mesh"], "msm_axis": rec["msm_axis"], "seconds": rec["seconds"],
                        "timings": rec["timings"], "launches": rec["launches"]} for rec in recs] for recs in ranks],
        })
    return groups


def run_cards(params, vk, protos, want: list, world: int) -> list:
    """One rank a card over NCCL, `world` cards.  Raises ValueError, before
    any work, unless `world` (> 1) cards are visible (`check_cards`).

    The checks, as `run_card`'s, at B = len(want) proofs (`protos` cycled)
    on `make_mesh`'s mesh, then world x 1 and 1 x world built by shape:
    every rank's quads of both formulations equal `want`, h_eval equals
    `field_algebra`'s, `sharded_msm` at 2^16 over the larger axis equals one
    `msm`, every rank's launches, `check_aggregate` on rank 0's quads, and
    `check_placement`.  Then the scale-out (`scale_run`, REPEATS timed
    steps after a warm-up): world 1 over NCCL at B and world B, then
    world x 1 at world B, its `sharded_msm` at 2^SCALE_MSM_LOG_N against
    one card's `msm` (its median of REPEATS host-clocked calls, here).
    Returns one record a group: the checks' (as `run_card`'s, each rank's
    with its card), one a scale-out batch (`scale_groups`), and the MSM's.
    The arguments' pickled size and time are in the records: spawn pickles
    them once a rank, before any clock starts."""
    from ..device import resolve_device
    from ..ops import curve_ops as co
    from ..ops.msm import msm
    from ..parallel.mesh import check_cards, mesh_split, run_ranks
    from ..plonk import kzg

    if world < 2:
        raise ValueError(f"run_cards: world {world}: expected 2 or more cards (one card is run_card's)")
    check_cards(world)

    device = resolve_device("cuda")
    B = len(want)
    parsed, h_eval, column, msm_want = _references(params, vk, protos, B, B * world, device)
    shapes = [None] + [s for s in ((world, 1), (1, world)) if s != mesh_split(world)]

    def pickled(args) -> dict:
        t0 = time.perf_counter()
        return {"bytes": len(pickle.dumps(args)), "seconds": time.perf_counter() - t0}

    check_args = (vk, parsed[:B], shapes, "cuda", column, True)
    ranks, seconds = dryrun(vk, parsed[:B], world, shapes, device, backend="nccl", msm_column=column, placement=True)
    _check_group(ranks, want, h_eval, msm_want, params)
    check_placement(ranks, world)
    groups = [{
        "world": world, "backend": "nccl", "meshes": [rec["mesh"] for rec in ranks[0]], "batch": B,
        "seconds": seconds, "sharded_msm_n": int(column[1].shape[0]), "pickled_args": pickled(check_args),
        "placement": "rank r on card r only", "cards": [recs[0]["card"] for recs in ranks],
        "ranks": [[{"mesh": rec["mesh"], "card": rec["card"], "msm_axis": rec["msm_axis"], "seconds": rec["seconds"],
                    "timings": rec["timings"], "launches": rec["launches"]} for rec in recs] for recs in ranks],
    }]

    # the scale-out: the SRS at 2^21 into kzg.setup's disk cache, which each
    # rank reads; one card's msm on it, here
    kzg.setup(SCALE_MSM_LOG_N)
    big_points, big_scalars = random_column(device, SCALE_MSM_LOG_N)
    big_want = co.jac_to_ints(JacPoint(*(c[None] for c in msm(big_points, big_scalars))))[0]
    one_card = []
    for _ in range(REPEATS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        msm(big_points, big_scalars)
        torch.cuda.synchronize(device)
        one_card.append(time.perf_counter() - t0)
    del big_points, big_scalars
    runs = {}
    for w, shape, batches, log_n in ((1, (1, 1), [B, B * world], None), (world, (world, 1), [B * world],
                                                                         SCALE_MSM_LOG_N)):
        args = (vk, parsed, shape, "cuda", batches, REPEATS, log_n)
        runs[w] = run_ranks(scale_run, w, device=device, backend="nccl", args=args), pickled(args)
    for w, (res, cost) in runs.items():
        for group in scale_groups(res, w, want, REPEATS):
            groups.append({**group, "backend": "nccl", "pickled_args": cost})
    ranks = runs[world][0]
    for r, res in enumerate(ranks):
        if res["card"] != r or res["msm"]["sum"] != big_want:
            raise AssertionError(f"scale-out rank {r} on card {res['card']}: sharded_msm != msm")
    slowest = [max(res["msm"]["walls"][j] for res in ranks) for j in range(REPEATS)]
    groups.append({
        "sharded_msm": True, "n": 1 << SCALE_MSM_LOG_N, "world": world, "backend": "nccl",
        "axis": ranks[0]["msm"]["axis"],
        "repeats": REPEATS, "equal_to_msm": True, "one_card_s": _spread(one_card), "sharded_s": _spread(slowest),
        "ranks_s": [statistics.median(res["msm"]["walls"]) for res in ranks],
        "ranks_share_s": [statistics.median(res["msm"]["share_walls"]) for res in ranks],
    })
    return groups


def main(argv=None) -> int:
    from ..config import H2AConfig
    from ..device import resolve_device
    from ..parallel.mesh import check_cards, mesh_split
    from ..plonk.verifier import verify_proof
    from ..plonk.verifier_device import batch_proofs, field_algebra

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks: on the CPU gloo ranks (default 8); on the card one rank a card over NCCL "
                         "(default 1: the one-card run)")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"proofs a batch (default: dp of the CPU mesh, {BATCH} on the card)")
    args = ap.parse_args(argv)
    multi = args.device == "cuda" and (args.world or 1) > 1
    if multi:
        check_cards(args.world)  # before the host proofs, so before any spawn
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    params, vk, protos = make_proofs(H2AConfig.from_env().k_inner)
    efws = []
    for insts, proof in protos:
        ok, efw = verify_proof(params, vk, insts, proof)
        if not ok:
            raise AssertionError("host verify_proof rejected a dry-run proof")
        efws.append(tuple(efw))
    print(f"[dryrun {time.perf_counter() - t0:6.1f}s] host proofs ready", flush=True)
    if device.type == "cpu":
        world = args.world or 8
        B = args.batch or mesh_split(world)[0]
        want = [efws[i % len(efws)] for i in range(B)]
        parsed = parse_all(params, vk, protos, B)
        h_eval = field_algebra(vk, batch_proofs(vk, parsed, device), B)[0]
        ranks, seconds = dryrun(vk, parsed, world, [None], device, backend="gloo")
        check(ranks, want, h_eval)
        groups = [{"world": world, "backend": "gloo", "meshes": [rec["mesh"] for rec in ranks[0]],
                   "batch": B, "seconds": seconds,
                   "ranks": [[{k: rec[k] for k in ("mesh", "seconds", "timings")} for rec in recs]
                             for recs in ranks]}]
    else:
        print(json.dumps({"cards": cards()}), flush=True)
        want = [efws[i % len(efws)] for i in range(args.batch or BATCH)]
        if multi:
            groups = run_cards(params, vk, protos, want, args.world)
        else:
            groups = run_card(params, vk, protos, want, device)
    for group in groups:
        print(json.dumps({**group, "quads_equal_host": True}), flush=True)
    print(f"dryrun_multichip ok: {[(g['world'], g.get('backend')) for g in groups]}, quads == host on every rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())
