"""The verifier's production step over a mesh of ranks, held to the host
verifier bit for bit.

    python3 -m halo2_aggregation_tpu_torch.tools.dryrun_multichip --device cpu --world 8
    python3 -m halo2_aggregation_tpu_torch.tools.dryrun_multichip --device cuda

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
  The kernels are built here before the ranks start.

Prints one JSON line a group, then `dryrun_multichip ok`.  A failed rank or
check exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the two inner witnesses (constant=7, a, b) and their seeds, as in the JAX dry run
WITNESSES = [(2, 3), (4, 5)]
MSM_LOG_N = 16
BATCH = 128  # proofs of the card run: the batch of chip_smoke.py's main phase
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


def rank_run(vk, parsed, shapes, device, msm_column=None) -> list:
    """One rank's part: for each mesh shape (dp, mp), or `make_mesh`'s for
    None, both formulations over the batch of `parsed` and
    `sharded_field_algebra`, and with `msm_column` = (points, scalars, nbits)
    on the host, `sharded_msm` over the axis of more ranks.  Returns a record
    a mesh: its shape, the quads as host ints, h_eval, the seconds, this
    rank's timings and its kernel launches."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    from ..ops import curve_ops as co
    from ..ops.curve_ops import AffinePoint, JacPoint
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
    recs = []
    for shape in shapes:
        if shape is None:
            mesh = make_mesh(device=device)
        else:
            mesh = init_device_mesh(device.type, tuple(shape), mesh_dim_names=("dp", "mp"))
        shape = tuple(mesh.shape)
        rec = {"mesh": list(shape), "quads": {}, "seconds": {}, "timings": {}, "launches": {}}
        for name, fn in (("shmap", shmap_verify_algebra_fast), ("sharded", sharded_verify_algebra_fast)):
            for c in counters.values():
                c.launches = 0
            timings = {}
            t0 = time.perf_counter()
            out = fn(mesh, vk, batch, parsed, timings=timings)
            rec["quads"][name] = quads_to_ints(out)
            rec["seconds"][name] = time.perf_counter() - t0
            rec["timings"][name] = timings
            rec["launches"][name] = {k: c.launches for k, c in counters.items()}
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


def dryrun(vk, parsed, world: int, shapes, device, *, backend=None, msm_column=None):
    """`rank_run` on `world` ranks; returns (records of every rank, seconds)."""
    from ..device import resolve_device
    from ..parallel.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(rank_run, world, device=device, backend=backend,
                      args=(vk, parsed, list(shapes), resolve_device(device).type, msm_column))
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
    from ..ops import build
    from ..ops import curve_ops as co
    from ..ops.curve_ops import AffinePoint, JacPoint
    from ..ops.msm import msm
    from ..plonk.verifier_device import batch_proofs, check_aggregate, field_algebra

    build.load_library()  # once, before the ranks start
    B = len(want)
    parsed = parse_all(params, vk, protos, B)
    h_eval = field_algebra(vk, batch_proofs(vk, parsed, device), B)[0].cpu()
    points, scalars = random_column(device)
    msm_want = co.jac_to_ints(JacPoint(*(c[None] for c in msm(points, scalars))))[0]
    column = (AffinePoint(*(c.cpu() for c in points)), scalars.cpu(), 254)
    groups = []
    for world, backend, shapes in ((1, "nccl", [None]), (2, "gloo", [None, (1, 2)])):
        ranks, seconds = dryrun(vk, parsed, world, shapes, device, backend=backend, msm_column=column)
        check(ranks, want, h_eval, msm_want)
        for recs in ranks:
            for rec in recs:
                for name in ("shmap", "sharded"):
                    if rec["launches"][name] != FAST_LAUNCHES:
                        raise AssertionError(f"mesh {rec['mesh']} {name}: launches {rec['launches'][name]}")
                if rec["launches"]["sharded_msm"] != MSM_LAUNCHES:
                    raise AssertionError(f"mesh {rec['mesh']} sharded_msm: launches {rec['launches']['sharded_msm']}")
        for rec in ranks[0]:
            if check_aggregate(rec["quads"]["shmap"], params) is not True:
                raise AssertionError(f"check_aggregate refused mesh {rec['mesh']}'s quads")
        groups.append({
            "world": world, "backend": backend, "meshes": [rec["mesh"] for rec in ranks[0]], "batch": B,
            "seconds": seconds, "sharded_msm_n": int(scalars.shape[0]),
            "ranks": [[{"mesh": rec["mesh"], "msm_axis": rec["msm_axis"], "seconds": rec["seconds"],
                        "timings": rec["timings"], "launches": rec["launches"]} for rec in recs] for recs in ranks],
        })
    return groups


def main(argv=None) -> int:
    from ..config import H2AConfig
    from ..device import resolve_device
    from ..parallel.mesh import mesh_split
    from ..plonk.verifier import verify_proof
    from ..plonk.verifier_device import batch_proofs, field_algebra

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--world", type=int, default=8, help="ranks of the CPU run")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"proofs a batch (default: dp of the CPU mesh, {BATCH} on the card)")
    args = ap.parse_args(argv)
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
        B = args.batch or mesh_split(args.world)[0]
        want = [efws[i % len(efws)] for i in range(B)]
        parsed = parse_all(params, vk, protos, B)
        h_eval = field_algebra(vk, batch_proofs(vk, parsed, device), B)[0]
        ranks, seconds = dryrun(vk, parsed, args.world, [None], device, backend="gloo")
        check(ranks, want, h_eval)
        groups = [{"world": args.world, "backend": "gloo", "meshes": [rec["mesh"] for rec in ranks[0]],
                   "batch": B, "seconds": seconds,
                   "ranks": [[{k: rec[k] for k in ("mesh", "seconds", "timings")} for rec in recs]
                             for recs in ranks]}]
    else:
        B = args.batch or BATCH
        groups = run_card(params, vk, protos, [efws[i % len(efws)] for i in range(B)], device)
    for group in groups:
        print(json.dumps({**group, "quads_equal_host": True}), flush=True)
    print(f"dryrun_multichip ok: {[(g['world'], g['backend']) for g in groups]}, quads == host on every rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())
