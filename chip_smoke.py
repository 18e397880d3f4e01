#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from `halo2_aggregation_tpu_torch/csrc`, checks
each against its plain PyTorch version on the card, then drives the port's
paths: the verifier's, B = 128 simple-example (k = 9) proofs folded into
one accumulator by `verify_batch(..., aggregate=True, device="cuda")`
(with K1, then with K8), the SRS commitments of `DeviceSRS` at the outer
proof's n = 2^21 (K7 and K9), and the prover's, `keygen_device` and
`create_proof_device(..., device="cuda")` with the quotient and every
commitment on the card; then the aggregation product, the k = 21 outer
proof of one inner proof (`tools/outer_prove.py::run_outer`), held byte for
byte to `docs/artifacts/outer_n1_k21.*`.

Phases (each prints on its own lines; any failure raises and exits
nonzero before the last line):
  0. card and versions (`nvidia-smi` name and power limit, torch, CUDA);
  1. kernel build (nvcc), timed, with ptxas' register and spill report;
  2. the latency of one dependent Montgomery product (one warp an SM,
     10,000 products in series, Fq and Fr), checked against host integers;
     K1 (windowed scalar-mul, each lane split in two halves over two
     threads) at the main path's 4,608 lanes against its plain version
     (affine equality), 16 lanes against the oracle, a ragged lane count
     against the full launch at two block shapes, and 2^17 lanes against K8
     on the same lanes, each on its own sample against the oracle; K8 (a
     joint double-and-add over K1's split) on the 4,608 lanes at 256 bits
     against K1 and its plain version (the bit-serial ladder), and ragged
     against full; the segmented Jacobian sum at the main path's
     shape (128 proofs, segments of 4, 4, 27 and 1 lanes) and at ragged
     segment lengths in both layouts against its plain version (affine
     equality);
  3. K2 (field-algebra tape with the e-lane's scalar, one inversion a lane)
     on a real B = 128 batch against its plain version (bit for bit), 8
     lanes against the host IntOps formulas, a ragged batch against the full
     launch, and the three-output tape against the first three outputs;
  4. the main path: result True, quads equal the host `verify_proof`, the
     host parse `parse_batch` equal to the loop of `parse_proof` (both
     timed, and the vk's point layout that parse_batch finds), a
     tampered proof and a wrong public input rejected, all three kernels
     launched by the main path, median of 5 wall times, the stage split and
     peak device memory; once more with method="ladder" (K8), with the
     same quads; then one run under torch.profiler for the device's busy
     share, its events and its kernels by name, and the events of each
     piece of the device step;
  4a. bench: the port's benchmark program (`halo2_aggregation_tpu_torch/
     bench.py::run`) at its defaults on the same four proofs: its line
     (`proofs_aggregated_per_s` without the instance commitments, the
     device algebra alone, K1 and K8 on the multiopen lanes, K7 at 2^17, K3
     at 8 x 2^16, the product chain, the host baseline), every gate passed
     (quads, K1, K8, MSM, NTT, product chain) and every roofline fraction
     in (0, 1.05] of the bound model both share (`tools/measure.py`);
  4b. benchmark: the benchmark's runner (`benchmark/run.py`) on its cell
     verify_b128_k9 at the default seed, as `python -m benchmark.run`
     runs it (`bench.py::run_verifier`, a discarded run then the measured
     one) but at 5 trials of the cell's 100: its line correct (every gate
     of the verifier's sections passed, the proofs and quads equal to the
     reference file's), and the main path's kernels launched by it (K2,
     K1 and the segmented sum);
  4c. parallel: on the main phase's B = 128 proofs, `verify_algebra` (the
     sequential folds, one K1 call a fold step) with the main phase's quads
     and `verify_batch(..., fast=False)` accepting; one padded K1 launch
     (`fast_prep(lane_pad=3)`'s lanes) with the unpadded lanes' sums; then
     `tools/dryrun_multichip.py`'s rank step on world 1 over NCCL (mesh 1 x
     1) and world 2 over gloo, two ranks on the one card (meshes 2 x 1 and
     1 x 2): both mesh formulations' quads equal the main phase's on every
     rank, `check_aggregate` accepts them, `sharded_field_algebra`'s h_eval
     equals `field_algebra`'s, `sharded_msm` of a random column at 2^16
     equals one `msm`; per rank the device stage, the collectives' time and
     the launches (K2 and K1 once a formulation, the segmented sum twice:
     the lanes, then the gathered mp partials; K7 and the segmented sum once
     a sharded MSM); on a host with two cards or more, also the dry run
     across every card (`run_cards`: one rank a card over NCCL, the same
     checks on `make_mesh`'s mesh, N x 1 and 1 x N, each rank's tensors and
     kernels on its own card, and the scale-out against one card), on a
     line of its own;
  5. ntt: the device's Montgomery product alone on 2^20 random pairs and
     the edge values, for Fq and Fr, against the plain PyTorch product; K3
     and K4 at k = 1, 5, 9, 13 and 16 on 2 random columns, K5's power series
     at k = 1, 5, 9, 16 and 21 in both orders (two launches a call), and K4,
     K5 and K3
     at k = 21 on 4 against their plain versions (bit for bit), each
     transform in `len(pass_plan(k))` launches, intt(ntt(x)) == x, and one
     column's coset evaluations through K4 -> K5 -> K3 against the native
     host engine; the pass kernels' blocks an SM;
  6. quotient: the aggregation circuit's 39 columns at k = 21 (the real
     outer proof's size) through `DeviceQuotient` (feed, finalize, 4
     cosets), K6 against its plain version on the first, last and random
     4,096-row windows and on every row, timings and peak memory;
  7. msm: `kzg.setup(21)` on the host and with `device` (its 2^21
     fixed-base products through K1), equal; `DeviceSRS` at n = 2^21 (the
     outer proof's size): K7 and K9
     commitments of a random column, an all-zero column (None) and a
     one-hot column (that SRS point) equal the native host MSM's, with the
     SRS upload, kernel and host times and peak memory; at the prove's
     n = 2^16 K7 and K9 against their plain versions and the native MSM
     (the `kernels` line's times); then at n = 2^14 - 3
     (ragged) K7 and K9 against their plain versions and the native MSM on
     edge lanes (infinity flags, zero scalars, 1, r - 1, 2^254 - 1 mod r, a
     point, its negation and repeats on adjacent rows of one chunk: the
     identity and doubling branches); prints the chosen C, the blocks an SM
     holds and the waves the grid fills, for 2^21 and 2^16;
  8. prove: the prover's path at k = 16 on the simple example:
     `keygen_device` with the vk of the port's host `keygen_native`,
     then `create_proof_device` sharing its `DeviceSRS`, byte-identical to
     `create_proof_native` in the same process and accepted by
     `verify_proof`, with K7 launched once per commitment and K3-K6
     launched during the prove;
  9. outer: `run_outer` at N = 1, k = 21 on the card (the inner proof at
     k = 9, the outer circuit's 1.27M rows, `keygen_device` on its
     assignment, `create_proof_device` with seed 1, the host
     `verify_proof`), sharing the `msm` phase's `DeviceSRS`: public inputs,
     vk, proof bytes, instance commitment and quad equal to
     `docs/artifacts/outer_n1_k21.*`, the in-circuit quad equal to the host
     verifier's; the outer proof through `verify_batch(aggregate=True)` at
     B = 1 and 2 (accepted, quads equal) and with a byte flipped
     (rejected); the stage split, peak device memory and each kernel's
     launches in the phase (K3-K7, K2, K1 and the segmented sum, each > 0).
Then one JSON line with the kernels' numbers (each with its launches on its
path, its time, its plain version's time, its bound and `library_ms`: null,
as no PyTorch call computes 256-bit modular arithmetic; the lane-serial
kernels also with their chain time, the dependent products of one thread
times the measured latency of one), and as the last line
{"ok": true, "device": {...}}.  Exits nonzero, printing no result, when no
CUDA device is visible.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

# The port runs without JAX and without the JAX package: both are made
# unimportable here, so nothing of either loads even where it is installed,
# and the last phase asserts that none did.
sys.modules["jax"] = None
sys.modules["halo2_aggregation_tpu"] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
# the SRS cache stays inside the checkout (build/ is not committed)
os.environ.setdefault("H2A_PARAMS_CACHE", os.path.join(ROOT, "build", "h2a-params"))
sys.path.insert(0, ROOT)

from halo2_aggregation_tpu_torch.tools.measure import (  # noqa: E402  (the checkout is on the path from here)
    P_ADD,
    P_ADD_MIXED,
    P_DOUBLE,
    bound,
    cuda_ms,
    inv_products,
    k1_products,
    tape_products,
)

B = 128  # production batch (the JAX package's config.py:50)
K = 9  # simple-example inner circuit (config.py:30)
SEED = 20261016


def emit(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def max_abs_err(a: list, b: list) -> int:
    """Largest coordinate difference between two lists of affine points."""
    err = 0
    for p, q in zip(a, b):
        if (p is None) != (q is None):
            raise AssertionError(f"identity mismatch: {p} vs {q}")
        if p is not None:
            err = max(err, abs(p[0] - q[0]), abs(p[1] - q[1]))
    return err


def latency_probe(device) -> dict:
    """Nanoseconds a dependent `fe_mul` (csrc/ew.cu::mul_chain_kernel,
    `ops/ntt.py::mul_chain`): one warp on every SM runs 10,000 products in
    series, each waiting for the one before; the result is held to
    a * (b / 2^256)^iters on host ints."""
    import numpy as np
    import torch

    from halo2_aggregation_tpu_torch.ops import field_ops as fo
    from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor, tensor_to_ints
    from halo2_aggregation_tpu_torch.ops.ntt import mul_chain

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    iters, n = 10_000, sms * 32
    rng = np.random.default_rng(SEED + 7)
    out = {"phase": "latency", "blocks_of_one_warp": sms, "dependent_products": iters}
    for spec in (fo.FQ, fo.FR):
        p = spec.p
        xs, ys = ([int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)] for _ in range(2))
        a, b = ints_to_tensor(xs, device), ints_to_tensor(ys, device)
        got = mul_chain(a, b, iters, spec)
        ms = cuda_ms(lambda: mul_chain(a, b, iters, spec), reps=5)
        rinv = pow(1 << 256, -1, p)
        if tensor_to_ints(got) != [x * pow(y * rinv, iters, p) % p for x, y in zip(xs, ys)]:
            raise AssertionError(f"mul_chain<{spec.name}> != a (b / 2^256)^{iters} on host ints")
        out[f"{spec.name}_ns"] = ms * 1e6 / iters
    emit(out)
    return out


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit(smi.splitlines()[0])
    emit({
        "phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "device_name": torch.cuda.get_device_name(0),
    })
    return smi.splitlines()[0]


def phase_build():
    from halo2_aggregation_tpu_torch.ops import build

    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    seconds = time.perf_counter() - t0
    log = (lib_path.parent / "ptxas.log").read_text().splitlines()
    for line in log:
        if "registers" in line or "spill" in line or "Compiling entry" in line or line.startswith("#"):
            emit("ptxas: " + line.strip())
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(lib_path.relative_to(ROOT))})


def k1_lanes(n: int, rng):
    """n lanes of (point, plain scalar): random multiples of G with random
    scalars < r, and mixed in: identity points, zero scalars, scalars 1,
    r - 1, r, r + 1 and 2^256 - 1, the old ladder's doubling cases, and
    scalars 2 a (mod r) for a short lattice vector (a, b), whose halves
    (a, -b) give the same point, so that K1's last add doubles.  Returns
    the lanes and how many of them meet in that doubling."""
    from halo2_aggregation_tpu_torch.fields import R
    from halo2_aggregation_tpu_torch.ops.ec_kernels import glv_split
    from halo2_aggregation_tpu_torch.oracle import curve as oc
    from halo2_aggregation_tpu_torch.oracle import glv
    from halo2_aggregation_tpu_torch.utils import native

    if not native.available():
        raise RuntimeError("the native host engine is needed to make K1's test points")
    g = oc.g1_generator()
    pts = native.g1_batch_mul(g, [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)])
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    # last window d with 16 * prefix == +-d (mod r): a 64-window ladder's
    # final add meets acc == d*P (doubling) or acc == -d*P (identity)
    inv16 = pow(16, -1, R)
    special = []
    for d in range(1, 16):
        for sign in (1, -1):
            prefix = sign * d * inv16 % R
            if prefix < 1 << 252:
                special.append(16 * prefix + d)
    meet = [sign * 2 * v[0] % R for v in (glv._V1, glv._V2) for sign in (1, -1)]
    edge = [0, 1, R - 1, (1 << 256) - 1, R, R + 1] + meet + special
    for i, k in enumerate(edge):
        ks[1 + 7 * i] = k
    for i in range(0, n, 97):
        pts[i] = None  # identity points
    doubling = 0
    for p, k in zip(pts, ks):
        s1, s2 = glv_split(k)
        doubling += p is not None and s1 != 0 and (s1 - s2 * glv.LAMBDA) % R == 0
    if doubling < 1:
        raise AssertionError("no lane's halves meet in the doubling branch of K1's last add")
    return pts, ks, doubling


# the dependent products of one K1 thread: the table, 32 x 4 doublings, 33
# window adds, the product by beta, the last add
K1_CHAIN = 4 * P_DOUBLE + 3 * P_ADD + 128 * P_DOUBLE + 33 * P_ADD + 1 + P_ADD


def phase_k1(device):
    import numpy as np
    import torch

    from halo2_aggregation_tpu_torch.fields import R
    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops.ec_kernels import scalar_mul_win
    from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor
    from halo2_aggregation_tpu_torch.oracle import curve as oc

    n = B * 36  # the main path's lanes: 35 multiopen lanes + the e-lane
    rng = np.random.default_rng(SEED)
    pts, ks, n_doubling = k1_lanes(n, rng)
    P = co.affine_to_jac(co.affine_from_ints(pts, device))
    s = ints_to_tensor(ks, device)
    out = scalar_mul_win(P, s)
    # a ragged lane count (not a multiple of the block) gives the same
    # lanes, at the block the launcher chooses and at two it is told
    m = n - 5
    for threads in (0, 32, 128):
        ragged = scalar_mul_win(co.JacPoint(*(c[:m].contiguous() for c in P)), s[:m].contiguous(), threads)
        if not all(torch.equal(a, b[:m]) for a, b in zip(ragged, out)):
            raise AssertionError(f"K1 on a ragged lane count (block {threads}) != the full launch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = co.scalar_mul(P, s)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got, want = co.jac_to_ints(out), co.jac_to_ints(ref)
    err = max_abs_err(got, want)
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"K1 != plain on {len(bad)} lanes, first {bad[:8]}")
    zero_ok = all(got[i] is None for i in range(n) if pts[i] is None or ks[i] % R == 0)
    if not zero_ok:
        raise AssertionError("K1: zero scalar or identity point did not give the identity")
    idx = list(range(16))
    oracle = [oc.g1_mul(pts[i], ks[i]) if pts[i] is not None else None for i in idx]
    if [got[i] for i in idx] != oracle:
        raise AssertionError("K1 != oracle g1_mul on the first 16 lanes")
    ms = cuda_ms(lambda: scalar_mul_win(P, s), reps=5)
    rec = {
        "name": "ec_win", "route": "cuda",
        "source": "halo2_aggregation_tpu_torch/csrc/ec_win.cu",
        "replaces": "halo2_aggregation_tpu/ops/ec_pallas.py:354",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(k1_products(pts, ks), n * 32 * (3 + 1 + 3)),
        "chain_products": K1_CHAIN, "chain_field": "Fq",
    }
    k8 = phase_k8(P, s, got, pts, ks)
    large_k1, large_k8 = k1_large_launch(device, P, pts, rng)
    rec.update(large_k1)
    k8.update(large_k8)
    emit({"phase": "k8_large", **large_k8})
    emit({
        "phase": "k1", "lanes": n, "doubling_cases": n_doubling, "oracle_lanes": 16,
        "ragged_blocks": [0, 32, 128], "tolerance": "exact: equal affine points", **rec,
    })
    return rec, k8, out


def k1_large_launch(device, P, pts, rng, log_n: int = 17) -> tuple:
    """K1 and K8 at 2^log_n lanes (the 4,608 points repeated, fresh random
    scalars below 2^256), where both launchers take the occupancy call's
    block: every lane of K1 equal to K8's over 256 bits as a group element,
    and a sample of each equal to the oracle (K1 and K8 share the split, so
    each is held to it on its own lanes).  Returns K1's and K8's fields."""
    import numpy as np
    import torch

    from halo2_aggregation_tpu_torch.fields import R
    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops.ec_kernels import ladder_block, scalar_mul_ladder, scalar_mul_win
    from halo2_aggregation_tpu_torch.ops.limbs import tensor_to_ints
    from halo2_aggregation_tpu_torch.oracle import curve as oc

    n = 1 << log_n
    idx = torch.arange(n, device=device) % P.x.shape[0]
    big = co.JacPoint(*(c[idx].contiguous() for c in P))
    raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    s = torch.from_numpy(raw.view(np.int32)).to(device)
    outs = {"K1": scalar_mul_win(big, s), "K8": scalar_mul_ladder(big, s, 256)}
    same = co.jac_eq(*outs.values())
    if not bool(same.all()):
        raise AssertionError(f"K1 != K8 on {int((~same).sum())} of 2^{log_n} lanes, "
                             f"first {(~same).nonzero()[:8].flatten().tolist()}")
    ks = tensor_to_ints(s.cpu())
    for name, out in outs.items():
        sample = [int(i) for i in rng.integers(0, n, size=8)]
        pick = torch.tensor(sample, device=device)
        got = co.jac_to_ints(co.JacPoint(*(c[pick] for c in out)))
        want = [oc.g1_mul(pts[i % len(pts)], ks[i] % R) if pts[i % len(pts)] is not None else None
                for i in sample]
        if got != want:
            raise AssertionError(f"{name} at 2^{log_n} lanes != oracle g1_mul on the sampled lanes {sample}")
    key = "2^%d" % log_n
    # nearly every digit of a random half is nonzero: count them all
    products = n * (2 * ((4 + 128) * P_DOUBLE + (3 + 32) * P_ADD) + 1 + P_ADD)
    rounds = k8_rounds(ks)
    live = [pts[i % len(pts)] is not None for i in range(n)]
    k1 = {
        "ms_at_" + key: cuda_ms(lambda: scalar_mul_win(big, s), reps=2),
        "bound_ms_at_" + key: bound(products, n * 32 * 7)["bound_ms"],
        "equal_to_k8_at_" + key: True, "oracle_lanes_at_" + key: 8,
    }
    k8 = {
        "ms_at_" + key: cuda_ms(lambda: scalar_mul_ladder(big, s, 256), reps=2),
        "bound_ms_at_" + key: bound(k8_products(rounds, live), n * 32 * 7)["bound_ms"],
        "chain_products_at_" + key: k8_chain(rounds), "block_at_" + key: ladder_block(n),
        "equal_to_k1_at_" + key: True, "oracle_lanes_at_" + key: 8,
    }
    return k1, k8


def k8_rounds(ks, nbits: int = 256) -> list:
    """[(rounds, adds)] of K8's lanes for these scalars: the split's halves
    of the masked scalar (`glv_split`, the host mirror of the kernel's), the
    rounds after the first below the top bit of the longer half, and an add
    for every nonzero bit pair below it."""
    from halo2_aggregation_tpu_torch.ops.ec_kernels import glv_split

    out = []
    for k in ks:
        m1, m2 = (abs(h) for h in glv_split(k % (1 << nbits)))
        top = max(m1.bit_length(), m2.bit_length())
        out.append((max(top - 1, 0), max(bin(m1 | m2).count("1") - 1, 0)))
    return out


def k8_setup_products() -> int:
    """The products of a K8 lane before its rounds: beta X, the full add
    P' + Q', then the one inversion that makes P' and P' + Q' affine and the
    12 products around it."""
    from halo2_aggregation_tpu_torch.fields import Q

    return 1 + P_ADD + inv_products(Q) + 12


def k8_products(rounds, live) -> int:
    """Montgomery products K8 needs for lanes of `rounds` (`k8_rounds`) on
    the lanes where `live` (the point is not the identity and the scalar
    not 0 mod r): the setup, a doubling a round and a mixed add a nonzero
    pair."""
    setup = k8_setup_products()
    return sum(setup + r * P_DOUBLE + a * P_ADD_MIXED for (r, a), ok in zip(rounds, live) if ok)


def k8_chain(rounds) -> int:
    """The dependent products of one K8 thread on the longest lane: the
    setup, then every round a doubling and a mixed add (a warp pays the add
    of a round as soon as one of its lanes has a nonzero pair)."""
    return k8_setup_products() + max(r for r, _ in rounds) * (P_DOUBLE + P_ADD_MIXED)


def phase_k8(P, s, k1_affine, pts, ks):
    """K8 on K1's lanes over all 256 bits (the lanes hold 2^256 - 1):
    affine-equal to K1 and to its plain version, the bit-serial ladder;
    ragged equals full."""
    import torch

    from halo2_aggregation_tpu_torch.fields import R
    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops.ec_kernels import ladder_block, scalar_mul_ladder

    n = P.x.shape[0]
    out = scalar_mul_ladder(P, s, 256)
    m = n - 5
    ragged = scalar_mul_ladder(co.JacPoint(*(c[:m] for c in P)), s[:m], 256)
    if not all(torch.equal(a, b[:m]) for a, b in zip(ragged, out)):
        raise AssertionError("K8 on a ragged lane count != the full launch")
    ref, plain_ms = host_ms(lambda: co.scalar_mul_ladder(P, s, 256))
    got, want = co.jac_to_ints(out), co.jac_to_ints(ref)
    err = max_abs_err(got, want)
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"K8 != plain on {len(bad)} lanes, first {bad[:8]}")
    if got != k1_affine:
        raise AssertionError("K8 != K1 on the same lanes")
    ms = cuda_ms(lambda: scalar_mul_ladder(P, s, 256), reps=5)
    rounds = k8_rounds(ks)
    live = [p is not None and k % R != 0 for p, k in zip(pts, ks)]
    rec = {
        "name": "ec_ladder", "route": "cuda",
        "source": "halo2_aggregation_tpu_torch/csrc/ec_ladder.cu",
        "replaces": "halo2_aggregation_tpu/ops/ec_pallas.py:317",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(k8_products(rounds, live), n * 32 * (3 + 1 + 3)),
        "chain_products": k8_chain(rounds), "chain_field": "Fq",
    }
    emit({"phase": "k8", "lanes": n, "nbits": 256, "block": ladder_block(n), "equal_to_k1": True,
          "max_rounds": max(r for r, _ in rounds), "tolerance": "exact: equal affine points", **rec})
    return rec


MAIN_OFFSETS = [0, 4, 8, 35, 36]  # a proof's lanes: w, zw, f and the e-lane


def segment_adds(p, offsets, lane_axis: int) -> int:
    """The adds a segmented sum needs on these lanes: in every (batch
    element, segment), one for every point that is not the identity but
    the first."""
    live = (p.z != 0).any(-1).movedim(lane_axis, 0)
    adds = 0
    for lo, hi in zip(offsets, offsets[1:]):
        adds += int((live[lo:hi].sum(0) - 1).clamp(min=0).sum())
    return adds


def phase_jac_sum(device, k1_out):
    """The segmented Jacobian sum (csrc/jac_sum.cu) against its plain
    version as affine points: at the main path's shape on K1's output
    lanes, and at ragged segment lengths (0, 1, 31, 32, 33, 70 and 33) in
    both layouts, with a point twice in one thread's run and across the
    tree (doubling) and a point beside its negation (cancelling)."""
    import torch

    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops import field_ops as fo
    from halo2_aggregation_tpu_torch.ops.ec_kernels import jac_segment_sum

    def affine(p):
        return co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in p)))

    lanes = MAIN_OFFSETS[-1]
    P = co.JacPoint(*(c.reshape(B, lanes, 8) for c in k1_out))
    out = jac_segment_sum(P, MAIN_OFFSETS, lane_axis=1)
    ref, plain_ms = host_ms(lambda: co.jac_segment_sum(P, MAIN_OFFSETS, lane_axis=1))
    got, want = affine(out), affine(ref)
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"segmented sum != plain on {len(bad)} of {len(got)} sums, first {bad[:8]}")
    err = max_abs_err(got, want)
    # a ragged batch gives the same sums
    m = B - 3
    ragged = jac_segment_sum(co.JacPoint(*(c[:m] for c in P)), MAIN_OFFSETS, lane_axis=1)
    if not all(torch.equal(a, b[:, :m]) for a, b in zip(ragged, out)):
        raise AssertionError("segmented sum on a ragged batch != the full launch")

    lens = [0, 1, 31, 32, 33, 70, 33]
    offsets = [0]
    for ln in lens:
        offsets.append(offsets[-1] + ln)
    M, Bn = offsets[-1], 5
    Q = co.JacPoint(*(c[: M * Bn].reshape(M, Bn, 8).clone() for c in k1_out))  # lanes first
    o32, o33, o70 = offsets[3], offsets[4], offsets[5]
    for dst, src, negate in ((o33 + 32, o33, False), (o32 + 17, o32 + 1, False),
                             (o32 + 18, o32 + 2, True), (o70 + 37, o70 + 5, True)):
        for c, name in zip(Q, "xyz"):
            c[dst] = fo.neg(c[src], fo.FQ) if negate and name == "y" else c[src]
    want = affine(co.jac_segment_sum(Q, offsets, lane_axis=0))
    if want[:Bn] != [None] * Bn:
        raise AssertionError("the plain segmented sum of an empty segment is not the identity")
    layouts = {"lanes_first": (Q, 0), "batch_first_view": (co.JacPoint(*(c.transpose(0, 1) for c in Q)), 1),
               "batch_first": (co.JacPoint(*(c.transpose(0, 1).contiguous() for c in Q)), 1)}
    for name, (pts, axis) in layouts.items():
        if affine(jac_segment_sum(pts, offsets, lane_axis=axis)) != want:
            raise AssertionError(f"segmented sum != plain at ragged segment lengths, layout {name}")

    ms = cuda_ms(lambda: jac_segment_sum(P, MAIN_OFFSETS, lane_axis=1), reps=100)
    adds = segment_adds(P, MAIN_OFFSETS, 1)
    rec = {
        "name": "jac_segment_sum", "route": "cuda",
        "source": "halo2_aggregation_tpu_torch/csrc/jac_sum.cu",
        # a lax.scan inside the jitted device step, not a Pallas kernel
        "replaces": "halo2_aggregation_tpu/ops/curve_ops.py:233",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(adds * P_ADD, (B * lanes + B * (len(MAIN_OFFSETS) - 1)) * 96 + len(MAIN_OFFSETS) * 4),
        # a thread's first point is free; then the five levels of the tree
        "chain_products": 5 * P_ADD, "chain_field": "Fq",
    }
    emit({
        "phase": "jac_sum", "batch": B, "offsets": MAIN_OFFSETS, "adds": adds,
        "ragged_segment_lengths": lens, "ragged_layouts": list(layouts),
        "tolerance": "exact: equal affine points", **rec,
    })
    return rec


def make_proofs():
    """The bench's four simple-example proofs (`bench.make_protos`, so
    that one function makes them): (params, vk, [(instances, proof)], and
    make_protos' own result, which the `bench` phase takes)."""
    from halo2_aggregation_tpu_torch.bench import make_protos

    made = make_protos(K)
    params, vk, protos = made
    return params, vk, [(insts, proof) for insts, proof, _ in protos], made


def phase_k2(params, vk, protos, device):
    import torch

    from halo2_aggregation_tpu_torch.ops import field_ops as fo
    from halo2_aggregation_tpu_torch.plonk import fa_fused as ff
    from halo2_aggregation_tpu_torch.plonk.protocol_ops import OP_INV, IntInvOps
    from halo2_aggregation_tpu_torch.plonk.verifier import parse_proof
    from halo2_aggregation_tpu_torch.plonk.verifier_device import batch_proofs, fast_prep_gathered

    comms = [[params.commit_lagrange(col) for col in insts] for insts, _ in protos]
    parsed = [parse_proof(vk, comms[i % 4], protos[i % 4][1]) for i in range(B)]
    batch = batch_proofs(vk, parsed, device)
    _, _, h_coeff, known = fast_prep_gathered(vk, parsed, device)
    tape = ff.fa_tape(vk, e_scalar=True)  # the main path's: with the e-lane's scalar
    inversions = int((tape.instrs[:, 0] == OP_INV).sum())
    if inversions != 1:
        raise AssertionError(f"K2's tape holds {inversions} inversions, expected one")
    cols = ff.fa_gather(vk, batch) + [h_coeff, known]
    inputs = torch.stack(cols).contiguous()
    out = ff.fa_tape_eval(tape, inputs)
    # a ragged batch (not a multiple of the block) gives the same lanes
    m = B - 3
    if not torch.equal(ff.fa_tape_eval(tape, inputs[:, :m].contiguous()), out[:, :m]):
        raise AssertionError("K2 on a ragged batch != the full launch")
    # the three-output tape gives the first three outputs
    if not torch.equal(ff.fa_tape_eval(ff.fa_tape(vk), inputs[:-2].contiguous()), out[:3]):
        raise AssertionError("K2's three-output tape != the first three outputs of the e-scalar tape")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ff.fa_tape_eval_plain(tape, inputs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
    if not torch.equal(out, ref):
        raise AssertionError("K2 != plain tape evaluation")
    # 8 lanes against the host formulas on the parsed proofs' own ints; the
    # e-lane's scalar comes out as plain limbs, the others in Montgomery form
    tags = ff.fa_schedule(vk) + ff.E_TAGS
    host_in = [fo.FR.from_mont_tensor(a) for a in cols]
    got = [fo.FR.from_mont_tensor(o) for o in out]
    for lane in range(min(8, B)):
        vals = {tag: host_in[j][lane] for j, tag in enumerate(tags)}
        want = ff.fa_program_e(IntInvOps(), vk, vals)
        if tuple(g[lane] for g in got) != tuple(want):
            raise AssertionError(f"K2 != host IntOps on lane {lane}")
    ms = cuda_ms(lambda: ff.fa_tape_eval(tape, inputs), reps=20)
    products = tape_products(tape)
    rec = {
        "name": "fa_tape", "route": "cuda",
        "source": "halo2_aggregation_tpu_torch/csrc/fa_tape.cu",
        "replaces": "halo2_aggregation_tpu/plonk/fa_fused.py:275",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(B * products, inputs.numel() * 4 + out.numel() * 4 + tape.instrs.size * 4),
        "chain_products": products, "chain_field": "Fr",
    }
    emit({
        "phase": "k2", "batch": B, "tape_instrs": int(tape.instrs.shape[0]),
        "tape_temps": tape.n_temps, "tape_inversions": inversions, "products_a_lane": products,
        "shared_bytes_a_block": ff.shared_bytes(tape),
        "host_lanes": 8, "tolerance": "exact: equal bits", **rec,
    })
    return rec


def phase_main(params, vk, protos, device):
    import torch

    from halo2_aggregation_tpu_torch.ops.ec_kernels import jac_segment_sum, scalar_mul_ladder, scalar_mul_win
    from halo2_aggregation_tpu_torch.plonk.fa_fused import fa_tape_eval
    from halo2_aggregation_tpu_torch.plonk.verifier import parse_proof, verify_proof
    from halo2_aggregation_tpu_torch.plonk.verifier_device import parse_batch, point_layout, verify_batch

    insts = [protos[i % 4][0] for i in range(B)]
    proofs = [protos[i % 4][1] for i in range(B)]

    torch.cuda.reset_peak_memory_stats(device)
    scalar_mul_win.launches = 0
    fa_tape_eval.launches = 0
    jac_segment_sum.launches = 0
    ok, efws = verify_batch(params, vk, insts, proofs, device=device, aggregate=True)
    torch.cuda.synchronize()
    launches = {"ec_win": scalar_mul_win.launches, "fa_tape": fa_tape_eval.launches,
                "jac_segment_sum": jac_segment_sum.launches}
    if ok is not True:
        raise AssertionError(f"aggregate check returned {ok!r}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    host_quads = []
    for i, (pub, proof) in enumerate(protos):
        ok_h, efw = verify_proof(params, vk, pub, proof)
        if not ok_h or tuple(efw) != tuple(efws[i]):
            raise AssertionError(f"quad of proof {i} != host verify_proof")
        host_quads.append(tuple(efw))

    # the host parse: parse_batch (one native decompression call for the
    # batch's points) against the loop of parse_proof it replaces
    comms = [[params.commit_lagrange(col) for col in pub] for pub, _ in protos]
    comms = [comms[i % 4] for i in range(B)]
    t0 = time.perf_counter()
    parsed = parse_batch(vk, comms, proofs)
    t1 = time.perf_counter()
    parsed_loop = [parse_proof(vk, c, p) for c, p in zip(comms, proofs)]
    parse_split = {"batch_s": t1 - t0, "loop_s": time.perf_counter() - t1}
    if parsed != parsed_loop:
        raise AssertionError("parse_batch != the loop of parse_proof")
    # parse_batch's share that finds the vk's point layout (one parse_proof
    # over no bytes), median of 20
    layout_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        point_layout(vk)
        layout_s.append(time.perf_counter() - t0)
    parse_split["layout_s"] = statistics.median(layout_s)

    # the same path with K8 in place of K1
    scalar_mul_ladder.launches = 0
    t0 = time.perf_counter()
    ok_l, efws_l = verify_batch(params, vk, insts, proofs, device=device, aggregate=True, method="ladder")
    torch.cuda.synchronize()
    ladder_wall = time.perf_counter() - t0
    launches["ec_ladder"] = scalar_mul_ladder.launches
    if ok_l is not True:
        raise AssertionError(f"aggregate check with method='ladder' returned {ok_l!r}")
    if launches["ec_ladder"] < 1:
        raise AssertionError("K8 was not launched by the ladder run of the main path")
    if [tuple(q) for q in efws_l[: len(protos)]] != host_quads or efws_l != efws:
        raise AssertionError("quads with method='ladder' != host verify_proof")

    # tampered inputs at a small batch: one flipped proof byte, one wrong
    # public input; each must fail the aggregate check or fail to parse
    rejected = {}
    bad = bytearray(proofs[0])
    bad[100] ^= 1
    cases = {
        "flipped_byte": (insts[:8], [bytes(bad)] + proofs[1:8]),
        "wrong_public_input": ([[[insts[0][0][0] + 1]]] + insts[1:8], proofs[:8]),
    }
    for name, (ins, prs) in cases.items():
        try:
            ok_bad, _ = verify_batch(params, vk, ins, prs, device=device)
            rejected[name] = "check_failed" if ok_bad is False else None
        except ValueError as e:
            rejected[name] = f"parse_raised: {e}"
        if rejected[name] is None:
            raise AssertionError(f"tampered batch ({name}) was accepted")
    torch.cuda.synchronize()

    runs = []
    for _ in range(5):
        t = {}
        t0 = time.perf_counter()
        ok_r, _ = verify_batch(params, vk, insts, proofs, device=device, timings=t)
        torch.cuda.synchronize()
        t["wall"] = time.perf_counter() - t0
        if ok_r is not True:
            raise AssertionError("aggregate check failed on a timed run")
        runs.append(t)
    wall = statistics.median(r["wall"] for r in runs)
    split = {k: statistics.median(r[k] for r in runs) for k in ("parse", "prep", "device", "pairing")}
    emit({
        "phase": "main", "batch": B, "k": K, "ok": ok, "launches": launches,
        "quads_match_host": len(protos), "parse_batch_equal_to_loop": True, "parse_split": parse_split,
        "ladder_ok": ok_l, "ladder_wall_s": ladder_wall,
        "rejected": rejected,
        "wall_s_median": wall, "wall_s_runs": [r["wall"] for r in runs],
        "proofs_per_s": B / wall, "stage_s_median": split,
        "peak_device_mib": torch.cuda.max_memory_allocated(device) / 2**20,
    })
    phase_profile(params, vk, insts, proofs, device)
    return launches, efws


def phase_bench(device, made) -> dict:
    """The port's benchmark program, `halo2_aggregation_tpu_torch/bench.py`,
    at its defaults (B = 128, 5 trials, MSM 2^17, NTT 2^16) on the four
    proofs `make_proofs` made: its line, then value > 0, every gate passed
    and every roofline fraction in (0, 1.05]."""
    from halo2_aggregation_tpu_torch import bench

    res = bench.run(device, protos=made)
    detail = res["detail"]
    emit({"phase": "bench", **res})
    fracs = {k: v for k, v in detail.items() if k.endswith("roofline_frac")}
    if not res["value"] > 0:
        raise AssertionError(f"bench: value {res['value']!r}")
    if detail["gates"] != dict.fromkeys(bench.GATES, True):
        raise AssertionError(f"bench: gates {detail['gates']}")
    if len(fracs) != 4 or not all(0 < f <= bench.MAX_FRAC for f in fracs.values()):
        raise AssertionError(f"bench: roofline fractions {fracs}")
    return res


def phase_benchmark(device) -> dict:
    """`benchmark/run.py`'s cell verify_b128_k9 once at seed 0, as the
    benchmark runs it (B = 128) at 5 trials: the line, then `correct` and
    each kernel of the verifier's path launched in the measured run (the
    runner sets the counts to 0 just before it and reads them just
    after).  Returns those counts."""
    from benchmark import run as cells

    line = cells.run_cell("verify_b128_k9", 0, device, trials=5)
    del line["program_line"]
    emit({"phase": "benchmark", **line})
    if line["correct"] is not True:
        raise AssertionError(f"benchmark: {line['checks']}")
    missing = [k for k in ("fa_tape", "ec_win", "jac_segment_sum") if line["launches"][k] < 1]
    if missing:
        raise AssertionError(f"benchmark: {missing} not launched by the cell's run: {line['launches']}")
    return line["launches"]


def phase_parallel(params, vk, protos, efws, device) -> None:
    """The verifier's scale-out and its reference formulation, on the main
    phase's proofs (B = 128, the four cycled) against the main phase's
    quads `efws` (held to the host verifier there).  Each path's launches
    are read with the counts set to 0 just before it."""
    import torch

    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops.ec_kernels import jac_segment_sum, scalar_mul_win
    from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
    from halo2_aggregation_tpu_torch.tools import dryrun_multichip as dm

    insts = [protos[i % 4][0] for i in range(B)]
    proofs = [protos[i % 4][1] for i in range(B)]
    parsed = dm.parse_all(params, vk, protos, B)
    seconds = {}

    # the sequential formulation: every fold step one K1 call
    batch = vd.batch_proofs(vk, parsed, device)
    scalar_mul_win.launches = 0
    t0 = time.perf_counter()
    out = vd.verify_algebra(vk, batch, B)
    torch.cuda.synchronize()
    seconds["verify_algebra"] = time.perf_counter() - t0
    va_launches = scalar_mul_win.launches
    if va_launches < 1 or vd.quads_to_ints(out) != efws:
        raise AssertionError(f"verify_algebra ({va_launches} K1 launches): quads != the fast path's")
    scalar_mul_win.launches = 0
    t0 = time.perf_counter()
    ok, got = vd.verify_batch(params, vk, insts, proofs, device=device, fast=False)
    torch.cuda.synchronize()
    seconds["verify_batch_sequential"] = time.perf_counter() - t0
    if ok is not True or got != efws or scalar_mul_win.launches != va_launches:
        raise AssertionError(f"verify_batch(fast=False) returned {ok!r}, {scalar_mul_win.launches} K1 launches")

    # one padded K1 launch: fast_prep(lane_pad=3)'s lanes, padding lanes
    # (identity points, zero scalars) in each component, give the sums of
    # the unpadded lanes (comparison launches, on no path)
    sums = {}
    for pad in (1, 3):
        pts, ss, ms, _, _ = vd.fast_prep(vk, parsed, device, lane_pad=pad)
        sums[pad] = (sum(ms), co.jac_to_ints(jac_segment_sum(scalar_mul_win(pts, ss), vd.segment_offsets(ms), 1)))
    if sums[3][0] <= sums[1][0] or sums[3][1] != sums[1][1]:
        raise AssertionError(f"padded K1 launch ({sums[3][0]} lanes) != unpadded ({sums[1][0]} lanes)")

    # the mesh formulations and the sharded MSM: the dry-run tool's card run
    groups = dm.run_card(params, vk, protos, efws, device)
    emit({
        "phase": "parallel", "batch": B, "tolerance": "exact: equal affine points and equal bits",
        "quads_equal_main": True, "check_aggregate": True, "sharded_msm_equal_msm": True,
        "h_eval_equal_field_algebra": True, "verify_algebra_equal_fast": True, "verify_batch_sequential_accepts": True,
        "verify_algebra_k1_launches": va_launches, "padded_lanes": [sums[1][0], sums[3][0]],
        "padded_k1_equal_unpadded": True, "seconds": seconds, "groups": groups,
        "note": "two ranks share one card: no speed-up is possible or claimed",
    })
    world = torch.cuda.device_count()
    if world >= 2:
        t0 = time.perf_counter()
        groups = dm.run_cards(params, vk, protos, efws, world)
        emit({"phase": "parallel_cards", "world": world, "batch": B, "cards": dm.cards(),
              "tolerance": "exact: equal affine points and equal bits", "quads_equal_main": True,
              "check_aggregate": True, "sharded_msm_equal_msm": True, "h_eval_equal_field_algebra": True,
              "placement": "rank r on card r only", "seconds": time.perf_counter() - t0, "groups": groups})


def device_events(prof) -> dict:
    """{kernel or copy name: (count, microseconds)} of a profile's device
    activity."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return by_name


def phase_profile(params, vk, insts, proofs, device):
    """One more main-path run under torch.profiler: the device's busy time
    (sum of kernel and copy durations on the one stream) against the wall,
    the events and the kernels by name; then the device step once more
    piece by piece, for the events each piece leaves.  Prints "not
    measured" if the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from halo2_aggregation_tpu_torch.ops.curve_ops import JacPoint
    from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
    from halo2_aggregation_tpu_torch.plonk.verifier import parse_proof

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ok, _ = vd.verify_batch(params, vk, insts, proofs, device=device, timings=t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError("aggregate check failed on the profiled run")
    by_name = device_events(prof)
    events = sum(n for n, _ in by_name.values())
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    most = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]

    # the pieces of verify_batch's device work, each under its own profile
    comms = {id(i): [params.commit_lagrange(col) for col in i] for i in insts}
    parsed = [parse_proof(vk, comms[id(i)], p) for i, p in zip(insts, proofs)]
    pieces, state = {}, {}

    def piece(name, fn):
        with profile(activities=acts) as pr:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        ev = device_events(pr)
        pieces[name] = {"events": sum(n for n, _ in ev.values()), "busy_ms": sum(us for _, us in ev.values()) / 1e3,
                        "host_ms_profiled": host_ms}

    def gather():
        descs = state["prep"][0]
        pts = [vd._desc_point_batch(vk, state["batch"], d, B) for comp in descs for d in comp]
        state["lane_pts"] = JacPoint(*(torch.stack([p[c] for p in pts], 1) for c in range(3)))
        state["ms"] = tuple(len(comp) for comp in descs)

    piece("batch_proofs", lambda: state.update(batch=vd.batch_proofs(vk, parsed, device)))
    piece("fast_prep_gathered", lambda: state.update(prep=vd.fast_prep_gathered(vk, parsed, device)))
    piece("lane_gather", gather)
    piece("fast_device", lambda: state.update(out=vd.fast_device(
        vk, state["batch"], B, state["ms"], state["lane_pts"], *state["prep"][1:])))
    piece("quads_to_ints", lambda: vd.quads_to_ints(state["out"]))

    if by_name and events >= 1000:
        raise AssertionError(f"the main path made {events} device events a batch, expected fewer than 1,000")
    emit({
        "phase": "profile", "wall_s": wall, "stage_s": t,
        "device_events": events or "not measured",
        "device_busy_ms": busy_us / 1e3 if by_name else "not measured",
        "device_busy_share": busy_us / 1e6 / wall if by_name else "not measured",
        # [kernel name cut to 120 characters, launches, ms]
        "top_device_ms": [[name[:120], n, us / 1e3] for name, (n, us) in top],
        "top_device_count": [[name[:120], n, us / 1e3] for name, (n, us) in most],
        "events_by_piece": pieces if by_name else "not measured",
    })


def equal_or_raise(name: str, got, want) -> int:
    """Largest limb difference of two int32 limb tensors; raises unless 0."""
    import torch

    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        bad = (got != want).any(-1).nonzero()[:8].tolist()
        raise AssertionError(f"{name}: kernel != plain, first differing elements {bad}")
    return err


def host_ms(fn):
    """(result, milliseconds) of one call on the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def random_columns(rng, c: int, n: int):
    """(c, n, 4) u64 canonical Montgomery values (top limb below r's)."""
    import numpy as np

    a = rng.integers(0, 1 << 63, size=(c, n, 4), dtype=np.uint64) * np.uint64(2)
    a[..., 3] &= np.uint64(0x1FFF_FFFF_FFFF_FFFF)
    return a


def ntt_launches() -> dict:
    from halo2_aggregation_tpu_torch.ops import ntt as nt
    from halo2_aggregation_tpu_torch.plonk.quotient_program import quotient_tape_eval

    return {
        "ntt": nt.ntt_batched.launches,
        "intt": nt.intt_batched.launches,
        "ew": nt.ew_mul_col.launches + nt.ew_mul_scalar.launches + nt.pow_series.launches,
        "quotient_tape": quotient_tape_eval.launches,
    }


def reset_ntt_launches() -> None:
    from halo2_aggregation_tpu_torch.ops import ntt as nt
    from halo2_aggregation_tpu_torch.plonk.quotient_program import quotient_tape_eval

    for fn in (nt.ntt_batched, nt.intt_batched, nt.ew_mul_col, nt.ew_mul_scalar, nt.pow_series,
               quotient_tape_eval):
        fn.launches = 0


def coset_shifts(cs, k: int) -> list:
    """The four coset shifts g * omega_ext^j of `create_proof_native`."""
    from halo2_aggregation_tpu_torch.fields import FR_GENERATOR, R, fr_omega

    ext_k = k + max(1, (cs.degree() - 2).bit_length())
    return [FR_GENERATOR * pow(fr_omega(ext_k), j, R) % R for j in range(1 << (ext_k - k))]


def check_product(device, rng) -> dict:
    """The device's `fe_mul` alone (csrc/ew.cu::h2a_mont_mul) against the
    plain PyTorch product on 2^20 random pairs and every pair of the edge
    values 0, 1, p - 1, R mod p and 2^253 - 1, for Fq and Fr."""
    import torch

    from halo2_aggregation_tpu_torch.fields import Q, R
    from halo2_aggregation_tpu_torch.ops import build
    from halo2_aggregation_tpu_torch.ops import field_ops as fo
    from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor, u64_to_port

    lib = build.load_library()
    n, step = 1 << 20, 1 << 18
    out = {}
    for field, (name, spec, p) in enumerate((("Fq", fo.FQ, Q), ("Fr", fo.FR, R))):
        edge = [0, 1, p - 1, (1 << 256) % p, (1 << 253) - 1]
        pairs = [(u, v) for u in edge for v in edge]
        a, b = (torch.from_numpy(u64_to_port(random_columns(rng, 1, n)[0]).copy()).to(device) for _ in range(2))
        a[: len(pairs)] = ints_to_tensor([u for u, _ in pairs], device)
        b[: len(pairs)] = ints_to_tensor([v for _, v in pairs], device)
        got = torch.empty_like(a)
        build.check(lib.h2a_mont_mul(field, a.data_ptr(), b.data_ptr(), got.data_ptr(), n, build.stream_ptr(device)),
                    "h2a_mont_mul")
        want = torch.cat([fo.mont_mul(a[i : i + step], b[i : i + step], spec) for i in range(0, n, step)])
        out[name] = equal_or_raise(f"fe_mul<{name}>", got, want)
    return {"pairs": n, "edge_pairs": len(pairs), "max_abs_err": out}


def check_series(device, shift: int) -> list:
    """K5's power series against its plain version at k = 1, 5, 9, 16 and
    21 in both orders (bit for bit), each call two launches: the tables,
    then the products."""
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    one, base = nt.mont_tensor(1, device), nt.mont_tensor(shift, device)
    for k in (1, 5, 9, 16, 21):
        for bitrev in (False, True):
            before = nt.pow_series.launches
            got = nt.pow_series(shift, k, device, bitrev=bitrev)
            if nt.pow_series.launches - before != 2:
                raise AssertionError(f"K5 pow_series at k = {k}: {nt.pow_series.launches - before} launches, expected 2")
            equal_or_raise(f"K5 pow_series, k = {k}, bitrev = {bitrev}", got,
                           nt.pow_series_plain(one, base, k, bitrev))
    return [1, 5, 9, 16, 21]


def check_transforms(device, rng, k: int, cols: int) -> dict:
    """K3 and K4 on `cols` random columns of size 2^k against their plain
    versions, each in `len(pass_plan(k))` launches."""
    import torch

    from halo2_aggregation_tpu_torch.ops import ntt as nt
    from halo2_aggregation_tpu_torch.ops.limbs import u64_to_port

    x = torch.from_numpy(u64_to_port(random_columns(rng, cols, 1 << k)).copy()).to(device)
    tables = nt.NttTables(k, device)
    passes = len(nt.pass_plan(k))
    before = (nt.ntt_batched.launches, nt.intt_batched.launches, nt.ew_mul_scalar.launches)
    fwd = nt.ntt_batched(x.clone(), tables.fwd)
    inv = nt.intt_batched(x.clone(), tables.inv, tables.n_inv)
    after = (nt.ntt_batched.launches, nt.intt_batched.launches, nt.ew_mul_scalar.launches)
    if [b - a for a, b in zip(before, after)] != [passes, passes, 0]:
        raise AssertionError(f"k = {k}: launches {before} -> {after} for a plan of {passes} passes")
    equal_or_raise(f"K3 ntt, k = {k}", fwd, nt.ntt_plain(x, tables.fwd))
    equal_or_raise(f"K4 intt, k = {k}", inv, nt.intt_plain(x, tables.inv, tables.n_inv))
    return {"k": k, "columns": cols, "passes": passes}


def phase_ntt(device, k: int = 21, cols: int = 4):
    """The device's product alone, K3 and K4 at small k, then K4, K5 and K3
    against their plain versions on `cols` random columns of size 2^k;
    returns the kernels' records (without launches)."""
    import numpy as np
    import torch

    from halo2_aggregation_tpu_torch.fields import FR_GENERATOR, R
    from halo2_aggregation_tpu_torch.ops import ntt as nt
    from halo2_aggregation_tpu_torch.ops.limbs import port_to_u64, u64_to_port
    from halo2_aggregation_tpu_torch.plonk import engine

    n = 1 << k
    rng = np.random.default_rng(SEED + k)
    host = random_columns(rng, cols, n)
    x = torch.from_numpy(u64_to_port(host).copy()).to(device)
    tables = nt.NttTables(k, device)
    shift = FR_GENERATOR * 0x1234_5678 % R
    s = nt.mont_tensor(shift, device)
    errs = {}
    product = check_product(device, rng)
    small = [check_transforms(device, rng, kk, 2) for kk in (1, 5, 9, 13, 16)]
    series_ks = check_series(device, shift)
    passes = len(nt.pass_plan(k))
    reset_ntt_launches()

    coeffs = nt.intt_batched(x.clone(), tables.inv, tables.n_inv)  # K4, its last pass times 1/n
    want, intt_plain_ms = host_ms(lambda: nt.intt_plain(x, tables.inv, tables.n_inv))
    errs["intt"] = equal_or_raise("K4 intt", coeffs, want)
    del want
    scale = nt.pow_series(shift, k, device, bitrev=True)
    errs["pow_series"] = equal_or_raise(
        "K5 pow_series", scale, nt.pow_series_plain(nt.mont_tensor(1, device), s, k, True))
    scaled = nt.ew_mul_col(coeffs, scale)
    want, ew_plain_ms = host_ms(lambda: nt.mul_plain(coeffs, scale))
    errs["ew_mul_col"] = equal_or_raise("K5 ew_mul_col", scaled, want)
    errs["ew_mul_scalar"] = equal_or_raise("K5 ew_mul_scalar", nt.ew_mul_scalar(x, s), nt.mul_plain(x, s))
    evals = nt.ntt_batched(scaled.clone(), tables.fwd)
    want, ntt_plain_ms = host_ms(lambda: nt.ntt_plain(scaled, tables.fwd))
    errs["ntt"] = equal_or_raise("K3 ntt", evals, want)
    del want
    if (nt.ntt_batched.launches, nt.intt_batched.launches) != (passes, passes):
        raise AssertionError(f"k = {k}: K3 and K4 launched {nt.ntt_batched.launches} and "
                             f"{nt.intt_batched.launches} kernels for a plan of {passes} passes")
    if not torch.equal(nt.intt_batched(nt.ntt_batched(coeffs.clone(), tables.fwd), tables.inv, tables.n_inv),
                       coeffs):
        raise AssertionError("intt(ntt(x)) != x")
    dom = engine.NativeDomain(k)
    host_coset = dom.coset_evals(dom.intt(host[0]), shift)
    if not np.array_equal(port_to_u64(evals[0]), host_coset):
        raise AssertionError("K4 -> K5 -> K3 coset evaluations != NativeDomain.coset_evals")

    work = x.clone()
    sq = nt.pow_series_squares(shift, k, device)
    series_tables = nt.pow_series_tables(sq, k, True)
    ms = {
        "ntt": cuda_ms(lambda: nt.ntt_batched(work, tables.fwd), reps=3),
        "intt": cuda_ms(lambda: nt.intt_batched(work, tables.inv, tables.n_inv), reps=3),
        "ew_mul_col": cuda_ms(lambda: nt.ew_mul_col(work, scale, out=work), reps=5),
        "ew_mul_scalar": cuda_ms(lambda: nt.ew_mul_scalar(work, s, out=work), reps=5),
        # the series' two launches on the uploaded squares, then each alone,
        # then the whole call (the host's squares and their upload included)
        "pow_series": cuda_ms(lambda: nt.pow_series_products(nt.pow_series_tables(sq, k, True), k), reps=20),
        "pow_series_tables": cuda_ms(lambda: nt.pow_series_tables(sq, k, True), reps=20),
        "pow_series_products": cuda_ms(lambda: nt.pow_series_products(series_tables, k), reps=20),
        "pow_series_call": cuda_ms(lambda: nt.pow_series(shift, k, device, bitrev=True), reps=20),
    }
    torch.cuda.synchronize()
    # the power series: the least work for n powers is one product an
    # element, and n elements written (the kernel spends one an element and
    # at most ceil(k / 2) an entry of its 2^ceil(k/2) + 2^floor(k/2) tables)
    series = bound(n, n * 32 + 64)
    emit({
        "phase": "ntt", "k": k, "columns": cols, "tolerance": "exact: equal bits",
        "max_abs_err": errs, "roundtrip": True, "host_coset_column_equal": True,
        "fe_mul_equal_to_plain": product, "small_k_equal_to_plain": small,
        "pass_plan": nt.pass_plan(k), "launches_a_transform": passes,
        "series_equal_to_plain": series_ks, "series_launches_a_call": 2,
        # the widest pass: shared memory a block, blocks an SM
        "occupancy": {"ntt": nt.pass_occupancy(False, k), "intt": nt.pass_occupancy(True, k)},
        "kernel_ms": ms, "plain_ms": {"ntt": ntt_plain_ms, "intt": intt_plain_ms, "ew_mul_col": ew_plain_ms},
        "pow_series_bound_ms": series["bound_ms"], "pow_series_bound_by": series["bound_by"],
    })
    src = "halo2_aggregation_tpu_torch/csrc/"
    # a transform: one twiddle product a butterfly, k stages of n / 2 (the
    # inverse also scales by 1/n); in place: the columns read and written
    # once, the table read once.  ew_mul_col: one product an element.
    col_bytes = cols * n * 32
    return {
        "ntt": {"name": "ntt", "route": "cuda", "source": src + "ntt.cu",
                "replaces": "halo2_aggregation_tpu/ops/ntt_pallas.py:117",
                "max_abs_err": errs["ntt"], "ms": ms["ntt"], "plain_ms": ntt_plain_ms,
                **bound(cols * k * (n // 2), 2 * col_bytes + (n // 2) * 32)},
        "intt": {"name": "intt", "route": "cuda", "source": src + "ntt.cu",
                 "replaces": "halo2_aggregation_tpu/ops/ntt_pallas.py:308",
                 "max_abs_err": errs["intt"], "ms": ms["intt"], "plain_ms": intt_plain_ms,
                 **bound(cols * (k * (n // 2) + n), 2 * col_bytes + (n // 2) * 32)},
        "ew": {"name": "ew", "route": "cuda", "source": src + "ew.cu",
               "replaces": "halo2_aggregation_tpu/ops/ntt_pallas.py:179",
               "max_abs_err": max(errs["ew_mul_col"], errs["ew_mul_scalar"], errs["pow_series"]),
               "ms": ms["ew_mul_col"], "plain_ms": ew_plain_ms,
               **bound(cols * n, 2 * col_bytes + n * 32),
               "pow_series_ms": ms["pow_series"], "pow_series_bound_ms": series["bound_ms"],
               "pow_series_bound_by": series["bound_by"], "pow_series_tables_ms": ms["pow_series_tables"],
               "pow_series_products_ms": ms["pow_series_products"], "pow_series_call_ms": ms["pow_series_call"]},
    }


def phase_quotient(device, k: int = 21):
    """The aggregation circuit's full quotient width at size 2^k through
    DeviceQuotient; K6 against its plain version.  Returns K6's record."""
    import numpy as np
    import torch

    from halo2_aggregation_tpu_torch.fields import R
    from halo2_aggregation_tpu_torch.models import aggregation_circuit as ac
    from halo2_aggregation_tpu_torch.ops import ntt as nt
    from halo2_aggregation_tpu_torch.ops.limbs import u64_to_port
    from halo2_aggregation_tpu_torch.plonk import quotient_program as qp
    from halo2_aggregation_tpu_torch.plonk.circuit import ConstraintSystem
    from halo2_aggregation_tpu_torch.plonk.quotient_device import DeviceQuotient

    cs = ConstraintSystem()
    ac.configure(cs)
    n = 1 << k
    rng = np.random.default_rng(SEED + 100 + k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_ntt_launches()
    dq = DeviceQuotient(cs, k, device)
    cols = {key: random_columns(rng, 1, n)[0] for key in dq.key_order}
    t0 = time.perf_counter()
    for key in dq.key_order:
        dq.feed_evals(key, cols[key])
    dq.finalize()
    torch.cuda.synchronize()
    finalize_s = time.perf_counter() - t0
    ch = dict(theta=int(rng.integers(1 << 62)), beta=int(rng.integers(1 << 62)),
              gamma=int(rng.integers(1 << 62)), y=int(rng.integers(1 << 62)))
    shifts = coset_shifts(cs, k)
    coset_s, outs = [], []
    for shift in shifts:
        t0 = time.perf_counter()
        outs.append(dq.run_coset(shift, **ch))
        coset_s.append(time.perf_counter() - t0)
    launches = ntt_launches()
    peak = torch.cuda.max_memory_allocated(device)
    C = len(dq.key_order)

    # K6 against its plain version on the last coset (dq.ext holds it)
    shift = shifts[-1]
    x = nt.ew_mul_scalar(dq.omega_pows, nt.mont_tensor(shift, device))
    vinv = pow((pow(shift, n, R) - 1) % R, -1, R)
    uniforms = torch.stack([nt.mont_tensor(v, device) for v in (*ch.values(), vinv)])
    got = torch.from_numpy(u64_to_port(outs[-1]).copy()).to(device)
    w = min(4096, n // 4)
    start = int(rng.integers(w, n - 2 * w))
    windows = {"first": (0, w), "last": (n - w, n), "random": (start, start + w)}
    for name, (a, b) in windows.items():
        rows = torch.arange(a, b, device=device)
        equal_or_raise(f"K6 rows {name} [{a}, {b})",
                       got[a:b], qp.quotient_tape_eval_plain(dq.program, dq.ext, x, uniforms, rows))
    want, plain_ms = host_ms(lambda: qp.quotient_tape_eval_plain(
        dq.program, dq.ext, x, uniforms, torch.arange(n, device=device), chunk=1 << 17))
    err = equal_or_raise("K6 all rows", got, want)
    del want
    ms = {
        "quotient_tape": cuda_ms(lambda: qp.quotient_tape_eval(dq.program, dq.ext, x, uniforms), reps=3),
        "ntt": cuda_ms(lambda: nt.ntt_batched(dq.ext, dq.tables.fwd), reps=2),
        "intt": cuda_ms(lambda: nt.intt_batched(dq.ext, dq.tables.inv, dq.tables.n_inv), reps=2),
        "ew_mul_col": cuda_ms(lambda: nt.ew_mul_col(dq.stack, x, out=dq.ext), reps=3),
    }
    torch.cuda.synchronize()
    emit({
        "phase": "quotient", "circuit": "aggregation (ac.configure)", "k": k,
        "columns": len(dq.key_order), "leaves": len(dq.schedule),
        "tape_instrs": int(dq.program.tape.instrs.shape[0]), "tape_temps": dq.program.tape.n_temps,
        "finalize_s": finalize_s, "coset_s": coset_s, "coset_s_median": statistics.median(coset_s),
        "k6_windows_equal": list(windows), "k6_all_rows_equal": True, "tolerance": "exact: equal bits",
        "kernel_ms": ms, "k6_plain_ms_all_rows": plain_ms,
        # K3 and K4 at this phase's width (all columns at once), as phase_ntt counts them
        "bound_ms": {
            "ntt": bound(C * k * (n // 2), 2 * C * n * 32 + (n // 2) * 32)["bound_ms"],
            "intt": bound(C * (k * (n // 2) + n), 2 * C * n * 32 + (n // 2) * 32)["bound_ms"],
            "ew_mul_col": bound(C * n, 2 * C * n * 32 + n * 32)["bound_ms"],
        },
        "peak_device_mib": peak / 2**20, "launches": launches,
    })
    return {"name": "quotient_tape", "route": "cuda",
            "source": "halo2_aggregation_tpu_torch/csrc/quotient_tape.cu",
            "replaces": "halo2_aggregation_tpu/plonk/quotient_device.py:803",
            "max_abs_err": err, "ms": ms["quotient_tape"], "plain_ms": plain_ms,
            # a row: the tape's products; the resident columns and x read
            # once, one output column written
            **bound(n * tape_products(dq.program.tape), (len(dq.key_order) + 2) * n * 32)}


MSM_KERNELS = {
    True: ("msm_s5", "halo2_aggregation_tpu/ops/ec_pallas.py:490"),
    False: ("msm_u4", "halo2_aggregation_tpu/ops/ec_pallas.py:408"),
}


def msm_bound(digits, signed: bool) -> dict:
    """The bound of K7 (`signed`) or K9 on these digits: one mixed (full)
    add for every nonzero digit; the points read once, the digits once."""
    nonzero = int(((digits & 31) != 0).sum())
    n_win, n = digits.shape
    return bound(nonzero * (P_ADD_MIXED if signed else P_ADD), n * 64 + n_win * n + 96)


def msm_launches() -> dict:
    from halo2_aggregation_tpu_torch.ops import msm_kernels as mk

    return {"msm_s5": mk.msm_bucket_s5.launches, "msm_u4": mk.msm_bucket_u4.launches}


def reset_msm_launches() -> None:
    from halo2_aggregation_tpu_torch.ops import msm_kernels as mk

    mk.msm_bucket_s5.launches = 0
    mk.msm_bucket_u4.launches = 0


def phase_msm(device, k: int = 21, k_edge: int = 14, k_prove: int = 16) -> dict:
    """K7 and K9 through `DeviceSRS.commit_lagrange` at n = 2^k against the
    native host MSM; at the prove's n = 2^k_prove against their plain
    versions and the native MSM (the kernels' records take these times);
    then at a ragged n near 2^k_edge against their plain versions on edge
    lanes.  Returns the two kernels' records (launches: the commitments of
    the 2^k run) and the DeviceSRS of the 2^k points, for the `outer`
    phase."""
    import numpy as np
    import torch

    from halo2_aggregation_tpu_torch.fields import R
    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops import field_ops as fo
    from halo2_aggregation_tpu_torch.ops import msm as m
    from halo2_aggregation_tpu_torch.ops import msm_kernels as mk
    from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor, u64_to_port
    from halo2_aggregation_tpu_torch.plonk import kzg
    from halo2_aggregation_tpu_torch.plonk.kzg import DeviceSRS
    from halo2_aggregation_tpu_torch.utils import native
    from halo2_aggregation_tpu_torch.utils.u64 import u64_to_points

    def affine(p):
        return co.jac_to_ints(co.JacPoint(*(c[None] for c in p)))[0]

    n = 1 << k
    rng = np.random.default_rng(SEED + 200 + k)
    t0 = time.perf_counter()
    params = kzg.setup(k)
    setup_s = time.perf_counter() - t0
    # the same SRS with its 2^k fixed-base products through K1 on the card;
    # a cache of its own, so that the host's file is not read back
    host_cache, kzg.CACHE_DIR = kzg.CACHE_DIR, os.path.join(ROOT, "build", "h2a-params-device")
    shutil.rmtree(kzg.CACHE_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        params_d = kzg.setup(k, device=device)
        setup_device_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(kzg.CACHE_DIR, ignore_errors=True)
        kzg.CACHE_DIR = host_cache
    if not (np.array_equal(params_d.g_lagrange_u64, params.g_lagrange_u64)
            and np.array_equal(params_d.g_lagrange_inf, params.g_lagrange_inf)):
        raise AssertionError(f"kzg.setup({k}, device) != the host SRS")
    del params_d
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    srs = DeviceSRS(params, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    col = random_columns(rng, 1, n)[0]  # plain values below 2^253 < r
    zero = np.zeros((n, 4), np.uint64)
    row = int(rng.integers(n))
    one_hot = zero.copy()
    one_hot[row, 0] = 1
    srs_row = u64_to_points(params.g_lagrange_u64[row : row + 1], params.g_lagrange_inf[row : row + 1])[0]
    t0 = time.perf_counter()
    want = native.g1_msm_u64(params.g_lagrange_u64, params.g_lagrange_inf, col)
    native_s = time.perf_counter() - t0
    cases = {"random": (col, want), "zero": (zero, None), "one_hot": (one_hot, srs_row)}
    reset_msm_launches()
    for signed in (True, False):
        for case, (values, expect) in cases.items():
            got = srs.commit_lagrange(values, signed=signed)
            if got != expect:
                raise AssertionError(f"{MSM_KERNELS[signed][0]} at 2^{k}, {case} column: {got} != {expect}")
    torch.cuda.synchronize()
    launches = msm_launches()
    if min(launches.values()) < len(cases):
        raise AssertionError(f"DeviceSRS did not launch K7 and K9 once per commitment: {launches}")
    if native.g1_msm_u64(params.g_lagrange_u64, params.g_lagrange_inf, zero) is not None:
        raise AssertionError("native MSM of the zero column is not the identity")

    # kernel times at 2^k: the launchers alone on resident digits, then the
    # whole commitment (H2D of the column, recoding, kernels, D2H)
    s_dev = torch.from_numpy(u64_to_port(col)).to(device)
    P = srs.points
    kernel_ms, recode_ms, commit_s, bound_k = {}, {}, {}, {}
    for signed in (True, False):
        name = MSM_KERNELS[signed][0]
        recode = m.signed_windows if signed else m.unsigned_windows
        digits = recode(s_dev)
        launch = mk.msm_bucket_s5 if signed else mk.msm_bucket_u4
        chunks = m.choose_chunks(n, signed, *mk.occupancy(signed))
        kernel_ms[name] = cuda_ms(lambda: launch(P.x, P.y, digits, chunks), reps=3)
        bound_k[name] = msm_bound(digits, signed)
        recode_ms[name] = cuda_ms(lambda: recode(s_dev), reps=3)
        _, commit_ms = host_ms(lambda: srs.commit_lagrange(col, signed=signed))
        commit_s[name] = commit_ms / 1e3
        del digits
    peak = torch.cuda.max_memory_allocated(device)
    del s_dev

    # the prove's size: the SRS's first 2^k_prove points, a random column;
    # kernel, plain version and native MSM at the kernel's chunking
    npr = 1 << k_prove
    col_p = random_columns(rng, 1, npr)[0]
    s_p = torch.from_numpy(u64_to_port(col_p)).to(device)
    xp, yp = P.x[:npr], P.y[:npr]
    native_p = native.g1_msm_u64(params.g_lagrange_u64[:npr], params.g_lagrange_inf[:npr], col_p)
    prove_ms, prove_plain_ms, prove_bound = {}, {}, {}
    for signed in (True, False):
        name = MSM_KERNELS[signed][0]
        digits = (m.signed_windows if signed else m.unsigned_windows)(torch.where(P.inf[:npr, None], 0, s_p))
        launch = mk.msm_bucket_s5 if signed else mk.msm_bucket_u4
        C = m.choose_chunks(npr, signed, *mk.occupancy(signed))
        got = affine(launch(xp, yp, digits, C))
        ref, prove_plain_ms[name] = host_ms(lambda: m.msm_bucket_plain(xp, yp, digits, signed, C))
        if got != affine(ref) or got != native_p:
            raise AssertionError(f"{name} at n = 2^{k_prove}: kernel {got}, plain {affine(ref)}, native {native_p}")
        prove_ms[name] = cuda_ms(lambda: launch(xp, yp, digits, C), reps=5)
        prove_bound[name] = msm_bound(digits, signed)

    # edge lanes at a ragged n near 2^k_edge on the SRS's first points
    ne = (1 << k_edge) - 3
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(ne)]
    for i, v in enumerate([0, 1, R - 1, ((1 << 254) - 1) % R]):
        ks[i] = v
    x, y = P.x[:ne].clone(), P.y[:ne].clone()
    inf = P.inf[:ne].clone()
    inf[4] = inf[ne - 1] = True  # infinity flags (their scalars are zeroed)
    ks[5] = 0
    records = {}
    for signed in (True, False):
        name, replaces = MSM_KERNELS[signed]
        C = m.choose_chunks(ne, signed, *mk.occupancy(signed))
        # adjacent rows of one chunk, one scalar: P, -P (sorted by digit they
        # meet back to back: the identity branch), P, P (the doubling branch)
        r = 6
        if (r + 3) // mk.chunk_len(ne, C) != r // mk.chunk_len(ne, C):
            raise AssertionError("the edge rows do not share a chunk")
        xe, ye, ke = x.clone(), y.clone(), list(ks)
        for j, neg in ((1, True), (2, False), (3, False)):
            xe[r + j] = xe[r]
            ye[r + j] = fo.neg(ye[r], fo.FQ) if neg else ye[r]
            ke[r + j] = ke[r]
        A = co.AffinePoint(xe, ye, inf)
        s = ints_to_tensor(ke, device)
        got = affine(m.msm(A, s, signed=signed))
        digits = (m.signed_windows if signed else m.unsigned_windows)(torch.where(inf[:, None], 0, s))
        ref, plain_ms = host_ms(lambda: m.msm_bucket_plain(xe, ye, digits, signed, C))
        want = affine(ref)
        host_pts = co.jac_to_ints(co.affine_to_jac(A))
        native_want = native.g1_msm(host_pts, [0 if p is None else kk for p, kk in zip(host_pts, ke)])
        if got != want or got != native_want:
            raise AssertionError(f"{name} at n = {ne}: kernel {got}, plain {want}, native {native_want}")
        launch = mk.msm_bucket_s5 if signed else mk.msm_bucket_u4
        records[name] = {
            "name": name, "route": "cuda", "source": "halo2_aggregation_tpu_torch/csrc/msm.cu",
            "replaces": replaces, "max_abs_err": max_abs_err([got], [want]),
            "ms": prove_ms[name], "plain_ms": prove_plain_ms[name], "n": npr, **prove_bound[name],
            "ms_at_2^%d" % k: kernel_ms[name], "bound_ms_at_2^%d" % k: bound_k[name]["bound_ms"],
            "edge_n": ne,
            "launches": launches[name],
            "edge_ms": cuda_ms(lambda: launch(xe, ye, digits, C), reps=5), "edge_plain_ms": plain_ms,
            "edge_bound_ms": msm_bound(digits, signed)["bound_ms"],
        }
    emit({
        "phase": "msm", "k": k, "n": n, "tolerance": "exact: equal affine points",
        "equal_to_native": list(cases), "setup_s": setup_s, "setup_device_s": setup_device_s,
        "setup_device_equal_to_host": True, "srs_upload_to_mont_s": upload_s,
        "native_host_msm_s": native_s, "kernel_ms": kernel_ms, "recode_ms": recode_ms,
        "commit_s": commit_s,
        # the chosen C, the blocks an SM holds and the waves the grid fills
        "grid": {MSM_KERNELS[sg][0]: m.grid_shape(n, sg, *mk.occupancy(sg)) for sg in (True, False)},
        "prove_n_grid": {MSM_KERNELS[sg][0]: m.grid_shape(npr, sg, *mk.occupancy(sg)) for sg in (True, False)},
        "bound_ms": {nm: b["bound_ms"] for nm, b in bound_k.items()},
        "peak_device_mib": peak / 2**20, "launches": launches,
        "prove_n": npr, "prove_n_equal_plain_and_native": True,
        "prove_n_kernel_ms": prove_ms, "prove_n_plain_ms": prove_plain_ms,
        "edge_n": ne, "edge_equal_plain_and_native": True,
        "edge_kernel_ms": {nm: r["edge_ms"] for nm, r in records.items()},
        "edge_plain_ms": {nm: r["edge_plain_ms"] for nm, r in records.items()},
        "edge_bound_ms": {nm: r["edge_bound_ms"] for nm, r in records.items()},
    })
    return records, srs


def prove_commitments(cs) -> int:
    """The commitments a proof writes: instance, advice, two per lookup
    (permuted input and table), the permutation products, the lookup
    products, the random r, the h pieces and one multiopen witness per
    rotation set."""
    from halo2_aggregation_tpu_torch.plonk.protocol import query_schedule, rotation_sets
    from halo2_aggregation_tpu_torch.plonk.verifier import num_perm_chunks

    chunks = num_perm_chunks(cs)
    lookups = len(cs.lookups)
    return (cs.num_instance_columns + cs.num_advice_columns + 3 * lookups + chunks + 1
            + cs.quotient_poly_degree() + len(rotation_sets(query_schedule(cs, chunks, lookups))))


def phase_prove(device, k: int = 16) -> dict:
    """The prover's path: keygen_device and create_proof_device on the card,
    sharing one DeviceSRS, against the port's host keygen_native and
    create_proof_native.  Returns the K3-K7 launch counts of the device
    prove."""
    import torch

    from halo2_aggregation_tpu_torch.models import simple_example as se
    from halo2_aggregation_tpu_torch.plonk import kzg
    from halo2_aggregation_tpu_torch.plonk.keygen import keygen_native
    from halo2_aggregation_tpu_torch.plonk.keygen_device import keygen_device
    from halo2_aggregation_tpu_torch.plonk.kzg import DeviceSRS
    from halo2_aggregation_tpu_torch.plonk.prover_device import create_proof_device
    from halo2_aggregation_tpu_torch.plonk.prover_native import create_proof_native
    from halo2_aggregation_tpu_torch.plonk.verifier import verify_proof

    t0 = time.perf_counter()
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vk, pk = keygen_native(params, cs_e, asg_e)
    keygen_host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srs = DeviceSRS(params, device)
    torch.cuda.synchronize()
    srs_s = time.perf_counter() - t0
    reset_msm_launches()
    t0 = time.perf_counter()
    vk_d, pk_d = keygen_device(params, cs_e, asg_e, device=device, srs=srs)
    torch.cuda.synchronize()
    keygen_device_s = time.perf_counter() - t0
    keygen_launches = msm_launches()
    keygen_commits = len(vk_d.fixed_commitments) + len(vk_d.sigma_commitments)
    if keygen_launches != {"msm_s5": keygen_commits, "msm_u4": 0}:
        raise AssertionError(f"keygen_device: {keygen_launches} launches for {keygen_commits} commitments")
    if (vk_d.fixed_commitments, vk_d.sigma_commitments) != (vk.fixed_commitments, vk.sigma_commitments):
        raise AssertionError("keygen_device's vk commitments != keygen_native's")
    if vk_d.hash_scalar() != vk.hash_scalar():
        raise AssertionError("keygen_device's vk hash != keygen_native's")
    pub = [circuit.public_output()]

    def prove(fn, key, **kw):
        stages = []
        last = [time.perf_counter()]

        def log(msg):
            now = time.perf_counter()
            stages.append([msg, now - last[0]])
            last[0] = now

        _, _, asg = se.build(circuit, k=k)
        t0 = time.perf_counter()
        proof = fn(params, key, asg, [pub], seed=42, progress=log, **kw)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0, stages

    ref, host_s, host_stages = prove(create_proof_native, pk)
    torch.cuda.synchronize()
    reset_ntt_launches()
    reset_msm_launches()
    got, dev_s, dev_stages = prove(create_proof_device, pk_d, device=device, srs=srs)
    launches = {**ntt_launches(), "msm_s5": msm_launches()["msm_s5"]}
    commits = prove_commitments(cs_e)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the prover's path was not launched: {launches}")
    if launches["msm_s5"] != commits or msm_launches()["msm_u4"] != 0:
        raise AssertionError(f"K7 launched {launches['msm_s5']} times for {commits} commitments")
    if got != ref:
        raise AssertionError("create_proof_device bytes != create_proof_native")
    ok, _ = verify_proof(params, vk, [pub], got)
    if not ok:
        raise AssertionError("verify_proof rejected the device proof")
    emit({
        "phase": "prove", "circuit": "simple example", "k": k, "proof_bytes": len(got),
        "vk_equal_to_keygen_native": True, "keygen_commitments": keygen_commits,
        "equal_to_create_proof_native": True, "verified": True, "prove_commitments": commits,
        "setup_s": setup_s, "keygen_host_s": keygen_host_s, "srs_upload_s": srs_s,
        "keygen_device_s": keygen_device_s, "device_prove_s": dev_s, "host_prove_s": host_s,
        "launches": launches,
        # [progress message, seconds since the previous one]
        "device_stages": dev_stages, "host_stages": host_stages,
    })
    return launches


def phase_outer(device, srs=None) -> dict:
    """The aggregation product: `tools/outer_prove.py::run_outer` at N = 1,
    k = 21 on the card (one inner proof, the outer circuit, keygen_device,
    create_proof_device, the host verify_proof), held to
    `docs/artifacts/outer_n1_k21.*`; then the outer proof through
    `verify_batch(aggregate=True)` at B = 1 and 2, and with a byte flipped.
    `srs` is the `msm` phase's DeviceSRS of the same SRS.  Returns the
    launches of each kernel in this phase."""
    import hashlib

    import torch

    from halo2_aggregation_tpu_torch.config import H2AConfig
    from halo2_aggregation_tpu_torch.ops.ec_kernels import jac_segment_sum, scalar_mul_win
    from halo2_aggregation_tpu_torch.plonk.fa_fused import fa_tape, fa_tape_eval, shared_bytes
    from halo2_aggregation_tpu_torch.plonk.verifier_device import verify_batch
    from halo2_aggregation_tpu_torch.tools.outer_prove import run_outer
    from halo2_aggregation_tpu_torch.utils.artifacts import load_vk

    stem = os.path.join(ROOT, "docs", "artifacts", "outer_n1_k21")
    with open(stem + ".meta.json") as f:
        meta = json.load(f)
    with open(stem + ".proof", "rb") as f:
        want_proof = f.read()
    want_vk = load_vk(stem)
    cfg = H2AConfig(k_inner=9, k_outer=meta["k"], num_proofs=1, constrained_fs=meta["constrained_fs"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_ntt_launches()
    reset_msm_launches()
    t0 = time.perf_counter()
    res = run_outer(cfg, device=device, srs=srs)
    wall = time.perf_counter() - t0
    launches = {**ntt_launches(), **msm_launches()}
    vk, proof, pis = res["vk"], res["proof"], res["public_inputs"]
    checks = {
        "pis_equal_to_meta": pis == [int(v) for v in meta["public_inputs"]],
        "quad_equal_to_host": res["in_circuit_quads"] == res["inner_quads"],
        "vk_equal_to_artifact": (vk.hash_scalar() == want_vk.hash_scalar()
                                 and vk.fixed_commitments == want_vk.fixed_commitments
                                 and vk.sigma_commitments == want_vk.sigma_commitments),
        "proof_equal_to_artifact": proof == want_proof,
        "inst_comm_equal_to_meta": res["inst_comm"] == tuple(int(c) for c in meta["inst_comm"]),
        "verified": res["verified"],
        "efw_equal_to_meta": res["efw"] == tuple(tuple(int(c) for c in p) for p in meta["efw"]),
    }

    # the outer proof through the verifier's main path on the card
    params = res["params"]
    for fn in (scalar_mul_win, fa_tape_eval, jac_segment_sum):
        fn.launches = 0
    batch = {}
    for b in (1, 2):
        t = {}
        t1 = time.perf_counter()
        ok, quads = verify_batch(params, vk, [[pis]] * b, [proof] * b, device=device, aggregate=True, timings=t)
        torch.cuda.synchronize()
        t["wall"] = time.perf_counter() - t1
        batch[f"B={b}"] = t
        checks[f"verify_batch_b{b}_accepts"] = ok is True and [tuple(map(tuple, q)) for q in quads] == [res["efw"]] * b
    bad = bytearray(proof)
    bad[len(proof) - 64 * 5] ^= 1  # an evaluation: the transcript still parses
    try:
        ok_bad, _ = verify_batch(params, vk, [[pis]], [bytes(bad)], device=device, aggregate=True)
        rejected = "check_failed" if ok_bad is False else None
    except ValueError as e:
        rejected = f"parse_raised: {e}"
    checks["flipped_byte_rejected"] = rejected is not None
    torch.cuda.synchronize()
    launches.update(ec_win=scalar_mul_win.launches, fa_tape=fa_tape_eval.launches,
                    jac_segment_sum=jac_segment_sum.launches)
    tape = fa_tape(vk, e_scalar=True)  # K2's program for the outer vk
    emit({
        "phase": "outer", "circuit": "aggregation, one inner proof (SingleProofCircuit)", "k": cfg.k_outer,
        "rows": res["rows"], **checks,
        "proof_bytes": len(proof), "proof_sha256": hashlib.sha256(proof).hexdigest(),
        "artifact_sha256": hashlib.sha256(want_proof).hexdigest(), "flipped_byte": rejected,
        "k2_tape": {"instrs": int(tape.instrs.shape[0]), "temps": tape.n_temps, "shared_bytes": shared_bytes(tape)},
        "wall_s": wall, "seconds": res["seconds"], "verify_batch_s": batch,
        "peak_device_mib": torch.cuda.max_memory_allocated(device) / 2**20, "launches": launches,
    })
    failed = [name for name, ok in checks.items() if ok is not True]
    if failed:
        raise AssertionError(f"outer: {failed} false")
    for name in ("ntt", "intt", "ew", "quotient_tape", "msm_s5", "ec_win", "fa_tape", "jac_segment_sum"):
        if launches[name] < 1:
            raise AssertionError(f"outer: {name} was not launched: {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    # the port must be beside this script: without it, fail before any output
    import halo2_aggregation_tpu_torch  # noqa: F401

    device = torch.device("cuda", 0)
    seconds = {}
    last = [time.perf_counter()]

    def done(phase):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[phase] = now - last[0]
        last[0] = now

    card = phase_card()
    phase_build()
    done("card+build")
    latency = latency_probe(device)
    k1, k8, k1_out = phase_k1(device)
    done("k1+k8")
    js = phase_jac_sum(device, k1_out)
    del k1_out
    done("jac_sum")
    params, vk, protos, made = make_proofs()
    k2 = phase_k2(params, vk, protos, device)
    done("k2")
    launches, efws = phase_main(params, vk, protos, device)
    done("main+profile")
    phase_bench(device, made)
    done("bench")
    benchmark_launches = phase_benchmark(device)
    done("benchmark")
    phase_parallel(params, vk, protos, efws, device)
    done("parallel")
    k1["launches"] = launches["ec_win"]
    k2["launches"] = launches["fa_tape"]
    k8["launches"] = launches["ec_ladder"]
    js["launches"] = launches["jac_segment_sum"]
    # the lane-serial kernels' chain time: one thread's dependent products
    # times the measured latency of one; a launch too small to fill the
    # card can approach this, not bound_ms
    for rec in (k1, k2, k8, js):
        rec["chain_ms"] = rec["chain_products"] * latency[rec["chain_field"] + "_ns"] * 1e-6
    recs = phase_ntt(device)
    done("ntt")
    recs["quotient_tape"] = phase_quotient(device)
    done("quotient")
    msm_recs, srs = phase_msm(device)
    done("msm")
    prove_launches = phase_prove(device)
    done("prove")
    outer_launches = phase_outer(device, srs)
    del srs
    done("outer")
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    for name, rec in recs.items():
        rec["launches"] = prove_launches[name]
    # K7 is on the prover's path; K9 on DeviceSRS(signed=False) in `msm`
    msm_recs["msm_s5"]["launches"] = prove_launches["msm_s5"]
    # each kernel's launches in the `outer` phase: one k = 21 outer keygen,
    # prove and instance commitment, then verify_batch at B = 1, 2 and 1
    for rec in (k1, k2, *recs.values(), msm_recs["msm_s5"], k8, msm_recs["msm_u4"], js):
        rec["launches_outer"] = outer_launches.get(rec["name"], 0)
        rec["launches_benchmark"] = benchmark_launches[rec["name"]]
    emit(card)  # once more, beside the numbers: the build's report is long
    emit({"kernels": [k1, k2, *recs.values(), msm_recs["msm_s5"], k8, msm_recs["msm_u4"], js]})
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "jaxlib", "halo2_aggregation_tpu"))
    if loaded:
        raise AssertionError(f"modules of JAX or the JAX package were loaded: {loaded[:5]}")
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
