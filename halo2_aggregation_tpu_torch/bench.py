"""The port's benchmark: B simple-example proofs folded into one accumulator
on one card, through the port's entry points.

    python -m halo2_aggregation_tpu_torch.bench [--device cuda|cpu]

The counterpart of the root `bench.py`.  It prints as its last line one JSON
object,

  {"metric": "proofs_aggregated_per_s", "value": N, "unit": "proofs/s",
   "vs_baseline": M, "detail": {...}}

where the metric is the end-to-end aggregation pipeline at batch B (k = 9):
per-proof transcript replay on the host (`parse_batch`: every proof point
of the batch decompressed in one native call, then `parse_proof` on each,
with each distinct proof's instance commitment made once, outside every
timed window), the
batch's host prep (`batch_proofs`, `fast_prep_gathered`), the device step
(`fast_device_gathered`: kernel K2, then K1 over every multiopen lane and
the e-lane, then the segmented sum), the quads' D2H (`quads_to_ints`), and
one folded pairing for the whole batch (`check_aggregate`).  `value` is B
over the median wall of `H2A_BENCH_TRIALS` calls after one warm-up; the
card is synchronised at every stage boundary, so no device work is counted
in a later stage.  `vs_baseline` is `value` over the port's single-threaded
host verifier (`verify_proof`, less one native pairing), as in `bench.py`.

Before anything is timed, each section holds its result to a reference,
and raises naming the gate if one differs:
* quads: every proof's (e, f, w, zw) equals the host `verify_proof`'s
  (and `run_verifier`'s `reference_quads`, when given);
* k1, k8: K1 and K8 (254 bits) on the first 8 multiopen lanes equal
  `oracle.curve.g1_mul` as affine points;
* msm: `ops/msm.py::msm` (K7, its signed recoding included) equals the
  native host Pippenger;
* ntt: one transform of the 8 columns equals `ntt_plain` on the same device
  and the native host engine's NTT;
* mul_chain: the chained products equal a (b / 2^256)^128 on host ints on
  a sample of lanes.

The sections and their sizes (`run`'s arguments; None takes the default,
through the environment where `bench.py` read one); `run_verifier` runs
the first three and the host baseline alone, K1 without K8: the
verifier's path, which the benchmark's cell `verify_b128_k9` measures:
* end to end: B = `batch` (`H2AConfig.batch`, `H2A_BENCH_BATCH`, 128),
  `trials` (`H2A_BENCH_TRIALS`, 5) after one gated warm-up; `stages` is each
  stage's median over the trials; `H2A_PROFILE=<dir>` runs one more call,
  untimed, under `torch.profiler` and writes a Chrome trace there;
* the device algebra alone: `fast_device_gathered` and the quads' D2H;
* scalar-mul: K1 (`scalar_mul_win`, what the main path runs) and K8
  (`scalar_mul_ladder`, 254 bits) on `fast_prep`'s B x M multiopen lanes,
  timed by CUDA events;
* MSM: 2^`msm_log2` (`H2A_BENCH_MSM_LOG2`, 17) points, multiples of G by
  62-bit ints, and 248-bit scalars, from `default_rng(5)` as `bench.py`
  draws them; the median wall of 2 calls;
* NTT: K3 on an (8, 2^`ntt_log2`, 8) stack (`H2A_BENCH_NTT_LOG2`, 16) of
  16-bit words, four transforms chained;
* host baseline: the host `verify_proof` of each distinct proof of the
  batch (the quads gate's reference), the mean call less one native
  pairing;
* field-mul: 128 dependent Fr products on each of 2^`mul_log2` (16) lanes
  (`csrc/ew.cu::h2a_mul_chain` through `ops/ntt.py::mul_chain`).
The counts of the later sections' calls are `bench.py`'s (3, 3, 2, 3), at
most `trials`, each after its gated first call.  On the CPU, where a first
call costs what any other does, a kernel section's time is its gated call's.

Rates are set against the H100 bound model of `tools/measure.py` (61.6 G
Montgomery products/s), the one `chip_smoke.py` uses: products of a K1
scalar-mul counted from this run's lanes (`k1_products`), 11 a mixed add of
K7, one a butterfly of K3.  A fraction above 1.05 raises: it would be a
miscount, not a fast card.

`detail`'s keys against `bench.py`'s: `pallas_scalar_muls_per_s` is
`ladder_scalar_muls_per_s` (K8, the kernel `bench.py` timed), and the new
`scalar_muls_per_s` is K1's; `pallas_kernel_mont_mul_per_s` and
`pallas_kernel_roofline_frac` are `kernel_mont_mul_per_s` and
`kernel_roofline_frac` (K1's products); `msm_mpoint_adds_per_s_per_chip` is
`msm_mpoint_adds_per_s`; `pallas_kernel_tile`,
`pallas_scalar_muls_per_s_by_tile` (a TPU tile knob) and
`ntt_executed_roofline_frac` (the port's butterfly does one product, so it
would equal `ntt_kernel_roofline_frac`) are gone; `gates` is new.  Every
other key keeps its name and meaning; `device` is the card's `nvidia-smi`
name and power limit, or "cpu".

`run(device="cpu", ...)` runs the same program on CPU tensors through the
kernels' plain versions (the tests do, at small sizes); its times are the
CPU's.  The default device is the card, which it requires.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from .config import H2AConfig
from .device import resolve_device
from .fields import G1_GEN, R
from .models import simple_example as se
from .ops import build
from .ops import curve_ops as co
from .ops import field_ops as fo
from .ops import ntt as nt
from .ops.curve_ops import AffinePoint, JacPoint
from .ops.ec_kernels import scalar_mul_ladder, scalar_mul_win
from .ops.limbs import ints_to_tensor, tensor_to_ints, u64_to_port
from .ops.msm import msm
from .oracle import curve as oc
from .oracle.pairing import multi_pairing_check_fast
from .plonk import kzg
from .plonk.engine import NativeDomain
from .plonk.keygen import keygen
from .plonk.prover import create_proof
from .plonk.verifier import verify_proof
from .plonk.verifier_device import (
    QUAD_NAMES,
    batch_proofs,
    check_aggregate,
    fast_device_gathered,
    fast_prep,
    fast_prep_gathered,
    parse_batch,
    quads_to_ints,
)
from .tools.measure import P_ADD_MIXED, PRODUCTS_PER_S, cuda_ms, k1_products
from .utils import native
from .utils.u64 import ints_to_u64

#: the four inner witnesses (a, b) of `bench.py:95`; proof i has seed 40 + a
PAIRS = ((2, 3), (4, 5), (1, 255), (6, 6))
GATE_LANES = 8  # multiopen lanes held to the oracle (`bench.py:175`)
MSM_WINDOWS = 52  # K7's signed 5-bit windows: one add a point a window
NTT_COLS, NTT_CHAIN = 8, 4
MUL_ITERS = 128
MAX_FRAC = 1.05
GATES = ("quads", "k1", "k8", "msm", "ntt", "mul_chain")


class GateError(AssertionError):
    """A section's result differs from its reference."""

    def __init__(self, gate: str, what: str):
        super().__init__(f"gate {gate!r}: {what}")
        self.gate = gate


def make_protos(k: int, pairs=PAIRS, prove_seed: int = 40):
    """The SRS, the vk and the four proofs of `bench.py:90-101`: keygen on
    `MyCircuit(7, 2, 3)` without witnesses, then one proof a witness pair
    (a, b) of `pairs`, proved with seed `prove_seed + a` (the defaults are
    `bench.py`'s).  Returns (params, vk, protos), each proto (instances,
    proof bytes, instance commitments): the instance commitments are made
    here, once a distinct proof."""
    params = kzg.setup(k)
    cs_e, _, asg_e = se.build(se.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in pairs:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=k)
        pub = [c.public_output()]
        proof = create_proof(params, pk, asg, [pub], seed=prove_seed + a)
        protos.append(([pub], proof, [params.commit_lagrange(pub)]))
    return params, vk, protos


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_call(fn, device: torch.device):
    """(output, milliseconds) of one call of `fn`, ended by a synchronise:
    the call whose output a gate holds to its reference."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def timed_ms(fn, reps: int, device: torch.device, first_ms: float) -> float:
    """Milliseconds a call of `fn` after its gated `first_call`: on the card
    the mean of `reps` calls by CUDA events; on the CPU, where a first call
    costs what any other does, that call's `first_ms`."""
    return cuda_ms(fn, reps) if device.type == "cuda" else first_ms


def host_seconds(fn, trials: int, device: torch.device) -> list:
    """Wall seconds of each of `trials` calls of `fn`, each ended by a
    synchronise."""
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append(time.perf_counter() - t0)
    return out


def fraction(name: str, rate: float, counted: str) -> float:
    """`rate` (products/s) over the card's 61.6 G products/s; above 1.05
    raises, naming the count that gave it."""
    frac = rate / PRODUCTS_PER_S
    if frac > MAX_FRAC:
        raise ValueError(f"{name} = {frac:.4f} > {MAX_FRAC}: {rate:.4g} products/s from {counted}; "
                         "a miscount, not a fast card")
    return frac


def parse_cycled(vk, protos, B: int) -> list:
    """`parse_proof` of B proofs, the protos cycled, with their
    precomputed instance commitments: through `verifier_device.parse_batch`,
    every point of the B proofs decompressed in one call."""
    picks = [protos[i % len(protos)] for i in range(B)]
    return parse_batch(vk, [p[2] for p in picks], [p[1] for p in picks])


def aggregate_once(params, vk, protos, B: int, device, stages: dict | None = None) -> list:
    """B proofs from bytes to one accepted pairing, as `bench.py:105-135`
    composes it; the card synchronised at each stage boundary.  Returns the
    quads; `stages`, if given, receives the split in seconds."""
    t0 = time.perf_counter()
    parsed = parse_cycled(vk, protos, B)
    t1 = time.perf_counter()
    batch = batch_proofs(vk, parsed, device)
    prep = fast_prep_gathered(vk, parsed, device)
    _sync(device)
    t2 = time.perf_counter()
    quads = quads_to_ints(fast_device_gathered(vk, batch, B, *prep, method="win"))
    _sync(device)
    t3 = time.perf_counter()
    ok = check_aggregate(quads, params)
    t4 = time.perf_counter()
    if ok is not True:
        raise AssertionError(f"check_aggregate returned {ok!r}")
    if stages is not None:
        stages.update(parse_s=t1 - t0, prep_s=t2 - t1, device_and_d2h_s=t3 - t2, pairing_s=t4 - t3)
    return quads


def host_verify(params, vk, protos, n: int) -> tuple:
    """The host `verify_proof` of the first n protos: their quads (the
    quads gate's reference) and the mean seconds a call."""
    quads = []
    t0 = time.perf_counter()
    for insts, proof, _ in protos[:n]:
        ok, efw = verify_proof(params, vk, insts, proof)
        if not ok:
            raise AssertionError("the host verify_proof rejected a bench proof")
        quads.append(tuple(efw))
    return quads, (time.perf_counter() - t0) / n


def bench_end_to_end(params, vk, protos, B: int, trials: int, device, host_quads: list,
                     reference_quads: list | None = None) -> dict:
    """One warm-up call, its quads gated against the host verifier's (and
    `reference_quads`, one a distinct proof, when given); then `trials`
    timed calls, each stage the median over them.  With `H2A_PROFILE`
    naming a directory, one more call under torch.profiler, untimed, writes
    a Chrome trace there."""
    quads = aggregate_once(params, vk, protos, B, device)
    refs = {"the host verify_proof": host_quads, "the reference quads": reference_quads}
    for what, ref in refs.items():
        bad = [] if ref is None else [i for i, q in enumerate(quads) if tuple(q) != tuple(ref[i % len(ref)])]
        if bad:
            raise GateError("quads", f"{len(bad)} of {B} proofs differ from {what}, first {bad[:8]}")
    runs = []
    for _ in range(trials):
        t = {}
        t0 = time.perf_counter()
        aggregate_once(params, vk, protos, B, device, t)
        t["wall"] = time.perf_counter() - t0
        runs.append(t)
    prof_dir = os.environ.get("H2A_PROFILE")
    if prof_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            aggregate_once(params, vk, protos, B, device)
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "bench_aggregate_trace.json"))
    walls = [r["wall"] for r in runs]
    return {
        "value": B / statistics.median(walls), "agg_trials_proofs_per_s": [B / t for t in walls],
        "stages": {k: statistics.median(r[k] for r in runs) for k in runs[0] if k != "wall"},
    }


def bench_algebra(vk, batch, parsed, trials: int, device) -> float:
    """Proofs a second of the device step alone (`fast_device_gathered`
    and the D2H of the quads), on a batch prepared once; the end-to-end
    calls have warmed the same kernels at the same shapes."""
    B = len(parsed)
    prep = fast_prep_gathered(vk, parsed, device)

    def once():
        out = fast_device_gathered(vk, batch, B, *prep, method="win")
        torch.stack([c for name in QUAD_NAMES for c in out[name]]).cpu()

    return B / statistics.median(host_seconds(once, min(3, trials), device))


def bench_scalar_mul(vk, batch, parsed, trials: int, device, ladder: bool = True) -> dict:
    """K1 and (with `ladder`) K8 on `fast_prep`'s multiopen lanes: each
    launch's first 8 lanes gated against the oracle, then timed; K1's
    products counted from these lanes."""
    lane_pts, lane_ss, _, _, _ = fast_prep(vk, parsed, device, batch=batch)
    P = JacPoint(*(c.reshape(-1, 8).contiguous() for c in lane_pts))
    s = lane_ss.reshape(-1, 8).contiguous()
    n = s.shape[0]
    pts, ks = co.jac_to_ints(P), tensor_to_ints(s)
    want = [oc.g1_mul(p, k) if p is not None else None for p, k in zip(pts[:GATE_LANES], ks)]
    kernels = {"k1": lambda: scalar_mul_win(P, s), "k8": lambda: scalar_mul_ladder(P, s, 254)}
    if not ladder:
        del kernels["k8"]
    secs = {}
    for gate, fn in kernels.items():
        out, first_ms = first_call(fn, device)
        got = co.jac_to_ints(JacPoint(*(c[:GATE_LANES] for c in out)))
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise GateError(gate, f"lanes {bad} of the first {GATE_LANES} differ from oracle g1_mul")
        secs[gate] = timed_ms(fn, min(3, trials), device, first_ms) / 1e3
    products = k1_products(pts, ks)
    k1_rate = products / secs["k1"]
    out = {"multiopen_lanes": n, "scalar_muls_per_s": n / secs["k1"]}
    if ladder:
        out["ladder_scalar_muls_per_s"] = n / secs["k8"]
    return {
        **out, "kernel_mont_mul_per_s": k1_rate,
        "kernel_roofline_frac": fraction("kernel_roofline_frac", k1_rate,
                                         f"K1's {products} products on {n} lanes in {secs['k1'] * 1e3:.4f} ms"),
    }


def msm_inputs(log_n: int, device):
    """2^log_n points k_i G (62-bit k_i) and 31-byte scalars, drawn from
    `default_rng(5)` as `bench.py:234-250` draws them.  Returns the device
    points and scalars, and the host arrays the native MSM takes."""
    n = 1 << log_n
    rng = np.random.default_rng(5)
    base = ints_to_u64([G1_GEN[0], G1_GEN[1]]).reshape(-1)
    ks = ints_to_u64([int(rng.integers(1, 1 << 62)) for _ in range(n)])
    aff, inf = native.g1_batch_mul_win(base, ks)
    scalars_u64 = ints_to_u64([int.from_bytes(rng.bytes(31), "little") for _ in range(n)])
    x, y = (fo.to_mont(torch.from_numpy(u64_to_port(aff[:, h : h + 4])).to(device), fo.FQ) for h in (0, 4))
    pts = AffinePoint(x, y, torch.from_numpy(inf.astype(bool)).to(device))
    return pts, torch.from_numpy(u64_to_port(scalars_u64)).to(device), (aff, inf, scalars_u64)


def bench_msm(log_n: int, trials: int, device) -> dict:
    """`ops/msm.py::msm` (K7, its recoding included) at 2^log_n points:
    gated against the native Pippenger, then the median wall of 2 calls
    (on the CPU, the gated call's)."""
    pts, ss, host = msm_inputs(log_n, device)
    n = 1 << log_n
    out, first_ms = first_call(lambda: msm(pts, ss, signed=True), device)
    if co.jac_to_ints(JacPoint(*(c[None] for c in out)))[0] != native.g1_msm_u64(*host):
        raise GateError("msm", f"msm at 2^{log_n} points != the native Pippenger")
    if device.type == "cuda":
        wall = statistics.median(host_seconds(lambda: msm(pts, ss, signed=True), min(2, trials), device))
    else:
        wall = first_ms / 1e3
    adds = n * MSM_WINDOWS
    rate = adds * P_ADD_MIXED / wall
    return {
        "msm_mpoint_adds_per_s": adds / wall / 1e6, "msm_n_points": n, "msm_wall_s": wall,
        "msm_kernel_mont_mul_per_s": rate,
        "msm_kernel_roofline_frac": fraction("msm_kernel_roofline_frac", rate,
                                             f"{adds} mixed adds of {P_ADD_MIXED} products in {wall:.4f} s"),
    }


def ntt_columns(k: int) -> np.ndarray:
    """(8, 2^k, 4) u64 natural-order coefficients of 16-bit words, values
    far below r, from `default_rng(7)` as `bench.py:290-297` draws them."""
    n = 1 << k
    rng = np.random.default_rng(7)
    return np.stack([
        np.frombuffer(rng.bytes(n * 32), dtype="<u8").view("<u2").astype(np.uint64).reshape(n, 16)[:, :4]
        for _ in range(NTT_COLS)
    ])


def bench_ntt(k: int, trials: int, device) -> dict:
    """K3 on an (8, 2^k, 8) stack of bit-reversed coefficients: one
    transform gated against `ntt_plain` on the same device and the native
    host NTT, then four chained in place, timed."""
    cols = ntt_columns(k)
    br = nt.bit_reverse_indices(k)
    x0 = torch.from_numpy(np.ascontiguousarray(u64_to_port(cols[:, br]))).to(device)
    tables = nt.NttTables(k, device)
    got = nt.ntt_batched(x0.clone(), tables.fwd)
    if not torch.equal(got, nt.ntt_plain(x0, tables.fwd)):
        raise GateError("ntt", f"ntt_batched at k = {k} != ntt_plain on {device}")
    dom = NativeDomain(k)
    got_u64 = got.cpu().numpy().view("<u8")
    bad = [c for c in range(NTT_COLS) if not np.array_equal(got_u64[c], dom.ntt(cols[c]))]
    if bad:
        raise GateError("ntt", f"ntt_batched at k = {k} != the native host NTT on columns {bad}")

    def chain():
        for _ in range(NTT_CHAIN):
            nt.ntt_batched(x0, tables.fwd)  # in place: each transform takes the last one's output

    _, first_ms = first_call(chain, device)
    chain_s = timed_ms(chain, min(3, trials), device, first_ms) / 1e3
    n = 1 << k
    products = NTT_CHAIN * NTT_COLS * (n // 2) * k
    rate = products / chain_s
    return {
        "ntt_k": k, "ntt_batch_cols": NTT_COLS, "ntt_wall_s_per_transform": chain_s / NTT_CHAIN,
        "ntt_mont_mul_per_s": rate,
        "ntt_kernel_roofline_frac": fraction("ntt_kernel_roofline_frac", rate,
                                             f"{products} butterflies in {chain_s * 1e3:.4f} ms"),
    }


def native_pairing_s(params) -> float:
    """Seconds of one native two-pair pairing check, the cost the host
    baseline leaves out (deferred to the batch's one pairing)."""
    g = oc.g1_generator()
    t0 = time.perf_counter()
    multi_pairing_check_fast([(g, params.s_g2), (oc.g1_neg(g), params.g2)])
    return time.perf_counter() - t0


def bench_mul_chain(log_m: int, trials: int, device) -> dict:
    """128 dependent Fr products on each of 2^log_m lanes (`bench.py:342-
    360`: 256 random values tiled, each times itself): gated on a sample
    of lanes against host ints, then timed."""
    m = 1 << log_m
    rng = np.random.default_rng(0)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(256)]
    a = ints_to_tensor(vals, device).repeat(-(-m // 256), 1)[:m].contiguous()
    fn = lambda: nt.mul_chain(a, a, MUL_ITERS)  # noqa: E731
    out, first_ms = first_call(fn, device)
    rinv = pow(1 << 256, -1, R)
    sample = sorted(int(i) for i in rng.choice(m, size=min(m, 64), replace=False))
    got = tensor_to_ints(out[torch.tensor(sample, device=device)])
    bad = [i for i, g in zip(sample, got) if g != vals[i % 256] * pow(vals[i % 256] * rinv, MUL_ITERS, R) % R]
    if bad:
        raise GateError("mul_chain", f"lanes {bad[:8]} != a (a / 2^256)^{MUL_ITERS} on host ints")
    secs = timed_ms(fn, min(3, trials), device, first_ms) / 1e3
    rate = MUL_ITERS * m / secs
    return {
        "fr_mont_mul_per_s": rate, "fr_mont_mul_sol_per_s": PRODUCTS_PER_S,
        "fr_mont_mul_roofline_frac": fraction("fr_mont_mul_roofline_frac", rate,
                                              f"{MUL_ITERS} x {m} products in {secs * 1e3:.4f} ms"),
    }


def card_line(device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_verifier(device="cuda", *, batch=None, trials=None, protos=None, pairs=PAIRS, prove_seed: int = 40,
                 reference_quads=None, ladder: bool = False) -> dict:
    """The verifier's sections alone: end to end, the device algebra, K1 on
    the multiopen lanes (and K8 with `ladder`), with the host baseline
    that the quads gate holds them to.  Returns a result line of `run`'s
    form whose `detail` holds those sections' keys; `gates` names the gates
    passed.  `batch`, `trials`, `protos`, `pairs` and `prove_seed` are
    `run`'s; `reference_quads` (one a distinct proof), when given, gates
    the warm-up's quads too."""
    device = resolve_device(device)
    cfg = H2AConfig.from_env()
    B = cfg.batch if batch is None else batch
    trials = int(os.environ.get("H2A_BENCH_TRIALS", "5")) if trials is None else trials
    if B < 1 or trials < 1:
        raise ValueError(f"batch = {B}, trials = {trials}: expected >= 1")
    if device.type == "cuda":
        build.load_library()  # the kernels' build, before the first clock
    params, vk, protos = make_protos(cfg.k_inner, pairs, prove_seed) if protos is None else protos
    host_quads, host_s = host_verify(params, vk, protos, min(B, len(protos)))
    pairing_s = native_pairing_s(params)

    e2e = bench_end_to_end(params, vk, protos, B, trials, device, host_quads, reference_quads)
    parsed = parse_cycled(vk, protos, B)
    batch_dev = batch_proofs(vk, parsed, device)
    detail = {
        "batch": B,
        "verify_algebra_proofs_per_s": bench_algebra(vk, batch_dev, parsed, trials, device),
        **bench_scalar_mul(vk, batch_dev, parsed, trials, device, ladder),
        "host_algebra_proofs_per_s": 1.0 / max(host_s - pairing_s, 1e-9),
        "native_pairing_s": pairing_s,
        "agg_trials_proofs_per_s": e2e["agg_trials_proofs_per_s"],
        "stages": e2e["stages"],
        "gates": dict.fromkeys(("quads", "k1", "k8") if ladder else ("quads", "k1"), True),
        "device": card_line(device),
    }
    return {
        "metric": "proofs_aggregated_per_s", "value": e2e["value"], "unit": "proofs/s",
        "vs_baseline": e2e["value"] / detail["host_algebra_proofs_per_s"], "detail": detail,
    }


def run(device="cuda", *, batch=None, trials=None, msm_log2=None, ntt_log2=None, mul_log2=16,
        protos=None, pairs=PAIRS, prove_seed: int = 40) -> dict:
    """The whole measurement; returns the result line as a dict.  Sizes left
    None take `bench.py`'s defaults through its environment variables.
    `protos`, if given, is `make_protos`' result at `H2AConfig.k_inner`
    (the proofs are then not made again); else `make_protos` makes them
    from `pairs` and `prove_seed`."""
    device = resolve_device(device)
    trials = int(os.environ.get("H2A_BENCH_TRIALS", "5")) if trials is None else trials
    msm_log2 = int(os.environ.get("H2A_BENCH_MSM_LOG2", "17")) if msm_log2 is None else msm_log2
    ntt_log2 = int(os.environ.get("H2A_BENCH_NTT_LOG2", "16")) if ntt_log2 is None else ntt_log2
    line = run_verifier(device, batch=batch, trials=trials, protos=protos, pairs=pairs, prove_seed=prove_seed,
                        ladder=True)
    detail = line["detail"]
    head = {k: detail.pop(k) for k in ("agg_trials_proofs_per_s", "stages", "gates", "device")}
    detail.update({
        **bench_msm(msm_log2, trials, device),
        **bench_mul_chain(mul_log2, trials, device),
        **bench_ntt(ntt_log2, trials, device),
        **head,
        "gates": dict.fromkeys(GATES, True),
    })
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
