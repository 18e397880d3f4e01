"""The port's benchmark program (`halo2_aggregation_tpu_torch/bench.py`) on
the CPU, through the kernels' plain versions, against the JAX package.

One module-scoped run at B = 2, one trial and small MSM, NTT and mul-chain
sizes: the result line's keys are those of the root `bench.py` under the
documented mapping, every gate passes and every roofline fraction lies in
(0, 1.05].  The bench's four proofs and instance commitments equal, byte
for byte, those the JAX package's functions make as `bench.py:91-101`
makes them, and the batch's quads equal the JAX host `verify_proof`'s.
Each gate bites: a plain scalar-mul, MSM, NTT or product chain that is off
in one lane raises `GateError` naming it.  The times of a CPU run are the
CPU's: nothing here reads them.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.models import simple_example as se_r
from halo2_aggregation_tpu.plonk import kzg as kzg_r
from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
from halo2_aggregation_tpu.plonk.prover import create_proof as create_proof_r
from halo2_aggregation_tpu.plonk.verifier import verify_proof as verify_proof_r
from halo2_aggregation_tpu_torch import bench
from halo2_aggregation_tpu_torch.config import H2AConfig
from halo2_aggregation_tpu_torch.fields import R
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops import msm as msm_mod
from halo2_aggregation_tpu_torch.ops import ntt as nt
from halo2_aggregation_tpu_torch.ops.curve_ops import JacPoint
from halo2_aggregation_tpu_torch.ops.limbs import tensor_to_ints
from halo2_aggregation_tpu_torch.oracle import curve as oc
from halo2_aggregation_tpu_torch.plonk.verifier_device import batch_proofs
from halo2_aggregation_tpu_torch.utils import native

torch.set_num_threads(1)  # small tensors; the test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
B = 2

# the root bench.py's detail keys -> the port's (the module docstring's mapping)
RENAMED = {
    "pallas_scalar_muls_per_s": "ladder_scalar_muls_per_s",
    "pallas_kernel_mont_mul_per_s": "kernel_mont_mul_per_s",
    "pallas_kernel_roofline_frac": "kernel_roofline_frac",
    "msm_mpoint_adds_per_s_per_chip": "msm_mpoint_adds_per_s",
}
DROPPED = {"pallas_kernel_tile", "pallas_scalar_muls_per_s_by_tile", "ntt_executed_roofline_frac"}
ADDED = {"scalar_muls_per_s", "gates"}
FRACTIONS = ("fr_mont_mul_roofline_frac", "kernel_roofline_frac", "msm_kernel_roofline_frac",
             "ntt_kernel_roofline_frac")


@pytest.fixture(scope="module")
def protos():
    return bench.make_protos(9)


@pytest.fixture(scope="module")
def result(protos):
    """`run` on the CPU, and the quads of every end-to-end call it made."""
    quads = []
    real = bench.aggregate_once

    def spy(*args, **kwargs):
        quads.append(real(*args, **kwargs))
        return quads[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "aggregate_once", spy)
        res = bench.run("cpu", batch=B, trials=1, msm_log2=8, ntt_log2=6, mul_log2=8, protos=protos)
    return res, quads


@pytest.fixture(scope="module")
def jax_protos():
    """The SRS, vk and four proofs of the root `bench.py:91-101`, made by
    the JAX package's functions exactly as it makes them."""
    params = kzg_r.setup(9)
    circuit = se_r.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se_r.build(circuit.without_witnesses(), k=9)
    vk, pk = keygen_r(params, cs_e, asg_e)
    protos = []
    for a, b in [(2, 3), (4, 5), (1, 255), (6, 6)]:
        c = se_r.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se_r.build(c, k=9)
        pub = [c.public_output()]
        proof = create_proof_r(params, pk, asg, [pub], seed=40 + a)
        protos.append((pub, proof, [params.commit_lagrange(pub)]))
    return params, vk, protos


def jax_detail_keys() -> set:
    """The keys of the `detail` dict literal the root bench.py prints."""
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "detail" in keys:
                detail = node.values[keys.index("detail")]
                return {k.value for k in detail.keys}
    raise AssertionError("no detail dict in bench.py")


def test_run_on_the_cpu_gives_the_documented_line(result):
    res, _ = result
    line = json.loads(json.dumps(res))
    assert line == res
    assert line["metric"] == "proofs_aggregated_per_s" and line["unit"] == "proofs/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    detail = line["detail"]
    assert set(detail) == {RENAMED.get(k, k) for k in jax_detail_keys() - DROPPED} | ADDED
    assert detail["gates"] == dict.fromkeys(bench.GATES, True)
    assert detail["device"] == "cpu" and detail["batch"] == B
    assert set(detail["stages"]) == {"parse_s", "prep_s", "device_and_d2h_s", "pairing_s"}
    assert len(detail["agg_trials_proofs_per_s"]) == 1
    assert detail["multiopen_lanes"] == 35 * B  # w 4, zw 4, f 27 a proof
    assert (detail["msm_n_points"], detail["ntt_k"], detail["ntt_batch_cols"]) == (1 << 8, 6, 8)
    for key in FRACTIONS:
        assert 0 < detail[key] <= 1.05, key
    assert detail["fr_mont_mul_sol_per_s"] == pytest.approx(61.58e9, rel=1e-3)


def test_bench_proofs_equal_the_jax_bench(protos, jax_protos):
    params, vk, port = protos
    params_r, vk_r, ref = jax_protos
    assert vk.hash_scalar() == vk_r.hash_scalar()
    for (insts, proof, comms), (pub_r, proof_r, comms_r) in zip(port, ref, strict=True):
        assert insts == [pub_r]
        assert proof == proof_r
        assert comms == comms_r


def test_batch_quads_equal_the_jax_host_verifier(result, jax_protos):
    _, quads = result
    params_r, vk_r, ref = jax_protos
    want = []
    for pub, proof, _ in ref[:B]:
        ok, efw = verify_proof_r(params_r, vk_r, [pub], proof)
        assert ok
        want.append(tuple(efw))
    assert len(quads) == 2  # the warm-up call (gated) and the one trial
    for q in quads:
        assert [tuple(x) for x in q] == want


# ---------------------------------------------------------------------------
# each gate bites
# ---------------------------------------------------------------------------


def native_mul(points: JacPoint, scalars, off_lane=None, nbits=256) -> JacPoint:
    """s_i P_i by the native host engine, lane `off_lane` moved by G: a
    stand-in for a plain scalar-mul that is right on every lane but one."""
    pts = co.jac_to_ints(points)
    ks = tensor_to_ints(scalars)
    out = [native.g1_msm([p], [(k % (1 << nbits)) % R]) if p is not None else None for p, k in zip(pts, ks)]
    if off_lane is not None:
        out[off_lane] = oc.g1_add(out[off_lane], oc.g1_generator())
    return co.affine_to_jac(co.affine_from_ints(out, points.x.device))


@pytest.fixture(scope="module")
def one_proof(protos):
    _, vk, pr = protos
    parsed = bench.parse_cycled(vk, pr, 1)
    return vk, batch_proofs(vk, parsed, "cpu"), parsed


def test_k1_gate_bites(one_proof, monkeypatch):
    monkeypatch.setattr(co, "scalar_mul", lambda p, s: native_mul(p, s, off_lane=3))
    with pytest.raises(bench.GateError, match="'k1'") as err:
        bench.bench_scalar_mul(*one_proof, 1, torch.device("cpu"))
    assert err.value.gate == "k1"


def test_k8_gate_bites(one_proof, monkeypatch):
    monkeypatch.setattr(co, "scalar_mul", lambda p, s: native_mul(p, s))
    monkeypatch.setattr(co, "scalar_mul_ladder", lambda p, s, nbits: native_mul(p, s, off_lane=5, nbits=nbits))
    with pytest.raises(bench.GateError, match="'k8'") as err:
        bench.bench_scalar_mul(*one_proof, 1, torch.device("cpu"))
    assert err.value.gate == "k8"


def test_msm_gate_bites(monkeypatch):
    _, _, (aff, inf, scalars_u64) = bench.msm_inputs(4, "cpu")
    dropped = scalars_u64.copy()
    dropped[3] = 0  # lane 3 left out of the sum
    wrong = co.affine_to_jac(co.affine_from_ints([native.g1_msm_u64(aff, inf, dropped)], "cpu"))
    monkeypatch.setattr(msm_mod, "msm_bucket_plain", lambda *a: JacPoint(*(c[0] for c in wrong)))
    with pytest.raises(bench.GateError, match="'msm'") as err:
        bench.bench_msm(4, 1, torch.device("cpu"))
    assert err.value.gate == "msm"


def test_ntt_gate_bites(monkeypatch):
    real = nt.ntt_plain

    def off(x, tw):
        out = real(x, tw)
        out[2, 5] = out[2, 6]
        return out

    monkeypatch.setattr(nt, "ntt_plain", off)
    with pytest.raises(bench.GateError, match="'ntt'") as err:
        bench.bench_ntt(4, 1, torch.device("cpu"))
    assert err.value.gate == "ntt"


def test_mul_chain_gate_bites(monkeypatch):
    real = nt.mul_chain

    def off(a, b, iters):
        out = real(a, b, iters)
        out[7] = a[7]
        return out

    monkeypatch.setattr(nt, "mul_chain", off)
    with pytest.raises(bench.GateError, match="'mul_chain'") as err:
        bench.bench_mul_chain(5, 1, torch.device("cpu"))
    assert err.value.gate == "mul_chain"


def test_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    """`H2A_PROFILE=<dir>`: one more end-to-end call, untimed, under
    torch.profiler, its trace written into <dir> (the pipeline stubbed out:
    this holds the plumbing, the run above the pipeline)."""
    quads = [("e", "f", "w", "zw")]
    calls = []
    monkeypatch.setattr(bench, "aggregate_once", lambda *a, **k: calls.append(a) or quads)
    monkeypatch.setenv("H2A_PROFILE", str(tmp_path / "trace"))
    out = bench.bench_end_to_end(None, None, None, 1, 2, torch.device("cpu"), quads)
    assert len(calls) == 4  # warm-up, two trials, the profiled call
    assert len(out["agg_trials_proofs_per_s"]) == 2
    assert (tmp_path / "trace" / "bench_aggregate_trace.json").stat().st_size > 0


def test_fraction_above_the_bound_raises():
    with pytest.raises(ValueError, match="miscount"):
        bench.fraction("x", 1.06 * bench.PRODUCTS_PER_S, "a test count")
    assert bench.fraction("x", 0.5 * bench.PRODUCTS_PER_S, "a test count") == pytest.approx(0.5)


def test_mul_chain_plain_equals_host_ints():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(64)]
    a = torch.tensor(np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4").reshape(64, 8))
    got = tensor_to_ints(nt.mul_chain(a, a, 5))
    rinv = pow(1 << 256, -1, R)
    assert got == [v * pow(v * rinv, 5, R) % R for v in vals]
    with pytest.raises(ValueError, match="multiple of 32"):
        nt.mul_chain(a[:40], a[:40], 5)


# ---------------------------------------------------------------------------
# the batch knob and the card
# ---------------------------------------------------------------------------


def test_config_batch_follows_the_variable(monkeypatch):
    monkeypatch.delenv("H2A_BENCH_BATCH", raising=False)
    assert H2AConfig.from_env().batch == 128
    monkeypatch.setenv("H2A_BENCH_BATCH", "7")
    assert H2AConfig.from_env().batch == 7
    assert H2AConfig().batch == 7


def test_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card path does not apply")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run()
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
