"""The benchmark (`BENCHMARK.json`, `benchmark/run.py`) on the CPU.

Every cell `BENCHMARK.json` lists is held to the same rules (one card, a
program the runner knows, metrics with a unit, a direction and a bound, its
reference where it names one), so a new cell is one JSON entry.  One
module-scoped CPU run of the verifier's program goes through
`run_cell(device="cpu")`, i.e. the bench's verifier sections through the
kernels' plain versions, at B = 2 and one trial, at a seed other than the
reference's: its four inner proofs equal, byte for byte, those the JAX
package makes from the same witnesses and seeds, and its quads the JAX host
`verify_proof`'s.  The seed-0 reference file is the JAX package's proofs'
hashes and quads.  The outer program's metrics are read from a line of
`tools/outer_prove.py`'s form recorded on the card (no k = 21 work here).
Each correctness check fails on a corrupted input, and the runner raises
when it is asked for a card and none exists.  Times of a CPU run are the
CPU's: nothing here reads them.
"""

import copy
import hashlib
import json
import re
from pathlib import Path

import pytest
import torch

from benchmark import run as runner
from halo2_aggregation_tpu.models import simple_example as se_r
from halo2_aggregation_tpu.plonk import kzg as kzg_r
from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
from halo2_aggregation_tpu.plonk.prover import create_proof as create_proof_r
from halo2_aggregation_tpu.plonk.verifier import verify_proof as verify_proof_r
from halo2_aggregation_tpu_torch import bench
from halo2_aggregation_tpu_torch.config import H2AConfig
from halo2_aggregation_tpu_torch.tools import outer_prove

torch.set_num_threads(1)  # small tensors; the test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
CELLS = {c["name"]: c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
VERIFIER = "halo2_aggregation_tpu_torch/bench.py::run_verifier"
OUTER = "halo2_aggregation_tpu_torch/tools/outer_prove.py::run_outer"
VERIFY_CELLS = [n for n, c in CELLS.items() if c["program"] == VERIFIER]
OUTER_CELLS = [n for n, c in CELLS.items() if c["program"] == OUTER]
B = 2
SEED = 7  # not the reference seed: the cell's inputs drawn from it
SMALL = {"batch": B, "trials": 1}

#: a line of `tools/outer_prove.py`'s form (`result_line`), from the
#: outer_n1_k21 cell's first card run at seed 0 (NVIDIA H100 80GB HBM3,
#: 700.00 W), its seconds cut to three decimals
OUTER_LINE = {"num_proofs": 1,
              "k_outer": 21,
              "rows": 1265640,
              "proof_bytes": 2432,
              "proof_sha256": "ddf5419238a0feb186e3c18018796e6510e4ea3935818b04dda186177bff1b4e",
              "vk_hash": "18409149904397833514932626697575365966457177629674121399207633864194433722328",
              "verified": True,
              "in_circuit_quads_equal_host": True,
              "artifact_stem": None,
              "seconds": {"inner_proofs": 4.885,
                          "synthesis": 41.145,
                          "setup": 0.222,
                          "srs_upload": 0.418,
                          "keygen": 27.304,
                          "keygen_stages": [["fixed committed", 12.183],
                                            ["permutation arrays", 13.645],
                                            ["sigma committed", 1.473]],
                          "prove": 45.952,
                          "prove_stages": [["fixed columns fed", 1.001],
                                           ["advice committed", 5.956],
                                           ["lookups permuted", 3.732],
                                           ["permutation products", 2.5],
                                           ["lookup products", 2.804],
                                           ["vanishing random committed", 20.137],
                                           ["quotient columns on the device", 0.302],
                                           ["quotient coset 1/4 (device)", 0.262],
                                           ["quotient coset 2/4 (device)", 0.136],
                                           ["quotient coset 3/4 (device)", 0.139],
                                           ["quotient coset 4/4 (device)", 0.13],
                                           ["  h ext intt+scale (3.0s)", 3.0],
                                           ["  h piece ntt 0.5s commit 0.1s", 0.555],
                                           ["  h piece ntt 0.5s commit 0.1s", 0.544],
                                           ["  h piece ntt 0.4s commit 0.1s", 0.537],
                                           ["  h piece ntt 0.4s commit 0.1s", 0.523],
                                           ["quotient committed", 0.0],
                                           ["evaluations", 1.852],
                                           ["multiopen witnesses", 1.812]],
                          "verify": 5.984}}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def card():
    """Whether a CUDA device is visible, decided when a test asks."""
    return torch.cuda.is_available()


@pytest.fixture(scope="module")
def verify_run():
    """The first verifier cell on the CPU at `SEED`: its line, the protos
    the runner made and the quads of each end-to-end call."""
    made, quads = [], []
    real_make, real_agg = bench.make_protos, bench.aggregate_once

    def make_spy(*args, **kwargs):
        made.append(real_make(*args, **kwargs))
        return made[-1]

    def agg_spy(*args, **kwargs):
        quads.append(real_agg(*args, **kwargs))
        return quads[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "make_protos", make_spy)
        mp.setattr(bench, "aggregate_once", agg_spy)
        line = runner.run_cell(VERIFY_CELLS[0], SEED, device="cpu", **SMALL)
    return line, made[0], quads


@pytest.fixture(scope="module")
def jax_made():
    """seed -> (the vk's hash, [(public inputs, proof bytes)], quads): the
    bench's four inner proofs at the seed's witnesses and prove seeds, made
    and verified by the JAX package's own host functions."""
    params = kzg_r.setup(9)
    cs_e, _, asg_e = se_r.build(se_r.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=9)
    vk, pk = keygen_r(params, cs_e, asg_e)
    cache = {}

    def made(seed):
        if seed not in cache:
            pairs, prove_seed = runner.verify_inputs(seed)
            protos, quads = [], []
            for a, b in pairs:
                c = se_r.MyCircuit(constant=7, a=a, b=b)
                _, _, asg = se_r.build(c, k=9)
                pub = [c.public_output()]
                proof = create_proof_r(params, pk, asg, [pub], seed=prove_seed + a)
                ok, efw = verify_proof_r(params, vk, [pub], proof)
                assert ok
                protos.append((pub, proof, params.commit_lagrange(pub)))
                quads.append(tuple(efw))
            cache[seed] = vk.hash_scalar(), protos, quads
        return cache[seed]

    return made


# ---------------------------------------------------------------------------
# BENCHMARK.json
# ---------------------------------------------------------------------------


def test_benchmark_json_names_two_one_card_cells(spec):
    """Every cell on one card, run by the runner's command at its seed,
    by a program the runner knows; each program has a cell."""
    assert [c["name"] for c in spec["workloads"]] == list(CELLS) and len(CELLS) >= 2
    assert {c["program"] for c in CELLS.values()} == set(runner.PROGRAMS)
    for name, c in CELLS.items():
        assert c["chips"] == 1 and c["seed"] == 0
        assert len(c["source"]) <= 200
        assert c["command"] == f"python -m benchmark.run --cell {name} --seed {{seed}}"
        assert c["trace_command"] == c["command"] + " --trace"
        for key in ("traffic", "users", "correct", "why"):
            assert isinstance(c[key], str) and c[key], (name, key)
        assert isinstance(c["reduced"], list) and isinstance(c["assumed"], list)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_reference_and_sizes(name):
    """A cell's reference file exists and is read at its seed only; a
    verifier cell's sizes are its environment's, an outer cell's an
    `H2AConfig` and its rows."""
    cell = CELLS[name]
    ref = cell["reference"]
    assert (ROOT / ref["file"]).is_file()
    assert runner.reference(cell, ref["seed"] + 1) is None
    if cell["program"] == VERIFIER:
        assert set(cell["env"]) == {"H2A_BENCH_BATCH", "H2A_BENCH_TRIALS"}
        assert int(cell["env"]["H2A_BENCH_BATCH"]) >= 1 and int(cell["env"]["H2A_BENCH_TRIALS"]) >= 1
        assert runner.reference(cell, ref["seed"])["config"] == cell["config"]
    else:
        cfg = H2AConfig(**cell["h2a_config"])
        assert cell["rows"] <= 1 << cfg.k_outer
        assert isinstance(runner.reference(cell, ref["seed"]), bytes)


@pytest.mark.parametrize("name", list(CELLS))
def test_end_to_end_metrics_have_unit_direction_and_bound(spec, name):
    cell = CELLS[name]
    want = {VERIFIER: {"proofs_aggregated_per_s": ("proofs/s", "higher")},
            OUTER: {"outer_proof_s": ("s", "lower"), "outer_setup_s": ("s", "lower")}}[cell["program"]]
    assert {m["name"]: (m["unit"], m["direction"]) for m in cell["metrics"]} == want
    for m in cell["metrics"]:
        assert isinstance(m["bound"], float) and 0 < m["bound"] < 2, m
        assert m["read"], m


def test_each_cell_program_exists(spec):
    for program, fn in runner.PROGRAMS.items():
        path, func = program.split("::")
        assert (ROOT / path).is_file() and callable(fn)
    assert callable(bench.run_verifier) and callable(outer_prove.run_outer)
    assert all(runner.PROGRAMS[c["program"]] for c in CELLS.values())


def test_per_layer_metrics_name_a_cell_that_prints_them(spec, verify_run):
    printed = {VERIFIER: set(verify_run[0]["cpu"]), OUTER: set(runner.outer_metrics(OUTER_LINE))}
    layers = spec["per_layer_metrics"]
    assert len({m["name"] for m in layers}) == len(layers)
    for m in layers:
        assert m["name"] in printed[CELLS[m["cell"]]["program"]], m
        assert m["unit"] and m["layer"] and m["moves"]
    for c in spec["workloads"]:
        e2e = {m["name"] for m in c["metrics"]}
        assert {m["name"] for m in layers if m["cell"] == c["name"]} | e2e == printed[c["program"]]
        assert all(m["moves"] == "none" or m["moves"].split()[0] in e2e for m in layers if m["cell"] == c["name"])


# ---------------------------------------------------------------------------
# the verifier's cell on the CPU
# ---------------------------------------------------------------------------


def test_verify_cell_line_on_the_cpu(verify_run):
    line, _, quads = verify_run
    assert line["cell"] == VERIFY_CELLS[0] and line["seed"] == SEED and line["device"] == "cpu"
    assert line["correct"] is True and line["checks"] == {"gates_passed": True, "batch": True, "value_finite": True}
    metrics = line["cpu"]
    # one trial: all the proofs over all the wall is the bench's value
    assert metrics["proofs_aggregated_per_s"] == pytest.approx(line["program_line"]["value"], rel=1e-12)
    assert metrics["parse_s"] == line["program_line"]["detail"]["stages"]["parse_s"]
    assert all(v > 0 for v in metrics.values())
    # the verifier's sections alone: no K8, MSM, NTT or product chain
    assert line["program_line"]["detail"]["gates"] == {"quads": True, "k1": True}
    assert not {"ladder_scalar_muls_per_s", "msm_wall_s", "ntt_k", "fr_mont_mul_per_s"} & set(
        line["program_line"]["detail"])
    # no CPU number under a metric's name, and no kernel launched on CPU tensors
    assert not set(metrics) & set(line) and "layers" not in line and "peak_device_mib" not in line
    assert set(line["units"]) == set(metrics) and line["units"]["scalar_muls_per_s"] == "scalar-muls/s"
    assert set(line["launches"]) >= {"ec_win", "fa_tape", "jac_segment_sum", "msm_s5", "ntt"}
    assert set(line["launches"].values()) == {0}
    assert len(line["host_probe_ms"]) == 2 and all(v > 0 for v in line["host_probe_ms"])
    assert len(quads) == 4  # the gated warm-up and the one trial, of the discarded run and the measured one


def test_verify_metric_is_all_the_proofs_over_all_the_wall():
    """Two trials of B = 2 at 100 and 200 proofs/s: 4 proofs in 0.03 s,
    not the median's 150."""
    line = {"value": 150.0, "detail": {"batch": 2, "agg_trials_proofs_per_s": [100.0, 200.0],
                                       "stages": dict.fromkeys(("parse_s", "prep_s", "device_and_d2h_s",
                                                                "pairing_s"), 0.01),
                                       "verify_algebra_proofs_per_s": 1.0, "scalar_muls_per_s": 1.0}}
    assert runner.verify_metrics(line)["proofs_aggregated_per_s"] == pytest.approx(4 / 0.03)


def test_verify_cell_seed_draws_the_inputs():
    assert runner.verify_inputs(0) == (bench.PAIRS, 40)
    pairs, prove_seed = runner.verify_inputs(SEED)
    assert runner.verify_inputs(SEED) == (pairs, prove_seed) and prove_seed == 40 + SEED
    assert pairs != bench.PAIRS and len(pairs) == 4 and all(1 <= v <= 255 for p in pairs for v in p)
    assert runner.verify_inputs(SEED + 1)[0] != pairs


def test_verify_cell_proofs_and_quads_equal_the_jax_package(verify_run, jax_made):
    """The proofs of the drawn witnesses, made by the JAX package's
    functions with the same prove seeds, equal the run's byte for byte, and
    the run's quads equal the JAX host verify_proof's."""
    _, (params, vk, protos), quads = verify_run
    vk_hash, want_protos, want = jax_made(SEED)
    assert vk.hash_scalar() == vk_hash
    for (insts, proof, comms), (pub, proof_r, comm_r) in zip(protos, want_protos, strict=True):
        assert insts == [pub] and proof == proof_r and comms == [comm_r]
    for q in quads:
        assert [tuple(x) for x in q] == [want[i % len(want)] for i in range(B)]


@pytest.mark.parametrize("name", VERIFY_CELLS)
def test_reference_file_is_the_jax_package_s(name, jax_made):
    """The reference file's proofs and quads are those the JAX package's
    own prover and verifier make at the reference seed."""
    cell = CELLS[name]
    ref = runner.reference(cell, cell["reference"]["seed"])
    _, protos, quads = jax_made(ref["seed"])
    assert (ref["pairs"], ref["prove_seed"]) == ([list(p) for p in bench.PAIRS], 40)
    assert ref["proof_sha256"] == [hashlib.sha256(proof).hexdigest() for _, proof, _ in protos]
    assert runner.as_quads(ref["quads"]) == quads


def test_verify_quad_lane_off_fails_the_cell(verify_run, monkeypatch):
    """One quad lane off in the run's end-to-end call: the bench's quads
    gate raises through the runner, uncaught."""
    _, made, quads = verify_run
    off = copy.deepcopy([list(q) for q in quads[0]])
    e, f, w, zw = off[1]
    off[1] = (e, f, w, (zw[0], zw[1] + 1))
    monkeypatch.setattr(bench, "aggregate_once", lambda *a, **k: off)
    with pytest.raises(bench.GateError, match="'quads'") as err:
        runner.run_cell(VERIFY_CELLS[0], SEED, device="cpu", protos=made, **SMALL)
    assert err.value.gate == "quads"


def test_reference_quad_lane_off_fails_the_gate(monkeypatch):
    """Quads equal to the host verifier's but one lane off the reference
    file's: the quads gate raises, naming the reference."""
    cell = CELLS[VERIFY_CELLS[0]]
    ref = runner.as_quads(runner.reference(cell, 0)["quads"])
    off = copy.deepcopy(ref)
    e, f, w, zw = off[2]
    off[2] = (e, (f[0], f[1] + 1), w, zw)
    monkeypatch.setattr(bench, "aggregate_once", lambda *a, **k: [off[i % 4] for i in range(8)])
    with pytest.raises(bench.GateError, match="the reference quads") as err:
        bench.bench_end_to_end(None, None, None, 8, 1, torch.device("cpu"), off, ref)
    assert err.value.gate == "quads"
    out = bench.bench_end_to_end(None, None, None, 8, 1, torch.device("cpu"), off, off)
    assert len(out["agg_trials_proofs_per_s"]) == 1


@pytest.mark.parametrize("corrupt, check", [
    (lambda ln: ln["detail"]["gates"].update(k1=False), "gates_passed"),
    (lambda ln: ln["detail"].update(batch=B - 1), "batch"),
    (lambda ln: ln.update(value=float("nan")), "value_finite"),
    (lambda ln: ln["detail"]["agg_trials_proofs_per_s"].append(float("inf")), "value_finite"),
])
def test_verify_checks_fail_on_a_corrupted_line(verify_run, corrupt, check):
    line = copy.deepcopy(verify_run[0]["program_line"])
    protos = verify_run[1][2]
    assert all(runner.verify_checks(line, B, protos, None).values())
    corrupt(line)
    checks = runner.verify_checks(line, B, protos, None)
    assert [k for k, v in checks.items() if not v] == [check]


def test_verify_proofs_held_to_the_reference(verify_run, jax_made):
    """At the reference seed the proofs' bytes are the reference's; one byte
    off fails that check alone."""
    line = verify_run[0]["program_line"]
    ref = runner.reference(CELLS[VERIFY_CELLS[0]], 0)
    protos = jax_made(0)[1]
    assert runner.verify_checks(line, B, protos, ref)["proofs_equal_to_reference"] is True
    pub, proof, comm = protos[3]
    bad = protos[:3] + [(pub, proof[:10] + bytes([proof[10] ^ 1]) + proof[11:], comm)]
    checks = runner.verify_checks(line, B, bad, ref)
    assert [k for k, v in checks.items() if not v] == ["proofs_equal_to_reference"]


# ---------------------------------------------------------------------------
# the outer proof's cell, from a recorded line
# ---------------------------------------------------------------------------


def test_outer_metrics_from_the_recorded_line():
    s = OUTER_LINE["seconds"]
    m = runner.outer_metrics(OUTER_LINE)
    assert m["outer_proof_s"] == s["synthesis"] + s["prove"]
    assert m["outer_setup_s"] == s["setup"] + s["srs_upload"] + s["keygen"]
    assert m["prove_s"] == s["prove"] and m["synthesis_s"] == s["synthesis"]
    prove_stages = [k for k in m if k.startswith("prove_") and k != "prove_s"]
    assert sum(m[k] for k in prove_stages) == pytest.approx(sum(r[1] for r in s["prove_stages"]))
    assert sum(m[k] for k in prove_stages) == pytest.approx(s["prove"], rel=0.02)
    keygen_stages = [k for k in m if k.startswith("keygen_") and k != "keygen_s"]
    assert sum(m[k] for k in keygen_stages) == pytest.approx(s["keygen"], rel=0.02)
    assert m["prove_cosets_s"] == pytest.approx(sum(r[1] for r in s["prove_stages"] if "coset" in r[0]))


def outer_cell():
    """The outer cell the recorded line is of."""
    return next(c for c in CELLS.values() if c["program"] == OUTER and c["h2a_config"]["k_outer"] == 21)


def test_outer_checks_pass_on_the_recorded_line():
    cell = outer_cell()
    ref = runner.reference(cell, 0)
    assert OUTER_LINE["proof_sha256"] == hashlib.sha256(ref).hexdigest()
    assert runner.outer_checks(OUTER_LINE, cell, ref) == {
        "verified": True, "in_circuit_quads_equal_host": True, "shape": True, "proof_equal_to_reference": True}


def one_byte_off(sha: str) -> str:
    raw = bytearray(bytes.fromhex(sha))
    raw[5] ^= 1
    return raw.hex()


@pytest.mark.parametrize("key, value, seed, check", [
    ("verified", False, 0, "verified"),
    ("verified", False, 1, "verified"),
    ("in_circuit_quads_equal_host", False, 0, "in_circuit_quads_equal_host"),
    ("rows", 1_265_639, 0, "shape"),
    ("proof_sha256", one_byte_off(OUTER_LINE["proof_sha256"]), 0, "proof_equal_to_reference"),
])
def test_outer_checks_fail_on_a_corrupted_line(key, value, seed, check):
    cell = outer_cell()
    line = dict(OUTER_LINE, **{key: value})
    checks = runner.outer_checks(line, cell, runner.reference(cell, seed))
    assert [k for k, v in checks.items() if not v] == [check]


def test_outer_proof_hash_decides_only_at_the_artifact_seed():
    """At another seed the proof differs from the artifact's, and the host
    verify decides alone."""
    cell = outer_cell()
    line = dict(OUTER_LINE, proof_sha256=one_byte_off(OUTER_LINE["proof_sha256"]))
    assert runner.reference(cell, 1) is None
    assert runner.outer_checks(line, cell, None) == {"verified": True, "in_circuit_quads_equal_host": True,
                                                     "shape": True}


def test_stage_table_rejects_an_unknown_message():
    with pytest.raises(ValueError, match="stage table"):
        runner.stage_sums([["advice committed", 1.0], ["a new stage", 2.0]], runner.PROVE_STAGES)


def test_run_outer_forwards_the_seed_and_the_window(monkeypatch):
    """`run_outer`'s seed and profiler window reach the prove (phases A-C
    and the prove stubbed: this holds the plumbing; the card run holds the
    proof)."""
    from halo2_aggregation_tpu_torch.config import H2AConfig

    got = {}
    monkeypatch.setattr(outer_prove, "inner_proofs", lambda cfg, off: {"efws": [], "verified": []})
    monkeypatch.setattr(outer_prove, "outer_circuit", lambda cfg, inner: (None, [1]))
    monkeypatch.setattr(outer_prove, "synthesize", lambda *a: ("cs", "asg", 10, [], None))
    monkeypatch.setattr(outer_prove, "prove_and_save",
                        lambda *a, **k: got.update(k) or {"verified": True, "seconds": {}, "rss_mib": []})
    window = object()
    outer_prove.run_outer(H2AConfig(k_outer=21, num_proofs=1), device="cpu", seed=5, prove_window=window)
    assert got["seed"] == 5 and got["prove_window"] is window
    outer_prove.run_outer(H2AConfig(k_outer=21, num_proofs=1), device="cpu")
    assert got["seed"] == 1 and got["prove_window"] is None


def test_prove_and_save_enters_the_window_around_the_prove_alone(monkeypatch):
    from halo2_aggregation_tpu_torch.plonk import keygen_device, kzg, prover_device, verifier

    events = []

    class Window:
        def __enter__(self):
            events.append("enter")

        def __exit__(self, *exc):
            events.append("exit")

    class SRS:
        device, n = torch.device("cpu"), 4

        def __init__(self, *a):
            pass

        def commit_lagrange(self, values):
            return (1, 2)

    monkeypatch.setattr(kzg, "setup", lambda k, device=None: type("P", (), {"n": 4})())
    monkeypatch.setattr(kzg, "DeviceSRS", SRS)
    monkeypatch.setattr(keygen_device, "keygen_device", lambda *a, **k: events.append("keygen") or ("vk", "pk"))
    monkeypatch.setattr(prover_device, "create_proof_device", lambda *a, **k: events.append("prove") or b"p")
    monkeypatch.setattr(verifier, "verify_proof", lambda *a: events.append("verify") or (True, None))
    res = outer_prove.prove_and_save("cs", "asg", [1], 2, seed=1, device="cpu", prove_window=Window())
    assert events == ["keygen", "enter", "prove", "exit", "verify"] and res["verified"] is True


def test_result_line_says_whether_the_quads_agree():
    res = {"num_proofs": 1, "k_outer": 21, "rows": 3, "proof": b"abc", "vk": type("V", (), {"hash_scalar": lambda s: 9})(),
           "verified": True, "in_circuit_quads": [(1, 2)], "inner_quads": [(1, 2)], "artifact_stem": None,
           "seconds": {"prove": 1.0}, "rss_mib": [["synthesis", 10.0, 12.0]],
           "public_inputs": [1]}
    line = outer_prove.result_line(res)
    assert line["in_circuit_quads_equal_host"] is True and line["proof_sha256"] == hashlib.sha256(b"abc").hexdigest()
    assert json.loads(json.dumps(line)) == line
    res["in_circuit_quads"] = [(1, 3)]
    assert outer_prove.result_line(res)["in_circuit_quads_equal_host"] is False


# ---------------------------------------------------------------------------
# the card, the trace, the boundaries
# ---------------------------------------------------------------------------


def test_runner_asked_for_the_card_raises_without_one(card):
    if card:
        pytest.skip("a CUDA device is visible: the no-card path does not apply")
    for name in CELLS:
        with pytest.raises(RuntimeError, match="cuda"):
            runner.run_cell(name, 0)
        with pytest.raises(RuntimeError, match="cuda"):
            runner.main(["--cell", name, "--seed", "0"])


def test_outer_cell_refuses_the_cpu():
    for name in OUTER_CELLS:
        with pytest.raises(ValueError, match="card only"):
            runner.run_cell(name, 0, device="cpu")


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError, match="unknown cell"):
        runner.run_cell("no_such_cell", 0, device="cpu")


def test_host_probe_times_a_fixed_workload(monkeypatch):
    monkeypatch.setattr(runner, "PROBE_PRODUCTS", 1000)
    assert 0 < runner.host_probe_ms() < 10_000


def trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_device_busy_share_from_a_chrome_trace(tmp_path):
    """The union of the device's spans over the window of every event:
    overlapping kernels count once, host events only widen the window."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 100, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 500, "dur": 50},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 520, "dur": 10},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 5000},
        {"ph": "X", "cat": "python_function", "name": "f", "ts": 1000, "dur": 100},
    ]
    busy = runner.device_busy(trace_file(tmp_path, events))
    assert busy == {"share": 200 / 1000, "busy_ms": 0.2, "window_ms": 1.0, "device_events": 4}


def test_device_busy_without_device_events_is_not_measured(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 100, "dur": 900}]
    assert runner.device_busy(trace_file(tmp_path, events)) == {"share": "not measured", "device_events": 0}


def test_quartiles_and_spread():
    assert runner.quartiles([4.0]) == {"n": 1, "q1": 4.0, "median": 4.0, "q3": 4.0}
    assert runner.quartiles([1.0, 2.0, 3.0, 4.0, 5.0]) == {"n": 5, "q1": 2.0, "median": 3.0, "q3": 4.0}
    from benchmark import spread

    assert spread.spread([2.0, 3.0])["widest_over_min"] == 0.5
    assert spread.spread([2.0, 3.0, 4.0])["widest_over_median"] == pytest.approx(2 / 3)


def test_environment_is_restored(monkeypatch):
    monkeypatch.setenv("H2A_BENCH_TRIALS", "5")
    monkeypatch.delenv("H2A_PROFILE", raising=False)
    with runner.environment({"H2A_BENCH_TRIALS": "25", "H2A_PROFILE": "x"}):
        assert runner.os.environ["H2A_BENCH_TRIALS"] == "25"
    assert runner.os.environ["H2A_BENCH_TRIALS"] == "5" and "H2A_PROFILE" not in runner.os.environ


def test_benchmark_imports_no_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|(import|from)\s+halo2_aggregation_tpu(?!_torch)\b)", re.M)
    files = sorted((ROOT / "benchmark").glob("*.py"))
    assert files and not [f.name for f in files if pattern.search(f.read_text())]
