"""The aggregation proper (N > 1 inner proofs in one outer circuit) through
the port's outer driver, `tools/outer_prove.py`, against the JAX package and
the checked-in artifacts `docs/artifacts/outer_n2_k22{,b}` and
`outer_n4_k23`, and at N = 8 (k = 24) and at N = 2 over witness offsets 4
and 6 (the recursion tree's new leaves, `tools/tree_prove.py`), where no
artifact exists, against the JAX package and the public inputs' SHA-256
pinned in `outer_prove.PIS_SHA256`; the level-3 node's public inputs over
`level2_n2_k23` against the JAX package's; and the
commands' checks that hold a card run to them (`--expect`, `run_checks`,
`level2_prove --children`) and the RSS of each stage they print.

Phases A-B (the inner proofs at k = 9 with the Poseidon transcript, seed
42 + i, and the outer circuit's public inputs) run here in seconds; the
synthesis at N = 2 (phase C, 2.67M rows) and at N = 8 (about 10.7M rows,
port only: the JAX side needs about 55 GB there) is marked slow, as the JAX
package's own N > 1 synthesis tests are.  Exact equality throughout."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from halo2_aggregation_tpu.models import aggregation_circuit as ac_r
from halo2_aggregation_tpu.models import simple_example as se_r
from halo2_aggregation_tpu.plonk import kzg as kzg_r
from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
from halo2_aggregation_tpu.plonk.prover import create_proof as create_proof_r
from halo2_aggregation_tpu.plonk.verifier import verify_proof as verify_proof_r
from halo2_aggregation_tpu.utils.transcript import PoseidonRead as PoseidonRead_r
from halo2_aggregation_tpu.utils.transcript import PoseidonWrite as PoseidonWrite_r
from halo2_aggregation_tpu_torch.config import H2AConfig
from halo2_aggregation_tpu_torch.models import aggregation_circuit as ac
from halo2_aggregation_tpu_torch.tools import level2_prove, outer_prove
from halo2_aggregation_tpu_torch.utils import artifacts

torch.set_num_threads(1)  # small tensors; the test workers share the cores

ART = Path(__file__).resolve().parents[1] / "docs" / "artifacts"
K_INNER = 9
#: (N, witness offset, the artifact made from that window; None where no
#: artifact exists: the recursion tree's two new leaves and N = 8)
RUNS = [(2, 0, "outer_n2_k22"), (2, 2, "outer_n2_k22b"), (4, 0, "outer_n4_k23"), (8, 0, None),
        (2, 4, None), (2, 6, None)]
#: the N = 2 synthesis' rows (docs/PHASE_D_n2b_k22_dq_run.log:4)
ROWS_N2 = 2673963


def cfg_of(n: int) -> H2AConfig:
    return H2AConfig(k_inner=K_INNER, k_outer=21 + (n - 1).bit_length(), num_proofs=n, constrained_fs=True)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's inner proofs, as `examples/simple_example.py`
    makes them: for witness window [off, off + N), proof i of seed 42 + i.
    A function of (N, offset) -> (vk, proofs, inst_comms, efws)."""
    params = kzg_r.setup(K_INNER)
    made = {}

    def proof(w: int, seed: int):
        if (w, seed) not in made:
            a, b = outer_prove.WITNESSES[w]
            circuit = se_r.MyCircuit(constant=7, a=a, b=b)
            cs_e, _, asg_e = se_r.build(circuit.without_witnesses(), k=K_INNER)
            vk, pk = keygen_r(params, cs_e, asg_e)
            _, _, asg = se_r.build(circuit, k=K_INNER)
            pub = [circuit.public_output()]
            p = create_proof_r(params, pk, asg, [pub], seed=seed, transcript_cls=PoseidonWrite_r)
            ok, efw = verify_proof_r(params, vk, [pub], p, transcript_cls=PoseidonRead_r)
            assert ok
            made[w, seed] = (vk, p, params.commit_lagrange(pub), tuple(efw))
        return made[w, seed]

    def window(n: int, off: int):
        got = [proof(off + i, 42 + i) for i in range(n)]
        return got[0][0], [g[1] for g in got], [g[2] for g in got], [g[3] for g in got]

    return window


@pytest.fixture(scope="module")
def port():
    """The port's phases A-B a run: (inner, outer circuit, public inputs)."""
    made = {}

    def run(n: int, off: int):
        if (n, off) not in made:
            cfg = cfg_of(n)
            inner = outer_prove.inner_proofs(cfg, off)
            made[n, off] = (inner, *outer_prove.outer_circuit(cfg, inner))
        return made[n, off]

    return run


@pytest.mark.parametrize("n,off,stem", RUNS)
def test_inner_proofs_equal_the_jax_package(n, off, stem, reference, port):
    """Phase A: each inner proof's bytes, instance commitment and host
    quad equal the JAX package's `create_proof` (PoseidonWrite, seed
    42 + i) and `verify_proof`."""
    vk_r, proofs_r, comms_r, efws_r = reference(n, off)
    inner, _, _ = port(n, off)
    assert len(inner["proofs"]) == n and all(len(p) == 1248 for p in inner["proofs"])
    assert inner["proofs"] == proofs_r
    assert [tuple(c) for c in inner["inst_comms"]] == [tuple(c) for c in comms_r]
    assert [tuple(map(tuple, q)) for q in inner["efws"]] == [tuple(map(tuple, q)) for q in efws_r]
    assert inner["vk"].hash_scalar() == vk_r.hash_scalar()


@pytest.mark.parametrize("n,off,stem", RUNS)
def test_public_inputs_equal_the_jax_package_and_the_meta(n, off, stem, reference, port):
    """Phase B: the `AggregationCircuit`'s 40 N + 16 public inputs equal
    the JAX package's `AggregationCircuit.public_inputs` over its own inner
    proofs and the artifact meta's; at N = 8, where no artifact exists,
    their SHA-256 is the one `outer_prove.run_checks` holds a card run to
    (N = 8 and the tree's leaves at witness offsets 4 and 6)."""
    vk_r, proofs_r, comms_r, efws_r = reference(n, off)
    _, outer, pis = port(n, off)
    want = ac_r.AggregationCircuit(vk_r, proofs_r, num_proofs=n, constrained_fs=True).public_inputs(comms_r, efws_r)
    assert type(outer).__name__ == "AggregationCircuit" and outer.num_proofs == n and outer.constrained_fs
    assert len(pis) == 40 * n + 16 == {2: 96, 4: 176, 8: 336}[n]
    assert pis == [int(v) for v in want]
    if stem is None:
        assert outer_prove.pis_sha256(want) == outer_prove.PIS_SHA256[n, off, True]
    else:
        meta = json.loads((ART / f"{stem}.meta.json").read_text())
        assert pis == [int(v) for v in meta["public_inputs"]]
        assert (n, off, True) not in outer_prove.PIS_SHA256


def test_level3_public_inputs_equal_the_jax_package():
    """Phase B one level up: the level-3 node's `AggregationCircuit` over
    `level2_n2_k23` in both slots (its vk loaded by each package's own
    `load_vk`, the node's default transcript) has the JAX package's 96
    public inputs; the vk is the level-2 node's, at k = 23."""
    from halo2_aggregation_tpu.utils.artifacts import load_vk as load_vk_r

    stem = str(ART / "level2_n2_k23")
    proof = (ART / "level2_n2_k23.proof").read_bytes()
    meta = json.loads((ART / "level2_n2_k23.meta.json").read_text())
    efw = tuple(tuple(int(c) for c in p) for p in meta["efw"])
    inst_comm = tuple(int(c) for c in meta["inst_comm"])
    vk, vk_r = artifacts.load_vk(stem), load_vk_r(stem)
    assert vk.k == vk_r.k == 23 and vk.hash_scalar() == vk_r.hash_scalar()
    got = ac.AggregationCircuit(vk, [proof, proof], num_proofs=2).public_inputs([inst_comm] * 2, [efw] * 2)
    want = ac_r.AggregationCircuit(vk_r, [proof, proof], num_proofs=2).public_inputs([inst_comm] * 2, [efw] * 2)
    assert len(got) == 96 and got == [int(v) for v in want]
    # the node's instance: each child's instance commitment and quad, then the fold
    assert got != [int(v) for v in meta["public_inputs"]]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("constrained_fs", [True, False])
def test_fold_quads_host_equals_the_jax_package(n, constrained_fs, reference):
    """The host fold the in-circuit fold is held to (W, RHS under the
    Poseidon or the Blake2b lambda), port against JAX, over the window's
    inner quads; the lambdas too."""
    efws = reference(n, 0)[3]
    assert ac.fold_quads_host(efws, constrained_fs=constrained_fs) == ac_r.fold_quads_host(
        efws, constrained_fs=constrained_fs)
    assert ac.aggregate_lambda(efws) == ac_r.aggregate_lambda(efws)
    assert ac.aggregate_lambda_poseidon(efws) == ac_r.aggregate_lambda_poseidon(efws)
    assert ac.aggregate_lambda(efws) != ac.aggregate_lambda_poseidon(efws)


def result_of(stem: Path) -> dict:
    """What `run_outer` returns for the keys `expect_checks` reads, taken
    from an artifact."""
    meta = json.loads(stem.with_suffix(".meta.json").read_text())
    return {
        "vk": artifacts.load_vk(str(stem)), "proof": stem.with_suffix(".proof").read_bytes(),
        "public_inputs": [int(v) for v in meta["public_inputs"]],
        "efw": tuple(tuple(int(c) for c in p) for p in meta["efw"]),
        "inst_comm": tuple(int(c) for c in meta["inst_comm"]), "verified": True,
        "num_proofs": meta["num_proofs"], "k_outer": meta["k"], "rows": 0, "in_circuit_quads": [],
        "inner_quads": [], "artifact_stem": None, "seconds": {}, "rss_mib": [["synthesis", 10.0, 12.0]],
    }


def run_result(inner: dict, pis: list, n: int) -> dict:
    """What `run_outer` returns for the keys `run_checks` reads, from the
    port's phases A-B: every check true (the card's verify stubbed)."""
    vk = type("VK", (), {"n": 16, "cs": type("CS", (), {"usable_rows": lambda self, n: n - 6})()})()
    return {
        "num_proofs": n, "witness_offset": 0, "constrained_fs": True, "rows": 10,
        "inner_verified": list(inner["verified"]), "inner_quads": list(inner["efws"]),
        "in_circuit_quads": list(inner["efws"]),
        "in_circuit_fold": ac.fold_quads_host(inner["efws"], constrained_fs=True) if n > 1 else None,
        "verified": True, "params": None, "vk": vk, "public_inputs": list(pis), "proof": b"proof", "efw": ((1, 2),),
    }


def copy_stem(name: str, dst: Path) -> Path:
    for ext in (".proof", ".vk.npz", ".meta.json"):
        shutil.copy(ART / f"{name}{ext}", dst / f"{name}{ext}")
    return dst / name


def change(stem: Path, what: str) -> str:
    """One change to a copied stem; returns the check it must turn false."""
    if what == "proof":
        b = bytearray(stem.with_suffix(".proof").read_bytes())
        b[100] ^= 1
        stem.with_suffix(".proof").write_bytes(bytes(b))
        return "proof_equal_to_artifact"
    if what == "vk":
        # another circuit's vk, a valid file of its own
        artifacts.save_vk_npz(str(stem.parent / f"{stem.name}.vk.npz"), artifacts.load_vk(str(ART / "outer_n1_k21")))
        return "vk_equal_to_artifact"
    meta = json.loads(stem.with_suffix(".meta.json").read_text())
    key = {"pis": "public_inputs", "efw": "efw", "inst_comm": "inst_comm"}[what]
    if key == "efw":
        meta[key][0][0] = str(int(meta[key][0][0]) + 1)
    else:
        meta[key][0] = str(int(meta[key][0]) + 1)
    stem.with_suffix(".meta.json").write_text(json.dumps(meta))
    return f"{what}_equal_to_meta"


@pytest.mark.parametrize("what", ["proof", "vk", "pis", "efw", "inst_comm"])
def test_expect_checks_fail_on_one_change(what, tmp_path):
    """`--expect`'s comparison: a copied stem matches the artifact's run;
    one byte of the proof, another vk or one value of the meta turns
    exactly that check false."""
    stem = copy_stem("outer_n2_k22", tmp_path)
    res = result_of(ART / "outer_n2_k22")
    assert all(outer_prove.expect_checks(res, str(stem)).values())
    broken = change(stem, what)
    checks = outer_prove.expect_checks(res, str(stem))
    assert [k for k, ok in checks.items() if not ok] == [broken]


def test_expect_ignores_the_witness_offset_key(tmp_path):
    """A level-1 meta the port writes has `witness_offset`, the checked-in
    N = 2 and N = 4 metas do not: not compared."""
    stem = copy_stem("outer_n4_k23", tmp_path)
    meta = json.loads(stem.with_suffix(".meta.json").read_text())
    assert "witness_offset" not in meta
    meta["witness_offset"] = 0
    stem.with_suffix(".meta.json").write_text(json.dumps(meta))
    assert all(outer_prove.expect_checks(result_of(ART / "outer_n4_k23"), str(stem)).values())


def test_main_exits_1_when_expect_differs(tmp_path, monkeypatch, capsys):
    """`outer_prove --expect STEM` exits 0 on an equal run, 1 after one
    byte of the stem's proof changes (the run itself stubbed by the
    artifact's own values, its `run_checks` by true)."""
    stem = copy_stem("outer_n2_k22b", tmp_path)
    monkeypatch.setattr(outer_prove, "run_outer", lambda *a, **k: result_of(ART / "outer_n2_k22b"))
    monkeypatch.setattr(outer_prove, "run_checks", lambda res: {"verified": res["verified"]})
    assert outer_prove.main(["--expect", str(stem)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["proof_equal_to_artifact"] is True and line["peak_rss_mib"] > 0
    change(stem, "proof")
    assert outer_prove.main(["--expect", str(stem)]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["proof_equal_to_artifact"] is False


@pytest.mark.parametrize("n", [2, 8])
def test_run_checks_turn_false_one_at_a_time(n, port, monkeypatch):
    """`run_checks` over a run built from the port's phases A-B (the card's
    `verify_batch` stubbed): all true, with the pinned SHA-256 at N = 8
    only; each one change turns exactly its check false."""
    inner, _, pis = port(n, 0)
    verdicts = {"accept": True, "flipped": "check_failed"}
    monkeypatch.setattr(outer_prove, "verify_on_device", lambda *a: (verdicts["accept"], {}))
    monkeypatch.setattr(outer_prove, "flipped_byte_verdict", lambda *a: verdicts["flipped"])
    res = run_result(inner, pis, n)
    checks = outer_prove.run_checks(res, "cpu")
    assert all(checks.values()) and ("pis_sha256_equal_to_pinned" in checks) == (n == 8)
    assert "fold_equal_to_host" in checks
    other = inner["efws"][1]
    changes = {
        "inner_proofs_verified": ("inner_verified", [True] * (n - 1) + [False]),
        "rows_fit": ("rows", 11),
        "in_circuit_quads_equal_host": ("in_circuit_quads", [other] * n),
        "fold_equal_to_host": ("in_circuit_fold", (1, 2)),
        "verified": ("verified", False),
        "pis_sha256_equal_to_pinned": ("public_inputs", [*pis[:-1], pis[-1] + 1]),
    }
    for check, (key, value) in changes.items():
        if check not in checks:
            continue
        checks = outer_prove.run_checks({**res, key: value}, "cpu")
        assert [k for k, ok in checks.items() if not ok] == [check], check
    for key, value, check in (("accept", False, "verify_batch_b1_accepts"), ("flipped", None, "flipped_byte_rejected")):
        saved, verdicts[key] = verdicts[key], value
        checks = outer_prove.run_checks(res, "cpu")
        assert [k for k, ok in checks.items() if not ok] == [check]
        verdicts[key] = saved


def test_main_exits_1_when_a_run_check_fails(monkeypatch, capsys):
    """Without `--expect`, `main` holds the run to `run_checks` alone."""
    monkeypatch.setattr(outer_prove, "run_outer", lambda *a, **k: result_of(ART / "outer_n2_k22b"))
    monkeypatch.setattr(outer_prove, "run_checks", lambda res: {"verified": True, "rows_fit": True})
    assert outer_prove.main([]) == 0
    monkeypatch.setattr(outer_prove, "run_checks", lambda res: {"verified": True, "rows_fit": False})
    assert outer_prove.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rows_fit"] is False and line["expect"] is None and line["host_mem_total_mib"] > 0


def test_result_line_carries_the_rss_of_each_stage():
    """`result_line` beside `seconds`: the [stage, RSS, peak] rows, the
    stage during which the peak was reached, the host's MemTotal, the
    public inputs' SHA-256."""
    res = {**result_of(ART / "outer_n2_k22b"), "rss_mib": [
        ["inner_proofs", 200.0, 210.0], ["synthesis", 900.0, 950.0], ["keygen: fixed committed", 1500.0, 1600.0],
        ["prove: evaluations", 1400.0, 2400.0], ["prove: multiopen witnesses", 1450.0, 2400.0],
        ["verify", 800.0, 2400.0]]}
    line = outer_prove.result_line(res)
    assert line["rss_mib"] == res["rss_mib"] and line["peak_rss_stage"] == "prove: evaluations"
    assert 0 < line["host_mem_total_mib"] and line["pis_sha256"] == outer_prove.pis_sha256(res["public_inputs"])
    assert json.loads(json.dumps(line)) == line


def test_stages_record_rss_at_each_message():
    """`Stages` keeps [message, seconds] rows (the benchmark sums them) and
    [message, RSS, peak] rows: the RSS of /proc/self/statm, the peak of
    `ru_maxrss`, which grows with a large array."""
    import numpy as np

    stages = outer_prove.Stages()
    stages("before")
    big = np.ones(64 << 20, np.uint8)
    stages("after")
    assert [r[0] for r in stages.rows] == [r[0] for r in stages.memory] == ["before", "after"]
    assert all(len(r) == 2 for r in stages.rows) and all(len(r) == 3 for r in stages.memory)
    (_, rss0, peak0), (_, rss1, peak1) = stages.memory
    assert 0 < rss0 <= peak0 <= peak1 and rss1 >= rss0 + 60 and int(big.sum()) == 64 << 20
    assert outer_prove.peak_rss_stage(stages.memory) == "after" and outer_prove.peak_rss_stage([]) is None


def test_prove_and_save_records_rss_in_run_order(monkeypatch):
    """`prove_and_save`'s `rss_mib`: setup, the upload, each of keygen's
    and the prove's `progress` stages (prefixed), then the verify."""
    from halo2_aggregation_tpu_torch.plonk import keygen_device, kzg, prover_device, verifier

    class SRS:
        n, device = 4, torch.device("cpu")

        def __init__(self, *a):
            pass

        def commit_lagrange(self, values):
            return (1, 2)

    def keygen(*a, progress, **k):
        progress("fixed committed")
        progress("permutation arrays")
        return "vk", "pk"

    def prove(*a, progress, **k):
        progress("advice committed")
        return b"p"

    monkeypatch.setattr(kzg, "setup", lambda k, device=None: type("P", (), {"n": 4})())
    monkeypatch.setattr(kzg, "DeviceSRS", SRS)
    monkeypatch.setattr(keygen_device, "keygen_device", keygen)
    monkeypatch.setattr(prover_device, "create_proof_device", prove)
    monkeypatch.setattr(verifier, "verify_proof", lambda *a: (True, None))
    res = outer_prove.prove_and_save("cs", "asg", [1], 2, seed=1, device="cpu")
    assert [r[0] for r in res["rss_mib"]] == ["setup", "srs_upload", "keygen: fixed committed",
                                              "keygen: permutation arrays", "prove: advice committed", "verify"]
    assert all(0 < r[1] <= r[2] for r in res["rss_mib"])
    assert [r[0] for r in res["seconds"]["keygen_stages"]] == ["fixed committed", "permutation arrays"]


def test_main_refuses_a_missing_expect_stem_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(outer_prove, "run_outer", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(SystemExit):
        outer_prove.main(["--expect", str(tmp_path / "nothing")])


def test_level2_children_parsing():
    """`--children A B`: two stems, by default the checked-in pair."""
    args = level2_prove.parse_args([])
    assert [Path(c) for c in args.children] == [ART / "outer_n2_k22", ART / "outer_n2_k22b"]
    assert args.out_stem == str(Path("build") / "level2" / "level2_n2_k23")
    args = level2_prove.parse_args(["--children", "build/port_art/outer_n2_k22", "build/port_art/outer_n2_k22b",
                                    "--out", "build/port_l2"])
    assert args.children == ["build/port_art/outer_n2_k22", "build/port_art/outer_n2_k22b"]
    assert args.out_stem == str(Path("build") / "port_l2" / "level2_n2_k23")
    with pytest.raises(SystemExit):
        level2_prove.parse_args(["--children", "only_one"])


def test_level2_refuses_docs_artifacts_before_any_work(monkeypatch):
    from halo2_aggregation_tpu_torch.aggregation import tree

    monkeypatch.setattr(tree, "prove_node", lambda *a, **k: pytest.fail("proved"))
    with pytest.raises(ValueError, match="checked-in"):
        level2_prove.main(["--out", str(ART)])


@pytest.mark.parametrize("flip", [False, True])
def test_level2_main_holds_the_node_to_the_artifact(flip, tmp_path, monkeypatch, capsys):
    """`level2_prove`'s comparison of the node it proved (`prove_node`
    stubbed by a copy of `level2_n2_k23`) with the checked-in node: exit 0
    when equal, 1 with one byte of the proof flipped."""
    from halo2_aggregation_tpu_torch.aggregation import tree

    node = copy_stem("level2_n2_k23", tmp_path)
    if flip:
        change(node, "proof")
    got = {}
    monkeypatch.setattr(tree, "prove_node", lambda *a, **k: got.update(children=a, **k) or str(node))
    argv = ["--out", str(tmp_path), "--children", "a", "b"]
    assert level2_prove.main(argv) == (1 if flip else 0)
    assert got["children"] == ("a", "b") and got["out_stem"] == str(node) and got["k"] == 23
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["proof_equal_to_artifact"] is not flip and line["vk_equal_to_artifact"] is True
    assert line["efw_equal_to_meta"] and line["inst_comm_equal_to_meta"] and line["pis_equal_to_meta"]


@pytest.mark.slow
def test_phase_c_two_proofs(reference, port):
    """Phase C at N = 2 (`outer_prove.synthesize`, k = 22): each in-circuit
    quad equals the JAX package's host quad, the gadget's Poseidon lambda
    the JAX `aggregate_lambda_poseidon`, the in-circuit fold the JAX
    `fold_quads_host`, and the rows those of the run that made
    `outer_n2_k22b` (as `tests/test_aggregation.py`'s constrained N = 2
    test, on the port)."""
    _, _, _, efws_r = reference(2, 0)
    inner, outer, pis = port(2, 0)
    cs, asg, rows, quads, fold = outer_prove.synthesize(cfg_of(2), outer, pis, inner["efws"])
    assert quads == [tuple(q) for q in efws_r]
    assert outer.last_lambda.value == ac_r.aggregate_lambda_poseidon(efws_r)
    assert fold == ac_r.fold_quads_host(efws_r, constrained_fs=True)
    assert rows == ROWS_N2 and rows <= cs.usable_rows(1 << 22)


def phase_c_port_only(n: int, port) -> None:
    """Phase C at N proofs on the port alone: `synthesize` (which raises
    unless every in-circuit quad equals the host verifier's and the fold
    `fold_quads_host`'s), each quad and the fold once more, the rows within
    `cs.usable_rows(2^k)`, and the rows of the affine line through N = 1, 2
    and 4 (`docs/AGGREGATION_SCALING.md`) within 3 % (the constrained
    transcript adds rows a proof)."""
    inner, outer, pis = port(n, 0)
    cfg = cfg_of(n)
    cs, asg, rows, quads, fold = outer_prove.synthesize(cfg, outer, pis, inner["efws"])
    assert quads == [tuple(q) for q in inner["efws"]] and len(quads) == n
    assert fold == ac.fold_quads_host(inner["efws"], constrained_fs=True)
    assert outer.last_lambda.value == ac.aggregate_lambda_poseidon(inner["efws"])
    assert rows <= cs.usable_rows(1 << cfg.k_outer) and asg.n == 1 << cfg.k_outer
    assert abs(rows - (1300406 * n - 7300)) < 0.03 * rows


@pytest.mark.slow
def test_phase_c_eight_proofs(port):
    """Phase C at N = 8, k = 24 against the host's quads and fold, port
    only (the JAX package's synthesis needs about 55 GB here,
    tests/test_aggregation.py)."""
    phase_c_port_only(8, port)


@pytest.mark.slow
def test_level3_synthesis_equals_the_jax_package():
    """The level-3 node's synthesis (`prove_node`'s circuit one level up)
    over `level2_n2_k23` in both slots at k = 23, port against the JAX
    package's `ac.build` on the same proof, vk file and public inputs: the
    same rows, in-circuit quads and fold; the quads are the meta's and the
    rows fit k = 23.  The JAX side runs first and is freed before the port's
    (each about 2 min here)."""
    import gc

    from halo2_aggregation_tpu.utils.artifacts import load_vk as load_vk_r

    stem = str(ART / "level2_n2_k23")
    proof = (ART / "level2_n2_k23.proof").read_bytes()
    meta = json.loads((ART / "level2_n2_k23.meta.json").read_text())
    efw = tuple(tuple(int(c) for c in p) for p in meta["efw"])
    inst_comm = tuple(int(c) for c in meta["inst_comm"])

    def synthesis(ac_mod, vk) -> tuple:
        circ = ac_mod.AggregationCircuit(vk, [proof, proof], num_proofs=2)
        pis = circ.public_inputs([inst_comm] * 2, [efw] * 2)
        cs, _, _, ctx, (quads, W, RHS) = ac_mod.build(circ, 23, pis)
        def point(cell):
            return tuple(int(c) for c in cell.value())

        got = [(point(q.e), point(q.f), point(q.w), point(q.zw)) for q in quads]
        return ctx.offset, cs.usable_rows(1 << 23), got, (point(W), point(RHS))

    want = synthesis(ac_r, load_vk_r(stem))
    gc.collect()
    got = synthesis(ac, artifacts.load_vk(stem))
    assert got == want
    rows, usable, quads, fold = got
    assert quads == [efw, efw] and fold == ac.fold_quads_host([efw, efw]) and rows <= usable
