"""The recursion tree through the port: `tools/tree_prove.py` (four N = 2
leaves folded by `aggregation/tree.py::run_tree` up to a level-3 root) and
`tools/level2_probe.py`, on the port alone.

The proves are stubbed by copies of the checked-in stems (as
`test_torch_aggregation.py::test_level2_main_holds_the_node_to_the_artifact`
does): the command's checks each turn false on their own and the command
then exits 1; the resume run proves nothing; `NodeProver` records what the
real `prove_node` reports (its synthesis, SRS, verify and prove stubbed).
Marked slow: the level-3 node's synthesis over `docs/artifacts/
level2_n2_k23` in both slots at k = 23 (the in-circuit quads equal to the
meta's, the fold to `fold_quads_host`, its rows pinned), and `level2_probe`
over the checked-in level-1 pair (4,271,581 rows, k = 23,
`docs/level2_probe_run.log`).  No JAX here: the file also runs where only
the port is installed (`pytest --noconftest`)."""

import json
import os
import shutil
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

from halo2_aggregation_tpu_torch.aggregation import tree
from halo2_aggregation_tpu_torch.models import aggregation_circuit as ac
from halo2_aggregation_tpu_torch.plonk import kzg, verifier
from halo2_aggregation_tpu_torch.tools import level2_probe, outer_prove, tree_prove
from halo2_aggregation_tpu_torch.utils import artifacts

torch.set_num_threads(1)  # small tensors; the test workers share the cores

ART = Path(__file__).resolve().parents[1] / "docs" / "artifacts"
NODES = ["tree_l2_i0_k23", "tree_l2_i1_k23", "tree_l3_i0_k23"]
#: the level-3 node's rows over two level-2 children, as the JAX package's
#: `ac.build` synthesises the same circuit
#: (`test_torch_aggregation.py::test_level3_synthesis_equals_the_jax_package`,
#: which needs JAX; this file's slow test holds the port to the number
#: where only the port is installed): the level-2 node's 4,271,581 and one
#: row a child for its x^n's one more squaring (k = 23 children)
ROWS_LEVEL3 = 4271583
NODE_CHECKS = ["verified", "verify_batch_b1_accepts", "flipped_byte_rejected", "level", "children"]


def copy_stem(name: str, dst: Path, as_name: str = None) -> Path:
    dst.mkdir(parents=True, exist_ok=True)
    for ext in (".proof", ".vk.npz", ".meta.json"):
        shutil.copy(ART / f"{name}{ext}", dst / f"{as_name or name}{ext}")
    return dst / (as_name or name)


def flip(stem: Path, at: int) -> None:
    b = bytearray(stem.with_suffix(".proof").read_bytes())
    b[at] ^= 1
    stem.with_suffix(".proof").write_bytes(bytes(b))


class Value:
    """A synthesised cell's stand-in: `value()` only."""

    def __init__(self, v):
        self.v = v

    def value(self):
        return self.v


def meta_efw(name: str) -> tuple:
    meta = json.loads((ART / f"{name}.meta.json").read_text())
    return tuple(tuple(int(c) for c in p) for p in meta["efw"])


class Tree:
    """`tree_prove.main` over stubs: leaves w4 and w6 copies of
    `outer_n2_k22` with one byte changed, every node a copy of
    `level2_n2_k23` with the meta `prove_node` writes, the host verify and
    the card's verify_batch by call order (l2_i0, l2_i1, root).  `fault`
    names one check to turn false."""

    def __init__(self, tmp_path, monkeypatch, fault=None):
        self.out = tmp_path / "tree"
        self.fault = fault
        self.proved = []
        self.levels = {}
        self.counts = {"verify": 0, "batch": 0, "flip": 0}
        monkeypatch.setattr(tree_prove, "prove_leaf", self.prove_leaf)
        monkeypatch.setattr(tree, "prove_node", self.prove_node)
        monkeypatch.setattr(kzg, "setup", lambda k, device=None: None)
        monkeypatch.setattr(verifier, "verify_proof", self.verify_proof)
        monkeypatch.setattr(outer_prove, "verify_on_device", self.verify_on_device)
        monkeypatch.setattr(outer_prove, "flipped_byte_verdict", self.flipped)
        run_tree = tree.run_tree
        self.tree_runs = 0

        def counting_run_tree(*args, **kwargs):
            self.tree_runs += 1
            if self.tree_runs == 2 and self.fault == "resume_proves_nothing":
                os.remove(self.out / "tree.jsonl")
            root = run_tree(*args, **kwargs)
            return root + "_other" if self.tree_runs == 2 and self.fault == "resume_same_root" else root

        monkeypatch.setattr(tree, "run_tree", counting_run_tree)

    def faulty(self, node: str, check: str) -> bool:
        return self.fault == f"{node}.{check}"

    def prove_leaf(self, offset, out, device, progress):
        progress("leaf proved")
        stem = copy_stem("outer_n2_k22", Path(out), f"outer_n2_k22w{offset}")
        flip(stem, 200 + offset)  # distinct leaves, distinct node keys
        checks = {"verified": not self.fault == f"leaf_w{offset}.verified", "pis_sha256_equal_to_pinned": True}
        return str(stem), {"witness_offset": offset}, checks

    def prove_node(self, a, b, k=23, out_stem=None, seed=2, progress=None, device="cuda"):
        name = os.path.basename(out_stem)
        self.proved.append((name, seed, str(device)))
        progress("children re-verify natively (0.1s)")
        progress(f"node circuit synthesized: 1000 rows @ k={k} (1s); quads + fold match")
        stem = copy_stem("level2_n2_k23", Path(out_stem).parent, name)
        if name == "tree_l2_i0_k23" and self.fault == "tree_l2_i0_k23.proof_equal_to_artifact":
            flip(stem, 100)
        if name == "tree_l2_i1_k23" and self.fault == "level2_vks_equal":
            shutil.copy(ART / "outer_n2_k22.vk.npz", stem.with_suffix(".vk.npz"))
        level = max(self.levels.get(s, 1) for s in (a, b)) + 1  # as prove_node derives it
        self.levels[out_stem] = level
        meta = json.loads(stem.with_suffix(".meta.json").read_text())
        meta["level"] = level + self.faulty(name, "level")
        meta["children"] = [b, a] if self.faulty(name, "children") else [a, b]
        stem.with_suffix(".meta.json").write_text(json.dumps(meta))
        return out_stem

    def nth(self, what: str) -> str:
        i = self.counts[what]
        self.counts[what] += 1
        return NODES[i % 3]

    def verify_proof(self, params, vk, pis, proof):
        return not self.faulty(self.nth("verify"), "verified"), meta_efw("level2_n2_k23")

    def verify_on_device(self, params, vk, pis, proofs, efws, device):
        return not self.faulty(self.nth("batch"), "verify_batch_b1_accepts"), {}

    def flipped(self, params, vk, pis, proofs, device):
        return None if self.faulty(self.nth("flip"), "flipped_byte_rejected") else "check_failed"

    def run(self, capsys) -> tuple:
        rc = tree_prove.main(["--out", str(self.out)], device="cpu")
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        return rc, line


def test_tree_prove_all_checks_hold(tmp_path, monkeypatch, capsys):
    """Every check true: exit 0; three nodes proved with seed 2 over the
    checked-in pair, the two new leaves and the two level-2 stems; the
    resume run proves nothing; each node's record beside it."""
    t = Tree(tmp_path, monkeypatch)
    rc, line = t.run(capsys)
    assert rc == 0 and line["ok"] is True and all(line["checks"].values())
    assert [p[0] for p in t.proved] == NODES and {p[1] for p in t.proved} == {2}
    assert line["node_proves"] == 3 and line["checks"]["resume_proves_nothing"] and t.tree_runs == 2
    stems = line["stems"]
    assert stems[:2] == [os.path.relpath(ART / n) for n in ("outer_n2_k22", "outer_n2_k22b")]
    assert stems[2:] == [str(t.out / "outer_n2_k22w4"), str(t.out / "outer_n2_k22w6")]
    assert line["root"] == str(t.out / "tree_l3_i0_k23")
    checks = line["checks"]
    for node in ("tree_l2_i0_k23", "tree_l2_i1_k23", "tree_l3_i0_k23"):
        assert [c for c in NODE_CHECKS if f"{node}.{c}" in checks] == NODE_CHECKS
    for c in ("proof_equal_to_artifact", "vk_equal_to_artifact", "pis_equal_to_meta", "efw_equal_to_meta",
              "inst_comm_equal_to_meta"):
        assert checks[f"tree_l2_i0_k23.{c}"] is True
    assert {"leaf_w4.verified", "leaf_w6.pis_sha256_equal_to_pinned", "level2_vks_equal",
            "resume_same_root"} <= set(checks)
    nodes = line["nodes"]
    assert [n["rows"] for n in nodes] == [1000] * 3
    assert all(list(n["seconds"]) == ["reverify", "synthesis"] for n in nodes)
    assert nodes[2]["children"] == [str(t.out / "tree_l2_i0_k23"), str(t.out / "tree_l2_i1_k23")]
    assert json.loads((t.out / "tree_l3_i0_k23.meta.json").read_text())["level"] == 3
    assert set(line["vk_hash"]) == {"level1", "level2", "level3"} and "level3_vk_differs_from_level2" in line
    assert line["peak_rss_mib"] > 0 and line["host_mem_total_mib"] > 0 and line["peak_rss_stage"]


FAULTS = ([f"{node}.{c}" for node in NODES for c in NODE_CHECKS]
          + ["leaf_w4.verified", "leaf_w6.verified", "tree_l2_i0_k23.proof_equal_to_artifact", "level2_vks_equal",
             "resume_proves_nothing", "resume_same_root"])


@pytest.mark.parametrize("fault", FAULTS)
def test_tree_prove_each_check_turns_false_alone(fault, tmp_path, monkeypatch, capsys):
    """One change to a leaf, a node, the nodes' vks or the resume turns
    exactly its check false, and the command exits 1."""
    rc, line = Tree(tmp_path, monkeypatch, fault).run(capsys)
    assert rc == 1 and line["ok"] is False
    assert [k for k, ok in line["checks"].items() if not ok] == [fault]


def test_tree_prove_refuses_docs_artifacts_before_any_work(monkeypatch):
    monkeypatch.setattr(tree_prove, "prove_leaf", lambda *a: pytest.fail("proved a leaf"))
    monkeypatch.setattr(tree, "run_tree", lambda *a, **k: pytest.fail("ran the tree"))
    with pytest.raises(ValueError, match="checked-in"):
        tree_prove.main(["--out", str(ART)], device="cpu")


def test_tree_prove_leaves_flag(tmp_path, monkeypatch, capsys):
    """`--leaves A B C D`: four given stems, no leaf proved, no leaf check."""
    t = Tree(tmp_path, monkeypatch)
    monkeypatch.setattr(tree_prove, "prove_leaf", lambda *a: pytest.fail("proved a leaf"))
    given = [str(copy_stem(n, tmp_path / "given", f"{n}_{i}")) for i, n in
             enumerate(["outer_n2_k22", "outer_n2_k22b", "outer_n2_k22", "outer_n2_k22b"])]
    flip(Path(given[2]), 300)
    flip(Path(given[3]), 301)
    assert tree_prove.main(["--out", str(t.out), "--leaves", *given], device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["stems"] == given and line["leaves_given"] and line["leaves"] == []
    assert not any(k.startswith("leaf_") for k in line["checks"])
    # the first pair is byte for byte the checked-in one: the node is held to level2_n2_k23
    assert line["checks"]["tree_l2_i0_k23.proof_equal_to_artifact"] is True
    with pytest.raises(SystemExit):
        tree_prove.parse_args(["--leaves", "a", "b", "c"])


def test_node_prover_records_what_prove_node_reports(tmp_path, monkeypatch):
    """`NodeProver` over the real `prove_node` (its SRS, host verify,
    synthesis and `prove_and_save` stubbed): seed 2, the rows of its
    "synthesized" message, every message with its second and RSS, the
    stage seconds taken from them, the proof's SHA-256 and vk hash, written
    beside the node."""
    children = [str(ART / "outer_n2_k22"), str(ART / "outer_n2_k22b")]
    efws = {(ART / f"{n}.proof").read_bytes(): meta_efw(n) for n in ("outer_n2_k22", "outer_n2_k22b")}
    monkeypatch.setattr(kzg, "setup", lambda k, device=None: None)
    monkeypatch.setattr(verifier, "verify_proof", lambda params, vk, pis, proof: (True, efws[proof]))

    def build(circ, k, pis):
        quads = [NS(e=Value(q[0]), f=Value(q[1]), w=Value(q[2]), zw=Value(q[3])) for q in efws.values()]
        W, RHS = ac.fold_quads_host(list(efws.values()))
        return NS(usable_rows=lambda n: n - 10), None, "asg", NS(offset=4321), (quads, Value(W), Value(RHS))

    monkeypatch.setattr(ac, "build", build)
    got = {}

    def prove_and_save(cs, asg, pis, k, *, seed, device, stem, meta, progress):
        got.update(seed=seed, meta=meta)
        for msg in ("SRS at k = 23 ready", "keygen done", "multiopen witnesses", "proof of 2432 bytes valid"):
            progress(msg)
        copy_stem("level2_n2_k23", Path(stem).parent, Path(stem).name)
        return {"verified": True}

    monkeypatch.setattr(outer_prove, "prove_and_save", prove_and_save)
    prover = tree_prove.NodeProver(torch.device("cpu"), lambda m: None)
    stem = prover(*children, k=23, out_stem=str(tmp_path / "tree_l2_i0_k23"))
    assert stem == str(tmp_path / "tree_l2_i0_k23") and prover.calls == 1
    assert got["seed"] == 2 and got["meta"]["children"] == children and got["meta"]["level"] == 2
    rec = tree_prove.node_record(stem)
    assert rec["rows"] == 4321 and [row[0] for row in rec["progress"]][:2] == [
        "children re-verify natively (0.0s)", "node circuit synthesized: 4321 rows @ k=23 (0s); quads + fold match"]
    assert all(len(row) == 4 and row[2] > 0 and row[3] >= row[2] for row in rec["progress"])
    assert list(rec["seconds"]) == [stage for stage, _ in tree_prove.STAGE_ENDS]
    assert all(t >= 0 for t in rec["seconds"].values())
    assert rec["proof_sha256"] == tree_prove.proof_sha256(str(ART / "level2_n2_k23"))
    assert rec["vk_hash"] == str(artifacts.load_vk(str(ART / "level2_n2_k23")).hash_scalar())
    assert rec["children"] == children and len(rec["rss_at_start_mib"]) == 2
    assert rec["progress"][-1][0] == "  [node       0s] proof of 2432 bytes valid"


def test_stage_seconds_from_the_progress_rows():
    """Each stage from the end of the one before to the first message that
    holds its marker; a stage whose marker never came is left out, and the
    next is timed from the last one that came."""
    rows = [["children re-verify natively (2.0s)", 2.0], ["node circuit synthesized: 9 rows", 10.0],
            ["  [node 1s] SRS at k = 23 ready", 11.0], ["  [node 5s] fixed committed", 15.0],
            ["  [node 9s] keygen done", 19.0], ["  [node 12s] multiopen witnesses", 30.0],
            ["  [node 14s] proof of 2432 bytes valid", 33.5], ["  [node 14s] keygen done", 40.0]]
    assert tree_prove.stage_seconds(rows) == {"reverify": 2.0, "synthesis": 8.0, "setup": 1.0, "keygen": 8.0,
                                              "prove": 11.0, "verify": 3.5}
    assert tree_prove.stage_seconds(rows[1:3]) == {"synthesis": 10.0, "setup": 1.0}
    assert tree_prove.stage_seconds([]) == {}


def test_prove_leaf_runs_outer_at_n2_and_its_checks(tmp_path, monkeypatch):
    """A new leaf: `run_outer` at N = 2, k = 22, the Poseidon transcript,
    the witness offset, seed 1, tag `w<offset>` under the out directory;
    then `run_checks` on the same device."""
    res = {
        "num_proofs": 2, "k_outer": 22, "rows": 7, "proof": b"p", "vk": type("VK", (), {"hash_scalar": lambda s: 5})(),
        "public_inputs": [1, 2], "verified": True, "in_circuit_quads": [], "inner_quads": [],
        "artifact_stem": str(tmp_path / "outer_n2_k22w4"), "seconds": {}, "rss_mib": [["synthesis", 1.0, 2.0]],
    }
    got = {}

    def run_outer(cfg, **kwargs):
        got.update(cfg=cfg, **kwargs)
        return res

    monkeypatch.setattr(outer_prove, "run_outer", run_outer)
    monkeypatch.setattr(outer_prove, "run_checks", lambda r, device: {"verified": r is res, "device": str(device)})
    stem, record, checks = tree_prove.prove_leaf(4, str(tmp_path), torch.device("cpu"), print)
    cfg = got["cfg"]
    assert (cfg.num_proofs, cfg.k_outer, cfg.k_inner, cfg.constrained_fs) == (2, 22, 9, True)
    assert (got["witness_offset"], got["seed"], got["tag"], got["artifacts_dir"]) == (4, 1, "w4", str(tmp_path))
    assert stem == res["artifact_stem"] and checks == {"verified": True, "device": "cpu"}
    assert record["witness_offset"] == 4 and record["rows"] == 7 and record["vk_hash"] == "5"
    assert set(record["launches"]) == set(outer_prove.kernel_launches())


@pytest.mark.slow
def test_level3_synthesis_over_two_level2_proofs():
    """The level-3 node (`prove_node`'s circuit one level up) over
    `level2_n2_k23` in both slots, synthesised at k = 23 on the port: each
    in-circuit quad equals the meta's `efw`, the fold `fold_quads_host`'s,
    and the rows (pinned) fit k = 23."""
    proof, vk, meta, pis, efw, inst_comm = tree.load_artifact(str(ART / "level2_n2_k23"))
    assert vk.k == 23 and meta["level"] == 2
    circ = ac.AggregationCircuit(vk, [proof, proof], num_proofs=2)
    pis3 = circ.public_inputs([inst_comm, inst_comm], [efw, efw])
    cs, _, asg, ctx, (quads, W, RHS) = ac.build(circ, 23, pis3)
    assert [(q.e.value(), q.f.value(), q.w.value(), q.zw.value()) for q in quads] == [efw, efw]
    assert (W.value(), RHS.value()) == ac.fold_quads_host([efw, efw])
    assert ctx.offset == ROWS_LEVEL3 and ctx.offset <= cs.usable_rows(1 << 23)


@pytest.mark.slow
def test_level2_probe_over_the_checked_in_pair():
    """`level2_probe` over `outer_n2_k22` and `outer_n2_k22b` (their SRS by
    the host engine), synthesised at k = 23: 4,271,581 rows, fits k = 23
    (`docs/level2_probe_run.log`), the quads those of the metas."""
    out = level2_probe.probe([str(ART / "outer_n2_k22"), str(ART / "outer_n2_k22b")], k=23, device="cpu")
    assert out["rows"] == 4271581 and out["k_fit"] == 23
    assert out["quads"] == [meta_efw("outer_n2_k22"), meta_efw("outer_n2_k22b")]
    assert out["tree64_rows"] == 31 * 4271581 + 32 * 2673963
