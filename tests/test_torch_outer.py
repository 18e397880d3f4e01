"""The port's outer-proof path against the checked-in artifacts
(`docs/artifacts/*`, proofs of the outer and level-2 aggregation circuits
made by the JAX package) and against the JAX package itself.

The SRS of an artifact is `kzg.setup(k)` at its k; tau, and so `s_g2`, does
not depend on k, and the verifier needs of the SRS only the instance
commitment. So a `Params` of `kzg.setup(4)` whose `commit_lagrange` gives
the meta's `inst_comm` for exactly the meta's public inputs verifies every
artifact without a 2^21-point SRS. Exact equality throughout: points,
hashes and bytes."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.utils import artifacts as artifacts_r
from halo2_aggregation_tpu_torch.config import H2AConfig
from halo2_aggregation_tpu_torch.plonk import kzg
from halo2_aggregation_tpu_torch.plonk.verifier import verify_proof
from halo2_aggregation_tpu_torch.plonk.verifier_device import verify_batch
from halo2_aggregation_tpu_torch.tools import outer_prove
from halo2_aggregation_tpu_torch.utils import artifacts

torch.set_num_threads(1)  # small tensors; the test workers share the cores

ART = Path(__file__).resolve().parents[1] / "docs" / "artifacts"
STEMS = ["outer_n1_k21", "outer_n2_k22", "outer_n2_k22b", "outer_n4_k23", "outer_n4_k23dq", "level2_n2_k23"]


class ArtifactParams(kzg.Params):
    """The SRS of `kzg.setup(4)` with `commit_lagrange` answering the
    instance commitments of the metas given, and nothing else."""

    def __init__(self, metas):
        base = kzg.setup(4)
        super().__init__(base.k, base.g_lagrange_u64, base.g_lagrange_inf, base.g2, base.s_g2)
        self.comms = {tuple(int(v) for v in m["public_inputs"]): tuple(int(c) for c in m["inst_comm"])
                      for m in metas}

    def commit_lagrange(self, values):
        key = tuple(int(v) for v in values)
        if key not in self.comms:
            raise ValueError("no instance commitment for these public inputs")
        return self.comms[key]


def load(stem):
    """(proof, port vk, meta, public inputs, efw) of an artifact."""
    meta = json.loads((ART / f"{stem}.meta.json").read_text())
    pis = [int(v) for v in meta["public_inputs"]]
    efw = tuple(tuple(int(c) for c in p) for p in meta["efw"])
    return (ART / f"{stem}.proof").read_bytes(), artifacts.load_vk(str(ART / stem)), meta, pis, efw


@pytest.mark.parametrize("stem", STEMS)
def test_load_vk_equals_the_jax_package(stem):
    vk_p = artifacts.load_vk(str(ART / stem))
    vk_r = artifacts_r.load_vk(str(ART / stem))
    assert vk_p.k == vk_r.k == json.loads((ART / f"{stem}.meta.json").read_text())["k"]
    assert vk_p.hash_scalar() == vk_r.hash_scalar()
    assert vk_p.fixed_commitments == vk_r.fixed_commitments
    assert vk_p.sigma_commitments == vk_r.sigma_commitments
    assert type(vk_p.cs).__module__ == "halo2_aggregation_tpu_torch.plonk.circuit"


def test_load_vk_rejects_a_changed_k(tmp_path):
    with np.load(ART / "outer_n1_k21.vk.npz", allow_pickle=False) as d:
        fields = dict(d)
    fields["k"] = np.asarray([20], np.int64)
    np.savez(tmp_path / "bad.vk.npz", **fields)
    with pytest.raises(ValueError, match="vk hash mismatch"):
        artifacts.load_vk(str(tmp_path / "bad"))


def test_saved_vk_reloads_with_the_same_hash(tmp_path):
    vk = artifacts.load_vk(str(ART / "outer_n1_k21"))
    artifacts.save_vk_npz(str(tmp_path / "copy.vk.npz"), vk)
    back = artifacts.load_vk(str(tmp_path / "copy"))
    assert back.hash_scalar() == vk.hash_scalar()
    assert (back.fixed_commitments, back.sigma_commitments) == (vk.fixed_commitments, vk.sigma_commitments)


@pytest.mark.parametrize("stem", STEMS)
def test_host_verify_accepts_the_artifact(stem):
    proof, vk, meta, pis, efw = load(stem)
    ok, got = verify_proof(ArtifactParams([meta]), vk, [pis], proof)
    assert ok is True
    assert tuple(tuple(p) for p in got) == efw


def test_host_verify_rejects_a_flipped_byte():
    """The low bit of one evaluation's lowest byte: the transcript still
    parses, and the pairing check fails."""
    proof, vk, meta, pis, _ = load("outer_n1_k21")
    bad = bytearray(proof)
    bad[len(proof) - 64 * 5] ^= 1  # an evaluation, before the multiopen witnesses
    ok, _ = verify_proof(ArtifactParams([meta]), vk, [pis], bytes(bad))
    assert ok is False


def test_verify_batch_on_two_artifacts():
    """verify_batch(aggregate=True) on CPU tensors over the two N = 2 outer
    proofs under one vk: accepted, quads equal the metas' efw; the pair with
    one byte flipped is rejected."""
    stems = ["outer_n2_k22", "outer_n2_k22b"]
    arts = [load(s) for s in stems]
    vk = arts[0][1]
    assert arts[1][1].hash_scalar() == vk.hash_scalar()
    params = ArtifactParams([a[2] for a in arts])
    ok, quads = verify_batch(params, vk, [[a[3]] for a in arts], [a[0] for a in arts], device="cpu", aggregate=True)
    assert ok is True
    assert [tuple(tuple(p) for p in q) for q in quads] == [a[4] for a in arts]
    bad = bytearray(arts[1][0])
    bad[len(bad) - 64 * 5] ^= 1
    ok_bad, _ = verify_batch(params, vk, [[a[3]] for a in arts], [arts[0][0], bytes(bad)], device="cpu")
    assert ok_bad is False


def test_outer_prove_phases_a_b_give_the_artifacts_public_inputs():
    """`tools/outer_prove.py`'s inner proofs (k = 9, Poseidon transcript, seed
    42) and outer circuit at N = 1: the 40 public inputs of
    `outer_n1_k21.meta.json`."""
    cfg = H2AConfig(k_inner=9, k_outer=21, num_proofs=1, constrained_fs=True)
    inner = outer_prove.inner_proofs(cfg)
    outer, pis = outer_prove.outer_circuit(cfg, inner)
    meta = json.loads((ART / "outer_n1_k21.meta.json").read_text())
    assert pis == [int(v) for v in meta["public_inputs"]]
    assert len(inner["proofs"]) == 1 and len(inner["proofs"][0]) == 1248
    assert type(outer).__name__ == "SingleProofCircuit" and outer.proof == inner["proofs"][0]


def test_outer_prove_rejects_too_many_proofs():
    cfg = H2AConfig(k_inner=9, k_outer=21, num_proofs=2, constrained_fs=True)
    with pytest.raises(ValueError, match="not within"):
        outer_prove.inner_proofs(cfg, witness_offset=7)


def test_outer_prove_writes_the_examples_artifacts(tmp_path):
    """`save_artifacts` writes what examples/simple_example.py writes: the
    artifact's own proof, vk and meta come back equal."""
    proof, vk, meta, pis, efw = load("outer_n1_k21")
    cfg = H2AConfig(k_inner=9, k_outer=21, num_proofs=1, constrained_fs=True)
    stem = str(tmp_path / "outer_n1_k21")
    inst_comm = tuple(int(c) for c in meta["inst_comm"])
    outer_prove.save_artifacts(stem, proof, vk, outer_prove.level1_meta(cfg, 0), pis, efw, inst_comm)
    assert (tmp_path / "outer_n1_k21.proof").read_bytes() == proof
    back = artifacts.load_vk(stem)
    assert back.hash_scalar() == vk.hash_scalar() and back.fixed_commitments == vk.fixed_commitments
    written = json.loads((tmp_path / "outer_n1_k21.meta.json").read_text())
    assert written.pop("witness_offset") == 0
    assert written == meta


def test_checked_in_artifacts_are_never_overwritten(tmp_path, monkeypatch):
    """The writer, `run_outer` and `prove_node` (by its default stem
    too, under $H2A_ARTIFACTS_DIR) refuse the checked-in `docs/artifacts`
    before any work; a stem elsewhere passes."""
    from halo2_aggregation_tpu_torch.aggregation.tree import prove_node

    proof, vk, meta, pis, efw = load("outer_n1_k21")
    before = (ART / "outer_n1_k21.proof").read_bytes()
    with pytest.raises(ValueError, match="checked-in"):
        outer_prove.save_artifacts(str(ART / "outer_n1_k21"), proof, vk, meta, pis, efw, meta["inst_comm"])
    cfg = H2AConfig(k_inner=9, k_outer=21, num_proofs=1, constrained_fs=True)
    with pytest.raises(ValueError, match="checked-in"):
        outer_prove.run_outer(cfg, device="cpu", artifacts_dir=str(ART))
    with pytest.raises(ValueError, match="checked-in"):
        prove_node(str(ART / "outer_n2_k22"), str(ART / "outer_n2_k22b"), out_stem=str(ART / "level2_n2_k23"),
                   device="cpu")
    monkeypatch.setenv("H2A_ARTIFACTS_DIR", str(ART))
    with pytest.raises(ValueError, match="checked-in"):
        prove_node(str(ART / "outer_n2_k22"), str(ART / "outer_n2_k22b"), device="cpu")
    assert (ART / "outer_n1_k21.proof").read_bytes() == before
    assert outer_prove.writable_stem(str(tmp_path / "outer_n1_k21")) == str(tmp_path / "outer_n1_k21")
