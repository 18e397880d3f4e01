"""The port's `utils/jobs.py`, `aggregation/tree.py` and `api.py` at k = 9
on CPU tensors: the checkpointed aggregator's resume contract with quads
equal to the host `verify_proof`'s, the recursion tree's schedule with a
stub prove, and the reference-style API flow with its rejections."""

import os

import pytest
import torch

from halo2_aggregation_tpu_torch import api
from halo2_aggregation_tpu_torch.aggregation.tree import run_tree
from halo2_aggregation_tpu_torch.models import simple_example as se
from halo2_aggregation_tpu_torch.plonk import kzg
from halo2_aggregation_tpu_torch.plonk.keygen import keygen
from halo2_aggregation_tpu_torch.plonk.prover_native import create_proof_native
from halo2_aggregation_tpu_torch.plonk.verifier import verify_proof
from halo2_aggregation_tpu_torch.utils.jobs import StageLogger, aggregate_checkpointed

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

K = 9


@pytest.fixture(scope="module")
def stream():
    """Two distinct proofs at k = 9 and a stream of B = 4 cycling them."""
    params = kzg.setup(K)
    c = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(c.without_witnesses(), k=K)
    vk, pk = keygen(params, cs_e, asg_e)
    proofs, insts = [], []
    for a, b in [(2, 3), (4, 5)]:
        cc = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(cc, k=K)
        pub = [cc.public_output()]
        proofs.append(create_proof_native(params, pk, asg, [pub], seed=80 + a))
        insts.append([pub])
    B = 4
    return params, vk, [insts[i % 2] for i in range(B)], [proofs[i % 2] for i in range(B)]


def test_checkpoint_resume(stream, tmp_path):
    params, vk, il, pl = stream
    ckpt = str(tmp_path / "agg.jsonl")
    logp = str(tmp_path / "stages.jsonl")

    # full run, chunk=2 -> 2 chunks; each quad equals the host verifier's
    ok, quads = aggregate_checkpointed(params, vk, il, pl, ckpt, chunk=2, logger=StageLogger(logp), device="cpu")
    assert ok is True and len(quads) == len(pl)
    assert quads[2:] == quads[:2]  # the stream cycles two proofs
    for insts, proof, q in zip(il[:2], pl[:2], quads):
        ok_h, efw = verify_proof(params, vk, insts, proof)
        assert ok_h and tuple(efw) == tuple(q)
    assert os.path.getsize(logp) > 0

    # a crash after chunk 0: drop the second checkpoint line
    lines = open(ckpt).read().strip().split("\n")
    assert len(lines) == 2
    open(ckpt, "w").write(lines[0] + "\n")
    ok2, quads2 = aggregate_checkpointed(params, vk, il, pl, ckpt, chunk=2, device="cpu")
    assert ok2 is True and quads2 == quads
    assert len(open(ckpt).read().strip().split("\n")) == 2

    # a changed input invalidates the stale entry: chunk 0 recomputed,
    # chunk 1 taken from the checkpoint, still correct
    pl_swapped = [pl[1], pl[0], pl[2], pl[3]]
    il_swapped = [il[1], il[0], il[2], il[3]]
    ok3, quads3 = aggregate_checkpointed(params, vk, il_swapped, pl_swapped, ckpt, chunk=2, device="cpu")
    assert ok3 is True
    assert quads3[0] == quads[1] and quads3[1] == quads[0]


@pytest.mark.slow  # the JAX verifier's compile on the CPU: about 170 s here
def test_checkpoint_quads_equal_the_jax_package(stream, tmp_path):
    """The JAX package's aggregate_checkpointed on the same stream (its own
    params and vk, the same proof bytes) gives the same verdict and quads
    as the port's, checkpoint and all."""
    from halo2_aggregation_tpu.models import simple_example as se_r
    from halo2_aggregation_tpu.plonk import kzg as kzg_r
    from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
    from halo2_aggregation_tpu.utils.jobs import aggregate_checkpointed as aggregate_checkpointed_r

    params, vk, il, pl = stream
    params_r = kzg_r.setup(K)
    cs_e, _, asg_e = se_r.build(se_r.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=K)
    vk_r, _ = keygen_r(params_r, cs_e, asg_e)
    assert vk_r.hash_scalar() == vk.hash_scalar()
    ok_r, quads_r = aggregate_checkpointed_r(params_r, vk_r, il, pl, str(tmp_path / "jax.jsonl"), chunk=2)
    ok, quads = aggregate_checkpointed(params, vk, il, pl, str(tmp_path / "port.jsonl"), chunk=2, device="cpu")
    assert ok is True and bool(ok_r) is True
    assert [tuple(map(tuple, q)) for q in quads_r] == [tuple(map(tuple, q)) for q in quads]


def test_checkpoint_skips_a_torn_line(stream, tmp_path):
    """A line cut short by a crash is skipped and its chunk recomputed."""
    params, vk, il, pl = stream
    ckpt = str(tmp_path / "agg.jsonl")
    ok, quads = aggregate_checkpointed(params, vk, il, pl, ckpt, chunk=2, device="cpu")
    lines = open(ckpt).read().strip().split("\n")
    open(ckpt, "w").write(lines[0] + "\n" + lines[1][: len(lines[1]) // 2] + "\n")
    ok_t, quads_t = aggregate_checkpointed(params, vk, il, pl, ckpt, chunk=2, device="cpu")
    assert ok is True and ok_t is True and quads_t == quads


def test_checkpoint_rejects_a_tampered_stream(stream, tmp_path):
    params, vk, il, pl = stream
    bad = bytearray(pl[2])
    bad[100] ^= 1
    try:
        ok, _ = aggregate_checkpointed(params, vk, il, pl[:2] + [bytes(bad)] + pl[3:],
                                       str(tmp_path / "bad.jsonl"), chunk=2, device="cpu")
    except ValueError:
        ok = False  # the flipped byte does not parse
    assert ok is False


def test_run_tree_schedule_resume_and_bye(tmp_path):
    """run_tree's binary schedule, its manifest resume keyed by the
    children's proof digests, the re-prove of a vanished node and the odd
    leaf's bye, with the prove stubbed (tests/test_jobs.py's contract)."""

    def make_leaf(i):
        stem = str(tmp_path / f"leaf{i}")
        with open(stem + ".proof", "wb") as f:
            f.write(bytes([i]) * 8)
        return stem

    leaves = [make_leaf(i) for i in range(4)]
    calls = []

    def fake_prove(a, b, k, out_stem):
        calls.append((os.path.basename(a), os.path.basename(b)))
        with open(out_stem + ".proof", "wb") as f:
            f.write(open(a + ".proof", "rb").read() + open(b + ".proof", "rb").read())
        return out_stem

    man = str(tmp_path / "tree.jsonl")
    logger = StageLogger(str(tmp_path / "tree.log"))
    root = run_tree(leaves, man, k_node=5, prove_fn=fake_prove, out_dir=str(tmp_path), logger=logger)
    assert calls == [("leaf0", "leaf1"), ("leaf2", "leaf3"), ("tree_l2_i0_k5", "tree_l2_i1_k5")]
    assert root.endswith("tree_l3_i0_k5")
    assert open(root + ".proof", "rb").read() == bytes([0] * 8 + [1] * 8 + [2] * 8 + [3] * 8)

    calls.clear()
    assert run_tree(leaves, man, k_node=5, prove_fn=fake_prove, out_dir=str(tmp_path), logger=logger) == root
    assert calls == []

    os.remove(root + ".proof")
    calls.clear()
    assert run_tree(leaves, man, k_node=5, prove_fn=fake_prove, out_dir=str(tmp_path), logger=logger) == root
    assert calls == [("tree_l2_i0_k5", "tree_l2_i1_k5")]

    calls.clear()
    root5 = run_tree(leaves[:3], str(tmp_path / "tree3.jsonl"), k_node=5, prove_fn=fake_prove,
                     out_dir=str(tmp_path), logger=logger)
    assert calls == [("leaf0", "leaf1"), ("tree_l2_i0_k5", "leaf2")]
    assert root5.endswith("tree_l3_i0_k5")


def test_api_flow_accepts_and_rejects():
    """The reference-style flow through the port's `api` on the host
    (`device=None`): a proof accepted; a wrong public input, a corrupted
    byte and a truncated proof rejected; `api.verify_batch` is the port's,
    on the CPU when asked."""
    params = api.Setup.new(K, device=None)
    params_v = api.Setup.verifier_params(params, 1)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    vk = api.keygen_vk(params, cs_e, asg_e, device=None)
    pk = api.keygen_pk(params, cs_e, asg_e, device=None)
    cs, _, asg = se.build(circuit, k=K)
    assert api.MockProver.run(K, cs, asg).verify() is None

    pub = [circuit.public_output()]
    proof = api.create_proof(params, pk, asg, [pub], seed=7, device=None)
    ok, efw = api.verify_proof(params_v, vk, [pub], proof)
    assert ok and len(efw) == 4

    ok_wrong, _ = api.verify_proof(params_v, vk, [[pub[0] + 1]], proof)
    assert not ok_wrong
    bad = bytearray(proof)
    bad[len(proof) - 64 * 3] ^= 1
    try:
        ok_bad, _ = api.verify_proof(params_v, vk, [pub], bytes(bad))
    except ValueError:
        ok_bad = False
    assert not ok_bad
    with pytest.raises(ValueError, match="transcript exhausted"):
        api.verify_proof(params_v, vk, [pub], proof[:-32])

    ok_b, quads = api.verify_batch(params_v, vk, [[pub]], [proof], device="cpu")
    assert ok_b is True and quads == [tuple(efw)]
    assert api.parse_proof(vk, [params.commit_lagrange(pub)], proof).x is not None


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_api_routes_a_device_to_the_card_paths(device, monkeypatch):
    """With a device, `api`'s setup, keygen and prover hand it to
    `kzg.setup`, `keygen_device` and `create_proof_device`, with the caller's
    arguments (the card paths themselves are held to the host's bytes in
    test_torch_imports.py and on the card)."""
    calls = []
    monkeypatch.setattr(api, "resolve_device", lambda d: ("resolved", d))
    monkeypatch.setattr(api._kzg, "setup", lambda k, seed, device: calls.append(("setup", k, seed, device)))
    monkeypatch.setattr(api, "keygen_device",
                        lambda params, cs, asg, device: calls.append(("keygen", params, cs, asg, device)) or ("vk", "pk"))
    monkeypatch.setattr(api, "create_proof_device",
                        lambda *a, transcript_cls, device: calls.append(("prove", a, transcript_cls, device)) or b"p")
    api.Setup.new(5, 11, device=device)
    assert api.keygen_vk("params", "cs", "asg", device=device) == "vk"
    assert api.keygen_pk("params", "cs", "asg", device=device) == "pk"
    assert api.create_proof("params", "pk", "asg", [[1]], 3, device=device) == b"p"
    assert calls == [
        ("setup", 5, 11, ("resolved", device)),
        ("keygen", "params", "cs", "asg", device),
        ("keygen", "params", "cs", "asg", device),
        ("prove", ("params", "pk", "asg", [[1]], 3), api.Blake2bWrite, device),
    ]
