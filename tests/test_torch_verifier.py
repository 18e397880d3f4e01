"""The port's batched verifier on CPU tensors vs the host verifier and the
JAX package's host prep: quads equal `verify_proof`'s, the aggregate check
accepts a good batch and rejects a tampered one."""

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk import verifier_tpu as vt
from halo2_aggregation_tpu.plonk.keygen import keygen
from halo2_aggregation_tpu.plonk.prover import create_proof
from halo2_aggregation_tpu.plonk.verifier import parse_proof, verify_proof
from halo2_aggregation_tpu_torch.convert import keys_from_reference, params_from_reference
from halo2_aggregation_tpu_torch.ops.limbs import jax_to_port
from halo2_aggregation_tpu_torch.plonk import verifier_device as vd

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

K = 9


@pytest.fixture(scope="module")
def setup():
    params = kzg.setup(K)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in [(2, 3), (1, 255)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=K)
        pub = [c.public_output()]
        protos.append(([pub], create_proof(params, pk, asg, [pub], seed=100 + a)))
    return params, vk, protos


@pytest.fixture(scope="module")
def pvk(setup):
    """The vk as the port's own class (the JAX package's, carried over)."""
    return keys_from_reference(setup[1])


@pytest.fixture(scope="module")
def batch4(setup, pvk):
    """B = 4 cycling two distinct proofs, through verify_batch."""
    params, vk, protos = setup
    insts = [protos[i % 2][0] for i in range(4)]
    proofs = [protos[i % 2][1] for i in range(4)]
    timings = {}
    ok, efws = vd.verify_batch(params_from_reference(params), pvk, insts, proofs, device="cpu", timings=timings)
    return ok, efws, timings


def test_aggregate_accepts_and_quads_match_host(setup, batch4):
    params, vk, protos = setup
    ok, efws, _ = batch4
    assert ok is True
    assert len(efws) == 4
    for i, (insts, proof) in enumerate(protos):
        ok_h, efw = verify_proof(params, vk, insts, proof)
        assert ok_h
        assert tuple(efw) == efws[i] == efws[i + 2], f"quad {i} != host verify_proof"


def test_ladder_method_gives_the_same_quads(setup, batch4, pvk):
    """verify_batch with method="ladder" (K8's plain version on CPU
    tensors) accepts the batch with the same quads as the windowed K1."""
    from halo2_aggregation_tpu_torch.ops.ec_kernels import scalar_mul_ladder

    params, vk, protos = setup
    _, efws, _ = batch4
    before = scalar_mul_ladder.launches
    ok, got = vd.verify_batch(
        params_from_reference(params), pvk, [p[0] for p in protos], [p[1] for p in protos], device="cpu", method="ladder"
    )
    assert ok is True
    assert got == efws[:2]
    assert scalar_mul_ladder.launches == before


def test_timings_cover_the_stages(batch4):
    _, _, timings = batch4
    assert set(timings) == {"parse", "prep", "device", "pairing"}
    assert all(v >= 0 for v in timings.values())


def test_tampered_proofs_rejected(setup, pvk):
    """One batch of [good, wrong public input, one flipped proof byte]:
    per-proof checks (aggregate=False) give [True, False, False], and the
    aggregate check over the same quads fails.  The flipped byte is the low
    byte of the first evaluation, so the proof still parses."""
    params, vk, protos = setup
    (pub0, proof0), (pub1, proof1) = protos
    p = parse_proof(vk, [params.commit_lagrange(c) for c in pub0], proof0)
    n_points = (
        len(p.adv_comms) + 2 * len(p.lookups_permuted) + len(p.perm_z_comms)
        + len(p.lookup_z_comms) + 1 + len(p.h_comms)
    )
    bad = bytearray(proof0)
    bad[32 * n_points] ^= 1
    insts = [pub0, [[pub1[0][0] + 1]], pub0]
    proofs = [proof0, proof1, bytes(bad)]
    oks, efws = vd.verify_batch(params_from_reference(params), pvk, insts, proofs, device="cpu", aggregate=False)
    assert oks == [True, False, False]
    assert vd.check_aggregate(efws, params) is False
    assert vd.check_aggregate(efws[:1], params) is True


def test_fast_prep_matches_jax(setup, pvk):
    params, vk, protos = setup
    parsed = [
        parse_proof(vk, [params.commit_lagrange(c) for c in insts], proof)
        for insts, proof in protos
    ]
    descs, ss, hc, kn = vd.fast_prep_gathered(pvk, parsed, "cpu")
    jdescs, jss, jhc, jkn = vt.fast_prep_gathered(vk, parsed)
    assert descs == jdescs
    assert [len(c) for c in descs] == [4, 4, 27]
    for p, j in ((ss, jss), (hc, jhc), (kn, jkn)):
        assert np.array_equal(p.numpy(), jax_to_port(np.asarray(j)))
    for p in parsed:
        assert vd._multiopen_coefficients(pvk, p) == vt._multiopen_coefficients(vk, p)


def test_aggregate_quads_matches_jax(setup, batch4):
    params = setup[0]
    _, efws, _ = batch4
    assert vd.aggregate_quads(efws, params.g1, params.s_g2, params.g2) == vt.aggregate_quads(
        efws, params.g1, params.s_g2, params.g2
    )
