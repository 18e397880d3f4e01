"""The slices as a whole: `keygen_device` and `create_proof_device` on CPU
tensors (every device step, the commitments included, through its
kernel's plain version) against the JAX package's host `keygen_native`,
`create_proof_native` and the pure-int spec prover `create_proof`, byte
for byte, and accepted by `verify_proof`."""

import pytest
import torch

from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk.keygen import keygen, keygen_native
from halo2_aggregation_tpu.plonk.prover import create_proof
from halo2_aggregation_tpu.plonk.prover_native import create_proof_native
from halo2_aggregation_tpu.plonk.verifier import verify_proof
from halo2_aggregation_tpu_torch import convert
from halo2_aggregation_tpu_torch.ops import msm_kernels as mk
from halo2_aggregation_tpu_torch.ops import ntt as nt
from halo2_aggregation_tpu_torch.plonk import quotient_program as qp
from halo2_aggregation_tpu_torch.plonk.keygen_device import keygen_device
from halo2_aggregation_tpu_torch.plonk.kzg import DeviceSRS
from halo2_aggregation_tpu_torch.plonk.prover_device import create_proof_device

torch.set_num_threads(1)  # small tensors; the test workers share the cores

K = 9


@pytest.fixture(scope="module")
def setup():
    params = kzg.setup(K)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    vk, pk = keygen(params, cs_e, asg_e)
    return params, vk, pk, circuit


def fresh_assignment(circuit):
    _, _, asg = se.build(circuit, k=K)
    return asg


def ported(params, key=None, assignment=None):
    """The JAX package's state as the port's own classes: both packages
    then compute on the same SRS, keys and witness."""
    out = [convert.params_from_reference(params)]
    if key is not None:
        out.append(convert.keys_from_reference(key))
    if assignment is not None:
        out.append(convert.assignment_from_reference(assignment))
    return out


@pytest.mark.parametrize("seed", [42, 7])
def test_create_proof_device_matches_native_and_spec(setup, seed):
    """Two seeds: a slip in the order or width of one blind's draw that
    one seed's bytes happen to hide shows in the other's."""
    params, vk, pk, circuit = setup
    pub = [circuit.public_output()]
    fns = (nt.ntt_batched, nt.intt_batched, nt.ew_mul_col, nt.ew_mul_scalar, nt.pow_series, qp.quotient_tape_eval,
           mk.msm_bucket_s5, mk.msm_bucket_u4)
    stages = []
    got = create_proof_device(*ported(params, pk, fresh_assignment(circuit)), [pub], seed=seed, progress=stages.append,
                              device="cpu")
    assert [f.launches for f in fns] == [0] * len(fns)  # CPU tensors never launch a kernel
    assert sum("(device)" in s for s in stages) == 4  # four cosets, all on the engine
    native = create_proof_native(params, pk, fresh_assignment(circuit), [pub], seed=seed)
    spec = create_proof(params, pk, fresh_assignment(circuit), [pub], seed=seed)
    assert got == native == spec
    ok, _ = verify_proof(params, vk, [pub], got)
    assert ok
    ok_bad, _ = verify_proof(params, vk, [[pub[0] + 1]], got)
    assert not ok_bad


def test_keygen_device_matches_native(setup):
    """keygen_device's commitments (the plain K7 on CPU tensors) and
    columns equal keygen_native's, so the vk hashes alike."""
    params, _, _, circuit = setup
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    params_p, asg_p = ported(params, assignment=asg_e)
    srs = DeviceSRS(params_p, "cpu")
    before = mk.msm_bucket_s5.launches
    vk, pk = keygen_device(params_p, asg_p.cs, asg_p, device="cpu", srs=srs)
    assert mk.msm_bucket_s5.launches == before
    vk_n, pk_n = keygen_native(params, cs_e, asg_e)
    assert vk.fixed_commitments == vk_n.fixed_commitments
    assert vk.sigma_commitments == vk_n.sigma_commitments
    assert vk.hash_scalar() == vk_n.hash_scalar()
    for a, b in zip(pk.fixed_columns + pk.sigma_columns, pk_n.fixed_columns + pk_n.sigma_columns):
        assert (a == b).all()
    with pytest.raises(ValueError, match="srs"):
        keygen_device(params_p, asg_p.cs, asg_p, device="cpu", srs=DeviceSRS(ported(kzg.setup(K - 1))[0], "cpu"))


def test_create_proof_device_raises_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card path does not apply")
    params, _, pk, circuit = setup
    with pytest.raises(RuntimeError, match="cuda"):
        create_proof_device(*ported(params, pk, fresh_assignment(circuit)), [[circuit.public_output()]], device="cuda")
