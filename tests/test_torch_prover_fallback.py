"""`create_proof_device`'s coefficient path, taken when an evaluation point
lands in the domain (probability ~ n/2^254, so never on its own): with
`Barycentric.point` made to refuse every point, the evaluations run by
Horner over `get_coeffs` and h's pieces come back from their values by
an inverse NTT.  The proof must be the same bytes as the JAX package's
`create_proof_native` (CPU tensors: every commitment through the plain
K7, ~3 min on one worker)."""

import torch

from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk.keygen import keygen
from halo2_aggregation_tpu.plonk.prover_native import create_proof_native
from halo2_aggregation_tpu_torch import convert
from halo2_aggregation_tpu_torch.plonk import engine
from halo2_aggregation_tpu_torch.plonk.prover_device import create_proof_device

torch.set_num_threads(1)  # small tensors; the test workers share the cores

K = 9


def test_coefficient_fallback_matches_native(monkeypatch):
    params = kzg.setup(K)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    _, pk = keygen(params, cs_e, asg_e)
    pub = [circuit.public_output()]
    points = []

    def refuse(self, z):
        points.append(z)
        raise ZeroDivisionError("every point refused")

    monkeypatch.setattr(engine.Barycentric, "point", refuse)
    _, _, asg = se.build(circuit, k=K)
    got = create_proof_device(convert.params_from_reference(params), convert.keys_from_reference(pk),
                              convert.assignment_from_reference(asg), [pub], seed=42, device="cpu")
    assert len(points) == 1  # the first point refused: the whole proof took the coefficient path
    _, _, asg = se.build(circuit, k=K)
    assert got == create_proof_native(params, pk, asg, [pub], seed=42)
