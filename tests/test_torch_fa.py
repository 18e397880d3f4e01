"""K2's program (the fused field algebra) vs the JAX package, bit for bit.

The same VerifierBatch feeds both packages: the JAX package builds it from
parsed proofs, `convert.from_jax_batch` carries it over.  The port's tape
is evaluated by K2's plain version (`fa_tape_eval` on CPU tensors), by
`TorchLimbOps` directly and by host ints; the JAX side runs `field_algebra`
and the Pallas kernel's body `field_algebra_fused_emulated` (the
`tests/test_fa_fused.py` pattern)."""

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk import verifier_tpu as vt
from halo2_aggregation_tpu.plonk.fa_fused import fa_schedule as jax_fa_schedule
from halo2_aggregation_tpu.plonk.fa_fused import field_algebra_fused_emulated
from halo2_aggregation_tpu.plonk.keygen import keygen
from halo2_aggregation_tpu.plonk.prover import create_proof
from halo2_aggregation_tpu.plonk.verifier import parse_proof
from halo2_aggregation_tpu_torch.convert import from_jax_batch, keys_from_reference
from halo2_aggregation_tpu_torch.ops import field_ops as fo
from halo2_aggregation_tpu_torch.ops.limbs import jax_to_port
from halo2_aggregation_tpu_torch.plonk import fa_fused as ff
from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
from halo2_aggregation_tpu_torch.plonk.protocol_ops import (
    IntInvOps,
    TapeOps,
    TorchLimbOps,
    run_tape,
)

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

B = 4


@pytest.fixture(scope="module")
def setup():
    params = kzg.setup(9)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=9)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in [(2, 3), (4, 5)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=9)
        pub = [c.public_output()]
        protos.append((pub, create_proof(params, pk, asg, [pub], seed=30 + a)))
    parsed = [
        parse_proof(vk, [params.commit_lagrange(protos[i % 2][0])], protos[i % 2][1])
        for i in range(B)
    ]
    jb = vt.batch_proofs(vk, parsed)
    return vk, parsed, jb, from_jax_batch(jb, "cpu")


@pytest.fixture(scope="module")
def pvk(setup):
    """The vk as the port's own class (the JAX package's, carried over)."""
    return keys_from_reference(setup[0])


@pytest.fixture(scope="module")
def jax_outputs(setup):
    vk, _, jb, _ = setup
    return [jax_to_port(np.asarray(a)) for a in vt.field_algebra(vk, jb, B)]


def test_tape_plain_matches_jax_field_algebra(setup, jax_outputs, pvk):
    vk, _, _, pb = setup
    before = ff.fa_tape_eval.launches
    got = ff.field_algebra_fused(pvk, pb, B)
    for name, g, w in zip(("h_eval", "x^n", "x^n - 1"), got, jax_outputs):
        assert np.array_equal(g.numpy(), w), name
    assert ff.fa_tape_eval.launches == before, "a CPU tensor must not count a kernel launch"


def test_tape_matches_jax_fused_body_emulation(setup, jax_outputs, pvk):
    vk, _, jb, pb = setup
    emu = [jax_to_port(np.asarray(a)) for a in field_algebra_fused_emulated(vk, jb, B)]
    for e, w in zip(emu, jax_outputs):
        assert np.array_equal(e, w)
    out = ff.fa_tape_eval(ff.fa_tape(pvk), torch.stack(ff.fa_gather(pvk, pb)))
    for g, e in zip(out, emu):
        assert np.array_equal(g.numpy(), e)


def test_torch_limb_ops_direct_matches_tape(setup, jax_outputs, pvk):
    """fa_program over TorchLimbOps without the tape: same outputs."""
    vk, _, _, pb = setup
    vals = dict(zip(ff.fa_schedule(pvk), ff.fa_gather(pvk, pb)))
    got = ff.fa_program(TorchLimbOps("cpu"), pvk, vals)
    for g, w in zip(got, jax_outputs):
        assert np.array_equal(g.numpy(), w)


def test_host_int_ops_match_tape(setup, jax_outputs, pvk):
    """The tape over host ints, and fa_program over host ints, equal the
    JAX outputs decoded from Montgomery form."""
    vk, _, _, pb = setup
    tape = ff.fa_tape(pvk)
    host_in = [fo.FR.from_mont_tensor(a) for a in ff.fa_gather(pvk, pb)]
    want = [fo.FR.from_mont_tensor(torch.from_numpy(w)) for w in jax_outputs]
    for lane in range(B):
        lane_in = [col[lane] for col in host_in]
        via_tape = run_tape(tape, lane_in, IntInvOps())
        direct = ff.fa_program(IntInvOps(), pvk, dict(zip(ff.fa_schedule(pvk), lane_in)))
        assert tuple(via_tape) == tuple(direct) == tuple(w[lane] for w in want)


def test_schedule_and_gather_match_jax(setup, pvk):
    vk, _, jb, pb = setup
    assert ff.fa_schedule(pvk) == jax_fa_schedule(vk)
    from halo2_aggregation_tpu.plonk.fa_fused import fa_gather as jax_fa_gather

    for p, j in zip(ff.fa_gather(pvk, pb), jax_fa_gather(vk, jb)):
        assert p.shape == (B, 8)
        assert np.array_equal(p.numpy(), jax_to_port(np.asarray(j)))


def test_tape_register_allocation(setup, pvk):
    """Dead code is dropped, temporaries are reused, every operand is
    defined before it is read, and outputs stay live."""
    vk = setup[0]
    tape = ff.fa_tape(pvk)
    S = tape.n_inputs
    assert tape.n_temps < tape.instrs.shape[0] // 4
    defined = set()
    for op, dst, a, b in tape.instrs.tolist():
        for r in (a, b) if op < 3 else (a,):
            assert r < S or r in defined, "operand read before it is written"
        assert S <= dst < S + tape.n_temps
        defined.add(dst)
    assert all(r in defined for r in tape.outputs)
    # a dead value is not emitted
    ops = TapeOps(2)
    x, y = ops.inputs()
    ops.mul(x, y)  # dead
    t = ops.finish([ops.add(x, y)])
    assert t.instrs.shape == (1, 4) and t.n_temps == 1


def test_port_batch_matches_converted_jax_batch(setup, pvk):
    vk, parsed, _, pb = setup
    own = vd.batch_proofs(pvk, parsed, "cpu")
    for a, b in zip(ff.fa_gather(pvk, own), ff.fa_gather(pvk, pb)):
        assert torch.equal(a, b)
    for name in ("w_comms", "h_comms", "adv_comms", "perm_z_comms"):
        for p, q in zip(getattr(own, name), getattr(pb, name)):
            assert all(torch.equal(c, d) for c, d in zip(p, q)), name


def test_synthetic_batch_matches_jax(setup, pvk):
    vk = setup[0]
    pb = vd.synthetic_batch(pvk, 2, "cpu", seed=3)
    jb = from_jax_batch(vt.synthetic_batch(vk, 2, seed=3), "cpu")
    for a, b in zip(ff.fa_gather(pvk, pb), ff.fa_gather(pvk, jb)):
        assert torch.equal(a, b)
    for p, q in zip(pb.h_comms + [pb.r_comm], jb.h_comms + [jb.r_comm]):
        assert all(torch.equal(c, d) for c, d in zip(p, q))
