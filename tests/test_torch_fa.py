"""K2's program (the fused field algebra) vs the JAX package, bit for bit.

The same VerifierBatch feeds both packages: the JAX package builds it from
parsed proofs, `convert.from_jax_batch` carries it over.  The port's tape
is evaluated by K2's plain version (`fa_tape_eval` on CPU tensors), by
`TorchLimbOps` directly and by host ints; the JAX side runs `field_algebra`
and the Pallas kernel's body `field_algebra_fused_emulated` (the
`tests/test_fa_fused.py` pattern)."""

import dataclasses

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.fields import R
from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk import verifier_tpu as vt
from halo2_aggregation_tpu.plonk.fa_fused import fa_schedule as jax_fa_schedule
from halo2_aggregation_tpu.plonk.fa_fused import field_algebra_fused_emulated
from halo2_aggregation_tpu.plonk.keygen import keygen
from halo2_aggregation_tpu.plonk.prover import create_proof
from halo2_aggregation_tpu.ops import field_ops as jfo
from halo2_aggregation_tpu.plonk.verifier import parse_proof
from halo2_aggregation_tpu_torch.convert import from_jax_batch, keys_from_reference
from halo2_aggregation_tpu_torch.ops import field_ops as fo
from halo2_aggregation_tpu_torch.ops.limbs import jax_to_port
from halo2_aggregation_tpu_torch.plonk import fa_fused as ff
from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
from halo2_aggregation_tpu_torch.plonk.protocol_ops import (
    OP_INV,
    IntInvOps,
    TapeOps,
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
    """fa_program over TorchLimbOps without the tape
    (`verifier_device.field_algebra`): same outputs."""
    vk, _, _, pb = setup
    got = vd.field_algebra(pvk, pb, B)
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


@pytest.mark.parametrize("e_scalar", [False, True], ids=["three_outputs", "with_e_scalar"])
def test_tape_has_one_inversion(pvk, e_scalar):
    """Montgomery's trick in the program: the 2 + bf Lagrange denominators
    and x^n - 1 share ONE `OP_INV`, and 3 products each but the first."""
    tape = ff.fa_tape(pvk, e_scalar)
    ops = tape.instrs[:, 0]
    assert int((ops == OP_INV).sum()) == 1
    assert tape.n_inputs == len(ff.fa_schedule(pvk)) + 2 * e_scalar
    assert len(tape.outputs) == 3 + e_scalar
    values = list(range(2, 2 + 8))
    got = ff.batch_inv(IntInvOps(), values)
    assert got == [pow(v, -1, R) for v in values]
    assert ff.batch_inv(IntInvOps(), [5, 0, 7]) == [0, 0, 0]
    assert ff.batch_inv(IntInvOps(), [9]) == [pow(9, -1, R)]


def _zero_lane_xs(pvk):
    """x = w^-i for every Lagrange index i = 0 .. bf + 1 (one denominator
    zero, and x^n - 1 with it), then x^n = 1 outside them (only x^n - 1
    zero), padded with one ordinary x to three batches of B."""
    omega_inv = pow(pvk.omega, -1, R)
    n_lagrange = 2 + pvk.cs.blinding_factors()
    xs = [pow(omega_inv, i, R) for i in range(n_lagrange)]
    xs += [pvk.omega, pow(pvk.omega, 5, R), R - 1]  # w^(n/2) = -1
    xs += [12345] * (-len(xs) % B)
    return xs, n_lagrange


def test_zero_denominators_match_unbatched_program_and_jax(setup, pvk, monkeypatch):
    """On lanes where a Lagrange denominator or x^n - 1 is zero, the
    program with one batched inversion gives the same three outputs as the
    program with one Fermat inversion a denominator (`batch_inv` replaced
    by separate `inv`s), over host ints and through the tape on tensors,
    and the same bits as the JAX `field_algebra`: h_eval = 0 there."""
    vk, _, jb, pb = setup
    xs, n_lagrange = _zero_lane_xs(pvk)
    schedule = ff.fa_schedule(pvk)
    host_in = [fo.FR.from_mont_tensor(a) for a in ff.fa_gather(pvk, pb)]
    tape = ff.fa_tape(pvk)
    for start in range(0, len(xs), B):
        chunk = xs[start : start + B]
        batched, unbatched = [], []
        for lane, x in enumerate(chunk):
            vals = {tag: host_in[j][lane] for j, tag in enumerate(schedule)}
            vals[("x",)] = x
            batched.append(ff.fa_program(IntInvOps(), pvk, vals))
            with monkeypatch.context() as m:
                m.setattr(ff, "batch_inv", lambda ops, values: [ops.inv(v) for v in values])
                unbatched.append(ff.fa_program(IntInvOps(), pvk, vals))
        assert batched == unbatched
        for lane, x in enumerate(chunk):
            if pow(x, pvk.n, R) == 1:
                assert batched[lane] == (0, 1, 0), f"x = {x}"
            else:
                assert batched[lane][0] != 0
        inputs = torch.stack(ff.fa_gather(pvk, pb)).clone()
        inputs[0] = fo.FR.to_mont_tensor(chunk, "cpu")
        out = ff.fa_tape_eval(tape, inputs)
        assert [tuple(fo.FR.from_mont_tensor(o)[lane] for o in out) for lane in range(B)] == batched
        jbx = dataclasses.replace(jb, x=vt._scalars_to_batch(chunk))
        for g, w in zip(out, vt.field_algebra(vk, jbx, B)):
            assert np.array_equal(g.numpy(), jax_to_port(np.asarray(w)))
    assert n_lagrange == 7


def test_e_scalar_output_matches_plain_ops_and_jax(setup, pvk, jax_outputs):
    """K2's fourth output: the plain limbs of -(known + h_coeff * h_eval),
    equal to `from_mont(neg(add(mont_mul(...))))` of the port's field ops
    and of the JAX package's (`verifier_tpu.fast_device`'s e-lane scalar);
    the first three outputs are those of the three-output tape."""
    vk, parsed, jb, pb = setup
    _, _, hc, kn = vd.fast_prep_gathered(pvk, parsed, "cpu")
    _, _, jhc, jkn = vt.fast_prep_gathered(vk, parsed)
    before = ff.fa_tape_eval.launches
    h_eval, xn, xn1, e = ff.field_algebra_fused(pvk, pb, B, hc, kn)
    assert ff.fa_tape_eval.launches == before
    for g, w in zip((h_eval, xn, xn1), jax_outputs):
        assert np.array_equal(g.numpy(), w)
    want = fo.from_mont(fo.neg(fo.add(fo.mont_mul(hc, h_eval, fo.FR), kn, fo.FR), fo.FR), fo.FR)
    assert torch.equal(e, want)
    jh = vt.field_algebra(vk, jb, B)[0]
    jwant = jfo.from_mont(jfo.neg(jfo.add(jfo.mont_mul(jhc, jh, jfo.FR), jkn, jfo.FR), jfo.FR), jfo.FR)
    assert np.array_equal(e.numpy(), jax_to_port(np.asarray(jwant)))
    # over host ints: the same scalar, as the value mod r
    host_in = [fo.FR.from_mont_tensor(a) for a in ff.fa_gather(pvk, pb) + [hc, kn]]
    tags = ff.fa_schedule(pvk) + ff.E_TAGS
    for lane in range(B):
        vals = {tag: host_in[j][lane] for j, tag in enumerate(tags)}
        h, _, _, e_int = ff.fa_program_e(IntInvOps(), pvk, vals)
        plain = -(vals[("known",)] + vals[("h_coeff",)] * h) % R
        assert e_int == plain * pow(1 << 256, -1, R) % R
        assert int.from_bytes(e[lane].numpy().tobytes(), "little") == plain
