"""The port's device quotient (`plonk/quotient_program.py`,
`plonk/quotient_device.py`) on CPU tensors, where every step runs its
kernel's plain version, against the JAX `DeviceQuotient`'s CPU path (the
XLA `slab_fn`, the route of `test_device_quotient_byte_parity`) and the
host coset loop of `create_proof_native` (`prover_native.py:481-541`).
Exact throughout: canonical Montgomery bytes."""

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.fields import FR_GENERATOR, R, fr_omega
from halo2_aggregation_tpu.models import aggregation_circuit as ac
from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.plonk import engine
from halo2_aggregation_tpu.plonk import quotient_device as jqd
from halo2_aggregation_tpu.plonk.circuit import ConstraintSystem
from halo2_aggregation_tpu.plonk.protocol import (
    LookupEvals,
    PermutationSetEvals,
    fold_y,
    gate_expressions,
    lookup_expressions,
    permutation_expressions,
)
from halo2_aggregation_tpu.plonk.verifier import num_perm_chunks
from halo2_aggregation_tpu_torch import convert
from halo2_aggregation_tpu_torch.ops import ntt as nt
from halo2_aggregation_tpu_torch.plonk import quotient_program as qp
from halo2_aggregation_tpu_torch.plonk.quotient_device import DeviceQuotient

torch.set_num_threads(1)  # small tensors; the test workers share the cores

CHALLENGES = dict(theta=0x1111_2222_3333, beta=0x4444_5555_6666, gamma=0x7777_8888_9999, y=0xAAAA_BBBB_CCCC)


def simple_cs():
    cs, _, _ = se.build(se.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=9)
    return cs


def aggregation_cs():
    cs = ConstraintSystem()
    ac.configure(cs)
    return cs


def ported(cs):
    """The JAX package's constraint system as the port's own classes."""
    return convert.constraint_system_from_reference(cs)


def shifts(k, cs):
    """The four coset shifts of `create_proof_native` (`:451-468`)."""
    ext_k = k + max(1, (cs.degree() - 2).bit_length())
    step = 1 << (ext_k - k)
    return [FR_GENERATOR * pow(fr_omega(ext_k), cj, R) % R for cj in range(step)]


def rand_evals(rng, keys, n) -> dict:
    """One (n, 4) u64 canonical Montgomery column per key."""
    out = {}
    for key in keys:
        a = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64) * np.uint64(2)
        a[:, 3] &= np.uint64(0x1FFF_FFFF_FFFF_FFFF)
        out[key] = a
    return out


def counters():
    fns = (nt.ntt_batched, nt.intt_batched, nt.ew_mul_col, nt.ew_mul_scalar, nt.pow_series, qp.quotient_tape_eval)
    return [f.launches for f in fns]


@pytest.mark.parametrize("which", ["simple", "aggregation"])
def test_leaf_schedule_matches_jax(which):
    cs = simple_cs() if which == "simple" else aggregation_cs()
    bf, chunks = cs.blinding_factors(), num_perm_chunks(cs)
    assert qp.leaf_schedule(ported(cs), bf, chunks) == jqd.leaf_schedule(cs, bf, chunks)
    tape = qp.quotient_tape(ported(cs))
    sched, keys = qp.leaf_schedule(ported(cs), bf, chunks)
    assert tape.tape.n_inputs == len(sched) + 1 + len(qp.UNIFORMS)
    assert sorted({rot for _, rot in sched}) == [-(bf + 1), -1, 0, 1]
    if which == "aggregation":
        assert (len(keys), len(sched), tape.tape.n_inputs) == (39, 50, 56)
    assert tape.tape.n_temps <= qp.QT_MAX_TEMPS


K_SIMPLE = 9


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX DeviceQuotient on its CPU path, fed random evaluations, and
    its four cosets."""
    cs = simple_cs()
    n = 1 << K_SIMPLE
    dq = jqd.DeviceQuotient(cs, K_SIMPLE)
    assert not dq.use_pallas
    evals = rand_evals(np.random.default_rng(9), dq.key_order, n)
    for key in reversed(dq.key_order):  # feeding order must not matter
        dq.feed_evals(key, evals[key])
    dq.finalize()
    cosets = [dq.run_coset(s, **CHALLENGES) for s in shifts(K_SIMPLE, cs)]
    return cs, dq, evals, cosets


@pytest.mark.parametrize("start", ["fed_evaluations", "jax_coefficients"])
def test_run_coset_matches_jax_engine(jax_engine, start):
    cs, dq_jax, evals, want = jax_engine
    before = counters()
    dq = DeviceQuotient(ported(cs), K_SIMPLE, "cpu")
    assert dq.key_order == dq_jax.key_order and dq.schedule == dq_jax.schedule
    if start == "fed_evaluations":
        for key in dq.key_order:
            dq.feed_evals(key, evals[key])
        dq.finalize()
    else:
        dq.finalize_coefficients(convert.quotient_columns_from_jax(dq_jax))
    for cj, s in enumerate(shifts(K_SIMPLE, cs)):
        got = dq.run_coset(s, **CHALLENGES)
        assert got.dtype == np.uint64 and got.shape == (1 << K_SIMPLE, 4)
        assert np.array_equal(got, want[cj]), f"coset {cj}"
    assert counters() == before  # CPU tensors never launch a kernel


def host_coset(cs, k, coeffs, shift):
    """The host coset loop's formulas (`prover_native.py:481-541`) over
    NativeVecOps and NativeDomain."""
    n = 1 << k
    ops = engine.NativeVecOps()
    dom = engine.NativeDomain(k)
    bf = cs.blinding_factors()
    num_chunks = num_perm_chunks(cs)

    def ext(key):
        return dom.coset_evals(coeffs[key], shift)

    adv = [engine.roll(ext(("advice", c.index)), rot.value) for c, rot in cs.advice_queries]
    fix = [engine.roll(ext(("fixed", c.index)), rot.value) for c, rot in cs.fixed_queries]
    inst = [engine.roll(ext(("instance", c.index)), rot.value) for c, rot in cs.instance_queries]
    sigma = [ext(("sigma", i)) for i in range(len(cs.permutation_columns))]
    l0, llast, lblind = (ext((name, 0)) for name in ("l0", "llast", "lblind"))
    coset_x = engine.pow_series(engine.mont_scalar(fr_omega(k)), n, engine.mont_scalar(shift))
    m = {name: engine.mont_scalar(v) for name, v in CHALLENGES.items()}
    exprs = gate_expressions(ops, cs, adv, fix, inst)
    perm_sets = []
    for ci in range(num_chunks):
        ze = ext(("perm_z", ci))
        perm_sets.append(PermutationSetEvals(
            z=ze, z_next=engine.roll(ze, 1),
            z_last=engine.roll(ze, -(bf + 1)) if ci < num_chunks - 1 else None,
        ))
    exprs += permutation_expressions(
        ops, cs, perm_sets, sigma, adv, fix, inst, l0, llast, lblind,
        m["beta"], m["gamma"], coset_x, cs.degree() - 2,
    )
    for li, arg in enumerate(cs.lookups):
        ze, ae, se_ = ext(("lookup_z", li)), ext(("lookup_a", li)), ext(("lookup_s", li))
        ev = LookupEvals(
            z=ze, z_next=engine.roll(ze, 1), a_prime=ae, a_prime_prev=engine.roll(ae, -1), s_prime=se_,
        )
        exprs += lookup_expressions(
            ops, ev, arg, l0, llast, lblind, m["theta"], m["beta"], m["gamma"], adv, fix, inst,
        )
    num = fold_y(ops, exprs, m["y"])
    vinv = pow((pow(shift, n, R) - 1) % R, -1, R)
    return ops.mul(num, engine.mont_scalar(vinv))


def test_aggregation_circuit_matches_host_coset_loop():
    cs = aggregation_cs()
    k = 8
    n = 1 << k
    dq = DeviceQuotient(ported(cs), k, "cpu")
    evals = rand_evals(np.random.default_rng(8), dq.key_order, n)
    for key in dq.key_order:
        dq.feed_evals(key, evals[key])
    dq.finalize()
    dom = engine.NativeDomain(k)
    coeffs = {key: dom.intt(col) for key, col in evals.items()}
    for cj, s in enumerate(shifts(k, cs)):
        assert np.array_equal(dq.run_coset(s, **CHALLENGES), host_coset(cs, k, coeffs, s)), f"coset {cj}"


def test_plain_tape_on_row_windows():
    """K6's plain version on a row subset equals the full run's rows,
    including the rows where rotations -(bf + 1), -1 and 1 wrap."""
    cs = simple_cs()
    k = 6
    n = 1 << k
    qt = qp.quotient_tape(ported(cs))
    C = int(qt.sources[:, 0].max()) + 1
    rng = np.random.default_rng(6)
    stack = torch.from_numpy(np.stack(list(rand_evals(rng, range(C), n).values())).view(np.int32).reshape(C, n, 8).copy())
    x = torch.from_numpy(rand_evals(rng, [0], n)[0].view(np.int32).reshape(n, 8).copy())
    uniforms = torch.stack([nt.mont_tensor(v, "cpu") for v in (3, 5, 7, 11, 13)])
    full = qp.quotient_tape_eval(qt, stack, x, uniforms)
    rows = torch.tensor([0, 1, 2, 3, 4, 5, 6, n // 2, n - 6, n - 5, n - 4, n - 3, n - 2, n - 1])
    assert torch.equal(qp.quotient_tape_eval_plain(qt, stack, x, uniforms, rows), full[rows])
    # a rotation is an index offset: rolling the stack by one row rolls the output
    rolled = qp.quotient_tape_eval(qt, torch.roll(stack, -1, 1).contiguous(), torch.roll(x, -1, 0).contiguous(), uniforms)
    assert torch.equal(rolled, torch.roll(full, -1, 0))


def test_engine_contract():
    cs = simple_cs()
    dq = DeviceQuotient(ported(cs), 5, "cpu")
    col = np.zeros((32, 4), np.uint64)
    with pytest.raises(KeyError):
        dq.feed_evals(("vanishing_r", 0), col)
    with pytest.raises(ValueError):
        dq.feed_evals(dq.key_order[0], np.zeros((16, 4), np.uint64))
    with pytest.raises(RuntimeError, match="before finalize"):
        dq.run_coset(FR_GENERATOR, 1, 2, 3, 4)
    for key in dq.key_order[1:]:
        dq.feed_evals(key, col)
    with pytest.raises(RuntimeError, match="before feed_evals"):
        dq.finalize()
    dq.feed_evals(dq.key_order[0], col)
    dq.finalize()
    with pytest.raises(RuntimeError, match="after finalize"):
        dq.feed_evals(dq.key_order[0], col)
    with pytest.raises(RuntimeError, match="twice"):
        dq.finalize()


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card path does not apply")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceQuotient(ported(simple_cs()), 5, "cuda")
