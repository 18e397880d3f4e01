"""K3-K5's plain versions (`halo2_aggregation_tpu_torch/ops/ntt.py`) against
the JAX XLA NTT (`ops/ntt.py`: `NttPlan`, `_ntt_core`, `Domain`,
`pow_series_dev`) and the native engine (`NativeDomain`, `pow_series`),
exactly: canonical Montgomery bytes.  This is how the JAX package holds its
Pallas NTT on the CPU (`tests/test_ntt_pallas.py` against `_ntt_core`).
The JAX transforms compile once per k (seconds to tens of seconds each on
the CPU), so they are compared at k = 7 and 8; the native engine at every
k (k = 8 and 11 are two-pass plans of the fused kernels, 4 + 4 and 6 + 5
stages; the passes themselves run in `tests/test_torch_host_core.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.fields import FR_GENERATOR, R, fr_omega
from halo2_aggregation_tpu.ops import ntt as jnt
from halo2_aggregation_tpu.ops.field_ops import FR as JFR
from halo2_aggregation_tpu.plonk import engine
from halo2_aggregation_tpu_torch import convert
from halo2_aggregation_tpu_torch.ops import ntt as nt
from halo2_aggregation_tpu_torch.ops.limbs import port_to_jax, port_to_u64, u64_to_port

torch.set_num_threads(1)  # small tensors; the test workers share the cores

C = 3  # columns per batch


def rand_cols(rng, c, n) -> np.ndarray:
    """(c, n, 4) u64 canonical values (top limb below r's)."""
    a = rng.integers(0, 1 << 63, size=(c, n, 4), dtype=np.uint64) * np.uint64(2)
    a |= rng.integers(0, 2, size=(c, n, 4), dtype=np.uint64)
    a[..., 3] &= np.uint64(0x1FFF_FFFF_FFFF_FFFF)
    return a


def to_port(a_u64) -> torch.Tensor:
    return torch.from_numpy(u64_to_port(a_u64).copy())


def counters():
    return [f.launches for f in (nt.ntt_batched, nt.intt_batched, nt.ew_mul_col, nt.ew_mul_scalar, nt.pow_series)]


@pytest.mark.parametrize("k", [7, 8, 9, 10, 11])
def test_transforms_match_jax_and_native(k):
    rng = np.random.default_rng(k)
    n = 1 << k
    cols = rand_cols(rng, C, n)
    br = nt.bit_reverse_indices(k)
    assert np.array_equal(br, jnt._bit_reverse_indices(k))
    tables = nt.NttTables(k, "cpu")
    dom_n = engine.NativeDomain(k)
    dom_j = jnt.Domain(k) if k <= 8 else None
    shift = FR_GENERATOR * pow(fr_omega(k + 2), 3, R) % R
    before = counters()

    # forward: natural coefficients -> natural evaluations
    x = to_port(cols[:, br])
    nt.ntt_batched(x, tables.fwd)
    for c in range(C):
        assert np.array_equal(port_to_u64(x[c]), dom_n.ntt(cols[c]))
        if dom_j is not None:
            want_j = np.asarray(dom_j.ntt(jnp.asarray(port_to_jax(u64_to_port(cols[c])))))
            assert np.array_equal(port_to_jax(x[c]), want_j)

    # inverse: natural evaluations -> bit-reversed coefficients (x 1/n)
    y = to_port(cols)
    nt.intt_batched(y, tables.inv, tables.n_inv)
    for c in range(C):
        natural = y[c][torch.from_numpy(br)]  # bit reversal is an involution
        assert np.array_equal(port_to_u64(natural), dom_n.intt(cols[c]))
        if dom_j is not None:
            want_j = np.asarray(dom_j.intt(jnp.asarray(port_to_jax(u64_to_port(cols[c])))))
            assert np.array_equal(port_to_jax(natural), want_j)

    # the pipeline of run_coset: INTT -> bit-reversed shift powers -> NTT
    scale = nt.pow_series(shift, k, "cpu", bitrev=True)
    scaled = nt.ew_mul_col(y, scale)
    ext = nt.ntt_batched(scaled.clone(), tables.fwd)
    for c in range(C):
        assert np.array_equal(port_to_u64(ext[c]), dom_n.coset_evals(dom_n.intt(cols[c]), shift))
    assert torch.equal(nt.intt_batched(ext, tables.inv, tables.n_inv), scaled)  # intt(ntt(v)) == v
    assert counters() == before  # CPU tensors never launch a kernel


@pytest.mark.parametrize("k", [7, 10])
def test_tables_match_jax_plan(k):
    omega = fr_omega(k)
    tables = nt.NttTables(k, "cpu")
    fwd = convert.twiddles_from_jax(jnt.NttPlan(k, omega))
    inv = convert.twiddles_from_jax(jnt.NttPlan(k, pow(omega, -1, R)))
    assert torch.equal(fwd, tables.fwd) and torch.equal(inv, tables.inv)
    assert port_to_u64(tables.n_inv[None]).tolist() == engine.mont_scalar(pow(1 << k, -1, R)).tolist()


def test_twiddles_from_jax_rejects_a_foreign_table():
    plan = jnt.NttPlan(7, fr_omega(7))
    plan.stage_twiddles[3] = plan.stage_twiddles[3][::-1]
    with pytest.raises(ValueError, match="stage 3"):
        convert.twiddles_from_jax(plan)


@pytest.mark.parametrize("k", [1, 9])
def test_pow_series_matches_jax_and_native(k):
    n = 1 << k
    base = 0x1234_5678_9ABC_DEF0_0FED_CBA9 % R
    start = 77
    want = engine.pow_series(engine.mont_scalar(base), n)
    got = nt.pow_series(base, k, "cpu")
    assert np.array_equal(port_to_u64(got), want)
    want_j = np.asarray(jnt.pow_series_dev(jnp.asarray(JFR.to_mont(base)), n))
    assert np.array_equal(port_to_jax(got), want_j)
    with_start = nt.pow_series(base, k, "cpu", start=start)
    assert np.array_equal(port_to_u64(with_start), engine.pow_series(engine.mont_scalar(base), n, engine.mont_scalar(start)))
    rev = nt.pow_series(base, k, "cpu", bitrev=True)
    assert torch.equal(rev, got[torch.from_numpy(nt.bit_reverse_indices(k))])


def test_elementwise_products():
    rng = np.random.default_rng(5)
    n = 64
    cols = rand_cols(rng, C + 1, n)
    x, col = to_port(cols[:C]), to_port(cols[C])
    s = 0xDEAD_BEEF_1234 % R
    prod = nt.ew_mul_col(x, col)
    scaled = nt.ew_mul_scalar(x, nt.mont_tensor(s, "cpu"))
    for c in range(C):
        assert np.array_equal(port_to_u64(prod[c]), engine.NativeVecOps().mul(cols[c], cols[C]))
        assert np.array_equal(port_to_u64(scaled[c]), engine.NativeVecOps().mul(cols[c], engine.mont_scalar(s)))
    y = x.clone()
    assert nt.ew_mul_col(y, col, out=y) is y and torch.equal(y, prod)  # in place


def test_wrappers_reject_bad_inputs():
    tables = nt.NttTables(4, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        nt.ntt_batched(torch.zeros((1, 12, 8), dtype=torch.int32), tables.fwd)
    with pytest.raises(ValueError, match="twiddles"):
        nt.ntt_batched(torch.zeros((1, 32, 8), dtype=torch.int32), tables.fwd)
    with pytest.raises(ValueError, match="int32"):
        nt.ew_mul_scalar(torch.zeros((4, 8), dtype=torch.int64), tables.n_inv)
    with pytest.raises(ValueError, match="contiguous"):
        nt.ew_mul_col(torch.zeros((2, 16, 8), dtype=torch.int32).transpose(0, 1), tables.fwd)
