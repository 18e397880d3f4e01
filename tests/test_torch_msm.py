"""The device MSM's plain path on CPU tensors against the JAX package and
the native engine: the digit recodings bit for bit, the mixed add against
the JAX `_jac_add_mixed` (run as jnp ops on (32, T) limb arrays), the
plain K7 and K9 against the JAX `ops/msm.py::msm` and the native
Pippenger, `DeviceSRS` against `Params.commit_lagrange`, and the JAX
resident SRS carried over by `convert.srs_from_jax`.  All comparisons are
exact: equal bits, or equal affine points.

K7 and K9 themselves run only on the card (`chip_smoke.py`); their
per-thread code is also built with g++ in `test_torch_host_core.py`."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_aggregation_tpu.fields import Q, R
from halo2_aggregation_tpu.ops import curve_ops as jco
from halo2_aggregation_tpu.ops import ec_pallas as ep
from halo2_aggregation_tpu.ops import msm as jmsm
from halo2_aggregation_tpu.ops.field_ops import FQ as JFQ
from halo2_aggregation_tpu.ops.limbs import ints_to_limbs
from halo2_aggregation_tpu.oracle import curve as oc
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.utils import native
from halo2_aggregation_tpu.utils.u64 import ints_to_u64, u64_to_points
from halo2_aggregation_tpu_torch import convert
from halo2_aggregation_tpu_torch.convert import params_from_reference
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops import msm as m
from halo2_aggregation_tpu_torch.ops import msm_kernels as mk
from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor, tensor_to_ints
from halo2_aggregation_tpu_torch.plonk.kzg import DeviceSRS

torch.set_num_threads(1)  # small tensors; the test workers share the cores

RNG = np.random.default_rng(0x3537)
EDGE_SCALARS = [0, 1, R - 1, ((1 << 254) - 1) % R]


def _rand_scalars(n):
    return [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(n)]


def _rand_points(n):
    g = oc.g1_generator()
    base = ints_to_u64([g[0], g[1]]).reshape(-1)
    aff, inf = native.g1_batch_mul_win(base, ints_to_u64([int(RNG.integers(1, 1 << 62)) for _ in range(n)]))
    return u64_to_points(aff, inf)


def _affine(p: co.JacPoint):
    return co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in p)))


def _edge_lanes(n):
    """n points and scalars with, mixed in: an infinity point, zero scalars,
    the scalars 1, r - 1 and 2^254 - 1 mod r, and, on adjacent rows 6..9
    (one contiguous chunk at the chunkings used here), with one scalar: a
    point P, then -P (the identity branch), then P into that emptied
    bucket, then P again (equal digits: the doubling branch)."""
    pts = _rand_points(n)
    ks = _rand_scalars(n)
    ks[: len(EDGE_SCALARS)] = EDGE_SCALARS
    pts[4] = None
    ks[5] = 0
    r = 6
    for j, p in enumerate((oc.g1_neg(pts[r]), pts[r], pts[r]), 1):
        pts[r + j], ks[r + j] = p, ks[r]
    return pts, ks


def _want(pts, ks):
    return oc.g1_msm([p for p in pts], ks)


def test_signed_windows_match_jax():
    ks = EDGE_SCALARS + _rand_scalars(60)
    got = m.signed_windows(ints_to_tensor(ks, "cpu")).numpy()
    want = np.asarray(ep.signed_windows_dev(jnp.asarray(np.asarray(ints_to_limbs(ks), np.int32)), 254, 5, 4))
    assert got.dtype == np.uint8 and got.shape == (52, 64)
    assert np.array_equal(got.astype(np.int32), want)
    for t, k in enumerate(ks):
        mag, sign = got[:, t] & 31, got[:, t] >> 5
        assert mag.max() <= 16
        assert sum(int(a) * (-1 if s else 1) << (5 * w) for w, (a, s) in enumerate(zip(mag, sign))) == k


def test_signed_windows_any_256_bit_scalar():
    """The recoding needs no headroom beyond 52 windows, even at 2^256 - 1."""
    ks = [(1 << 256) - 1, 1 << 255, (1 << 255) - 1]
    got = m.signed_windows(ints_to_tensor(ks, "cpu")).numpy()
    for t, k in enumerate(ks):
        d = [int(e & 31) * (-1 if e >> 5 else 1) for e in got[:, t]]
        assert sum(v << (5 * w) for w, v in enumerate(d)) == k


def test_unsigned_windows_follow_the_kernel_rule():
    ks = EDGE_SCALARS + [(1 << 256) - 1] + _rand_scalars(11)
    got = m.unsigned_windows(ints_to_tensor(ks, "cpu")).numpy()
    l8 = np.asarray(ints_to_limbs(ks))
    want = np.stack([(l8[:, w // 2] >> (4 * (w % 2))) & 15 for w in range(64)], axis=0)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


# --- the mixed add against the JAX kernel's, as jnp ops on (32, T) -------

T = 8
_RINV = pow(1 << 256, -1, Q)


def _fc():
    tconst = lambda v: jnp.asarray(np.tile(np.asarray(v, np.int32).reshape(ep.NLIMBS, 1), (1, T)))
    return (
        tconst(JFQ.p_limbs),
        tconst(JFQ.p_inv_neg),
        tconst(ep._sub_const_cols(Q)),
        tconst(ep._ints_to_cols((1 << 256) - 2 * Q, ep.NLIMBS)),
        tconst(JFQ.one_mont),
    )


def _cols(vals):
    cols = np.zeros((ep.NLIMBS, T), np.int32)
    for t, v in enumerate(vals):
        cols[:, t] = ep._ints_to_cols(v, ep.NLIMBS)
    return jnp.asarray(cols)


def _uncols(arr):
    a = np.asarray(arr, dtype=object)
    return [int(sum(int(a[i, t]) << (8 * i) for i in range(ep.NLIMBS))) % Q for t in range(T)]


def test_jac_add_mixed_matches_jax():
    """Edge lanes of tests/test_ec_pallas.py:142-159: P + P (doubling),
    P + (-P) (Z = 0), a bucket at infinity, then random lanes.  The plain
    add takes the JAX formulas and selects, so even the Jacobian
    coordinates agree (mod q)."""
    g = oc.g1_generator()
    ps = [oc.g1_mul(g, int(RNG.integers(1, 1 << 62))) for _ in range(T)]
    qs = [oc.g1_mul(g, int(RNG.integers(1, 1 << 62))) for _ in range(T)]
    qs[0] = ps[0]
    qs[1] = oc.g1_neg(ps[1])
    ps[2] = None
    mont = lambda v: v * (1 << 256) % Q
    jx = [mont(p[0] if p else 1) for p in ps]
    jy = [mont(p[1] if p else 1) for p in ps]
    jz = [mont(1 if p else 0) for p in ps]
    qx, qy = [mont(q[0]) for q in qs], [mont(q[1]) for q in qs]
    want = ep._jac_add_mixed(_fc(), _cols(jx), _cols(jy), _cols(jz), _cols(qx), _cols(qy))
    P = co.JacPoint(*(ints_to_tensor(v, "cpu") for v in (jx, jy, jz)))
    got = co.jac_add_mixed(P, ints_to_tensor(qx, "cpu"), ints_to_tensor(qy, "cpu"))
    for g_c, w_c in zip(got, want):
        assert [v % Q for v in tensor_to_ints(g_c)] == _uncols(w_c)
    assert _affine(got) == [oc.g1_add(p, q) for p, q in zip(ps, qs)]


# --- the plain K7 / K9 --------------------------------------------------


@pytest.fixture(scope="module")
def lanes24():
    """n = 24 edge lanes, the plain MSM of both kinds, and the JAX msm (its
    CPU branch: per-lane 256-bit scalar_mul, then a tree sum)."""
    pts, ks = _edge_lanes(24)
    A = co.affine_from_ints(pts, "cpu")
    s = ints_to_tensor(ks, "cpu")
    before = (mk.msm_bucket_s5.launches, mk.msm_bucket_u4.launches)
    got = {signed: _affine(m.msm(A, s, signed=signed))[0] for signed in (True, False)}
    launched = (mk.msm_bucket_s5.launches, mk.msm_bucket_u4.launches) != before
    jax_pts = jco.affine_from_ints(pts)
    jres = jmsm.msm(jax_pts, jnp.asarray(np.asarray(ints_to_limbs(ks), np.int32)))
    jax_out = jco.jac_to_ints(jco.JacPoint(jres.x[None], jres.y[None], jres.z[None]))[0]
    return pts, ks, got, jax_out, launched


@pytest.mark.parametrize("signed", [True, False], ids=["k7_signed", "k9_unsigned"])
def test_plain_msm_matches_jax_msm(lanes24, signed):
    pts, ks, got, jax_out, launched = lanes24
    assert got[signed] == jax_out == _want(pts, ks)
    assert not launched, "a CPU tensor must not count a kernel launch"


@pytest.mark.parametrize("signed", [True, False], ids=["k7_signed", "k9_unsigned"])
def test_plain_msm_matches_native_at_2_10(signed):
    n = 1 << 10
    pts, ks = _edge_lanes(n)
    got = _affine(m.msm(co.affine_from_ints(pts, "cpu"), ints_to_tensor(ks, "cpu"), signed=signed))[0]
    assert got == native.g1_msm(pts, ks)


@pytest.mark.parametrize("chunks", [1, 5, 24])
def test_plain_msm_same_at_any_chunking(lanes24, chunks):
    """The chunk count changes the order of the adds, not the sum; 5 chunks
    of 5 leave a ragged last chunk of 4, 24 are chunks of one point."""
    pts, ks, got, _, _ = lanes24
    A = co.affine_from_ints(pts, "cpu")
    s = torch.where(A.inf[:, None], 0, ints_to_tensor(ks, "cpu"))
    out = m.msm_bucket_plain(A.x, A.y, m.signed_windows(s), True, chunks)
    assert _affine(out)[0] == got[True]


@pytest.mark.parametrize("signed", [True, False], ids=["k7_signed", "k9_unsigned"])
def test_plain_partials_take_contiguous_chunks(signed):
    """Chunk c of the plain bucket pass holds the points [c L, (c + 1) L):
    its fold in window w equals the oracle's sum of d_i P_i over those rows,
    with d_i the window's digit; a chunk of zero scalars folds to the
    identity, and the ragged last chunk stops at n."""
    n, C = 22, 4  # L = 6: chunks of 6, 6, 6, 4
    pts, ks = _edge_lanes(n)
    for i in range(12, 18):  # chunk 2: every digit zero
        ks[i] = 0
    A = co.affine_from_ints(pts, "cpu")
    s = torch.where(A.inf[:, None], 0, ints_to_tensor(ks, "cpu"))
    digits = m.signed_windows(s) if signed else m.unsigned_windows(s)
    parts = m.bucket_partials_plain(A.x, A.y, digits, signed, C)
    got = _affine(parts)
    L = mk.chunk_len(n, C)
    assert L == 6
    dn = digits.numpy().astype(np.int64)
    d = np.where(dn >> 5 == 1, -(dn & 31), dn & 31) if signed else dn
    for w in (0, 1, 7, mk.WINDOWS[signed] - 1):
        for c in range(C):
            rows = range(c * L, min(n, (c + 1) * L))
            want = oc.g1_msm([pts[i] for i in rows], [int(d[w, i]) % R for i in rows])
            assert got[w * C + c] == want, (w, c)
        assert got[w * C + 2] is None


def test_chunk_longer_than_the_sort_offsets_raises():
    """A chunk holds at most 2^15 points (15-bit offsets in the sort's
    scratch): fewer chunks than that allows raise, in the plain version as
    in the launcher's check."""
    n = (1 << 15) + 1
    x = torch.zeros((n, 8), dtype=torch.int32)
    digits = torch.zeros((52, n), dtype=torch.uint8)
    with pytest.raises(ValueError, match="at most 32768"):
        m.msm_bucket_plain(x, x, digits, True, 1)
    with pytest.raises(ValueError, match="at most 32768"):
        mk.check_chunks(1 << 21, 63)
    assert mk.check_chunks(1 << 21, 64) == 1 << 15
    with pytest.raises(ValueError, match="chunks"):
        mk.check_chunks(8, 0)


def test_choose_chunks():
    """The grid fills whole waves of the kernel's occupancy: at n = 2^21,
    with 4 or 3 blocks of 128 threads on each of 132 SMs, n_win x C / 128
    blocks come to `WAVES` whole waves less a remainder below n_win; smaller n keep 128
    points a chunk, larger n at most 2^15."""
    for signed, n_win in ((True, 52), (False, 64)):
        assert m.choose_chunks(1, signed, 4, 132) == 1
        assert m.choose_chunks(1 << 9, signed, 4, 132) == 4
        assert m.choose_chunks(1 << 16, signed, 4, 132) == 512
        for blocks_per_sm in (4, 3):
            c = m.choose_chunks(1 << 21, signed, blocks_per_sm, 132)
            slots = blocks_per_sm * 132 * m.WAVES
            assert c % 128 == 0 and slots - n_win < n_win * c // 128 <= slots
            shape = m.grid_shape(1 << 21, signed, blocks_per_sm, 132)
            assert shape["chunks"] == c and m.WAVES - 0.13 < shape["waves"] <= m.WAVES
            assert shape["points_a_chunk"] == -(-(1 << 21) // c)
        assert mk.chunk_len(1 << 27, m.choose_chunks(1 << 27, signed, 4, 132)) == 1 << 15
    assert m.WAVES == 2
    assert m.choose_chunks(1 << 21, True, 4, 132) == 2560
    assert m.choose_chunks(1 << 21, False, 4, 132) == 2048
    assert m.choose_chunks(1 << 21, True, 3, 132) == 1920
    assert m.choose_chunks(1 << 21, False, 3, 132) == 1536


# --- DeviceSRS and the JAX resident SRS ---------------------------------

K_SRS = 5


@pytest.fixture(scope="module")
def srs_cpu():
    params = kzg.setup(K_SRS)
    return params, DeviceSRS(params_from_reference(params), "cpu")


@pytest.mark.parametrize("form", ["u64", "short_u64", "ints"])
def test_device_srs_commit_matches_params(srs_cpu, form):
    params, srs = srs_cpu
    n = params.n
    vals = _rand_scalars(n)
    if form == "u64":
        values = ints_to_u64(vals)
    elif form == "short_u64":
        values = ints_to_u64(vals[: n // 2])
    else:
        values = vals[:5] + [R + 3]  # reduced mod r, zero-padded
    got = srs.commit_lagrange(values)
    assert got == params.commit_lagrange(values)
    assert got is not None


def test_device_srs_zero_and_one_hot(srs_cpu):
    params, srs = srs_cpu
    assert srs.commit_lagrange(np.zeros((params.n, 4), np.uint64)) is None
    one_hot = np.zeros((params.n, 4), np.uint64)
    one_hot[3, 0] = 1
    assert srs.commit_lagrange(one_hot, signed=False) == params.g_lagrange[3]
    with pytest.raises(ValueError):
        srs.commit_lagrange(list(range(params.n + 1)))


def test_srs_from_jax_gives_the_resident_points(srs_cpu):
    """The JAX `Params._device_points` as `kzg.py:139-150` builds them
    (8-bit limbs, Montgomery on the device), repacked."""
    from halo2_aggregation_tpu.ops import field_ops as jfo
    from halo2_aggregation_tpu.utils.u64 import u64_view8

    params, srs = srs_cpu
    xs = jnp.asarray(u64_view8(params.g_lagrange_u64[:, :4])).astype(jnp.int32)
    ys = jnp.asarray(u64_view8(params.g_lagrange_u64[:, 4:])).astype(jnp.int32)
    jax_points = jco.AffinePoint(
        jfo.to_mont_chunked(xs, jfo.FQ), jfo.to_mont_chunked(ys, jfo.FQ),
        jnp.asarray(params.g_lagrange_inf.astype(bool)),
    )
    got = convert.srs_from_jax(jax_points, "cpu")
    for a, b in zip(got, srs.points):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cuda_requests_raise_without_a_card(srs_cpu):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card path does not apply")
    params, srs = srs_cpu
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceSRS(params, "cuda")
    P = srs.points
    digits = m.signed_windows(torch.zeros((params.n, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_bucket_s5(P.x, P.y, digits, 1)
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_bucket_u4(P.x, P.y, m.unsigned_windows(torch.zeros((params.n, 8), dtype=torch.int32)), 1)


def test_setup_device_fixed_base_products(monkeypatch):
    """`kzg.setup`'s device helper on a CPU tensor (the plain K1): n
    fixed-base products of the generator equal `native.g1_batch_mul`, as
    Jacobian points and through `native.g1_normalize` as the windowed
    native products give them; `H2A_DEVICE_MSM=1` without a device raises a
    ValueError that names the argument."""
    from halo2_aggregation_tpu_torch.plonk import kzg as pkzg

    g = oc.g1_generator()
    ks = _rand_scalars(4) + EDGE_SCALARS
    u64 = ints_to_u64(ks)
    jac = pkzg._device_g1_mul(g, u64, "cpu")
    want = native.g1_batch_mul(g, ks)
    assert co.jac_to_ints(jac) == want
    aff, inf = native.g1_normalize(pkzg._jac_to_u64(jac))
    base = ints_to_u64([g[0], g[1]]).reshape(-1)
    aff_n, inf_n = native.g1_batch_mul_win(base, u64)
    assert np.array_equal(aff, aff_n) and np.array_equal(inf, inf_n)
    assert u64_to_points(aff, inf) == want
    monkeypatch.setenv("H2A_DEVICE_MSM", "1")
    with pytest.raises(ValueError, match="`device`"):
        pkzg._batch_g1_mul(g, [1] * ((1 << 10) + 1))
