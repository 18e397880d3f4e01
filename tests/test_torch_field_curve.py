"""Port field and curve ops (PyTorch, CPU) vs the JAX package and the oracle.

Inputs are numpy-seeded ints; both packages get the same values, and the
outputs are compared exactly (integer field arithmetic), points as affine
points."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_aggregation_tpu.fields import MONT_R, Q, R
from halo2_aggregation_tpu.oracle import curve as oc
from halo2_aggregation_tpu.ops import curve_ops as jco
from halo2_aggregation_tpu.ops import field_ops as jfo
from halo2_aggregation_tpu.utils.u64 import ints_to_u64, u64_to_ints
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops import field_ops as fo
from halo2_aggregation_tpu_torch.ops import limbs

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

RNG = np.random.default_rng(0x70C4)
N = 24


def _rand(p, n):
    return [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(n)]


def _operands(p):
    """Edge values first (0, 1, p - 1, p - 2, 2^255 mod p), then random."""
    a = [0, 1, p - 1, p - 2, (1 << 255) % p] + _rand(p, N - 5)
    b = [0, p - 1, p - 1, 1, 5] + _rand(p, N - 5)
    return a, b


FIELDS = {"Fq": (fo.FQ, jfo.FQ, Q), "Fr": (fo.FR, jfo.FR, R)}
BINARY = {
    "add": (fo.add, jfo.add),
    "sub": (fo.sub, jfo.sub),
    "mont_mul": (fo.mont_mul, jfo.mont_mul),
}
UNARY = {
    "neg": (fo.neg, jfo.neg),
    "to_mont": (fo.to_mont, jfo.to_mont),
    "from_mont": (fo.from_mont, jfo.from_mont),
    "mont_sq": (fo.mont_sq, jfo.mont_sq),
}


def _port(xs):
    return limbs.ints_to_tensor(xs, "cpu")


def _jax(xs):
    return jnp.asarray(np.stack([jfo.int_to_limbs(x) for x in xs]))


def _jax_ints(arr):
    return limbs.np_to_ints(limbs.jax_to_port(np.asarray(arr)))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("op", BINARY)
def test_binary_ops_match_jax(field, op):
    spec, jspec, p = FIELDS[field]
    a, b = _operands(p)
    got = limbs.tensor_to_ints(BINARY[op][0](_port(a), _port(b), spec))
    want = _jax_ints(BINARY[op][1](_jax(a), _jax(b), jspec))
    assert got == want
    rinv = pow(MONT_R, -1, p)
    ref = {
        "add": [(x + y) % p for x, y in zip(a, b)],
        "sub": [(x - y) % p for x, y in zip(a, b)],
        "mont_mul": [x * y * rinv % p for x, y in zip(a, b)],
    }[op]
    assert got == ref


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("op", UNARY)
def test_unary_ops_match_jax(field, op):
    spec, jspec, p = FIELDS[field]
    a, _ = _operands(p)
    got = limbs.tensor_to_ints(UNARY[op][0](_port(a), spec))
    want = _jax_ints(UNARY[op][1](_jax(a), jspec))
    assert got == want


@pytest.mark.parametrize("field", FIELDS)
def test_inverse_matches_jax_and_fermat(field):
    spec, jspec, p = FIELDS[field]
    a = [0, 1, p - 1] + _rand(p, 5)
    got = limbs.tensor_to_ints(fo.inv(_port(a), spec))
    assert got == _jax_ints(jfo.inv(_jax(a), jspec))
    # Montgomery in and out: a * R -> a^-1 * R
    rinv = pow(MONT_R, -1, p)
    assert got == [pow(x * rinv % p, p - 2, p) * MONT_R % p for x in a]


def test_is_zero_and_select():
    a = _port([0, 1, 0, R - 1])
    assert fo.is_zero(a).tolist() == [True, False, True, False]
    b = _port([7, 8, 9, 10])
    mask = torch.tensor([True, False, True, False])
    assert limbs.tensor_to_ints(fo.select(mask, a, b)) == [0, 8, 0, 10]


def test_limb_layout_round_trips():
    xs = [0, 1, (1 << 256) - 1, Q, R] + _rand(1 << 256, 11)
    t = limbs.ints_to_tensor(xs, "cpu")
    assert t.dtype == torch.int32 and t.shape == (16, 8)
    assert limbs.tensor_to_ints(t) == xs
    j = limbs.port_to_jax(t)
    assert j.shape == (16, 32) and limbs.np_to_ints(limbs.jax_to_port(j)) == xs
    assert np.array_equal(j, np.stack([jfo.int_to_limbs(x) for x in xs]))
    u = limbs.port_to_u64(t)
    assert np.array_equal(u, ints_to_u64(xs)) and u64_to_ints(u) == xs
    assert np.array_equal(limbs.u64_to_port(u), t.numpy())


def _rand_points(n):
    g = oc.g1_generator()
    return [oc.g1_mul(g, int(RNG.integers(1, 1 << 62))) for _ in range(n)]


def _both(pts):
    return (
        co.affine_to_jac(co.affine_from_ints(pts, "cpu")),
        jco.affine_to_jac(jco.affine_from_ints(pts)),
    )


def test_double_and_add_match_jax_and_oracle():
    pts, qts = _rand_points(6), _rand_points(6)
    (p, jp), (q, jq) = _both(pts), _both(qts)
    got_dbl = co.jac_to_ints(co.jac_double(p))
    assert got_dbl == jco.jac_to_ints(jco.jac_double(jp)) == [oc.g1_double(x) for x in pts]
    got_add = co.jac_to_ints(co.jac_add(p, q))
    assert got_add == jco.jac_to_ints(jco.jac_add(jp, jq))
    assert got_add == [oc.g1_add(a, b) for a, b in zip(pts, qts)]
    # jac_eq: the same elements in other representatives, and other elements
    twice = co.jac_add(p, p)
    assert co.jac_eq(twice, co.jac_double(p)).all() and not torch.equal(twice.z, p.z)
    assert not co.jac_eq(twice, p).any()
    ident = co.jac_identity((6,), "cpu")
    assert co.jac_eq(ident, co.JacPoint(p.x, p.y, torch.zeros_like(p.z))).all()
    assert not co.jac_eq(ident, p).any()


def test_add_edge_cases_match_jax():
    """p + p (doubling), p + (-p) (identity), identity on either side."""
    g = oc.g1_generator()
    r = _rand_points(1)[0]
    pts = [g, g, None, g, None, r]  # 6 lanes: the same jit shape as above
    qts = [g, oc.g1_neg(g), g, None, None, r]
    (p, jp), (q, jq) = _both(pts), _both(qts)
    got = co.jac_to_ints(co.jac_add(p, q))
    assert got == jco.jac_to_ints(jco.jac_add(jp, jq))
    assert got == [oc.g1_add(a, b) for a, b in zip(pts, qts)]


def test_jac_sum_matches_jax():
    pts = _rand_points(6) + [None]
    p, jp = _both(pts)
    got = co.jac_to_ints(co.jac_sum(p))
    js = jco.jac_sum(jp)
    want = jco.jac_to_ints(jco.JacPoint(js.x[None], js.y[None], js.z[None]))
    acc = None
    for pt in pts:
        acc = oc.g1_add(acc, pt)
    assert got == want == [acc]


@pytest.mark.parametrize("lane_axis", [0, 1], ids=["lanes_first", "batch_first"])
def test_jac_segment_sum_matches_jax(lane_axis):
    """The plain segmented sum against the JAX `jac_segment_sum` (one scan
    over segment ids) and `jac_sum` a segment, as affine points: 9 lanes of
    B = 2 in segments of 3, 0, 3 and 3 lanes, with an identity lane and a
    point beside its negation; an empty segment is the identity (1, 1, 0).
    The wrapper gives a CPU tensor the plain version and counts no launch."""
    from halo2_aggregation_tpu_torch.ops import ec_kernels as ek

    offsets = [0, 3, 3, 6, 9]  # equal lengths: one compile of the JAX jac_sum
    M, Bn = offsets[-1], 2
    rows = [_rand_points(M) for _ in range(Bn)]
    rows[0][3] = None
    rows[1][6], rows[1][7] = rows[1][8], oc.g1_neg(rows[1][8])
    flat = [rows[b][i] for i in range(M) for b in range(Bn)]  # lanes first
    p, jp = _both(flat)
    p = co.JacPoint(*(c.reshape(M, Bn, 8) for c in p))
    jp = jco.JacPoint(*(c.reshape(M, Bn, -1) for c in jp))
    if lane_axis == 1:
        p = co.JacPoint(*(c.transpose(0, 1) for c in p))  # a strided view
    before = ek.jac_segment_sum.launches
    got = ek.jac_segment_sum(p, offsets, lane_axis)
    assert ek.jac_segment_sum.launches == before
    assert got.x.shape == (4, Bn, 8)
    seg_ids = np.repeat(np.arange(4), np.diff(offsets)).astype(np.int32)
    js = jco.jac_segment_sum(jp, seg_ids, 4)
    flat_ints = co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in got)))
    assert flat_ints == jco.jac_to_ints(jco.JacPoint(*(np.asarray(c).reshape(4 * Bn, -1) for c in js)))
    for j, (lo, hi) in enumerate(zip(offsets, offsets[1:])):
        if lo == hi:
            want = [None] * Bn
        else:
            seg = jco.jac_sum(jco.JacPoint(*(c[lo:hi] for c in jp)))
            want = jco.jac_to_ints(seg)
        assert flat_ints[j * Bn : (j + 1) * Bn] == want
        assert want == [_fold(rows[b][lo:hi]) for b in range(Bn)]
    ident = co.jac_identity((Bn,), "cpu")
    assert all(torch.equal(c[1], i) for c, i in zip(got, ident))
    with pytest.raises(ValueError):
        co.jac_segment_sum(p, [0, 3, 2], lane_axis)


def _fold(pts):
    acc = None
    for pt in pts:
        acc = oc.g1_add(acc, pt)
    return acc


def test_identity_and_affine_codec():
    ident = co.jac_identity((3,), "cpu")
    assert co.jac_to_ints(ident) == [None] * 3
    pts = _rand_points(3) + [None]
    a = co.affine_from_ints(pts, "cpu")
    ja = jco.affine_from_ints(pts)
    assert np.array_equal(limbs.port_to_jax(a.x), np.asarray(ja.x))
    assert a.inf.tolist() == np.asarray(ja.inf).tolist()
    assert co.jac_to_ints(co.affine_to_jac(a)) == pts
