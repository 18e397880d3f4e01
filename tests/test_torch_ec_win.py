"""K1's and K8's wrappers on CPU tensors (their plain versions) vs the JAX
package's scalar-mul and the oracle, compared as affine points.

The CUDA kernel itself runs only on the card (`chip_smoke.py`); its
per-lane code is also built with g++ in `test_torch_host_core.py`."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_aggregation_tpu.fields import R
from halo2_aggregation_tpu.oracle import curve as oc
from halo2_aggregation_tpu.ops import curve_ops as jco
from halo2_aggregation_tpu.ops.ec_pallas import scalar_mul_auto
from halo2_aggregation_tpu.ops.limbs import ints_to_limbs
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops.ec_kernels import scalar_mul, scalar_mul_ladder, scalar_mul_win
from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

RNG = np.random.default_rng(0xEC01)


def _doubling_scalars():
    """Scalars 16*prefix + d with 16*prefix == +-d (mod r): the last add
    meets acc == d*P (the doubling branch) or acc == -d*P (identity)."""
    inv16 = pow(16, -1, R)
    ks = []
    for d in range(1, 16):
        for sign in (1, -1):
            prefix = sign * d * inv16 % R
            if prefix < 1 << 252:
                ks.append(16 * prefix + d)
    return ks


@pytest.fixture(scope="module")
def lanes():
    """12 lanes, run once through the wrapper on CPU tensors as a (3, 4)
    batch: random points and scalars, a zero scalar, scalars 1 and r - 1,
    an identity point, and two full-width scalars that hit the doubling and
    cancelling branches."""
    g = oc.g1_generator()
    pts = [oc.g1_mul(g, int(RNG.integers(1, 1 << 62))) for _ in range(10)] + [None, g]
    ks = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(6)]
    ks += _doubling_scalars()[:2] + [0, 1, R - 1, 5]  # lane 10 is an identity point
    P = co.affine_to_jac(co.affine_from_ints(pts, "cpu"))
    before = scalar_mul_win.launches
    out = scalar_mul_win(
        co.JacPoint(*(c.reshape(3, 4, 8) for c in P)), ints_to_tensor(ks, "cpu").reshape(3, 4, 8)
    )
    launched = scalar_mul_win.launches - before
    return pts, ks, out, launched


def test_plain_matches_oracle_and_keeps_shape(lanes):
    pts, ks, out, launched = lanes
    assert out.x.shape == (3, 4, 8)
    got = co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in out)))
    assert got == [oc.g1_mul(p, k) if p is not None else None for p, k in zip(pts, ks)]
    assert launched == 0, "a CPU tensor must not count a kernel launch"


def test_plain_matches_jax_scalar_mul(lanes):
    """The CPU branch of JAX `scalar_mul_auto` is `curve_ops.scalar_mul`
    (254-bit double-and-add); it covers the lanes whose scalars are < r."""
    pts, ks, out, _ = lanes
    got = co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in out)))
    keep = [i for i, k in enumerate(ks) if k < R]
    jp = jco.affine_to_jac(jco.affine_from_ints([pts[i] for i in keep]))
    js = jnp.asarray(ints_to_limbs([ks[i] for i in keep]))
    want = jco.jac_to_ints(scalar_mul_auto(jp, js, 254))
    assert [got[i] for i in keep] == want


def test_identity_outputs_have_zero_z(lanes):
    pts, ks, out, _ = lanes
    zero_z = (out.z == 0).all(-1).reshape(-1).tolist()
    assert zero_z == [p is None or oc.g1_mul(p, k) is None for p, k in zip(pts, ks)]
    assert zero_z[8] and zero_z[10]  # the zero scalar, the identity point


def test_doubling_scalars_hit_the_edge_cases():
    """Before the last add, acc = (k >> 4) * 16 * P and the add picks
    table[k & 15]: the two are equal or opposite."""
    ks = _doubling_scalars()
    assert len(ks) >= 2
    for k in ks:
        d = k & 15
        assert k < 1 << 256 and (k >> 4) * 16 % R in (d, R - d)


def test_window_digits_match_jax_extraction(lanes):
    """Digit w covers bits [4w, 4w + 4): the JAX wrapper's extraction from
    8-bit limbs (`scalar_mul_pallas_win`) gives the same digits."""
    _, ks, _, _ = lanes
    got = co.window_digits(ints_to_tensor(ks, "cpu")).numpy()
    l8 = np.asarray(ints_to_limbs(ks))
    want = np.stack([(l8[:, w // 2] >> (4 * (w % 2))) & 15 for w in range(64)], axis=1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "contiguity"],
)
def test_wrapper_rejects_bad_inputs(lanes, bad):
    pts, ks, _, _ = lanes
    P = co.affine_to_jac(co.affine_from_ints(pts[:4], "cpu"))
    s = ints_to_tensor(ks[:4], "cpu")
    if bad == "dtype":
        s = s.to(torch.int64)
    elif bad == "shape":
        s = s[:3]
    else:
        P = co.JacPoint(P.x.t().contiguous().t(), P.y, P.z)
    with pytest.raises(ValueError):
        scalar_mul_win(P, s)


def test_ladder_matches_jax_scalar_mul_and_oracle(lanes):
    """K8's wrapper on CPU tensors (the plain double-and-add over 254 bits)
    on the lanes whose scalars are < r, as a (2, 5) batch: equal to the
    JAX CPU `scalar_mul` (254 bits), to K1's plain version and to the
    oracle, with no launch counted."""
    pts, ks, out, _ = lanes
    keep = [i for i, k in enumerate(ks) if k < R][:10]
    P = co.affine_to_jac(co.affine_from_ints([pts[i] for i in keep], "cpu"))
    s = ints_to_tensor([ks[i] for i in keep], "cpu")
    before = scalar_mul_ladder.launches
    got_t = scalar_mul_ladder(co.JacPoint(*(c.reshape(2, 5, 8) for c in P)), s.reshape(2, 5, 8))
    assert scalar_mul_ladder.launches == before
    assert got_t.x.shape == (2, 5, 8)
    got = co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in got_t)))
    jp = jco.affine_to_jac(jco.affine_from_ints([pts[i] for i in keep]))
    js = jnp.asarray(ints_to_limbs([ks[i] for i in keep]))
    assert got == jco.jac_to_ints(jco.scalar_mul(jp, js, 254))
    win = co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in out)))
    assert got == [win[i] for i in keep]
    assert got == [oc.g1_mul(pts[i], ks[i]) if pts[i] is not None else None for i in keep]


def test_scalar_mul_dispatches_by_method(lanes):
    pts, ks, _, _ = lanes
    P = co.affine_to_jac(co.affine_from_ints(pts[:2], "cpu"))
    s = ints_to_tensor(ks[:2], "cpu")
    assert co.jac_to_ints(scalar_mul(P, s, "win")) == co.jac_to_ints(scalar_mul_win(P, s))
    with pytest.raises(ValueError, match="method"):
        scalar_mul(P, s, "bits")
    with pytest.raises(ValueError, match="nbits"):
        scalar_mul_ladder(P, s, 257)
