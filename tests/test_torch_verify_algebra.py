"""The verifier's other formulations in the port, and the small ops, against
the JAX package on the same inputs.

`fast_prep` (the lane points as coordinates, padded to `lane_pad`), the
unfused `field_algebra`, the sequential `verify_algebra` and
`verify_batch(fast=False)`, the padding lanes through K1's lane (the g++
build of `csrc/ec_win.cuh`) and its plain version, and the small ops of
`ops/field_ops.py`, `ops/curve_ops.py`, `ops/ntt.py` and `ops/msm.py`.
Equality is exact throughout (integer field arithmetic), points compared
as affine points.  The sequential fold's scalar-muls run through the host
oracle here (`_ec_mul_mont` patched to `g1_mul` a lane): the plain K1 costs
seconds a call on the CPU and the fold makes dozens; `chip_smoke.py`'s
`parallel` phase runs the real route to K1 on the card."""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.fields import Q, R
from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.ops import curve_ops as jco
from halo2_aggregation_tpu.ops import field_ops as jfo
from halo2_aggregation_tpu.ops import msm as jmsm
from halo2_aggregation_tpu.ops import ntt as jntt
from halo2_aggregation_tpu.oracle import curve as oc
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk import verifier_tpu as vt
from halo2_aggregation_tpu.plonk.keygen import keygen
from halo2_aggregation_tpu.plonk.prover import create_proof
from halo2_aggregation_tpu.plonk.verifier import parse_proof, verify_proof
from halo2_aggregation_tpu_torch.convert import from_jax_batch, keys_from_reference, params_from_reference
from halo2_aggregation_tpu_torch.ops import build
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops import field_ops as fo
from halo2_aggregation_tpu_torch.ops import limbs
from halo2_aggregation_tpu_torch.ops import msm as pmsm
from halo2_aggregation_tpu_torch.ops import ntt as pntt
from halo2_aggregation_tpu_torch.ops.ec_kernels import glv_constants
from halo2_aggregation_tpu_torch.plonk import fa_fused as ff
from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
from halo2_aggregation_tpu_torch.plonk.verifier import parse_proof as port_parse_proof

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

K = 9
B = 2
RNG = np.random.default_rng(0x7A1)


@pytest.fixture(scope="module")
def setup():
    """Two k = 9 proofs from the JAX package; the batch in both packages."""
    params = kzg.setup(K)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in [(2, 3), (4, 5)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=K)
        pub = [c.public_output()]
        protos.append(([pub], create_proof(params, pk, asg, [pub], seed=90 + a)))
    parsed = [parse_proof(vk, [params.commit_lagrange(col) for col in insts], proof) for insts, proof in protos]
    jb = vt.batch_proofs(vk, parsed)
    pvk = keys_from_reference(vk)
    pparsed = [port_parse_proof(pvk, list(p.inst_comms), proof) for p, (_, proof) in zip(parsed, protos)]
    efws = [tuple(verify_proof(params, vk, insts, proof)[1]) for insts, proof in protos]
    return params, vk, protos, parsed, jb, pvk, pparsed, from_jax_batch(jb, "cpu"), efws


def _oracle_mul(point, scalar_mont):
    """`_ec_mul_mont` through the host oracle, a lane at a time."""
    pts = co.jac_to_ints(point)
    ks = fo.FR.from_mont_tensor(scalar_mont)
    out = [None if p is None else oc.g1_mul(p, k) for p, k in zip(pts, ks)]
    return co.affine_to_jac(co.affine_from_ints(out, point.x.device))


@pytest.mark.parametrize("lane_pad", [1, 2, 3])
def test_fast_prep_matches_jax(setup, lane_pad):
    """Scalars, component sizes and the h_eval linearization exactly, the
    lane points as affine ints (identity padding lanes included)."""
    _, vk, _, parsed, _, pvk, pparsed, _, _ = setup
    jpts, jss, jms, jhc, jkn = vt.fast_prep(vk, parsed, lane_pad=lane_pad)
    pts, ss, ms, hc, kn = vd.fast_prep(pvk, pparsed, "cpu", lane_pad=lane_pad)
    assert ms == tuple(jms) and all(m % lane_pad == 0 for m in ms)
    assert pts.x.shape == (B, sum(ms), 8) and ss.shape == (B, sum(ms), 8)
    assert np.array_equal(ss.numpy(), limbs.jax_to_port(np.asarray(jss)))
    assert np.array_equal(hc.numpy(), limbs.jax_to_port(np.asarray(jhc)))
    assert np.array_equal(kn.numpy(), limbs.jax_to_port(np.asarray(jkn)))
    got = co.jac_to_ints(pts)
    assert got == jco.jac_to_ints(jpts)
    # each component's padding: identity points with zero scalars
    unpadded = vd.fast_prep(pvk, pparsed, "cpu")[2]
    pad_lanes = [off + i for off, m, m0 in zip(vd.segment_offsets(ms), ms, unpadded) for i in range(m0, m)]
    assert len(pad_lanes) == sum(ms) - sum(unpadded)
    for lane in pad_lanes:
        assert all(got[i * sum(ms) + lane] is None for i in range(B))
        assert not ss[:, lane].any()


def test_field_algebra_matches_jax_and_tape(setup):
    """The unfused field algebra equals the JAX `field_algebra` and K2's
    plain tape, bit for bit."""
    _, vk, _, _, jb, pvk, _, pb, _ = setup
    want = [limbs.jax_to_port(np.asarray(a)) for a in vt.field_algebra(vk, jb, B)]
    got = vd.field_algebra(pvk, pb, B)
    tape = ff.field_algebra_fused(pvk, pb, B)
    for name, g, t, w in zip(("h_eval", "x^n", "x^n - 1"), got, tape, want):
        assert np.array_equal(g.numpy(), w), name
        assert torch.equal(g, t), name
    with pytest.raises(ValueError, match="proofs"):
        vd.field_algebra(pvk, pb, B + 1)


def test_verify_algebra_matches_host_and_fast_path(setup, monkeypatch):
    """The sequential H and GWC folds give the host verifier's quads and
    the fast path's (which runs K1's plain version)."""
    _, _, _, _, _, pvk, pparsed, pb, efws = setup
    fast = vd.quads_to_ints(vd.verify_algebra_fast(pvk, pb, pparsed))
    monkeypatch.setattr(vd, "_ec_mul_mont", _oracle_mul)
    out = vd.verify_algebra(pvk, pb, B)
    assert vd.quads_to_ints(out) == fast == efws
    assert torch.equal(out["h_eval"], vd.field_algebra(pvk, pb, B)[0])


def test_verify_batch_sequential_accepts_and_rejects(setup, monkeypatch):
    params, _, protos, _, _, pvk, _, _, efws = setup
    monkeypatch.setattr(vd, "_ec_mul_mont", _oracle_mul)
    pparams = params_from_reference(params)
    insts, proofs = [p[0] for p in protos], [p[1] for p in protos]
    ok, got = vd.verify_batch(pparams, pvk, insts, proofs, device="cpu", fast=False)
    assert ok is True and got == efws
    wrong = [[[insts[0][0][0] + 1]]] + insts[1:]
    ok_bad, _ = vd.verify_batch(pparams, pvk, wrong, proofs, device="cpu", fast=False)
    assert ok_bad is False


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build.build_host_library(tmp_path_factory.mktemp("host_core"))


def test_padding_lanes_through_k1(setup, host_lib):
    """`fast_prep(lane_pad=3)`'s lanes, padding included, through K1's lane
    (g++ build) and its plain version give the oracle's points, and a
    padding lane (the identity, Z = 0) gives the identity with its zero
    scalar and with a nonzero one."""
    _, _, _, _, _, pvk, pparsed, _, _ = setup
    pts, ss, ms, _, _ = vd.fast_prep(pvk, pparsed, "cpu", lane_pad=3)
    ms1 = vd.fast_prep(pvk, pparsed, "cpu")[2]
    pad = vd.segment_offsets(ms)[1] - 1  # the last lane of w
    assert ms[0] > ms1[0], "w must have a padding lane at lane_pad = 3"
    ss = ss.clone()
    ss[1, pad] = limbs.ints_to_tensor([5], "cpu")[0]  # a nonzero scalar on the identity
    P = co.JacPoint(*(c.reshape(-1, 8).contiguous() for c in pts))
    s = ss.reshape(-1, 8).contiguous()
    out = co.JacPoint(*(torch.empty_like(c) for c in P))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    glv = torch.from_numpy(glv_constants().view(np.int32))
    host_lib.h2a_host_ec_win(*(ptr(c) for c in P), ptr(s), ptr(glv), *(ptr(c) for c in out), s.shape[0])
    got = co.jac_to_ints(out)
    want = [None if p is None else oc.g1_mul(p, k % R) for p, k in zip(co.jac_to_ints(P), limbs.tensor_to_ints(s))]
    assert got == want == co.jac_to_ints(co.scalar_mul(P, s))
    M = sum(ms)
    assert got[pad] is None and got[M + pad] is None


# ---------------------------------------------------------------------------
# the small ops
# ---------------------------------------------------------------------------

FIELDS = {"Fq": (fo.FQ, jfo.FQ, Q), "Fr": (fo.FR, jfo.FR, R)}


def _rand(p, n):
    return [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(n)]


def _port(xs):
    return limbs.ints_to_tensor(xs, "cpu")


def _jax(xs):
    return jnp.asarray(np.stack([jfo.int_to_limbs(x) for x in xs]))


def _jax_ints(arr):
    return limbs.np_to_ints(limbs.jax_to_port(np.asarray(arr)))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("e", [0, 1, 5, 1 << 64, "p-2"])
def test_mont_pow_static_matches_jax(field, e):
    spec, jspec, p = FIELDS[field]
    e = p - 2 if e == "p-2" else e
    a = [0, 1, p - 1] + _rand(p, 5)
    got = limbs.tensor_to_ints(fo.mont_pow_static(_port(a), e, spec))
    assert got == _jax_ints(jfo.mont_pow_static(_jax(a), e, jspec))
    assert got == [spec.to_mont(pow(spec.from_mont(x), e, p)) for x in a]


@pytest.mark.parametrize("field", FIELDS)
def test_batch_inv_eq_and_horner_fold_match_jax(field):
    spec, jspec, p = FIELDS[field]
    a = [0, 1, p - 1] + _rand(p, 5)
    got = limbs.tensor_to_ints(fo.batch_inv(_port(a), spec))
    assert got == _jax_ints(jfo.batch_inv(_jax(a), jspec)) == limbs.tensor_to_ints(fo.inv(_port(a), spec))
    b = list(a)
    b[2], b[5] = 0, a[4]
    assert fo.eq(_port(a), _port(b)).tolist() == np.asarray(jfo.eq(_jax(a), _jax(b))).tolist()
    assert fo.eq(_port(a), _port(b)).tolist() == [x == y for x, y in zip(a, b)]
    # four values of a batch of 3, folded at x
    vals = [[0, p - 1, 7], [p - 1, p - 1, 0]] + [_rand(p, 3) for _ in range(2)]
    x = [p - 1, 0, _rand(p, 1)[0]]
    pv = torch.stack([_port(v) for v in vals])
    jv = jnp.stack([_jax(v) for v in vals])
    got = limbs.tensor_to_ints(fo.horner_fold(pv, _port(x), spec))
    assert got == _jax_ints(jfo.horner_fold(jv, _jax(x), jspec))
    rinv = pow(1 << 256, -1, p)
    want = []
    for lane in range(3):
        acc = vals[0][lane]
        for v in vals[1:]:
            acc = (acc * x[lane] * rinv + v[lane]) % p
        want.append(acc)
    assert got == want


def _rand_points(n):
    g = oc.g1_generator()
    return [oc.g1_mul(g, int(RNG.integers(1, 1 << 62))) for _ in range(n)]


def test_jac_neg_to_affine_and_affine_to_ints_match_jax():
    pts = _rand_points(5) + [None, oc.g1_generator()]
    p = co.affine_to_jac(co.affine_from_ints(pts, "cpu"))
    jp = jco.affine_to_jac(jco.affine_from_ints(pts))
    p2 = co.jac_add(p, p)  # Z != 1, and the identity stays Z = 0
    jp2 = jco.jac_add(jp, jp)
    neg = co.jac_neg(p2)
    assert co.jac_to_ints(neg) == jco.jac_to_ints(jco.jac_neg(jp2)) == [oc.g1_neg(oc.g1_double(x)) for x in pts]
    aff = co.jac_to_affine(p2)
    jaff = jco.jac_to_affine(jp2)
    assert aff.inf.tolist() == np.asarray(jaff.inf).tolist() == [x is None for x in pts]
    assert np.array_equal(aff.x.numpy(), limbs.jax_to_port(np.asarray(jaff.x)))
    assert np.array_equal(aff.y.numpy(), limbs.jax_to_port(np.asarray(jaff.y)))
    assert co.affine_to_ints(aff) == jco.affine_to_ints(jaff) == [oc.g1_double(x) for x in pts]


def test_poly_eval_and_msm_host_match_jax():
    coeffs = [0, R - 1, 3] + _rand(R, 6)
    for x in (0, 1, R - 1, _rand(R, 1)[0]):
        cm = [fo.FR.to_mont(c) for c in coeffs]
        got = fo.FR.from_mont(limbs.tensor_to_ints(pntt.poly_eval(_port(cm), _port([fo.FR.to_mont(x)])[0]))[0])
        jgot = jntt.poly_eval(_jax(cm), _jax([fo.FR.to_mont(x)])[0])
        assert got == fo.FR.from_mont(_jax_ints(jgot[None])[0]) == sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R
    pts = _rand_points(4) + [None]
    ks = [0, 1, R - 1] + _rand(R, 2)
    assert pmsm.msm_host(pts, ks) == jmsm.msm_host(pts, ks) == oc.g1_msm(pts, ks)
