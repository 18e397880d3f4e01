"""Plain PyTorch BN254 G1 arithmetic: Jacobian points over Montgomery Fq.

Counterpart of `halo2_aggregation_tpu/ops/curve_ops.py`, with the same
formulas and the same branchless edge cases (`jac_add`: p == O -> q,
q == O -> p, p == q -> 2p, p == -q -> O).  Coordinates are `(..., 8)`
int32 port tensors; Z == 0 encodes the identity.  Internally the chains
run on the wide form of `field_ops` and convert once at each end.

`scalar_mul` is the plain version of kernel K1 (`csrc/ec_win.cu`): a
4-bit windowed ladder over all 64 windows of the scalar, batched over lanes
with torch ops (the kernel splits the scalar in two halves first; the
affine points are equal); `jac_segment_sum` that of the segmented-sum
kernel (`csrc/jac_sum.cu`);
`scalar_mul_ladder` that of kernel K8 (`csrc/ec_ladder.cu`), the
bit-serial double-and-add.  `jac_add_mixed` (Jacobian + affine) is the
plain version of `csrc/curve.cuh::jac_add_mixed`, the add of kernel K7.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import Q
from . import field_ops as fo
from .field_ops import FQ, is_zero, narrow, select, wadd, widen, wmul, wsub


class AffinePoint(NamedTuple):
    x: torch.Tensor  # (..., 8) Montgomery Fq
    y: torch.Tensor
    inf: torch.Tensor  # (...,) bool


class JacPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor  # z == 0 <=> identity


def _widen(p: JacPoint) -> JacPoint:
    return JacPoint(widen(p.x), widen(p.y), widen(p.z))


def _narrow(p: JacPoint) -> JacPoint:
    return JacPoint(narrow(p.x), narrow(p.y), narrow(p.z))


def _wide_identity(shape, device) -> JacPoint:
    one = FQ.wide(device).one.expand(*shape, fo.WN)
    return JacPoint(one, one, torch.zeros_like(one))


def jac_identity(batch_shape, device) -> JacPoint:
    return _narrow(_wide_identity(tuple(batch_shape), device))


def affine_from_ints(points, device) -> AffinePoint:
    """Oracle points ((x, y) or None) -> AffinePoint on `device`."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    inf = torch.tensor([p is None for p in points], dtype=torch.bool, device=device)
    return AffinePoint(FQ.to_mont_tensor(xs, device), FQ.to_mont_tensor(ys, device), inf)


def affine_to_jac(p: AffinePoint) -> JacPoint:
    one = fo.narrow(FQ.wide(p.x.device).one).expand_as(p.x)
    return JacPoint(p.x, p.y, fo.select(p.inf, torch.zeros_like(p.x), one))


def _wdouble(p: JacPoint) -> JacPoint:
    """dbl-2009-l on wide coordinates; Z = 0 stays 0."""
    A = wmul(p.x, p.x, FQ)
    B = wmul(p.y, p.y, FQ)
    C = wmul(B, B, FQ)
    t = wadd(p.x, B, FQ)
    t = wmul(t, t, FQ)
    D = wsub(wsub(t, A, FQ), C, FQ)
    D = wadd(D, D, FQ)
    E = wadd(wadd(A, A, FQ), A, FQ)
    x3 = wsub(wmul(E, E, FQ), wadd(D, D, FQ), FQ)
    C8 = wadd(C, C, FQ)
    C8 = wadd(C8, C8, FQ)
    C8 = wadd(C8, C8, FQ)
    y3 = wsub(wmul(E, wsub(D, x3, FQ), FQ), C8, FQ)
    z3 = wmul(wadd(p.y, p.y, FQ), p.z, FQ)
    return JacPoint(x3, y3, z3)


def _wadd(p: JacPoint, q: JacPoint, lazy: bool = False) -> JacPoint:
    """Unified Jacobian addition on wide coordinates, branchless.  With
    `lazy`, the doubling is computed only when some lane needs it (a host
    check of the mask, so a sync on a CUDA tensor): the same values, about
    40 % less work where no lane does."""
    z1z1 = wmul(p.z, p.z, FQ)
    z2z2 = wmul(q.z, q.z, FQ)
    u1 = wmul(p.x, z2z2, FQ)
    u2 = wmul(q.x, z1z1, FQ)
    s1 = wmul(p.y, wmul(q.z, z2z2, FQ), FQ)
    s2 = wmul(q.y, wmul(p.z, z1z1, FQ), FQ)
    h = wsub(u2, u1, FQ)
    r = wsub(s2, s1, FQ)
    h2 = wmul(h, h, FQ)
    h3 = wmul(h2, h, FQ)
    u1h2 = wmul(u1, h2, FQ)
    x3 = wsub(wsub(wmul(r, r, FQ), h3, FQ), wadd(u1h2, u1h2, FQ), FQ)
    y3 = wsub(wmul(r, wsub(u1h2, x3, FQ), FQ), wmul(s1, h3, FQ), FQ)
    z3 = wmul(wmul(p.z, q.z, FQ), h, FQ)

    p_inf = is_zero(p.z)
    q_inf = is_zero(q.z)
    use_dbl = ~p_inf & ~q_inf & is_zero(h) & is_zero(r)
    # p == -q: h == 0 makes z3 == 0 already
    out = [x3, y3, z3]
    if not lazy or bool(use_dbl.any()):
        out = [select(use_dbl, d, g) for d, g in zip(_wdouble(p), out)]
    out = [select(p_inf, b, o) for b, o in zip(q, out)]
    return JacPoint(*(select(q_inf, a, o) for a, o in zip(p, out)))


def _wadd_mixed(p: JacPoint, x2, y2, lazy: bool = False) -> JacPoint:
    """p + (x2, y2, 1) on wide coordinates, branchless: the formulas and
    selects of the JAX `ec_pallas._jac_add_mixed` (11 products).  p == O
    gives (x2, y2, 1); h == r == 0 gives 2p; p == -q gives z3 = z1 * h = 0
    with x3, y3 as computed.  `lazy` as for `_wadd`."""
    z1z1 = wmul(p.z, p.z, FQ)
    u2 = wmul(x2, z1z1, FQ)
    s2 = wmul(y2, wmul(p.z, z1z1, FQ), FQ)
    h = wsub(u2, p.x, FQ)
    r = wsub(s2, p.y, FQ)
    h2 = wmul(h, h, FQ)
    h3 = wmul(h2, h, FQ)
    u1h2 = wmul(p.x, h2, FQ)
    x3 = wsub(wsub(wmul(r, r, FQ), h3, FQ), wadd(u1h2, u1h2, FQ), FQ)
    y3 = wsub(wmul(r, wsub(u1h2, x3, FQ), FQ), wmul(p.y, h3, FQ), FQ)
    z3 = wmul(p.z, h, FQ)

    p_inf = is_zero(p.z)
    use_dbl = ~p_inf & is_zero(h) & is_zero(r)
    out = [x3, y3, z3]
    if not lazy or bool(use_dbl.any()):
        out = [select(use_dbl, d, g) for d, g in zip(_wdouble(p), out)]
    one = FQ.wide(x2.device).one.expand_as(x2)
    return JacPoint(*(select(p_inf, a, o) for a, o in zip((x2, y2, one), out)))


def jac_double(p: JacPoint) -> JacPoint:
    return _narrow(_wdouble(_widen(p)))


def jac_add(p: JacPoint, q: JacPoint) -> JacPoint:
    return _narrow(_wadd(_widen(p), _widen(q)))


def jac_add_mixed(p: JacPoint, x2: torch.Tensor, y2: torch.Tensor) -> JacPoint:
    """p + (x2, y2) for Jacobian p and affine (x2, y2) (never the identity),
    over any batch shape."""
    return _narrow(_wadd_mixed(_widen(p), widen(x2), widen(y2)))


def jac_neg(p: JacPoint) -> JacPoint:
    return JacPoint(p.x, fo.neg(p.y, FQ), p.z)


def jac_to_affine(p: JacPoint) -> AffinePoint:
    """Batch conversion on the device (one Fermat inversion a point); the
    identity comes out as (0, 0) with its `inf` flag set."""
    w = _widen(p)
    zinv = fo.winv(w.z, FQ)  # 0 -> 0
    zinv2 = wmul(zinv, zinv, FQ)
    x = wmul(w.x, zinv2, FQ)
    y = wmul(w.y, wmul(zinv2, zinv, FQ), FQ)
    return AffinePoint(narrow(x), narrow(y), is_zero(p.z))


def jac_eq(p: JacPoint, q: JacPoint) -> torch.Tensor:
    """Whether p and q are the same group element, lane by lane (a bool
    tensor of the batch shape), whatever their Jacobian representatives:
    both the identity, or X1 Z2^2 = X2 Z1^2 and Y1 Z2^3 = Y2 Z1^3."""
    a, b = _widen(p), _widen(q)
    z1z1, z2z2 = wmul(a.z, a.z, FQ), wmul(b.z, b.z, FQ)
    same_x = (wmul(a.x, z2z2, FQ) == wmul(b.x, z1z1, FQ)).all(-1)
    same_y = (wmul(a.y, wmul(b.z, z2z2, FQ), FQ) == wmul(b.y, wmul(a.z, z1z1, FQ), FQ)).all(-1)
    p_inf, q_inf = is_zero(a.z), is_zero(b.z)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & same_x & same_y)


def jac_sum(p: JacPoint) -> JacPoint:
    """Sum the points along axis 0 (any further batch axes stay): a tree of
    batched adds, log2(n) steps instead of n - 1 sequential ones.  The group
    element equals the JAX left fold's; its Jacobian representative may
    differ."""
    w = _widen(p)
    while w.x.shape[0] > 1:
        n = w.x.shape[0]
        if n % 2:
            pad = _wide_identity((1, *w.x.shape[1:-1]), w.x.device)
            w = JacPoint(*(torch.cat((c, i), 0) for c, i in zip(w, pad)))
        half = w.x.shape[0] // 2
        w = _wadd(JacPoint(*(c[:half] for c in w)), JacPoint(*(c[half:] for c in w)))
    return _narrow(JacPoint(*(c[0] for c in w)))


def jac_segment_sum(p: JacPoint, offsets, lane_axis: int = 0) -> JacPoint:
    """Per-segment sums of the points along `lane_axis` of `(..., 8)`
    coordinates: segment j holds lanes offsets[j] .. offsets[j + 1] - 1
    (non-decreasing offsets; an empty segment gives the identity (1, 1, 0)).
    Returns coordinates of shape (segments, *other axes, 8): the function
    of the JAX `jac_segment_sum` for contiguous segments, and the plain
    version of the segmented-sum kernel (`csrc/jac_sum.cu`), one `jac_sum`
    a segment.  The kernel adds in another order: compare as affine
    points."""
    offsets = [int(o) for o in offsets]
    if len(offsets) < 2 or any(a > b for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"offsets {offsets}: expected two or more, non-decreasing")
    lanes = JacPoint(*(c.movedim(lane_axis, 0) for c in p))
    if offsets[0] < 0 or offsets[-1] > lanes.x.shape[0]:
        raise ValueError(f"offsets {offsets} leave the {lanes.x.shape[0]} lanes")
    sums = []
    for lo, hi in zip(offsets, offsets[1:]):
        if lo == hi:
            sums.append(jac_identity(lanes.x.shape[1:-1], lanes.x.device))
            continue
        seg = jac_sum(JacPoint(*(c[lo:hi] for c in lanes)))
        ident = jac_identity(seg.x.shape[:-1], seg.x.device)
        sums.append(JacPoint(*(select(is_zero(seg.z), i, a) for i, a in zip(ident, seg))))
    return JacPoint(*(torch.stack([s[c] for s in sums]) for c in range(3)))


def window_digits(scalars: torch.Tensor) -> torch.Tensor:
    """Plain (..., 8) int32 scalars -> (..., 64) 4-bit digits, low first."""
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 4, device=scalars.device)
    return ((u.unsqueeze(-1) >> shifts) & 15).reshape(*scalars.shape[:-1], 64)


def scalar_mul(points: JacPoint, scalars: torch.Tensor) -> JacPoint:
    """s_i * P_i for plain (non-Montgomery) 256-bit scalars: the plain
    version of kernel K1.  4-bit windows: a 16-entry table k*P (evens by
    doubling, odds by adding P), then from the top window down 4 doublings
    and one add of the table entry picked by the digit.  Zero scalars and
    identity points give the identity (Z = 0)."""
    shape = points.x.shape[:-1]
    P = _widen(JacPoint(*(c.reshape(-1, 8) for c in points)))
    n = P.x.shape[0]
    device = P.x.device
    digits = window_digits(scalars.reshape(-1, 8))
    table = [_wide_identity((n,), device), P]
    for k in range(2, 16):
        table.append(_wadd(table[k - 1], P) if k % 2 else _wdouble(table[k // 2]))
    stacked = [torch.stack([t[c] for t in table]) for c in range(3)]  # (16, n, 16)
    lanes = torch.arange(n, device=device)
    acc = _wide_identity((n,), device)
    for w in range(63, -1, -1):
        if w != 63:
            for _ in range(4):
                acc = _wdouble(acc)
        d = digits[:, w]
        acc = _wadd(acc, JacPoint(*(s[d, lanes] for s in stacked)))
    ident = _wide_identity((n,), device)
    acc = JacPoint(*(select(is_zero(acc.z), i, a) for i, a in zip(ident, acc)))
    return JacPoint(*(narrow(c).reshape(*shape, 8) for c in acc))


def scalar_mul_ladder(points: JacPoint, scalars: torch.Tensor, nbits: int = 254) -> JacPoint:
    """s_i * P_i for the low `nbits` bits of plain 256-bit scalars: the
    plain version of kernel K8.  From bit nbits - 1 down to 0, one doubling
    and, where the bit is set, one add of P (as the JAX `_ladder_kernel`
    selects).  Zero scalars and identity points give the identity
    (1, 1, 0)."""
    if not 1 <= nbits <= 256:
        raise ValueError(f"nbits = {nbits}: expected 1 .. 256")
    shape = points.x.shape[:-1]
    P = _widen(JacPoint(*(c.reshape(-1, 8) for c in points)))
    n = P.x.shape[0]
    limbs = scalars.reshape(-1, 8).to(torch.int64) & 0xFFFFFFFF
    acc = _wide_identity((n,), P.x.device)
    for bit in range(nbits - 1, -1, -1):
        acc = _wdouble(acc)
        take = ((limbs[:, bit // 32] >> (bit % 32)) & 1).bool()
        acc = JacPoint(*(select(take, a, o) for a, o in zip(_wadd(acc, P), acc)))
    ident = _wide_identity((n,), P.x.device)
    acc = JacPoint(*(select(is_zero(acc.z), i, a) for i, a in zip(ident, acc)))
    return JacPoint(*(narrow(c).reshape(*shape, 8) for c in acc))


def affine_to_ints(p: AffinePoint) -> list:
    """Affine batch -> host int pairs (None where `inf`), flattened."""
    xs = FQ.from_mont_tensor(p.x)
    ys = FQ.from_mont_tensor(p.y)
    infs = p.inf.reshape(-1).tolist()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def jac_to_ints(p: JacPoint) -> list:
    """Jacobian batch -> host affine int pairs (None for the identity),
    flattened over the batch axes; the division runs on the host."""
    xs = FQ.from_mont_tensor(p.x)
    ys = FQ.from_mont_tensor(p.y)
    zs = FQ.from_mont_tensor(p.z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, Q)
        zi2 = zinv * zinv % Q
        out.append((x * zi2 % Q, y * zi2 % Q * zinv % Q))
    return out

