"""Plain PyTorch BN254 G1 arithmetic: Jacobian points over Montgomery Fq.

Counterpart of `halo2_aggregation_tpu/ops/curve_ops.py`, with the same
formulas and the same branchless edge cases (`jac_add`: p == O -> q,
q == O -> p, p == q -> 2p, p == -q -> O).  Coordinates are `(..., 8)`
int32 port tensors; Z == 0 encodes the identity.  Internally the chains
run on the wide form of `field_ops` and convert once at each end.

`scalar_mul` is the plain version of kernel K1 (`csrc/ec_win.cu`): the
same 4-bit windowed ladder, batched over lanes with torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from halo2_aggregation_tpu.fields import Q

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


def _wadd(p: JacPoint, q: JacPoint) -> JacPoint:
    """Unified Jacobian addition on wide coordinates, branchless."""
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
    dbl = _wdouble(p)
    # p == -q: h == 0 makes z3 == 0 already
    out = [select(use_dbl, d, g) for d, g in zip(dbl, (x3, y3, z3))]
    out = [select(p_inf, b, o) for b, o in zip(q, out)]
    return JacPoint(*(select(q_inf, a, o) for a, o in zip(p, out)))


def jac_double(p: JacPoint) -> JacPoint:
    return _narrow(_wdouble(_widen(p)))


def jac_add(p: JacPoint, q: JacPoint) -> JacPoint:
    return _narrow(_wadd(_widen(p), _widen(q)))


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

