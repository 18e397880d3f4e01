"""Python-int BN254 optimal-ate pairing oracle.

The reference defers the final pairing check outside the circuit
(`reference/src/multiopen.rs:271-509` produces the `(w, zw, f, e)`
quad; the native `verify_proof` fork then checks
``e(w, [tau]_2) == e(zw + f + e, [1]_2)`` — see SURVEY.md §3.3).  Our
framework performs that host-side check with this oracle: it runs once per
aggregate, so a clean slow implementation is the right trade.

Strategy: untwist G2 points into E(Fq12) and run a fully generic Miller
loop there — ~4x slower than sparse-line implementations but with far less
room for subtle coefficient errors.  Correctness is pinned by the
bilinearity test in tests/test_pairing.py.
"""

from __future__ import annotations

from ..fields import Q, R, BN_SIX_X_PLUS_2

# Fq2 = Fq[u]/(u^2+1); elements (c0, c1)
from .curve import (
    fq2_add,
    fq2_sub,
    fq2_neg,
    fq2_mul,
    fq2_inv,
    FQ2_ONE,
    FQ2_ZERO,
)

# non-residue for the sextic twist: xi = 9 + u
XI = (9, 1)

# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi); elements (c0, c1, c2)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t00 = fq2_mul(a0, b0)
    t11 = fq2_mul(a1, b1)
    t22 = fq2_mul(a2, b2)
    c0 = fq2_add(t00, fq2_mul(XI, fq2_add(fq2_mul(a1, b2), fq2_mul(a2, b1))))
    c1 = fq2_add(fq2_add(fq2_mul(a0, b1), fq2_mul(a1, b0)), fq2_mul(XI, t22))
    c2 = fq2_add(fq2_add(fq2_mul(a0, b2), fq2_mul(a2, b0)), t11)
    return (c0, c1, c2)


def fq6_mul_by_v(a):
    # (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2
    return (fq2_mul(XI, a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_mul(a0, a0), fq2_mul(XI, fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul(XI, fq2_mul(a2, a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_mul(a1, a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul(a0, c0),
        fq2_mul(XI, fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))),
    )
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v); elements (c0, c1)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    t0 = fq6_mul(a[0], b[0])
    t1 = fq6_mul(a[1], b[1])
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_add(fq6_mul(a[0], b[1]), fq6_mul(a[1], b[0]))
    return (c0, c1)


def fq12_square(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    t = fq6_sub(fq6_mul(a[0], a[0]), fq6_mul_by_v(fq6_mul(a[1], a[1])))
    tinv = fq6_inv(t)
    return (fq6_mul(a[0], tinv), fq6_neg(fq6_mul(a[1], tinv)))


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_square(base)
        e >>= 1
    return result


def fq12_from_fq(x: int):
    return (((x % Q, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq12_from_fq2(x):
    return ((x, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


#: w as an Fq12 element (basis for the untwist map)
FQ12_W = (FQ6_ZERO, FQ6_ONE)
FQ12_W2 = fq12_square(FQ12_W)  # = v
FQ12_W3 = fq12_mul(FQ12_W2, FQ12_W)


# ---------------------------------------------------------------------------
# Miller loop on E(Fq12): y^2 = x^3 + 3
# ---------------------------------------------------------------------------


def _untwist(q2_point):
    """Map a point on the twist E'(Fq2) to E(Fq12): (x, y) -> (x w^2, y w^3)."""
    x2, y2 = q2_point
    return (fq12_mul(fq12_from_fq2(x2), FQ12_W2), fq12_mul(fq12_from_fq2(y2), FQ12_W3))


def _ec12_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq12_add(y1, y2) == FQ12_ZERO:
            return None
        num = fq12_mul(fq12_from_fq(3), fq12_mul(x1, x1))
        lam = fq12_mul(num, fq12_inv(fq12_mul(fq12_from_fq(2), y1)))
    else:
        lam = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    x3 = fq12_sub(fq12_sub(fq12_mul(lam, lam), x1), x2)
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _line_eval(t, q, p):
    """Evaluate the line through t and q (or the tangent when t == q) at p.

    All points in E(Fq12) affine coordinates; returns an Fq12 value.
    """
    xt, yt = t
    xp, yp = p
    if t == q:
        num = fq12_mul(fq12_from_fq(3), fq12_mul(xt, xt))
        lam = fq12_mul(num, fq12_inv(fq12_mul(fq12_from_fq(2), yt)))
    else:
        xq, yq = q
        if xt == xq:
            # vertical line x - xt
            return fq12_sub(xp, xt)
        lam = fq12_mul(fq12_sub(yq, yt), fq12_inv(fq12_sub(xq, xt)))
    # l(P) = (yp - yt) - lam * (xp - xt)
    return fq12_sub(fq12_sub(yp, yt), fq12_mul(lam, fq12_sub(xp, xt)))


def _fq12_frobenius(a):
    """a^q via plain exponentiation — slow but used only twice per pairing."""
    return fq12_pow(a, Q)


def _ec12_frobenius(p):
    return (_fq12_frobenius(p[0]), _fq12_frobenius(p[1]))


def _ec12_neg(p):
    return (p[0], fq12_neg(p[1]))


def miller_loop(p_g1, q_g2):
    """Optimal-ate Miller loop for BN254: f_{6x+2,Q}(P) with the two
    Frobenius correction lines."""
    if p_g1 is None or q_g2 is None:
        return FQ12_ONE
    xp, yp = p_g1
    p12 = (fq12_from_fq(xp), fq12_from_fq(yp))
    q12 = _untwist(q_g2)

    f = FQ12_ONE
    t = q12
    bits = bin(BN_SIX_X_PLUS_2)[3:]  # skip the leading 1
    for b in bits:
        f = fq12_mul(fq12_square(f), _line_eval(t, t, p12))
        t = _ec12_add(t, t)
        if b == "1":
            f = fq12_mul(f, _line_eval(t, q12, p12))
            t = _ec12_add(t, q12)

    q1 = _ec12_frobenius(q12)
    q2 = _ec12_neg(_ec12_frobenius(q1))
    f = fq12_mul(f, _line_eval(t, q1, p12))
    t = _ec12_add(t, q1)
    f = fq12_mul(f, _line_eval(t, q2, p12))
    return f


def final_exponentiation(f):
    """f^((q^12 - 1)/r) by direct exponentiation (oracle-grade)."""
    e = (Q**12 - 1) // R
    return fq12_pow(f, e)


def pairing(p_g1, q_g2):
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing_check(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 — one shared final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        f = fq12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == FQ12_ONE


def multi_pairing_check_fast(pairs) -> bool:
    """Production path: the C++ pairing (native/h2a_native.cpp, ~40x
    faster), oracle-diffed against this module in
    tests/test_native_engine.py; falls back to the Python oracle when the
    native library is unavailable."""
    from ..utils import native

    if native.available():
        return native.multi_pairing_check(pairs)
    return multi_pairing_check(pairs)
