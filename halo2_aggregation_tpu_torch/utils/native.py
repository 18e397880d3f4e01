"""ctypes bindings for the C++ host runtime (native/h2a_native.cpp).

Builds the shared library on first use (g++, cached next to the source);
falls back silently to the pure-Python oracle when unavailable.  This is
the framework's native CPU runtime piece — SRS generation, host-side
commitments, and the Fr polynomial engine behind the scaled prover —
around the TPU compute path.

Array conventions: field vectors are C-contiguous (n, 4) uint64 limb
arrays; the `fr_*` entry points operate in Montgomery form (convert with
fr_to_mont / fr_from_mont at the boundary).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..fields import Q

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "h2a_native.cpp")
_SO = os.path.join(os.path.dirname(__file__), "..", "..", "native", "libh2a_native.so")

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _p(a):
    return a.ctypes.data_as(_U64P)


def _p8(a):
    return a.ctypes.data_as(_U8P)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        src = os.path.abspath(_SRC)
        so = os.path.abspath(_SO)
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            # build to a temp file + atomic rename: rebuilding in place
            # would TRUNCATE a .so another live process (e.g. a running
            # Phase-D prove) still has mmapped and SIGBUS it
            tmp = so + f".build.{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", tmp, src],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.h2a_g1_msm.argtypes = [
            _U64P, _U8P, _U64P, ctypes.c_size_t, ctypes.c_int, _U64P,
        ]
        lib.h2a_g1_batch_mul.argtypes = [_U64P, _U64P, ctypes.c_size_t, _U64P]
        lib.h2a_g1_batch_mul_win.argtypes = [
            _U64P, _U64P, ctypes.c_size_t, _U64P, _U8P,
        ]
        lib.h2a_g1_normalize.argtypes = [_U64P, ctypes.c_size_t, _U64P, _U8P]
        lib.h2a_fr_to_mont.argtypes = [_U64P, ctypes.c_size_t]
        lib.h2a_fr_from_mont.argtypes = [_U64P, ctypes.c_size_t]
        lib.h2a_fr_vec_binop.argtypes = [
            ctypes.c_int,
            _U64P, ctypes.c_size_t, ctypes.c_long,
            _U64P, ctypes.c_size_t, ctypes.c_long,
            _U64P, ctypes.c_size_t,
        ]
        lib.h2a_fr_vec_neg.argtypes = [_U64P, _U64P, ctypes.c_size_t]
        lib.h2a_fr_vec_scale.argtypes = [_U64P, ctypes.c_size_t, _U64P]
        lib.h2a_fr_scale_pows.argtypes = [_U64P, ctypes.c_size_t, _U64P]
        lib.h2a_fr_ntt.argtypes = [_U64P, ctypes.c_uint32, _U64P]
        lib.h2a_fr_batch_inv.argtypes = [_U64P, ctypes.c_size_t]
        lib.h2a_fr_grand_product.argtypes = [
            _U64P, _U64P, _U64P, _U64P, ctypes.c_size_t,
        ]
        lib.h2a_fr_horner.argtypes = [_U64P, ctypes.c_size_t, _U64P, _U64P]
        lib.h2a_fr_divide_linear.argtypes = [
            _U64P, ctypes.c_size_t, _U64P, _U64P,
        ]
        lib.h2a_fr_fold.argtypes = [_U64P, _U64P, _U64P, ctypes.c_size_t]
        lib.h2a_fr_dot.argtypes = [_U64P, _U64P, ctypes.c_size_t, _U64P]
        lib.h2a_miller_loop.argtypes = [
            _U64P, ctypes.c_int, _U64P, ctypes.c_int, _U64P,
        ]
        lib.h2a_final_exp.argtypes = [_U64P, _U64P]
        lib.h2a_multi_pairing_check.argtypes = [
            ctypes.c_size_t, _U64P, _U8P, _U64P,
        ]
        lib.h2a_multi_pairing_check.restype = ctypes.c_int
        lib.h2a_fq_batch_sqrt.argtypes = [
            _U64P, ctypes.c_size_t, _U64P, _U8P,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _to_u64_limbs(x: int, n=4) -> list:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def _from_u64(arr) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(arr))


def _jac_to_affine(x, y, z):
    if z == 0:
        return None
    zinv = pow(z, -1, Q)
    zi2 = zinv * zinv % Q
    return (x * zi2 % Q, y * zi2 % Q * zinv % Q)


def g1_msm_u64(points_u64, infs, scalars_u64):
    """Native Pippenger MSM over (n,8)/(n,)/(n,4) uint64 numpy arrays —
    the zero-copy fast path used by Params.commit_lagrange."""
    lib = _load()
    if lib is None:
        return NotImplemented
    pts = np.ascontiguousarray(points_u64, dtype=np.uint64)
    inf = np.ascontiguousarray(infs, dtype=np.uint8)
    ss = np.ascontiguousarray(scalars_u64, dtype=np.uint64)
    n = pts.shape[0]
    if ss.shape[0] != n or inf.shape[0] != n:
        raise ValueError("msm input length mismatch")
    out = np.zeros(12, dtype=np.uint64)
    lib.h2a_g1_msm(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        inf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return _jac_to_affine(
        _from_u64(out[0:4]), _from_u64(out[4:8]), _from_u64(out[8:12])
    )


def g1_msm(points, scalars):
    """Native Pippenger MSM over oracle-format points; None if lib absent."""
    lib = _load()
    if lib is None:
        return NotImplemented
    n = len(points)
    pts = np.zeros((n, 8), dtype=np.uint64)
    infs = np.zeros(n, dtype=np.uint8)
    ss = np.zeros((n, 4), dtype=np.uint64)
    for i, (p, s) in enumerate(zip(points, scalars)):
        if p is None:
            infs[i] = 1
        else:
            pts[i, 0:4] = _to_u64_limbs(p[0])
            pts[i, 4:8] = _to_u64_limbs(p[1])
        ss[i] = _to_u64_limbs(int(s))
    return g1_msm_u64(pts, infs, ss)


def g1_batch_mul(base, scalars):
    """out[i] = scalars[i] * base (native); None if lib absent."""
    lib = _load()
    if lib is None:
        return NotImplemented
    n = len(scalars)
    b = np.zeros(8, dtype=np.uint64)
    b[0:4] = _to_u64_limbs(base[0])
    b[4:8] = _to_u64_limbs(base[1])
    ss = np.zeros(n * 4, dtype=np.uint64)
    for i, s in enumerate(scalars):
        ss[i * 4 : i * 4 + 4] = _to_u64_limbs(int(s))
    out = np.zeros(n * 12, dtype=np.uint64)
    lib.h2a_g1_batch_mul(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    res = []
    for i in range(n):
        res.append(
            _jac_to_affine(
                _from_u64(out[i * 12 : i * 12 + 4]),
                _from_u64(out[i * 12 + 4 : i * 12 + 8]),
                _from_u64(out[i * 12 + 8 : i * 12 + 12]),
            )
        )
    return res


# ---------------------------------------------------------------------------
# Fr polynomial engine wrappers (Montgomery-form (n, 4) uint64 arrays)
# ---------------------------------------------------------------------------


def _cc(a):
    """Ensure a C-contiguous uint64 array (no copy when already so)."""
    return np.ascontiguousarray(a, dtype=np.uint64)


def fr_to_mont(a: np.ndarray) -> np.ndarray:
    a = _cc(a).copy() if not a.flags.writeable else _cc(a)
    _lib().h2a_fr_to_mont(_p(a), a.shape[0])
    return a


def fr_from_mont(a: np.ndarray) -> np.ndarray:
    a = _cc(a)
    _lib().h2a_fr_from_mont(_p(a), a.shape[0])
    return a


def fr_vec_binop(op: int, x, xrot: int, y, yrot: int, n: int) -> np.ndarray:
    """op: 0 add, 1 sub, 2 mul; x/y are (m,4) mont arrays, m in {1, len}."""
    x = _cc(x)
    y = _cc(y)
    out = np.empty((n, 4), dtype=np.uint64)
    _lib().h2a_fr_vec_binop(
        op, _p(x), x.shape[0], xrot, _p(y), y.shape[0], yrot, _p(out), n
    )
    return out


def fr_vec_neg(x) -> np.ndarray:
    x = _cc(x)
    out = np.empty_like(x)
    _lib().h2a_fr_vec_neg(_p(x), _p(out), x.shape[0])
    return out


def fr_vec_scale_inplace(a: np.ndarray, c_mont: np.ndarray):
    _lib().h2a_fr_vec_scale(_p(a), a.shape[0], _p(_cc(c_mont)))


def fr_scale_pows_inplace(a: np.ndarray, g_mont: np.ndarray):
    _lib().h2a_fr_scale_pows(_p(a), a.shape[0], _p(_cc(g_mont)))


def fr_ntt_inplace(a: np.ndarray, k: int, omega_plain: np.ndarray):
    """In-place radix-2 NTT of mont-form (2^k, 4); omega in PLAIN form."""
    _lib().h2a_fr_ntt(_p(a), k, _p(_cc(omega_plain)))


def fr_batch_inv_inplace(a: np.ndarray):
    _lib().h2a_fr_batch_inv(_p(a), a.shape[0])


def fr_grand_product(num, den, init_mont) -> np.ndarray:
    num = _cc(num)
    den = _cc(den)
    m = num.shape[0]
    z = np.empty((m + 1, 4), dtype=np.uint64)
    _lib().h2a_fr_grand_product(_p(num), _p(den), _p(_cc(init_mont)), _p(z), m)
    return z


def fr_horner(coeffs, x_mont) -> np.ndarray:
    coeffs = _cc(coeffs)
    out = np.empty(4, dtype=np.uint64)
    _lib().h2a_fr_horner(_p(coeffs), coeffs.shape[0], _p(_cc(x_mont)), _p(out))
    return out


def fr_divide_linear(coeffs, z_mont) -> np.ndarray:
    coeffs = _cc(coeffs)
    q = np.empty((coeffs.shape[0] - 1, 4), dtype=np.uint64)
    _lib().h2a_fr_divide_linear(
        _p(coeffs), coeffs.shape[0], _p(_cc(z_mont)), _p(q)
    )
    return q


def fr_fold_inplace(acc: np.ndarray, x, v_mont):
    """acc = acc * v + x, elementwise."""
    _lib().h2a_fr_fold(_p(acc), _p(_cc(x)), _p(_cc(v_mont)), acc.shape[0])


def fr_dot(a, b) -> np.ndarray:
    """sum_i a[i] * b[i] over (n, 4)-u64 Montgomery columns -> (4,) mont.
    OpenMP-parallel (no sequential dependency, unlike fr_horner) — one
    call per (query, point) in the prover's barycentric evaluations."""
    aa, bb = _cc(a), _cc(b)
    out = np.empty(4, dtype=np.uint64)
    _lib().h2a_fr_dot(_p(aa), _p(bb), aa.shape[0], _p(out))
    return out


def fq_batch_sqrt(vals_u64: np.ndarray):
    """Square roots in Fq: (n, 4) plain canonical u64 -> ((n, 4) u64
    roots, (n,) bool exists).  One fixed-exponent (q+1)/4 modexp per
    entry in C++ (~20us) vs ~150us for the Python pow it replaces —
    transcript-replay point decompression was 70% `pow` (VERDICT r2
    item 4)."""
    a = _cc(vals_u64)
    n = a.shape[0]
    out = np.empty((n, 4), dtype=np.uint64)
    ok = np.empty(n, dtype=np.uint8)
    _lib().h2a_fq_batch_sqrt(_p(a), n, _p(out), _p8(ok))
    return out, ok.astype(bool)


def fq_sqrt(a: int):
    """Single square root for the sequential transcript replay; int (a
    canonical Fq residue) -> int root or None."""
    vals = np.array(
        [[(a >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]],
        dtype=np.uint64,
    )
    out, ok = fq_batch_sqrt(vals)
    if not ok[0]:
        return None
    return _from_u64(out[0])


def g1_normalize(jac_u64: np.ndarray):
    """(n, 12) plain Jacobian -> ((n, 8) plain affine, (n,) inf flags)."""
    jac_u64 = _cc(jac_u64)
    n = jac_u64.shape[0]
    aff = np.empty((n, 8), dtype=np.uint64)
    inf = np.empty(n, dtype=np.uint8)
    _lib().h2a_g1_normalize(_p(jac_u64), n, _p(aff), _p8(inf))
    return aff, inf


def g1_batch_mul_win(base_xy: np.ndarray, scalars_u64: np.ndarray):
    """out[i] = scalars[i] * base; returns ((n,8) affine plain, (n,) inf)."""
    base_xy = _cc(base_xy)
    scalars_u64 = _cc(scalars_u64)
    n = scalars_u64.shape[0]
    aff = np.empty((n, 8), dtype=np.uint64)
    inf = np.empty(n, dtype=np.uint8)
    _lib().h2a_g1_batch_mul_win(_p(base_xy), _p(scalars_u64), n, _p(aff), _p8(inf))
    return aff, inf


# ---------------------------------------------------------------------------
# pairing (the deferred e(w, [tau]_2) == e(zw+f+e, [1]_2) check)
# ---------------------------------------------------------------------------


def _g1_flat(pairs):
    n = len(pairs)
    g1 = np.zeros((n, 8), dtype=np.uint64)
    infs = np.zeros(n, dtype=np.uint8)
    g2 = np.zeros((n, 16), dtype=np.uint64)
    for j, (p, q) in enumerate(pairs):
        if p is None:
            infs[j] = 1
        else:
            g1[j, :4] = _to_u64_limbs(p[0])
            g1[j, 4:] = _to_u64_limbs(p[1])
        (x2, y2) = q
        for jj, v in enumerate([x2[0], x2[1], y2[0], y2[1]]):
            g2[j, 4 * jj : 4 * jj + 4] = _to_u64_limbs(v)
    return g1, infs, g2


def multi_pairing_check(pairs) -> bool:
    """Native prod e(P_i, Q_i) == 1 check (h2a_multi_pairing_check);
    oracle-diffed in tests/test_native_engine.py.  G2 inputs must be
    actual points (never infinity — true at every call site: the G2 side
    is always [tau]_2 / [1]_2 from the SRS)."""
    g1, infs, g2 = _g1_flat(pairs)
    return bool(
        _lib().h2a_multi_pairing_check(len(pairs), _p(g1), _p8(infs), _p(g2))
    )


def miller_loop(p, q):
    """Native Miller loop -> Fq12 as the oracle's nested tuples (12 Fq
    coefficients), for oracle-diff testing."""
    g1, infs, g2 = _g1_flat([(p, q)])
    out = np.zeros(48, dtype=np.uint64)
    _lib().h2a_miller_loop(_p(g1), int(infs[0]), _p(g2), 0, _p(out))
    c = [_from_u64(out[4 * i : 4 * i + 4]) for i in range(12)]
    return (
        ((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
        ((c[6], c[7]), (c[8], c[9]), (c[10], c[11])),
    )
