"""Native column engine: (n, 4) uint64 Fr vectors backed by the C++ runtime.

This is the polynomial layer of the scaled prover — the role the reference
delegates to its halo2 fork's `EvaluationDomain` + rayon multicore
(`SURVEY.md` §2b: `create_proof`).  The pure-Python `VecIntOps` prover path
(plonk/prover.py) stays as the byte-exactness reference at small k; this
engine makes k=23 (the reference's outer circuit size,
`reference/examples/simple-example.rs:663`) tractable on the host
while the TPU owns the batched verification path.

Conventions:
* "plain" arrays hold canonical values (commit/serialize-ready)
* "mont" arrays hold Montgomery form (all algebra happens here)
* columns are C-contiguous (n, 4) uint64; scalars are (1, 4)
"""

from __future__ import annotations

import numpy as np

from ..fields import R, fr_omega
from ..utils import native
from ..utils.u64 import int_to_u64, ints_to_u64, u64_to_int, u64_to_ints
from .protocol import ScalarOps

MONT_R = 1 << 256


def available() -> bool:
    return native.available()


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def mont_scalar(v: int) -> np.ndarray:
    """int -> (1, 4) Montgomery-form scalar."""
    return int_to_u64((int(v) % R) * MONT_R % R).reshape(1, 4)


def plain_scalar(v: int) -> np.ndarray:
    return int_to_u64(int(v) % R).reshape(1, 4)


def scalar_to_int(mont4: np.ndarray) -> int:
    return u64_to_int(mont4.reshape(-1)) * pow(MONT_R, -1, R) % R


def col_from_ints(vals) -> np.ndarray:
    """List of ints (canonical) -> plain (n, 4) u64."""
    return ints_to_u64([int(v) % R for v in vals])


def col_to_ints(plain: np.ndarray) -> list:
    return u64_to_ints(plain)


def to_mont(plain: np.ndarray) -> np.ndarray:
    out = np.ascontiguousarray(plain, dtype=np.uint64).copy()
    native._lib().h2a_fr_to_mont(native._p(out), out.shape[0])
    return out


def from_mont(mont: np.ndarray) -> np.ndarray:
    out = np.ascontiguousarray(mont, dtype=np.uint64).copy()
    native._lib().h2a_fr_from_mont(native._p(out), out.shape[0])
    return out


def roll(col: np.ndarray, rot: int) -> np.ndarray:
    """rolled(vals, rot) = vals[rot:] + vals[:rot] (prover leaf semantics)."""
    if rot % col.shape[0] == 0:
        return col
    return np.roll(col, -rot, axis=0)


def pow_series(base_mont: np.ndarray, n: int, start_mont=None) -> np.ndarray:
    """[start * base^i for i in range(n)] as a mont (n, 4) array."""
    out = np.broadcast_to(
        start_mont if start_mont is not None else mont_scalar(1), (n, 4)
    ).copy()
    native.fr_scale_pows_inplace(out, base_mont.reshape(-1))
    return out


# ---------------------------------------------------------------------------
# ScalarOps backend over mont arrays (protocol.py formulas reuse this)
# ---------------------------------------------------------------------------


class NativeVecOps(ScalarOps):
    """Backend handles are mont (m, 4) arrays, m in {1, n}; (1, 4) scalars
    broadcast inside the C++ kernels."""

    def constant(self, v: int):
        return mont_scalar(v)

    def _n(self, a, b) -> int:
        return max(a.shape[0], b.shape[0])

    def add(self, a, b):
        return native.fr_vec_binop(0, a, 0, b, 0, self._n(a, b))

    def sub(self, a, b):
        return native.fr_vec_binop(1, a, 0, b, 0, self._n(a, b))

    def mul(self, a, b):
        return native.fr_vec_binop(2, a, 0, b, 0, self._n(a, b))

    def neg(self, a):
        return native.fr_vec_neg(a)

    def scale(self, a, v: int):
        return self.mul(a, mont_scalar(v))


# ---------------------------------------------------------------------------
# NTT domain
# ---------------------------------------------------------------------------


class NativeDomain:
    """Size-2^k evaluation domain over the native engine (mont in/out)."""

    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.omega = fr_omega(k)
        self.omega_inv = pow(self.omega, -1, R)
        self._omega_plain = int_to_u64(self.omega)
        self._omega_inv_plain = int_to_u64(self.omega_inv)
        self._n_inv_mont = mont_scalar(pow(self.n, -1, R))

    def ntt(self, coeffs_mont: np.ndarray) -> np.ndarray:
        out = np.ascontiguousarray(coeffs_mont).copy()
        if out.shape[0] != self.n:
            out = np.vstack(
                [out, np.zeros((self.n - out.shape[0], 4), np.uint64)]
            )
        native.fr_ntt_inplace(out, self.k, self._omega_plain)
        return out

    def intt(self, evals_mont: np.ndarray) -> np.ndarray:
        out = np.ascontiguousarray(evals_mont).copy()
        native.fr_ntt_inplace(out, self.k, self._omega_inv_plain)
        native.fr_vec_scale_inplace(out, self._n_inv_mont.reshape(-1))
        return out

    def coset_evals(self, coeffs_mont: np.ndarray, shift: int) -> np.ndarray:
        """Evaluate on {shift * omega^i}: scale coeffs by shift^t, NTT."""
        out = np.ascontiguousarray(coeffs_mont).copy()
        if out.shape[0] != self.n:
            out = np.vstack(
                [out, np.zeros((self.n - out.shape[0], 4), np.uint64)]
            )
        native.fr_scale_pows_inplace(out, mont_scalar(shift).reshape(-1))
        native.fr_ntt_inplace(out, self.k, self._omega_plain)
        return out


def eval_at(coeffs_mont: np.ndarray, x: int) -> int:
    """Horner-evaluate a mont coefficient column at plain int x -> int."""
    acc = native.fr_horner(coeffs_mont, mont_scalar(x).reshape(-1))
    return scalar_to_int(acc.reshape(1, 4))


class Barycentric:
    """Exact polynomial evaluation from VALUES on the 2^k domain — the
    prover-side engine that lets coefficients never materialize on the
    host when the device quotient is active (ROADMAP "coupled
    device-prover move").

    For the domain {omega^i}, the Lagrange weights give

        F(z) = (1 - z^n)/n * sum_i F_i * w_i,   w_i = omega^i/(omega^i - z)

    (derived from L_i(z) = (z^n - 1) * omega^i / (n * (z - omega^i)),
    using V'(omega^i) = n * omega^{-i}).  All arithmetic is exact mod r,
    so evaluations are bit-identical to Horner over the INTT'd
    coefficients (pinned by tests/test_native_engine.py and the
    test_prover_native byte-parity suite).

    The batch-inverted denominator column dinv_i = 1/(omega^i - z) is
    cached per point and shared with `witness_evals`, the eval-form
    multiopen witness W_i = (F_i - F(z)) * dinv_i — the same polynomial
    the reference commits after synthetic division (multiopen.rs:271-509
    verifies it), built here without ever leaving the Lagrange basis.

    Raises ZeroDivisionError if z lands on a domain point (probability
    ~n/2^254); callers fall back to the coefficient path.
    """

    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.omega = fr_omega(k)
        self.omega_pows = pow_series(mont_scalar(self.omega), self.n)
        self._n_inv = pow(self.n, -1, R)
        self._points = {}  # z -> (dinv col, weight col, c_z mont scalar)

    def point(self, z: int):
        z = int(z) % R
        entry = self._points.get(z)
        if entry is None:
            d = native.fr_vec_binop(
                1, self.omega_pows, 0, mont_scalar(z), 0, self.n
            )
            if not d.any(axis=1).all():
                raise ZeroDivisionError(f"evaluation point {z} is in the domain")
            native.fr_batch_inv_inplace(d)
            w = native.fr_vec_binop(2, d, 0, self.omega_pows, 0, self.n)
            c_z = mont_scalar((1 - pow(z, self.n, R)) * self._n_inv % R)
            entry = self._points[z] = (d, w, c_z)
        return entry

    def eval(self, evals_mont: np.ndarray, z: int) -> int:
        """F(z) from F's values on the domain (exact, == Horner)."""
        _, w, c_z = self.point(z)
        s = native.fr_dot(evals_mont, w).reshape(1, 4)
        return scalar_to_int(native.fr_vec_binop(2, s, 0, c_z, 0, 1))

    def witness_evals(self, folded_mont: np.ndarray, fe: int, z: int):
        """Values of W(X) = (F(X) - F(z))/(X - z) on the domain, from
        F's values: W_i = (F_i - fe) * dinv_i.  W has degree <= n-2, so
        its domain values determine it; commit_lagrange over them equals
        the commit of the synthetic-division quotient bit-for-bit."""
        dinv, _, _ = self.point(z)
        num = native.fr_vec_binop(
            1, folded_mont, 0, mont_scalar(fe), 0, self.n
        )
        return native.fr_vec_binop(2, num, 0, dinv, 0, self.n)
