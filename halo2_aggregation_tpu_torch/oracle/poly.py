"""Python-int polynomial utilities over Fr (host orchestration + tests).

The host-side counterpart of ops/ntt.py, used by keygen/prover
orchestration where n is small and by tests as the trusted reference.
"""

from __future__ import annotations

from ..fields import R, fr_omega


def ntt(values, omega, n):
    """In-order iterative radix-2 NTT (values: list of ints, len n=2^k)."""
    assert len(values) == n and n & (n - 1) == 0
    a = list(values)
    # bit-reverse
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    m = 2
    while m <= n:
        w_m = pow(omega, n // m, R)
        for start in range(0, n, m):
            w = 1
            for t in range(m // 2):
                lo = a[start + t]
                hi = a[start + t + m // 2] * w % R
                a[start + t] = (lo + hi) % R
                a[start + t + m // 2] = (lo - hi) % R
                w = w * w_m % R
        m <<= 1
    return a


def lagrange_to_coeffs(values, k):
    n = 1 << k
    omega_inv = pow(fr_omega(k), -1, R)
    out = ntt(values, omega_inv, n)
    n_inv = pow(n, -1, R)
    return [v * n_inv % R for v in out]


def coeffs_to_lagrange(coeffs, k):
    n = 1 << k
    c = list(coeffs) + [0] * (n - len(coeffs))
    return ntt(c, fr_omega(k), n)


def coset_extended_evals(coeffs, g, ext_k):
    """Evaluate on {g * w_ext^i}: scale coeffs by g^j then NTT."""
    ext_n = 1 << ext_k
    c = list(coeffs) + [0] * (ext_n - len(coeffs))
    gp = 1
    for j in range(ext_n):
        c[j] = c[j] * gp % R
        gp = gp * g % R
    return ntt(c, fr_omega(ext_k), ext_n)


def coset_extended_to_coeffs(evals, g, ext_k):
    ext_n = 1 << ext_k
    omega_inv = pow(fr_omega(ext_k), -1, R)
    c = ntt(list(evals), omega_inv, ext_n)
    n_inv = pow(ext_n, -1, R)
    g_inv = pow(g, -1, R)
    gp = 1
    out = []
    for j in range(ext_n):
        out.append(c[j] * n_inv % R * gp % R)
        gp = gp * g_inv % R
    return out


def eval_poly(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def divide_linear(coeffs, z):
    """(f(X) - f(z)) / (X - z): synthetic division, returns quotient coeffs
    of length len(coeffs) - 1."""
    q = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R
        q[i - 1] = acc
    return q
