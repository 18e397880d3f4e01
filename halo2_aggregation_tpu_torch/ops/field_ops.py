"""Plain PyTorch BN254 Fr / Fq arithmetic on port tensors.

Counterpart of `halo2_aggregation_tpu/ops/field_ops.py`.  Elements are
`(..., 8)` int32 tensors (see `ops/limbs.py`) holding canonical values in
[0, p), Montgomery form with R = 2^256 for products.  Every function is
exact, has no data-dependent control flow, and runs the same on CPU and
CUDA tensors: these are the plain versions the kernels are checked
against, and the device code for the small steps around the kernels.

A 32 x 32-bit limb product does not fit in signed int64, so the arithmetic
runs on a *wide* form: `(..., 16)` int64 holding 16-bit limbs, where a
product is < 2^32 and a 16-term column sum < 2^36.  `widen`/`narrow`
convert; the `w*` functions take and return the wide form, so a long chain
(the plain ladder, the curve ops) converts once.  Carry propagation is
branch-free and exact: three relaxation rounds bring every column to at
most 2^16, then a prefix-max over the non-propagating columns resolves the
last carries (the lookahead of the JAX `carry_prop`, in one `cummax`).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ..fields import MONT_R, Q, R
from .limbs import NL, ints_to_tensor, tensor_to_ints

WBITS = 16
WN = 16  # 16-bit limbs per element in the wide form
WMASK = (1 << WBITS) - 1


def _int_to_wide(x: int) -> list:
    return [(x >> (WBITS * i)) & WMASK for i in range(WN)]


class FieldSpec:
    """Per-modulus constants; the wide-form tensors are made once per device."""

    def __init__(self, name: str, p: int):
        self.name = name
        self.p = p
        self.r_inv = pow(MONT_R, -1, p)
        self._wide = {}

    def __repr__(self):
        return f"FieldSpec({self.name})"

    # ---- host-side codecs -------------------------------------------------
    def to_mont(self, x: int) -> int:
        return x % self.p * MONT_R % self.p

    def from_mont(self, x: int) -> int:
        return x * self.r_inv % self.p

    def to_mont_tensor(self, xs, device) -> torch.Tensor:
        return ints_to_tensor([self.to_mont(int(x)) for x in xs], device)

    def from_mont_tensor(self, t: torch.Tensor) -> list:
        return [self.from_mont(v) for v in tensor_to_ints(t)]

    # ---- device constants (wide form) -------------------------------------
    def wide(self, device) -> SimpleNamespace:
        device = torch.device(device)
        if device not in self._wide:
            p = self.p

            def t(x):
                return torch.tensor(x, dtype=torch.int64, device=device)

            e = p - 2
            self._wide[device] = SimpleNamespace(
                p=t(_int_to_wide(p)),
                pinv=t(_int_to_wide((-pow(p, -1, MONT_R)) % MONT_R)),
                comp=t(_int_to_wide(MONT_R - p)),
                # p + (2^256 - 1) + 1 spread per column: a - b + subk has
                # non-negative columns and value a - b + p + 2^256
                subk=t([l + WMASK + (i == 0) for i, l in enumerate(_int_to_wide(p))]),
                r2=t(_int_to_wide(MONT_R * MONT_R % p)),
                one=t(_int_to_wide(MONT_R % p)),
                unit=t(_int_to_wide(1)),
                exp_bits=[int(c) for c in bin(e)[2:]],
            )
        return self._wide[device]


FQ = FieldSpec("Fq", Q)
FR = FieldSpec("Fr", R)


# ---------------------------------------------------------------------------
# wide form
# ---------------------------------------------------------------------------


def widen(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 16) int64 16-bit limbs."""
    u = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((u & WMASK, u >> WBITS), -1).reshape(*a.shape[:-1], WN)


def narrow(w: torch.Tensor) -> torch.Tensor:
    """Canonical (..., 16) int64 16-bit limbs -> (..., 8) int32 raw bits."""
    v = w.reshape(*w.shape[:-1], NL, 2)
    u = v[..., 0] | (v[..., 1] << WBITS)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _shift_up(x, fill=0):
    """Move every column one limb toward the top; the top column drops."""
    return F.pad(x, (1, 0), value=fill)[..., :-1]


def _relax(x, n_out: int, rounds: int = 3):
    """Partial carries: non-negative columns < 2^40 -> n_out columns of the
    same value mod 2^(16 n_out), each <= 2^16.  `rounds` passes must reach
    that bound: 3 for columns < 2^40, 2 for columns < 2^18."""
    k = x.shape[-1]
    if k < n_out:
        x = F.pad(x, (0, n_out - k))
    elif k > n_out:
        x = x[..., :n_out]
    for _ in range(rounds):
        x = (x & WMASK) + _shift_up(x >> WBITS)
    return x


def _carry(x, n_out: int, rounds: int = 3):
    """Exact carry propagation: `_relax`, then canonical 16-bit limbs."""
    x = _relax(x, n_out, rounds)
    # columns in [0, 2^16]: the carry into column k is the carry out of
    # the nearest column below k that is not 0xFFFF (0xFFFF only passes a
    # carry on); that column's carry out is its bit 16
    gen = x >> WBITS
    idx = torch.arange(n_out, device=x.device)
    stop = torch.where(x != WMASK, idx, -1)
    last = _shift_up(torch.cummax(stop, -1).values, fill=-1)
    cin = torch.gather(gen, -1, last.clamp(min=0)) * (last >= 0)
    return (x + cin) & WMASK


def _conv(a, b):
    """Schoolbook product columns of two 16-limb operands (31 columns),
    as one outer product and a skewed sum over its anti-diagonals."""
    n = a.shape[-1]
    prods = a.unsqueeze(-1) * b.unsqueeze(-2)
    lead = prods.shape[:-2]
    skew = F.pad(prods, (0, n)).reshape(*lead, 2 * n * n)[..., : n * (2 * n - 1)]
    return skew.reshape(*lead, n, 2 * n - 1).sum(-2)


def _cond_sub(r, c):
    """r - p if r >= p else r, for r < 2^256."""
    d = _carry(r + c.comp, WN + 1, rounds=2)
    return torch.where(d[..., WN:] == 1, d[..., :WN], r)


def wadd(a, b, spec: FieldSpec):
    return _cond_sub(_carry(a + b, WN, rounds=2), spec.wide(a.device))


def wsub(a, b, spec: FieldSpec):
    c = spec.wide(a.device)
    return _cond_sub(_carry(a - b + c.subk, WN, rounds=2), c)


def wneg(a, spec: FieldSpec):
    return wsub(torch.zeros_like(a), a, spec)


def wmul(a, b, spec: FieldSpec):
    """Montgomery product a * b / 2^256 mod p (full-width REDC)."""
    c = spec.wide(a.device)
    # a * b < p^2 < 2^508.  Relaxed columns suffice for t: the low 16 hold
    # a value = t mod R, and nothing leaves the top column (t < 2^512)
    t = _relax(_conv(a, b), 2 * WN)
    m = _carry(_conv(t[..., :WN], c.pinv), WN)  # (t mod R) * p' mod R
    s = _carry(t + F.pad(_conv(m, c.p), (0, 1)), 2 * WN)  # t + m p < 2^511
    return _cond_sub(s[..., WN:], c)  # (t + m p) / R < 2p


def winv(a, spec: FieldSpec):
    """Fermat inverse a^(p-2) (Montgomery in and out); 0 maps to 0."""
    c = spec.wide(a.device)
    acc = c.one.expand_as(a)
    for bit in c.exp_bits:
        acc = wmul(acc, acc, spec)
        if bit:
            acc = wmul(acc, a, spec)
    return acc


# ---------------------------------------------------------------------------
# port layout: (..., 8) int32
# ---------------------------------------------------------------------------


def add(a, b, spec: FieldSpec):
    return narrow(wadd(widen(a), widen(b), spec))


def sub(a, b, spec: FieldSpec):
    return narrow(wsub(widen(a), widen(b), spec))


def neg(a, spec: FieldSpec):
    return narrow(wneg(widen(a), spec))


def mont_mul(a, b, spec: FieldSpec):
    return narrow(wmul(widen(a), widen(b), spec))


def mont_sq(a, spec: FieldSpec):
    w = widen(a)
    return narrow(wmul(w, w, spec))


def inv(a, spec: FieldSpec):
    return narrow(winv(widen(a), spec))


def mont_pow_static(a, e: int, spec: FieldSpec):
    """a^e (Montgomery in and out) for a fixed Python-int exponent e >= 0:
    square and multiply over the bits of e, high first."""
    if e < 0:
        raise ValueError(f"exponent {e}: expected >= 0")
    w = widen(a)
    acc = spec.wide(a.device).one.expand_as(w)
    for bit in bin(e)[2:] if e else "":
        acc = wmul(acc, acc, spec)
        if bit == "1":
            acc = wmul(acc, w, spec)
    return narrow(acc)


def batch_inv(a, spec: FieldSpec):
    """The inverse of every element (Montgomery domain), each by its own
    Fermat chain vectorised over the batch: a zero maps to zero and leaves
    the others as they are."""
    return inv(a, spec)


def horner_fold(values, x, spec: FieldSpec):
    """acc = v_0, then acc = acc * x + v_i: the fold of the verifier's y, theta
    and v challenges.  `values` is `(n, ..., 8)` stacked along axis 0; returns
    `(..., 8)`."""
    w, xw = widen(values), widen(x)
    acc = w[0]
    for v in w[1:]:
        acc = wadd(wmul(acc, xw, spec), v, spec)
    return narrow(acc)


def to_mont(a, spec: FieldSpec):
    return narrow(wmul(widen(a), spec.wide(a.device).r2, spec))


def from_mont(a, spec: FieldSpec):
    return narrow(wmul(widen(a), spec.wide(a.device).unit, spec))


# is_zero and select work on both forms (canonical values, limb axis last)


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def select(mask, a, b):
    """Elementwise select; `mask` has the batch shape (no limb axis)."""
    return torch.where(mask.unsqueeze(-1), a, b)
