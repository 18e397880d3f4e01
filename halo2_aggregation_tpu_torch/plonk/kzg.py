"""KZG commitment scheme: toy SRS setup + Lagrange-basis commitments.

Replaces the fork APIs `Setup::<Bn256>::new(k, rng)`,
`Setup::verifier_params`, `Params::{read,write}`, `params.commit_lagrange`
(`reference/examples/simple-example.rs:584-693`).

TPU-first design note: the whole prover works in *Lagrange space* — every
committed polynomial has degree < n, so commitments only ever need the
Lagrange SRS ``[L_i(tau)]G1``, and opening witnesses are produced pointwise
on the domain (see prover.py) rather than by sequential synthetic division.
The monomial SRS never materializes.

Like the reference (which caches `/tmp/halo2-{k}.params`), generated params
are cached on disk keyed by k and seed.  The cache format is plain numpy
`.npz` (uint64 limb arrays) — never pickle — and the cache directory is
created mode 0700, so a pre-planted file can corrupt at most the SRS values
(which commit_lagrange consumers treat as data), not execute code.

`DeviceSRS` (below) is the SRS resident on a device: the counterpart of
the JAX package's device branch of `Params._msm`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..fields import R, fr_omega
from ..ops import curve_ops as co
from ..ops import field_ops as fo
from ..ops.curve_ops import AffinePoint, JacPoint
from ..ops.limbs import port_to_u64, u64_to_port
from ..ops.msm import msm
from ..oracle import curve as oc
from ..utils.u64 import (
    int_to_u64,
    ints_to_u64,
    points_to_u64,
    u64_to_int,
    u64_to_ints,
    u64_to_points,
)


def _default_cache_dir() -> str:
    env = os.environ.get("H2A_PARAMS_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(base, "h2a-params")


CACHE_DIR = _default_cache_dir()


def _g2_to_u64(p) -> np.ndarray:
    (x0, x1), (y0, y1) = p
    return ints_to_u64([x0, x1, y0, y1]).reshape(-1)


def _g2_from_u64(arr):
    x0, x1, y0, y1 = u64_to_ints(np.asarray(arr).reshape(4, 4))
    return ((x0, x1), (y0, y1))


class Params:
    """SRS for domain size n = 2^k.

    Attributes:
      g1: generator (int pair)
      g_lagrange_u64: (n, 8) uint64 — x‖y limbs of [L_i(tau)]G1, plain form
      g_lagrange_inf: (n,) uint8 infinity flags
      g2, s_g2: G2 generator and [tau]G2 (Fq2 coordinate pairs)
    """

    def __init__(self, k: int, g_lagrange_u64, g_lagrange_inf, g2, s_g2):
        self.k = k
        self.n = 1 << k
        self.g1 = oc.g1_generator()
        self.g_lagrange_u64 = np.asarray(g_lagrange_u64, dtype=np.uint64)
        self.g_lagrange_inf = np.asarray(g_lagrange_inf, dtype=np.uint8)
        self.g2 = g2
        self.s_g2 = s_g2
        self._g_lagrange_ints = None

    @classmethod
    def from_points(cls, k: int, g_lagrange, g2, s_g2) -> "Params":
        pts, infs = points_to_u64(g_lagrange)
        p = cls(k, pts, infs, g2, s_g2)
        p._g_lagrange_ints = list(g_lagrange)
        return p

    @property
    def g_lagrange(self) -> list:
        """Oracle-format view: list of (x, y) int pairs / None (lazy)."""
        if self._g_lagrange_ints is None:
            self._g_lagrange_ints = u64_to_points(
                self.g_lagrange_u64, self.g_lagrange_inf
            )
        return self._g_lagrange_ints

    # -- commitments ---------------------------------------------------------
    def commit_lagrange(self, values) -> tuple | None:
        """Commit to a polynomial given by its evaluations on the domain.

        `values` is a list of ints or an (n, 4) uint64 limb array.  Host
        orchestration; native C++ Pippenger by default, pure-Python oracle
        as the last resort.  The device MSM is `DeviceSRS.commit_lagrange`."""
        if isinstance(values, np.ndarray) and values.dtype == np.uint64:
            scalars_u64 = values
            if scalars_u64.shape[0] < self.n:
                scalars_u64 = np.vstack(
                    [
                        scalars_u64,
                        np.zeros(
                            (self.n - scalars_u64.shape[0], 4), dtype=np.uint64
                        ),
                    ]
                )
        else:
            vals = [int(v) % R for v in values]
            if len(vals) > self.n:
                raise ValueError("polynomial larger than the domain")
            vals = vals + [0] * (self.n - len(vals))
            scalars_u64 = ints_to_u64(vals)
        return self._msm(scalars_u64)

    def _msm(self, scalars_u64: np.ndarray):
        from ..utils import native

        if native.available():
            return native.g1_msm_u64(
                self.g_lagrange_u64, self.g_lagrange_inf, scalars_u64
            )
        return oc.g1_msm(self.g_lagrange, u64_to_ints(scalars_u64))

    # -- persistence ---------------------------------------------------------
    def save(self, path: str):
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            k=np.array([self.k], dtype=np.int64),
            g_lagrange=self.g_lagrange_u64,
            g_lagrange_inf=self.g_lagrange_inf,
            g2=_g2_to_u64(self.g2),
            s_g2=_g2_to_u64(self.s_g2),
        )

    @staticmethod
    def load(path: str) -> "Params":
        with np.load(path, allow_pickle=False) as d:
            return Params(
                int(d["k"][0]),
                d["g_lagrange"],
                d["g_lagrange_inf"],
                _g2_from_u64(d["g2"]),
                _g2_from_u64(d["s_g2"]),
            )


def setup(k: int, seed: int = 0xE5BC0654, device=None) -> Params:
    """Toy (tau-known) setup, deterministic in (k, seed) — the analog of
    `Setup::new(k, XorShiftRng(seed))`.  Caches to disk (npz).  With a
    `device`, the fixed-base products above 2^10 points run there through
    K1 (`ec_kernels.scalar_mul_win`); None keeps them on the host."""
    os.makedirs(CACHE_DIR, mode=0o700, exist_ok=True)
    cache = os.path.join(CACHE_DIR, f"params-{k}-{seed:x}.npz")
    if os.path.exists(cache):
        return Params.load(cache)

    rng = np.random.default_rng(seed)
    tau = int.from_bytes(rng.bytes(40), "little") % R
    n = 1 << k
    omega = fr_omega(k)
    g = oc.g1_generator()
    g2 = oc.g2_generator()
    s_g2 = oc.g2_mul(g2, tau)

    from ..utils import native

    if k >= 14 and native.available():
        # scaled path: L_i(tau) via native batch inversion, points via the
        # windowed fixed-base kernel — numpy end to end (minutes at k=23)
        from . import engine

        tn1_over_n = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
        wi_m = engine.pow_series(engine.mont_scalar(omega), n)
        denom_m = native.fr_vec_binop(
            0, engine.mont_scalar(tau), 0, native.fr_vec_neg(wi_m), 0, n
        )
        native.fr_batch_inv_inplace(denom_m)
        s_m = native.fr_vec_binop(2, wi_m, 0, denom_m, 0, n)
        native.fr_vec_scale_inplace(s_m, engine.mont_scalar(tn1_over_n).reshape(-1))
        scalars_u64 = engine.from_mont(s_m)
        if device is None:
            base = ints_to_u64([g[0], g[1]]).reshape(-1)
            aff, inf = native.g1_batch_mul_win(base, scalars_u64)
        else:
            aff, inf = native.g1_normalize(_jac_to_u64(_device_g1_mul(g, scalars_u64, device)))
        params = Params(k, aff, inf, g2, s_g2)
    else:
        # L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i))
        tn1 = (pow(tau, n, R) - 1) % R
        scalars = []
        wi = 1
        for _ in range(n):
            denom = (tau - wi) % R
            scalars.append(wi * tn1 % R * pow(denom * n, -1, R) % R)
            wi = wi * omega % R
        g_lagrange = _batch_g1_mul(g, scalars, device)
        params = Params.from_points(k, g_lagrange, g2, s_g2)
    params.save(cache)
    return params


def _batch_g1_mul(base, scalars, device=None):
    """Host-or-device batched fixed-base scalar mul for SRS generation."""
    n = len(scalars)
    if n <= 1 << 10 or device is None and os.environ.get("H2A_DEVICE_MSM", "0") != "1":
        from ..utils import native

        if native.available():
            return native.g1_batch_mul(base, scalars)
        # fixed-base with shared doubling table
        table = []
        p = base
        for _ in range(254):
            table.append(p)
            p = oc.g1_double(p)
        out = []
        for s in scalars:
            acc = None
            b = 0
            while s:
                if s & 1:
                    acc = oc.g1_add(acc, table[b])
                s >>= 1
                b += 1
            out.append(acc)
        return out
    if device is None:
        raise ValueError(
            "H2A_DEVICE_MSM=1: setup's fixed-base scalar-mul above 2^10 points "
            "runs on the device given by its `device` argument, and none was given"
        )
    return co.jac_to_ints(_device_g1_mul(base, ints_to_u64(scalars), device))


def _device_g1_mul(base, scalars_u64: np.ndarray, device) -> JacPoint:
    """scalars[i] * base for an (n, 4) uint64 array of plain scalars, through
    `ec_kernels.scalar_mul_win` on `device` (K1 on a card, its plain version
    on the CPU): Jacobian points with Montgomery coordinates there."""
    from ..ops.ec_kernels import scalar_mul_win

    dev = resolve_device(device)
    n = scalars_u64.shape[0]
    g = co.affine_to_jac(co.affine_from_ints([base], dev))
    points = JacPoint(*(c.expand(n, 8).contiguous() for c in g))
    return scalar_mul_win(points, torch.from_numpy(u64_to_port(scalars_u64)).to(dev))


def _jac_to_u64(p: JacPoint) -> np.ndarray:
    """Montgomery Jacobian points -> the (n, 12) plain x || y || z uint64
    rows `native.g1_normalize` takes, converted where they lie."""
    cols = []
    for c in p:
        plain = torch.empty_like(c)
        for i in range(0, c.shape[0], _TO_MONT_CHUNK):
            plain[i : i + _TO_MONT_CHUNK] = fo.from_mont(c[i : i + _TO_MONT_CHUNK], fo.FQ)
        cols.append(port_to_u64(plain.cpu()))
    return np.concatenate(cols, axis=1)


# ---------------------------------------------------------------------------
# the Lagrange SRS resident on a device, and commitments through the MSM
# ---------------------------------------------------------------------------
# Counterpart of the device branch of the JAX package's
# `plonk/kzg.py::Params._msm` (:132-156), which kept `_device_points`
# resident and ran `ops/msm.py::msm` under `H2A_DEVICE_MSM=1`.  Here the
# device is explicit: a `DeviceSRS` made on a CUDA device commits through
# kernel K7 (or K9 with `signed=False`), one made on the CPU through their
# plain version.

# rows a Montgomery conversion step takes: bounds the wide-form products'
# temporaries (about 10 KB a row)
_TO_MONT_CHUNK = 1 << 18


def _to_mont_fq(plain: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(plain)
    for i in range(0, plain.shape[0], _TO_MONT_CHUNK):
        out[i : i + _TO_MONT_CHUNK] = fo.to_mont(plain[i : i + _TO_MONT_CHUNK], fo.FQ)
    return out


class DeviceSRS:
    """`params.g_lagrange_u64` uploaded once to `device` (plain x || y,
    converted to Montgomery Fq there) with its infinity flags, as
    `self.points`; `commit_lagrange` commits with it.  At k = 21 the points
    take 128 MiB."""

    def __init__(self, params: Params, device="cuda"):
        self.device = resolve_device(device)
        self.n = params.n
        xy = np.asarray(params.g_lagrange_u64, dtype=np.uint64)
        if xy.shape != (self.n, 8):
            raise ValueError(f"g_lagrange_u64: expected ({self.n}, 8), got {xy.shape}")
        x = torch.from_numpy(u64_to_port(xy[:, :4])).to(self.device)
        y = torch.from_numpy(u64_to_port(xy[:, 4:])).to(self.device)
        inf = torch.from_numpy(np.asarray(params.g_lagrange_inf).astype(bool)).to(self.device)
        self.points = AffinePoint(_to_mont_fq(x), _to_mont_fq(y), inf)

    def commit_lagrange(self, values, *, signed: bool = True):
        """A commitment to the polynomial with Lagrange `values`, as
        `Params.commit_lagrange` takes them (an (m <= n, 4) uint64 array of
        plain values, zero-padded, or a list of ints) and gives it (an
        affine int pair, or None for the identity).  The MSM runs on the
        SRS's device: K7, or K9 with `signed=False`, on a card."""
        if isinstance(values, np.ndarray) and values.dtype == np.uint64:
            scalars_u64 = values
            if scalars_u64.shape[0] > self.n or scalars_u64.shape[1:] != (4,):
                raise ValueError(f"values: expected (m <= {self.n}, 4), got {scalars_u64.shape}")
            if scalars_u64.shape[0] < self.n:
                pad = np.zeros((self.n - scalars_u64.shape[0], 4), dtype=np.uint64)
                scalars_u64 = np.vstack([scalars_u64, pad])
        else:
            vals = [int(v) % R for v in values]
            if len(vals) > self.n:
                raise ValueError("polynomial larger than the domain")
            scalars_u64 = ints_to_u64(vals + [0] * (self.n - len(vals)))
        scalars = torch.from_numpy(u64_to_port(scalars_u64)).to(self.device)
        acc = msm(self.points, scalars, signed=signed)
        return co.jac_to_ints(JacPoint(*(c[None] for c in acc)))[0]
