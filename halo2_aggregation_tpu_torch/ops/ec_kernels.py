"""Kernels K1 and K8: the batched G1 scalar-mul, and their wrappers.

Counterpart of `halo2_aggregation_tpu/ops/ec_pallas.py::scalar_mul_auto`:
K1 (`csrc/ec_win.cu`, the windowed `_win_kernel` + `_final_kernel` behind
`scalar_mul_pallas_win`; plain version `curve_ops.scalar_mul`) and K8
(`csrc/ec_ladder.cu`, the bit-serial `_ladder_kernel` behind
`scalar_mul_pallas2`; plain version `curve_ops.scalar_mul_ladder`).
`scalar_mul` picks one by an explicit `method` where the JAX package read
`H2A_PALLAS_WIN`.
"""

from __future__ import annotations

import torch

from . import build
from . import curve_ops as co
from .curve_ops import JacPoint


def _check(t: torch.Tensor, name: str, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.shape[-1] != 8:
        raise ValueError(f"{name}: expected (..., 8) int32, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_lanes(points: JacPoint, scalars: torch.Tensor, who: str) -> str:
    """Validates the lanes; returns the device type, "cpu" or "cuda"."""
    device = points.x.device
    shape = points.x.shape
    for name, t in (("x", points.x), ("y", points.y), ("z", points.z), ("scalars", scalars)):
        _check(t, name, device)
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {device}")
    return device.type


def scalar_mul_win(points: JacPoint, scalars: torch.Tensor) -> JacPoint:
    """s_i * P_i over any leading batch shape: Jacobian points with
    Montgomery Fq coordinates, plain (non-Montgomery) scalars < 2^256.
    Output coordinates are canonical; zero scalars and identity points give
    the identity (Z = 0).  Z may differ from the JAX kernel's: compare as
    affine points.

    On a CUDA tensor this launches K1 (or raises); on a CPU tensor it runs
    the plain version `curve_ops.scalar_mul`."""
    if _check_lanes(points, scalars, "scalar_mul_win") == "cpu":
        return co.scalar_mul(points, scalars)
    device = points.x.device
    lib = build.load_library()
    out = JacPoint(*(torch.empty_like(c) for c in points))
    n = points.x.numel() // 8
    rc = lib.h2a_ec_win(
        points.x.data_ptr(), points.y.data_ptr(), points.z.data_ptr(),
        scalars.data_ptr(),
        out.x.data_ptr(), out.y.data_ptr(), out.z.data_ptr(),
        n, build.stream_ptr(device),
    )
    build.check(rc, "h2a_ec_win")
    scalar_mul_win.launches += 1
    return out


scalar_mul_win.launches = 0


def scalar_mul_ladder(points: JacPoint, scalars: torch.Tensor, nbits: int = 254) -> JacPoint:
    """s_i * P_i for the low `nbits` bits (1 .. 256; the JAX default 254)
    of plain scalars, over any leading batch shape, by the bit-serial
    double-and-add.  For scalars < 2^nbits its affine points equal
    `scalar_mul_win`'s; the identity comes out as (1, 1, 0).

    On a CUDA tensor this launches K8 (or raises); on a CPU tensor it runs
    the plain version `curve_ops.scalar_mul_ladder`."""
    if not 1 <= nbits <= 256:
        raise ValueError(f"nbits = {nbits}: expected 1 .. 256")
    if _check_lanes(points, scalars, "scalar_mul_ladder") == "cpu":
        return co.scalar_mul_ladder(points, scalars, nbits)
    device = points.x.device
    lib = build.load_library()
    out = JacPoint(*(torch.empty_like(c) for c in points))
    rc = lib.h2a_ec_ladder(
        points.x.data_ptr(), points.y.data_ptr(), points.z.data_ptr(),
        scalars.data_ptr(),
        out.x.data_ptr(), out.y.data_ptr(), out.z.data_ptr(),
        points.x.numel() // 8, nbits, build.stream_ptr(device),
    )
    build.check(rc, "h2a_ec_ladder")
    scalar_mul_ladder.launches += 1
    return out


scalar_mul_ladder.launches = 0

METHODS = ("win", "ladder")


def scalar_mul(points: JacPoint, scalars: torch.Tensor, method: str = "win") -> JacPoint:
    """The batched scalar-mul by `method`: "win" (K1, all 256 bits) or
    "ladder" (K8 over 254 bits, the JAX default: the caller's scalars are
    Fr values, below 2^254)."""
    if method == "win":
        return scalar_mul_win(points, scalars)
    if method == "ladder":
        return scalar_mul_ladder(points, scalars, 254)
    raise ValueError(f"method {method!r}: expected one of {METHODS}")
