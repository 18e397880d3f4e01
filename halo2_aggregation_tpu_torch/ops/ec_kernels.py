"""Kernel K1: the batched windowed G1 scalar-mul, and its wrapper.

Counterpart of `halo2_aggregation_tpu/ops/ec_pallas.py`'s `_win_kernel` +
`_final_kernel` behind `scalar_mul_pallas_win` / `scalar_mul_auto`.  The
kernel is `csrc/ec_win.cu`; its plain version is `curve_ops.scalar_mul`.
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


def scalar_mul_win(points: JacPoint, scalars: torch.Tensor) -> JacPoint:
    """s_i * P_i over any leading batch shape: Jacobian points with
    Montgomery Fq coordinates, plain (non-Montgomery) scalars < 2^256.
    Output coordinates are canonical; zero scalars and identity points give
    the identity (Z = 0).  Z may differ from the JAX kernel's: compare as
    affine points.

    On a CUDA tensor this launches K1 (or raises); on a CPU tensor it runs
    the plain version `curve_ops.scalar_mul`."""
    device = points.x.device
    shape = points.x.shape
    for name, t in (("x", points.x), ("y", points.y), ("z", points.z), ("scalars", scalars)):
        _check(t, name, device)
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if device.type == "cpu":
        return co.scalar_mul(points, scalars)
    if device.type != "cuda":
        raise ValueError(f"scalar_mul_win: unsupported device {device}")
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
