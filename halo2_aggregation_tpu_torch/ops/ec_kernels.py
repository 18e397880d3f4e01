"""Kernels K1 and K8, the batched G1 scalar-mul, and the segmented Jacobian
sum, with their wrappers.

Counterpart of `halo2_aggregation_tpu/ops/ec_pallas.py::scalar_mul_auto`:
K1 (`csrc/ec_win.cu`, the windowed `_win_kernel` + `_final_kernel` behind
`scalar_mul_pallas_win`; plain version `curve_ops.scalar_mul`) and K8
(`csrc/ec_ladder.cu`, for the bit-serial `_ladder_kernel` behind
`scalar_mul_pallas2` a joint double-and-add over K1's split; plain version
`curve_ops.scalar_mul_ladder`, the bit-serial ladder).
`scalar_mul` picks one by an explicit `method` where the JAX package read
`H2A_PALLAS_WIN`.  `jac_segment_sum` (`csrc/jac_sum.cu`; plain version
`curve_ops.jac_segment_sum`) is the counterpart of the `lax.scan`s
`curve_ops.jac_sum` and `jac_segment_sum` of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import Q, R
from ..oracle import glv
from . import build
from . import curve_ops as co
from .curve_ops import JacPoint
from .field_ops import FQ
from .limbs import ints_to_np


@functools.cache
def _glv_ints() -> tuple:
    """The 7 constants of K1's scalar split as ints, in the order of
    `csrc/ec_win.cuh`, from the lattice basis of `oracle/glv.py`: the two
    rounding constants |round(2^256 b2 / det)| and |round(-2^256 b1 / det)|,
    the factors of c1 and c2 in s1 and in s2 (mod 2^256, with the rounding
    constants' signs folded in), and beta in Montgomery form."""
    (a1, b1), (a2, b2) = glv._V1, glv._V2
    det = a1 * b2 - a2 * b1
    g = [glv._round_div(b2 << 256, det), glv._round_div(-b1 << 256, det)]
    sign = [1 if x >= 0 else -1 for x in g]
    mask = (1 << 256) - 1
    return (
        abs(g[0]), abs(g[1]),
        -sign[0] * a1 & mask, -sign[1] * a2 & mask,
        -sign[0] * b1 & mask, -sign[1] * b2 & mask,
        FQ.to_mont(glv.BETA % Q),
    )


def glv_constants() -> np.ndarray:
    """The (7, 8) uint32 limbs of `_glv_ints`, as K1 reads them."""
    return ints_to_np(list(_glv_ints())).view(np.uint32)


def glv_split(s: int) -> tuple:
    """The signed halves (s1, s2) of the plain scalar s < 2^256 exactly as
    K1 computes them (`csrc/ec_win.cuh::glv_half_scalar`): s1 + s2 lambda =
    s (mod r).  A host mirror, for counting a run's products and for the
    tests."""
    g1, g2, a1, a2, b1, b2, _ = _glv_ints()
    s %= R
    c1, c2 = s * g1 >> 256, s * g2 >> 256
    halves = []
    for v in (s + c1 * a1 + c2 * a2, c1 * b1 + c2 * b2):
        v &= (1 << 256) - 1
        halves.append(v - (1 << 256) if v >> 255 else v)
    return tuple(halves)


@functools.cache
def _glv_constants_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(glv_constants().view(np.int32)).to(device)


@functools.cache
def _offsets_on(offsets: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int32, device=device)


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


def scalar_mul_win(points: JacPoint, scalars: torch.Tensor, threads: int = 0) -> JacPoint:
    """s_i * P_i over any leading batch shape: Jacobian points with
    Montgomery Fq coordinates, plain (non-Montgomery) scalars < 2^256 (taken
    mod r).  The points are on the curve: the kernel splits each scalar by
    the GLV endomorphism, which acts as [lambda] only there.  Output
    coordinates are canonical; zero scalars and identity points give the
    identity (1, 1, 0).  Z differs from the JAX kernel's and from the plain
    version's: compare as affine points.  `threads` is the kernel's block
    size, a multiple of 32; 0 lets the launcher choose it from the lanes.

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
        scalars.data_ptr(), _glv_constants_on(device).data_ptr(),
        out.x.data_ptr(), out.y.data_ptr(), out.z.data_ptr(),
        n, threads, build.stream_ptr(device),
    )
    build.check(rc, "h2a_ec_win")
    scalar_mul_win.launches += 1
    return out


scalar_mul_win.launches = 0


def _block(entry: str, n: int) -> int:
    import ctypes

    threads = ctypes.c_int(0)
    build.check(getattr(build.load_library(), entry)(n, ctypes.byref(threads)), entry)
    return threads.value


def win_block(n: int) -> int:
    """The block size (threads) K1's launcher takes for n lanes on the
    current card: one warp for a short launch, the occupancy call's block
    (at most 256 threads) from two waves of it on."""
    return _block("h2a_ec_win_block", n)


def ladder_block(n: int) -> int:
    """The block size K8's launcher takes for n lanes, by K1's rule."""
    return _block("h2a_ec_ladder_block", n)


def scalar_mul_ladder(points: JacPoint, scalars: torch.Tensor, nbits: int = 254) -> JacPoint:
    """(s_i mod 2^nbits) * P_i for plain scalars s_i and `nbits` in 1 .. 256
    (the JAX default 254), over any leading batch shape.  The points are on
    the curve: the kernel reduces the masked scalar mod r (G1 has cofactor
    1) and splits it by the GLV endomorphism as K1 does, which is [lambda]
    only there.  For scalars < 2^nbits its affine points equal
    `scalar_mul_win`'s; the identity comes out as (1, 1, 0).  The launcher
    sizes the block from the lanes (`ladder_block`).

    On a CUDA tensor this launches K8 (or raises); on a CPU tensor it runs
    the plain version `curve_ops.scalar_mul_ladder`, the bit-serial
    double-and-add, which holds K8 independently of the split."""
    if not 1 <= nbits <= 256:
        raise ValueError(f"nbits = {nbits}: expected 1 .. 256")
    if _check_lanes(points, scalars, "scalar_mul_ladder") == "cpu":
        return co.scalar_mul_ladder(points, scalars, nbits)
    device = points.x.device
    lib = build.load_library()
    out = JacPoint(*(torch.empty_like(c) for c in points))
    rc = lib.h2a_ec_ladder(
        points.x.data_ptr(), points.y.data_ptr(), points.z.data_ptr(),
        scalars.data_ptr(), _glv_constants_on(device).data_ptr(),
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


def jac_segment_sum(p: JacPoint, offsets, lane_axis: int = 0) -> JacPoint:
    """Per-segment sums of Jacobian points along the lane axis of 3-d
    coordinates, `(lanes, B, 8)` with `lane_axis=0` (the JAX layout) or
    `(B, lanes, 8)` with `lane_axis=1` (as K1 writes them): segment j holds
    lanes offsets[j] .. offsets[j + 1] - 1.  Returns coordinates of shape
    `(segments, B, 8)`, canonical, an empty segment and a cancelled sum as
    the identity (1, 1, 0).  The coordinates may be strided views (limbs
    contiguous); nothing is copied.

    On a CUDA tensor this launches the segmented-sum kernel (or raises); on
    a CPU tensor it runs the plain version `curve_ops.jac_segment_sum`,
    whose Jacobian representatives differ: compare as affine points."""
    device = p.x.device
    if p.x.dim() != 3 or lane_axis not in (0, 1):
        raise ValueError(f"jac_segment_sum: expected 3-d coordinates and lane_axis 0 or 1, "
                         f"got {tuple(p.x.shape)}, {lane_axis}")
    for name, t in zip("xyz", p):
        if t.dtype != torch.int32 or t.shape != p.x.shape or t.shape[-1] != 8:
            raise ValueError(f"{name}: expected {tuple(p.x.shape)} int32, got {t.dtype} {tuple(t.shape)}")
        if t.device != device or t.stride() != p.x.stride() or t.stride(-1) != 1:
            raise ValueError(f"{name}: device or strides differ from x's, or limbs are not contiguous")
    if device.type == "cpu":
        return co.jac_segment_sum(p, offsets, lane_axis)
    if device.type != "cuda":
        raise ValueError(f"jac_segment_sum: unsupported device {device}")
    offsets = tuple(int(o) for o in offsets)
    lanes, batch = p.x.shape[lane_axis], p.x.shape[1 - lane_axis]
    if len(offsets) < 2 or any(a > b for a, b in zip(offsets, offsets[1:])) \
            or offsets[0] < 0 or offsets[-1] > lanes:
        raise ValueError(f"offsets {offsets}: expected non-decreasing lane indices in 0 .. {lanes}")
    lib = build.load_library()
    n_seg = len(offsets) - 1
    out = JacPoint(*(torch.empty((n_seg, batch, 8), dtype=torch.int32, device=device) for _ in range(3)))
    rc = lib.h2a_jac_segment_sum(
        p.x.data_ptr(), p.y.data_ptr(), p.z.data_ptr(),
        p.x.stride(1 - lane_axis), p.x.stride(lane_axis),
        _offsets_on(offsets, device).data_ptr(), n_seg, batch,
        out.x.data_ptr(), out.y.data_ptr(), out.z.data_ptr(), build.stream_ptr(device),
    )
    build.check(rc, "h2a_jac_segment_sum")
    jac_segment_sum.launches += 1
    return out


jac_segment_sum.launches = 0
