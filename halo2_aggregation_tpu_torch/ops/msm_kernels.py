"""Kernels K7 and K9: the bucket MSM on the card, and their launchers.

K7 (`msm_bucket_s5`) replaces `halo2_aggregation_tpu/ops/ec_pallas.py`'s
`_msm_kernel_s5` behind `msm_bucket_pallas_s5`; K9 (`msm_bucket_u4`) its
`_msm_kernel` behind `msm_bucket_pallas`.  Both are `csrc/msm.cu`: per
(window, chunk of contiguous points) a counting sort by digit, a walk with
one bucket sum in registers and the fold, then one launch that sums the
chunks and runs the Horner.  Their plain version, and the recoding and
chunk choice they take, are in `ops/msm.py`, whose `msm` is the entry
point; these launchers take CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .curve_ops import JacPoint
from .limbs import NL

# windows of K7 (True: signed 5-bit digits) and K9 (unsigned 4-bit), and
# their live buckets (|d| >= 1)
WINDOWS = {True: 52, False: 64}
BUCKETS = {True: 16, False: 15}
# the most points a chunk may hold: the sort's scratch keeps a point's offset
# in its chunk in 15 bits of a uint16 (csrc/msm.cuh::kMsmMaxChunk)
MAX_CHUNK_POINTS = 1 << 15
# threads a block of the bucket kernel (csrc/msm.cu::kBucketThreads)
BLOCK_THREADS = 128


def chunk_len(n: int, chunks: int) -> int:
    """L: chunk c of `chunks` holds the points [c * L, min(n, (c + 1) * L))."""
    return -(-n // chunks)


def check_chunks(n: int, chunks: int) -> int:
    """Validates a chunk count for n points; returns the chunk length."""
    if chunks < 1:
        raise ValueError(f"chunks = {chunks}: expected chunks >= 1")
    L = chunk_len(n, chunks)
    if L > MAX_CHUNK_POINTS:
        raise ValueError(
            f"{chunks} chunks of {n} points hold {L} each: a chunk takes at most {MAX_CHUNK_POINTS}"
        )
    return L


@functools.cache
def occupancy(signed: bool) -> tuple:
    """(blocks an SM holds, SMs) for the bucket kernel of K7 (`signed`) or
    K9 on the current card, from `cudaOccupancyMaxActiveBlocksPerMultiprocessor`."""
    blocks, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = build.load_library().h2a_msm_occupancy(int(signed), ctypes.byref(blocks), ctypes.byref(sms))
    build.check(rc, "h2a_msm_occupancy")
    return blocks.value, sms.value


def check_bucket_inputs(xs, ys, digits, signed: bool) -> int:
    """Validates (n, 8) int32 coordinates and (n_win, n) uint8 digits of
    one kind; returns n."""
    n = xs.shape[0]
    for name, t in (("xs", xs), ("ys", ys)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n, NL):
            raise ValueError(f"{name}: expected ({n}, 8) int32, got {t.dtype} {tuple(t.shape)}")
    if digits.dtype != torch.uint8 or tuple(digits.shape) != (WINDOWS[signed], n):
        raise ValueError(
            f"digits: expected ({WINDOWS[signed]}, {n}) uint8, got {digits.dtype} {tuple(digits.shape)}"
        )
    if n < 1:
        raise ValueError("msm of no points")
    return n


def _launch(signed: bool, xs, ys, digits, chunks: int) -> JacPoint:
    n = check_bucket_inputs(xs, ys, digits, signed)
    for name, t in (("xs", xs), ("ys", ys), ("digits", digits)):
        if t.device.type != "cuda" or t.device != xs.device:
            raise ValueError(f"{name} on {t.device}: the kernel takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    check_chunks(n, chunks)
    n_win = WINDOWS[signed]
    device = xs.device
    # scratch: the sort's offsets, written and read back by their own thread,
    # and the parked bucket sums
    order = torch.empty((n_win, n), dtype=torch.int16, device=device)
    bsums = torch.empty((n_win, chunks, BUCKETS[signed], 3, NL), dtype=torch.int32, device=device)
    partials = torch.empty((n_win, chunks, 3, NL), dtype=torch.int32, device=device)
    wsums = torch.empty((n_win, 3, NL), dtype=torch.int32, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    out = torch.empty((3, NL), dtype=torch.int32, device=device)
    rc = build.load_library().h2a_msm(
        int(signed), xs.data_ptr(), ys.data_ptr(), digits.data_ptr(), n, chunks,
        order.data_ptr(), bsums.data_ptr(), partials.data_ptr(), wsums.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        build.stream_ptr(device),
    )
    build.check(rc, "h2a_msm")
    return JacPoint(out[0], out[1], out[2])


def msm_bucket_s5(xs, ys, digits, chunks: int) -> JacPoint:
    """K7: sum_i d-recoded s_i * (xs_i, ys_i) for (n, 8) Montgomery affine
    coordinates and (52, n) signed digits (`msm.signed_windows`), with
    `chunks` contiguous chunks a window.  One (8,) Jacobian point, canonical."""
    out = _launch(True, xs, ys, digits, chunks)
    msm_bucket_s5.launches += 1
    return out


def msm_bucket_u4(xs, ys, digits, chunks: int) -> JacPoint:
    """K9: as K7, for (64, n) unsigned 4-bit digits (`msm.unsigned_windows`)
    and full adds."""
    out = _launch(False, xs, ys, digits, chunks)
    msm_bucket_u4.launches += 1
    return out


msm_bucket_s5.launches = 0
msm_bucket_u4.launches = 0
