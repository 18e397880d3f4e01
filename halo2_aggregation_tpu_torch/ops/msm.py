"""The device MSM: sum_i s_i * P_i over affine G1 points, by buckets.

Counterpart of `halo2_aggregation_tpu/ops/msm.py::msm` / `msm_pallas`
(:47-109) and of the recoding and glue of `ops/ec_pallas.py`
(`signed_windows_dev` :861-896, the digit rule of `_msm_kernel` :456-460,
the chunk sums and Horner of `msm_bucket_pallas*` :1018-1037):

* `signed_windows` / `unsigned_windows`: the digits, in plain torch
  outside any kernel, as `(n_win, N)` uint8;
* `msm`: zeroes the scalars of infinity points (they land in no bucket),
  recodes, and runs kernel K7 (`signed=True`: 52 signed 5-bit windows,
  mixed adds) or K9 (`signed=False`: 64 unsigned 4-bit windows, full adds)
  from `ops/msm_kernels.py` on a CUDA tensor, or their plain version
  `msm_bucket_plain` on a CPU tensor.

The plain version runs the kernels' arithmetic with torch ops on
`curve_ops`' wide form: one lane per (window, chunk of contiguous points),
buckets gathered and scattered by digit (bucket 0 is a dump, as on the
TPU), the running and suffix-sum fold, the sum over chunks and the Horner
across windows.  It adds a chunk's points in their order in memory, the
kernels in their digit-sorted order: the order of adds inside a bucket is
free, the buckets' sums are the same points.  The chunk count is a
parameter, so the plain version, the g++ build of the kernels' per-thread
code and the kernels can compare at one chunking; the chunking changes the
order of the adds, never the sum.

Not ported: the TPU tuning switches `H2A_MSM_TILE`, `H2A_MSM_WPG` and
`H2A_MSM_KFOLD` (VMEM working-set sizes), the `H2A_MSM_SIGNED` switch
(here the explicit `signed`), and the XLA sort + scan `msm_bucket`, which
stands in for hardware without the kernel.
"""

from __future__ import annotations

import torch

from . import curve_ops as co
from . import msm_kernels
from .curve_ops import AffinePoint, JacPoint, _wadd, _wadd_mixed, _wdouble, _wide_identity
from .field_ops import FQ, is_zero, narrow, select, widen, wneg
from .limbs import NL
from .msm_kernels import (
    BLOCK_THREADS,
    BUCKETS,
    MAX_CHUNK_POINTS,
    WINDOWS,
    check_bucket_inputs,
    check_chunks,
    chunk_len,
)

# bits a window of K7 (True) and K9
BITS = {True: 5, False: 4}

# t = s + H with H = sum_w 16 * 32^w: window w of t, less 16, is the signed
# digit d_w of s (the carry of the sequential recoding is t's carry)
_H = sum(16 << (5 * w) for w in range(WINDOWS[True]))
_MASK32 = 0xFFFFFFFF

# the fewest points a chunk: its fold (about 31 full adds, 496 products)
# stays well below its 128 or more adds.  On the card at n = 2^16, 512
# chunks of 128 ran 2 to 5 % faster than 1,024 of 64 and 256 of 256.
MIN_POINTS_PER_CHUNK = 128
# waves of blocks the bucket kernel's grid fills: at n = 2^21 two waves ran
# 3 % faster than one and 8 to 16 % faster than four
WAVES = 2
# chunks of the plain version on the CPU, where nothing is to be filled:
# few lanes keep its fold cheap
PLAIN_CHUNKS = 4


def choose_chunks(n: int, signed: bool, blocks_per_sm: int, sms: int) -> int:
    """Chunks a window on the card, C, from the bucket kernel's occupancy
    (`msm_kernels.occupancy`): n_win x C / 128 blocks fill `WAVES` whole
    waves of blocks_per_sm x sms blocks, rounded down to whole blocks a
    window.  A chunk keeps at least 128 points where n allows, and at most
    2^15 (the sort's offsets)."""
    n_win = WINDOWS[signed]
    blocks_a_window = max(1, (blocks_per_sm * sms * WAVES) // n_win)
    chunks = min(blocks_a_window * BLOCK_THREADS, max(1, n // MIN_POINTS_PER_CHUNK))
    return max(chunks, -(-n // MAX_CHUNK_POINTS))


def grid_shape(n: int, signed: bool, blocks_per_sm: int, sms: int) -> dict:
    """What `choose_chunks` leads to, for the records: chunks, points a
    chunk, blocks of the grid and the waves they fill."""
    chunks = choose_chunks(n, signed, blocks_per_sm, sms)
    blocks = WINDOWS[signed] * -(-chunks // BLOCK_THREADS)
    return {
        "chunks": chunks, "points_a_chunk": chunk_len(n, chunks), "blocks": blocks,
        "blocks_per_sm": blocks_per_sm, "sms": sms, "waves": blocks / (blocks_per_sm * sms),
    }


def _limbs64(scalars: torch.Tensor) -> torch.Tensor:
    if scalars.dtype != torch.int32 or scalars.dim() != 2 or scalars.shape[1] != NL:
        raise ValueError(f"scalars: expected (N, 8) int32, got {scalars.dtype} {tuple(scalars.shape)}")
    return scalars.to(torch.int64) & _MASK32


def signed_windows(scalars: torch.Tensor) -> torch.Tensor:
    """Plain (N, 8) int32 scalars < 2^256 -> (52, N) uint8 signed 5-bit
    digits d_w in [-16, 15], encoded |d| | (d < 0) << 5, with
    sum_w d_w 32^w == s: the output of the JAX `signed_windows_dev(s, 254,
    5, 4)`, bit for bit (52 = ceil(254 / 5) + 1 windows, a multiple of 4;
    the top window never carries out, for any 256-bit s)."""
    u = _limbs64(scalars)
    carry = torch.zeros_like(u[:, 0])
    t = []
    for j in range(NL + 1):  # t = s + H over 9 limbs (H < 2^260)
        v = (u[:, j] if j < NL else 0) + ((_H >> (32 * j)) & _MASK32) + carry
        t.append(v & _MASK32)
        carry = v >> 32
    out = torch.empty((WINDOWS[True], u.shape[0]), dtype=torch.uint8, device=u.device)
    for w in range(WINDOWS[True]):
        limb, off = divmod(5 * w, 32)
        v = t[limb] >> off
        if off > 32 - 5:
            v = v | (t[limb + 1] << (32 - off))
        d = (v & 31) - 16
        out[w] = (d.abs() | ((d < 0).to(torch.int64) << 5)).to(torch.uint8)
    return out


def unsigned_windows(scalars: torch.Tensor) -> torch.Tensor:
    """Plain (N, 8) int32 scalars -> (64, N) uint8 digits in [0, 16):
    window w is bits [4w, 4w + 4), the rule of the JAX `_msm_kernel`."""
    u = _limbs64(scalars).T  # (8, N)
    out = torch.empty((NL, 8, u.shape[1]), dtype=torch.uint8, device=u.device)
    for j in range(8):
        out[:, j] = ((u >> (4 * j)) & 15).to(torch.uint8)
    return out.reshape(WINDOWS[False], -1)


def bucket_partials_plain(xs, ys, digits, signed: bool, chunks: int) -> JacPoint:
    """The bucket sums and fold of every (window w, chunk c): the plain
    version of `csrc/msm.cuh::msm_chunk`.  Chunk c takes the contiguous
    points [c * L, min(n, (c + 1) * L)), L = ceil(n / C); returns
    (n_win, C, 8) Jacobian folds sum_m m * bucket_m."""
    n = check_bucket_inputs(xs, ys, digits, signed)
    L = check_chunks(n, chunks)
    n_win, C, nb = WINDOWS[signed], chunks, BUCKETS[signed]
    device = xs.device
    X, Y = widen(xs), widen(ys)
    lanes = torch.arange(n_win * C, device=device)
    # (lanes, nb + 1, 16) per coordinate; slot 0 takes the zero digits
    B = [c.clone() for c in _wide_identity((n_win * C, nb + 1), device)]
    one = FQ.wide(device).one.expand(n_win * C, -1)
    first = torch.arange(C, device=device) * L
    for j in range(L):  # step j adds point c * L + j of every chunk c
        idx = first + j
        valid = idx < n
        idx = idx.clamp(max=n - 1)
        e = torch.where(valid, digits[:, idx].to(torch.int64), 0).reshape(-1)
        mag = e & 31 if signed else e
        px = X[idx].expand(n_win, C, -1).reshape(-1, X.shape[-1])
        py = Y[idx].expand(n_win, C, -1).reshape(-1, Y.shape[-1])
        cur = JacPoint(*(b[lanes, mag] for b in B))
        if signed:
            py = select((e >> 5).bool(), wneg(py, FQ), py)
            new = _wadd_mixed(cur, px, py, lazy=True)
        else:
            new = _wadd(cur, JacPoint(px, py, one), lazy=True)
        for b, v in zip(B, new):
            b[lanes, mag] = v
    run = tot = _wide_identity((n_win * C,), device)
    for m in range(nb, 0, -1):
        run = _wadd(run, JacPoint(*(b[:, m] for b in B)), lazy=True)
        tot = _wadd(tot, run, lazy=True)
    return JacPoint(*(narrow(c).reshape(n_win, C, NL) for c in tot))


def combine_plain(partials: JacPoint, signed: bool) -> JacPoint:
    """Sum the (n_win, C) chunk folds per window, then Horner across the
    windows, high to low: acc = 2^bits acc + wsum_w.  Returns one (8,)
    Jacobian point, (1, 1, 0) for the identity."""
    wsum = co.jac_sum(JacPoint(*(c.transpose(0, 1) for c in partials)))  # (n_win, 8)
    w = JacPoint(*(widen(c) for c in wsum))
    acc = _wide_identity((), partials.x.device)
    for i in range(w.x.shape[0] - 1, -1, -1):
        for _ in range(BITS[signed]):
            acc = _wdouble(acc)
        acc = _wadd(acc, JacPoint(*(c[i] for c in w)), lazy=True)
    ident = _wide_identity((), partials.x.device)
    return JacPoint(*(narrow(select(is_zero(acc.z), a, b)) for a, b in zip(ident, acc)))


def msm_bucket_plain(xs, ys, digits, signed: bool, chunks: int) -> JacPoint:
    """The plain version of K7 (`signed`) or K9 on (n, 8) Montgomery affine
    coordinates and (n_win, n) digits: one (8,) Jacobian point."""
    return combine_plain(bucket_partials_plain(xs, ys, digits, signed, chunks), signed)


def msm(points: AffinePoint, scalars: torch.Tensor, *, signed: bool = True) -> JacPoint:
    """sum_i s_i * P_i for (n, 8) Montgomery affine points with (n,)
    infinity flags and (n, 8) int32 plain scalars < 2^256 on one device.
    Returns one Jacobian point of (8,) canonical coordinates (Z = 0 for the
    identity); compare as affine points.

    On a CUDA tensor this launches K7 (`signed=True`) or K9 (or raises),
    with `choose_chunks` chunks from the kernel's occupancy on the card; on
    a CPU tensor it runs their plain version with `PLAIN_CHUNKS` (more where
    n needs them to keep a chunk within 2^15 points)."""
    n = points.x.shape[0]
    if tuple(points.inf.shape) != (n,) or tuple(scalars.shape) != (n, NL):
        raise ValueError(f"inf {tuple(points.inf.shape)} / scalars {tuple(scalars.shape)} for {n} points")
    devices = {t.device for t in (points.x, points.y, points.inf, scalars)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = scalars.device
    scalars = torch.where(points.inf[:, None], 0, scalars)
    digits = signed_windows(scalars) if signed else unsigned_windows(scalars)
    if device.type == "cpu":
        return msm_bucket_plain(points.x, points.y, digits, signed, max(PLAIN_CHUNKS, -(-n // MAX_CHUNK_POINTS)))
    if device.type != "cuda":
        raise ValueError(f"msm: unsupported device {device}")
    launch = msm_kernels.msm_bucket_s5 if signed else msm_kernels.msm_bucket_u4
    return launch(points.x, points.y, digits, choose_chunks(n, signed, *msm_kernels.occupancy(signed)))


def msm_host(points_int, scalars_int):
    """The oracle's MSM on host ints, for tiny inputs and tests."""
    from ..oracle import curve as oc

    return oc.g1_msm(points_int, scalars_int)
