"""Kernels K3-K5: batched NTT, inverse NTT, elementwise Fr products and the
power series, on `(C, n, 8)` column stacks.

Counterpart of `halo2_aggregation_tpu/ops/ntt.py` (tables, bit reversal,
the radix-2 transform) and of the drivers in `ops/ntt_pallas.py`
(`ntt_batched_u8`, `intt_batched_u8`, `ew_mul_u8`, `ew_mul_scalar_u8`,
`pow_series_u8`).  Elements are canonical Montgomery Fr in the port's
`(..., 8)` int32 layout, the same 32 bytes as the native engine's
`(n, 4)` u64 columns.

Contracts (those of the TPU engine, without its u8 limbs-on-sublanes
layout and 128-lane tiles):
* `ntt_batched`: bit-reversed coefficients -> natural-order evaluations
  (DIT, kernel K3);
* `intt_batched`: natural-order evaluations -> bit-reversed coefficients,
  times 1/n (DIF, kernel K4, which multiplies by 1/n as its last pass
  stores), so INTT -> scale -> NTT needs no permutation anywhere;
* `ew_mul_col`, `ew_mul_scalar`, `pow_series`: kernel K5;
* `mul_chain`: dependent products, lane by lane, in the same source
  (the product's latency, the bench's field-mul rate).

Both transforms run in place on the stack they are given.  Twiddles come
from one natural-order table of root powers per direction (`NttTables`),
built by the native engine's `pow_series`.

On the card a transform of size 2^k is `len(pass_plan(k))` launches: a
pass runs up to `R_MAX` consecutive stages on tiles held in shared memory
(`csrc/ntt.cu`), so the stack crosses device memory once a pass and not once
a stage.  `pass_plan`, `pass_chunk_bits` and `tile_indices` mirror the
kernel's geometry (`csrc/ntt.cuh`) for the tests.

Every wrapper takes its kernel's plain PyTorch version for a CPU tensor,
and launches the kernel (or raises) for a CUDA tensor.  Each has a launch
count, `.launches`, raised by one per kernel launch (a transform launches
one kernel per pass).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import R, fr_omega
from ..plonk import engine
from . import build
from . import field_ops as fo
from .limbs import NL, u64_to_port

# most stages one pass fuses, and most low index bits a tile adds to make its
# global accesses runs of 2^c elements (csrc/ntt.cuh: kNttMaxStages,
# kNttMaxChunkBits)
R_MAX = 7
C_MAX = 2
PASS_THREADS = 128  # threads of a pass kernel's block (csrc/ntt.cu: kPassThreads)

# elements per plain-version step: bounds the 16-bit-limb products'
# temporaries (about 10 KB an element) to a few GB
PLAIN_CHUNK = 1 << 18


def bit_reverse_indices(k: int) -> np.ndarray:
    """The k-bit reversal of 0 .. 2^k - 1 (`ops/ntt.py::_bit_reverse_indices`)."""
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def mont_tensor(v: int, device) -> torch.Tensor:
    """A plain int as one (8,) Montgomery Fr tensor on `device`."""
    return fo.FR.to_mont_tensor([int(v) % R], device)[0]


def half_series(root: int, k: int, device) -> torch.Tensor:
    """root^0 .. root^(n/2 - 1), natural order, as (n/2, 8) Montgomery."""
    pows = engine.pow_series(engine.mont_scalar(root), 1 << (k - 1))
    return torch.from_numpy(u64_to_port(pows).copy()).to(device)


def pass_plan(k: int) -> list:
    """The passes of a size-2^k transform as [(s0, r), ...]: the k stages
    cut into ceil(k / R_MAX) runs of nearly equal length, in ascending
    order (K3 runs them first to last, K4 last to first)."""
    if k < 1:
        raise ValueError(f"k = {k}: transforms need n >= 2")
    passes = -(-k // R_MAX)
    base, extra = divmod(k, passes)
    plan, s0 = [], 0
    for i in range(passes):
        r = base + (i < extra)
        plan.append((s0, r))
        s0 += r
    return plan


def pass_chunk_bits(k: int, s0: int, r: int) -> int:
    """c of a pass (csrc/ntt.cuh::ntt_pass_chunk_bits): its tiles hold
    2^(r + c) elements in runs of 2^c neighbours."""
    return min(C_MAX, s0 if s0 > 0 else k - r)


def tile_indices(k: int, s0: int, r: int) -> np.ndarray:
    """Element index of every slot of every tile of a pass
    (csrc/ntt.cuh::ntt_tile_index), as (tiles, 2^(r + c)) int64."""
    c = pass_chunk_bits(k, s0, r)
    low = c if s0 > 0 else 0
    mid, top = s0 - low, s0 + r + c - low
    u = np.arange(1 << (r + c), dtype=np.int64)[None, :]
    block = np.arange(1 << (k - r - c), dtype=np.int64)[:, None]
    idx = (u & ((1 << low) - 1)) | ((u >> low) << s0)
    return idx | ((block & ((1 << mid) - 1)) << low) | ((block >> mid) << top)


class NttTables:
    """Per-k tables on `device`: the forward and inverse twiddle tables
    (natural-order powers of omega and of 1/omega, n/2 each) and 1/n."""

    def __init__(self, k: int, device):
        if k < 1:
            raise ValueError(f"k = {k}: transforms need n >= 2")
        self.k = k
        self.n = 1 << k
        omega = fr_omega(k)
        self.fwd = half_series(omega, k, device)
        self.inv = half_series(pow(omega, -1, R), k, device)
        self.n_inv = mont_tensor(pow(self.n, -1, R), device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b (Montgomery), b broadcast to a's shape, in row chunks."""
    b = b.expand_as(a)
    flat_a, flat_b = a.reshape(-1, NL), b.reshape(-1, NL)
    out = torch.empty_like(flat_a)
    for i in range(0, flat_a.shape[0], PLAIN_CHUNK):
        out[i : i + PLAIN_CHUNK] = fo.mont_mul(flat_a[i : i + PLAIN_CHUNK], flat_b[i : i + PLAIN_CHUNK], fo.FR)
    return out.reshape(a.shape)


def stage_pairs(k: int, s: int, device):
    """Index map of stage s (csrc/ntt.cuh::ntt_pair) for every butterfly:
    (lo, hi, twiddle index), each (n/2,) int64."""
    t = torch.arange(1 << (k - 1), dtype=torch.int64, device=device)
    j = t & ((1 << s) - 1)
    lo = ((t >> s) << (s + 1)) | j
    return lo, lo + (1 << s), j << (k - 1 - s)


def _transform_plain(x: torch.Tensor, tw: torch.Tensor, dif: bool) -> torch.Tensor:
    C, n = x.shape[0], x.shape[1]
    k = n.bit_length() - 1
    x = x.clone()
    step = max(1, PLAIN_CHUNK // C)
    stages = range(k - 1, -1, -1) if dif else range(k)
    for s in stages:
        lo_all, hi_all, ti_all = stage_pairs(k, s, x.device)
        for i in range(0, n // 2, step):
            lo, hi, ti = lo_all[i : i + step], hi_all[i : i + step], ti_all[i : i + step]
            a, b, w = x[:, lo], x[:, hi], tw[ti]
            if dif:
                x[:, lo] = fo.add(a, b, fo.FR)
                x[:, hi] = fo.mont_mul(fo.sub(a, b, fo.FR), w, fo.FR)
            else:
                t = fo.mont_mul(b, w, fo.FR)
                x[:, lo] = fo.add(a, t, fo.FR)
                x[:, hi] = fo.sub(a, t, fo.FR)
    return x


def ntt_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (C, n, 8) bit-reversed coefficients ->
    natural-order evaluations (a new tensor)."""
    return _transform_plain(x, tw, dif=False)


def intt_plain(x: torch.Tensor, tw_inv: torch.Tensor, n_inv: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 and its 1/n scale: (C, n, 8) natural-order
    evaluations -> bit-reversed coefficients (a new tensor)."""
    return mul_plain(_transform_plain(x, tw_inv, dif=True), n_inv)


def pow_series_plain(start: torch.Tensor, base: torch.Tensor, k: int, bitrev: bool) -> torch.Tensor:
    """Plain version of K5's power series: start * base^idx(i), i < 2^k,
    idx(i) = i or its k-bit reversal; a select ladder over the bits."""
    n = 1 << k
    idx = torch.arange(n, dtype=torch.int64, device=start.device)
    if bitrev:
        idx = torch.from_numpy(bit_reverse_indices(k)).to(start.device)
    acc = start.expand(n, NL).clone()
    sq = base
    for b in range(k):
        take = ((idx >> b) & 1).bool()
        acc = torch.where(take.unsqueeze(-1), mul_plain(acc, sq), acc)
        sq = fo.mont_mul(sq, sq, fo.FR)
    return acc


def poly_eval(coeffs: torch.Tensor, x: torch.Tensor, spec=fo.FR) -> torch.Tensor:
    """Horner evaluation of `(n, 8)` coefficients (low first) at the point
    `x` `(8,)`, all Montgomery form, from the top coefficient down."""
    return fo.horner_fold(coeffs.flip(0), x, spec)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, shape=None) -> None:
    if t.dtype != torch.int32 or t.shape[-1] != NL:
        raise ValueError(f"{name}: expected (..., 8) int32, got {t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_stack(x: torch.Tensor, tw: torch.Tensor) -> int:
    """Validates a (C, n, 8) stack and its (n/2, 8) table; returns k."""
    if x.dim() != 3:
        raise ValueError(f"stack: expected (C, n, 8), got {tuple(x.shape)}")
    n = x.shape[1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"stack: n = {n} is not a power of two >= 2")
    _check(x, "stack")
    _check(tw, "twiddles", (n // 2, NL))
    if tw.device != x.device:
        raise ValueError(f"twiddles on {tw.device}, stack on {x.device}")
    return n.bit_length() - 1


def _device_kind(*ts) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _passes(x: torch.Tensor, tw: torch.Tensor, k: int, dif: bool, counter, scale=None) -> None:
    """One launch a pass of `pass_plan(k)`: upward for K3, downward for K4,
    whose last pass (s0 = 0) multiplies by `scale` as it stores."""
    lib = build.load_library()
    stream = build.stream_ptr(x.device)
    plan = pass_plan(k)
    for s0, r in reversed(plan) if dif else plan:
        factor = scale.data_ptr() if scale is not None and s0 == 0 else None
        rc = lib.h2a_ntt_pass(x.data_ptr(), tw.data_ptr(), factor, x.shape[0], k, s0, r, int(dif), stream)
        build.check(rc, "h2a_ntt_pass")
        counter.launches += 1


def pass_occupancy(dif: bool, k: int) -> dict:
    """What the runtime says of the widest pass of a size-2^k transform on
    the current card: shared memory a block, blocks of `PASS_THREADS`
    threads an SM, SMs."""
    s0, r = max(pass_plan(k), key=lambda p: p[1] + pass_chunk_bits(k, *p))
    tile_bytes = (NL * 4) << (r + pass_chunk_bits(k, s0, r))
    blocks, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = build.load_library().h2a_ntt_occupancy(int(dif), tile_bytes, ctypes.byref(blocks), ctypes.byref(sms))
    build.check(rc, "h2a_ntt_occupancy")
    return {"tile_bytes": tile_bytes, "threads_a_block": PASS_THREADS, "blocks_per_sm": blocks.value,
            "sms": sms.value}


def ntt_batched(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Forward NTT of every column of the (C, n, 8) stack `x`, in place:
    bit-reversed coefficients -> natural-order evaluations.  `tw` is
    `NttTables.fwd`.  Returns x."""
    k = _check_stack(x, tw)
    if _device_kind(x, tw) == "cpu":
        return x.copy_(ntt_plain(x, tw))
    _passes(x, tw, k, dif=False, counter=ntt_batched)
    return x


def intt_batched(x: torch.Tensor, tw_inv: torch.Tensor, n_inv: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of every column of the (C, n, 8) stack `x`, in place:
    natural-order evaluations -> bit-reversed coefficients.  `tw_inv` and
    `n_inv` are `NttTables.inv` and `.n_inv`.  Returns x."""
    k = _check_stack(x, tw_inv)
    _check(n_inv, "n_inv", (NL,))
    if _device_kind(x, tw_inv, n_inv) == "cpu":
        return x.copy_(intt_plain(x, tw_inv, n_inv))
    _passes(x, tw_inv, k, dif=True, counter=intt_batched, scale=n_inv)
    return x


def ew_mul_col(x: torch.Tensor, col: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """out[c, i] = x[c, i] * col[i] for a (C, n, 8) stack and an (n, 8)
    column; `out` may be x.  Returns out."""
    if x.dim() != 3:
        raise ValueError(f"x: expected (C, n, 8), got {tuple(x.shape)}")
    _check(x, "x")
    _check(col, "col", x.shape[1:])
    out = torch.empty_like(x) if out is None else out
    _check(out, "out", x.shape)
    if _device_kind(x, col, out) == "cpu":
        return out.copy_(mul_plain(x, col))
    lib = build.load_library()
    rc = lib.h2a_ew_mul_col(
        x.data_ptr(), col.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], build.stream_ptr(x.device)
    )
    build.check(rc, "h2a_ew_mul_col")
    ew_mul_col.launches += 1
    return out


def ew_mul_scalar(x: torch.Tensor, s: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """out = x * s for a (..., 8) tensor and one (8,) scalar; `out` may be
    x.  Returns out."""
    _check(x, "x")
    _check(s, "scalar", (NL,))
    out = torch.empty_like(x) if out is None else out
    _check(out, "out", x.shape)
    if _device_kind(x, s, out) == "cpu":
        return out.copy_(mul_plain(x, s))
    lib = build.load_library()
    rc = lib.h2a_ew_mul_scalar(
        x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel() // NL, build.stream_ptr(x.device)
    )
    build.check(rc, "h2a_ew_mul_scalar")
    ew_mul_scalar.launches += 1
    return out


def mul_chain(a: torch.Tensor, b: torch.Tensor, iters: int, spec=fo.FR) -> torch.Tensor:
    """a * (b / 2^256)^iters elementwise in `spec` (Fq or Fr), for (n, 8)
    canonical a and b with n a multiple of 32: each lane `iters` dependent
    Montgomery products (csrc/ew.cu::h2a_mul_chain, n / 32 blocks of one
    warp), what the product's latency and the bench's field-mul rate are
    measured on.  Returns a new tensor."""
    _check(a, "a")
    _check(b, "b", a.shape)
    if a.dim() != 2 or a.shape[0] % 32 or iters < 0:
        raise ValueError(f"mul_chain: (n, 8) with n a multiple of 32 and iters >= 0, got "
                         f"{tuple(a.shape)}, {iters}")
    if _device_kind(a, b) == "cpu":
        out = a
        for _ in range(iters):
            out = fo.mont_mul(out, b, spec)
        return out.clone()
    lib = build.load_library()
    out = torch.empty_like(a)
    rc = lib.h2a_mul_chain(int(spec is fo.FR), a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0] // 32,
                           iters, build.stream_ptr(a.device))
    build.check(rc, "h2a_mul_chain")
    mul_chain.launches += 1
    return out


def pow_series_squares(base: int, k: int, device, start: int = 1) -> torch.Tensor:
    """(k + 1, 8) Montgomery Fr: start, then base^(2^j) for j < k, exact in
    host ints: what K5's series tables are built from (`csrc/ntt.cuh`)."""
    vals, sq = [int(start) % R], int(base) % R
    for _ in range(k):
        vals.append(sq)
        sq = sq * sq % R
    return fo.FR.to_mont_tensor(vals, device)


def pow_series_tables(sq: torch.Tensor, k: int, bitrev: bool) -> torch.Tensor:
    """The series' first launch: the tables TA (2^ceil(k/2) entries) and TB
    (2^floor(k/2)) in one (len, 8) tensor, from `pow_series_squares`."""
    _check(sq, "squares", (k + 1, NL))
    m = (k + 1) // 2
    tables = torch.empty(((1 << m) + (1 << (k - m)), NL), dtype=torch.int32, device=sq.device)
    rc = build.load_library().h2a_pow_series_tables(
        tables.data_ptr(), sq.data_ptr(), k, int(bitrev), build.stream_ptr(sq.device))
    build.check(rc, "h2a_pow_series_tables")
    pow_series.launches += 1
    return tables


def pow_series_products(tables: torch.Tensor, k: int) -> torch.Tensor:
    """The series' second launch: out[i] = TA[lo] * TB[hi], i = hi 2^ceil(k/2)
    + lo, one product an element."""
    m = (k + 1) // 2
    _check(tables, "tables", ((1 << m) + (1 << (k - m)), NL))
    out = torch.empty((1 << k, NL), dtype=torch.int32, device=tables.device)
    rc = build.load_library().h2a_pow_series_products(
        out.data_ptr(), tables.data_ptr(), k, build.stream_ptr(tables.device))
    build.check(rc, "h2a_pow_series_products")
    pow_series.launches += 1
    return out


def pow_series(base: int, k: int, device, start: int = 1, bitrev: bool = False) -> torch.Tensor:
    """[start * base^idx(i)] for i < 2^k (0 <= k <= 30) as an (n, 8)
    Montgomery tensor on `device`; idx(i) = i, or the k-bit reversal of i
    when `bitrev` (the coset scale of a bit-reversed coefficient stack).

    On the card two launches: the tables, then one product an element
    (`pow_series_tables`, `pow_series_products`)."""
    if not 0 <= k <= 30:
        raise ValueError(f"k = {k}: expected 0 .. 30")
    device = torch.device(device)
    if device.type == "cpu":
        return pow_series_plain(mont_tensor(start, device), mont_tensor(base, device), k, bitrev)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return pow_series_products(pow_series_tables(pow_series_squares(base, k, device, start), k, bitrev), k)


for _fn in (ntt_batched, intt_batched, ew_mul_col, ew_mul_scalar, pow_series, mul_chain):
    _fn.launches = 0
