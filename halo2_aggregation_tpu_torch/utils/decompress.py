"""Compressed G1 points decompressed a batch at a time.

`serialization.g1_decompress` takes one 32-byte encoding and makes one
square root call for it, which pays an array, its ctypes casts and an
OpenMP region for one modexp. Decompression depends only on the bytes of
the encoding, never on the transcript, so `g1_decompress_batch` takes every
encoding of a batch at once (16 points a proof at k = 9, 2,048 at B = 128):
the sign bit, the range test and x^3 + 3 over the whole array, then ONE
`native.fq_batch_sqrt` call for every entry that reaches it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import CURVE_B, Q
from . import native
from .serialization import fq_sqrt

_LOW63 = np.uint64((1 << 63) - 1)
_Q_LIMBS = [np.uint64((Q >> (64 * i)) & ((1 << 64) - 1)) for i in range(4)]


@dataclass(frozen=True)
class BadPoint:
    """An encoding `g1_decompress` refuses, with its ValueError's message."""

    message: str


BAD_ENCODING = BadPoint("bad point encoding")
NOT_ON_CURVE = BadPoint("x not on curve")


def _below_q(x: np.ndarray) -> np.ndarray:
    """(N,) bool: x < Q for (N, 4) little-endian limbs, compared from the top."""
    lt = np.zeros(x.shape[0], dtype=bool)
    eq = np.ones(x.shape[0], dtype=bool)
    for i in (3, 2, 1, 0):
        lt |= eq & (x[:, i] < _Q_LIMBS[i])
        eq &= x[:, i] == _Q_LIMBS[i]
    return lt


def _limbs_to_ints(a: np.ndarray) -> list:
    buf = np.ascontiguousarray(a, dtype="<u8").tobytes()
    return [int.from_bytes(buf[j : j + 32], "little") for j in range(0, len(buf), 32)]


def g1_decompress_batch(encodings: np.ndarray) -> list:
    """(N, 4) little-endian u64 encodings -> N entries, each what
    `g1_decompress` gives on the same 32 bytes: the point (x, y), None for
    the all-zero encoding, or `BAD_ENCODING` (x >= Q) / `NOT_ON_CURVE` (no
    root) where it raises. One `fq_batch_sqrt` call for the batch; nothing
    is kept between calls."""
    enc = np.asarray(encodings, dtype=np.uint64).reshape(-1, 4)
    out: list = [None] * enc.shape[0]
    x = enc.copy()
    x[:, 3] &= _LOW63
    below = _below_q(x)
    nonzero = enc.any(axis=1)
    for i in np.flatnonzero(nonzero & ~below):
        out[i] = BAD_ENCODING
    idx = np.flatnonzero(nonzero & below)
    if idx.size == 0:
        return out
    xs = _limbs_to_ints(x[idx])
    rhs = [(v * v % Q * v + CURVE_B) % Q for v in xs]
    sign = (enc[idx, 3] >> np.uint64(63)).astype(bool)
    if native.available():
        buf = b"".join(v.to_bytes(32, "little") for v in rhs)
        roots, ok = native.fq_batch_sqrt(np.frombuffer(buf, dtype="<u8").reshape(-1, 4))
        ys = _limbs_to_ints(roots)
    else:  # the pure-Python modexp `g1_decompress` falls back to
        ys = [fq_sqrt(v) for v in rhs]
        ok = [y is not None for y in ys]
    for j, i in enumerate(idx):
        if not ok[j]:
            out[i] = NOT_ON_CURVE
            continue
        y = ys[j]
        if bool(y % 2) != sign[j]:
            y = Q - y
        out[i] = (xs[j], y)
    return out
