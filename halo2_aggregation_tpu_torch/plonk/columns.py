"""Field columns in the (n, 4)-u64 layout, built without a Python int an
element where the values allow it.

Host constructions of the prover and keygen, each equal to the pinned
copy's on every input:

* `rand_fr_column(rng, m)`: the field elements of m calls of
  `prover._rand_fr(rng)`, in order, with the generator left in the same
  state, from one `rng.bytes` call reduced mod r on whole arrays;
* `col_from_ints_fast(vals)`: `engine.col_from_ints(vals)`, with the rows
  that fit a machine word converted as one array and only the others
  through a Python int each;
* `advice_column(vals)`: the same for an advice column, whose unassigned
  (None) rows are 0.
"""

from __future__ import annotations

import bisect

import numpy as np

from ..fields import R
from ..utils import native
from ..utils.u64 import int_to_u64
from . import engine

#: bytes of one `_rand_fr` draw: `rng.bytes(40)`, a 320-bit value
DRAW_BYTES = 40
DRAW_WORDS = DRAW_BYTES // 8
# A bulk `rng.bytes(40 * m)` reads the same generator stream as m calls of
# `rng.bytes(40)` only because 40 bytes are whole 64-bit words (and whole
# 32-bit draws): a ragged width would leave part of a word buffered.
assert DRAW_BYTES % 8 == 0

_WORD = 1 << 64
#: 2^448 mod r: a Montgomery product by it multiplies a value by 2^192
_MUL_2_192 = int_to_u64(pow(2, 448, R)).reshape(1, 4)


def reduce_words(words: np.ndarray) -> np.ndarray:
    """(m, 5) little-endian u64 words, each row a 320-bit value v, ->
    (m, 4) u64 of v mod r, exactly.

    v = lo + 2^192 * hi with lo the low three words (below 2^192 < r) and
    hi = w3 + 2^64 w4 (below 2^128 < r).  One Montgomery product by
    2^448 mod r gives hi * 2^192 mod r (canonical: one operand is below r
    and the product's final subtraction leaves it below r), and one field
    addition of two values below r adds lo."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    m = words.shape[0]
    if words.shape != (m, DRAW_WORDS):
        raise ValueError(f"expected (m, {DRAW_WORDS}) words, got {words.shape}")
    lo = np.zeros((m, 4), np.uint64)
    lo[:, :3] = words[:, :3]
    hi = np.zeros((m, 4), np.uint64)
    hi[:, :2] = words[:, 3:]
    hi = native.fr_vec_binop(2, hi, 0, _MUL_2_192, 0, m)
    return native.fr_vec_binop(0, lo, 0, hi, 0, m)


def rand_fr_column(rng: np.random.Generator, m: int) -> np.ndarray:
    """`ints_to_u64([_rand_fr(rng) for _ in range(m)])` from one draw of
    40 * m bytes: the same elements in the same order, and the same
    generator state afterwards (m = 0 draws nothing, as the loop does)."""
    if m == 0:
        return np.zeros((0, 4), np.uint64)
    words = np.frombuffer(rng.bytes(DRAW_BYTES * m), dtype="<u8").reshape(m, DRAW_WORDS)
    return reduce_words(words)


def col_from_ints_fast(vals) -> np.ndarray:
    """`engine.col_from_ints(vals)` (each value mod r, as plain (n, 4) u64)
    on every input: `_int_column` for a list of Python ints, the copy's
    conversion for any other element type."""
    if len(vals) and set(map(type, vals)) == {int}:
        return _int_column(vals)
    return engine.col_from_ints(vals)


def advice_column(vals: list) -> np.ndarray:
    """`col_from_ints_fast([0 if v is None else v for v in vals])`: an
    unassigned advice row is 0.  The rows past a circuit's last used row
    are one trailing run of None (831,512 of the outer circuit's 2^21 rows
    at N = 1).  A bisection finds where that run would start; when the rows
    after it are all None and those before it all ints, only those are
    converted.  Any other column takes the general path."""
    n = len(vals)
    head = bisect.bisect_left(vals, True, key=_is_none)
    if head and vals[head:] == [None] * (n - head) and set(map(type, vals[:head])) == {int}:
        out = np.zeros((n, 4), np.uint64)
        out[:head] = _int_column(vals[:head])
        return out
    return col_from_ints_fast([0 if v is None else v for v in vals])


def _is_none(v) -> bool:
    return v is None


def _int_column(vals: list) -> np.ndarray:
    """A non-empty list of Python ints -> plain (n, 4) u64 of each mod r.
    The rows in [0, 2^64) go into limb 0 as one array; the others (wider,
    or negative) through `% r` and `to_bytes` each, the `% r` a small part
    of the `to_bytes` on a value already below r."""
    n = len(vals)
    a = np.fromiter(vals, object, n)
    wide = (a < 0) | (a >= _WORD)
    rest = a[wide].tolist()
    a[wide] = 0
    out = np.zeros((n, 4), np.uint64)
    out[:, 0] = a.astype(np.uint64)
    if rest:
        buf = b"".join([(v % R).to_bytes(32, "little") for v in rest])
        out[wide] = np.frombuffer(buf, dtype="<u8").reshape(len(rest), 4)
    return out
