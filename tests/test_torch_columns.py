"""The port's host column construction (`plonk/columns.py`) against the JAX
package's originals: `rand_fr_column` against m calls of `_rand_fr` through
`ints_to_u64` (values, order and the generator's state afterwards),
`reduce_words` against `v % r` on the edge words of a 320-bit draw, and
`col_from_ints_fast` and `advice_column` against `engine.col_from_ints`.
Exact equality: these are integers."""

import numpy as np
import pytest

from halo2_aggregation_tpu.fields import R
from halo2_aggregation_tpu.plonk.engine import col_from_ints
from halo2_aggregation_tpu.plonk.prover import _rand_fr
from halo2_aggregation_tpu.utils.u64 import ints_to_u64
from halo2_aggregation_tpu_torch.plonk import columns

W64 = 1 << 64
TOP = (1 << 320) - 1


class CountingRng:
    """A generator that counts its `bytes` calls."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = 0

    def bytes(self, length):
        self.calls += 1
        return self.rng.bytes(length)


@pytest.mark.parametrize("m", [0, 1, 7, 1 << 16])
@pytest.mark.parametrize("seed", [0, 42])
def test_rand_fr_column_matches_rand_fr(seed, m):
    loop = np.random.default_rng(seed)
    bulk = CountingRng(seed)
    want = ints_to_u64([_rand_fr(loop) for _ in range(m)])
    got = columns.rand_fr_column(bulk, m)
    assert got.shape == (m, 4) and got.dtype == np.uint64
    assert (got == want.reshape(m, 4)).all()
    assert bulk.calls == (1 if m else 0)
    assert bulk.rng.bytes(8) == loop.bytes(8)  # the same state afterwards


def _words(vals):
    return np.array([[(v >> (64 * i)) & (W64 - 1) for i in range(5)] for v in vals], dtype=np.uint64)


_rs = np.random.default_rng(3)
_Q = TOP // R  # the largest multiple of r below 2^320 is _Q * r
EDGE_WORDS = {
    "all_ones": [TOP],
    "zero": [0],
    "around_multiples_of_r_below_2^256": [k * R + d for k in range(1, 6) for d in (-1, 0, 1)],
    "around_2^256": [(1 << 256) - 1, 1 << 256, (1 << 256) + 1],
    "around_the_top_multiple_of_r": [_Q * R - 1, _Q * R, _Q * R + 1, TOP - 1],
    "w4_zero": [int.from_bytes(_rs.bytes(32), "little") for _ in range(64)] + [(1 << 256) - 1],
    "w4_max": [((W64 - 1) << 256) + lo for lo in (0, 1, R - 1, R, (1 << 256) - 1)]
    + [((W64 - 1) << 256) + int.from_bytes(_rs.bytes(32), "little") for _ in range(64)],
    "w3_and_w4_max": [((1 << 128) - 1) << 192, (((1 << 128) - 1) << 192) + (1 << 192) - 1],
    "random_320_bit": [int.from_bytes(_rs.bytes(40), "little") for _ in range(1000)],
}


@pytest.mark.parametrize("case", sorted(EDGE_WORDS))
def test_reduce_words_is_exact(case):
    vals = EDGE_WORDS[case]
    assert all(0 <= v <= TOP for v in vals)
    got = columns.reduce_words(_words(vals))
    assert (got == ints_to_u64([v % R for v in vals])).all()


def test_reduce_words_rejects_other_widths():
    with pytest.raises(ValueError, match="words"):
        columns.reduce_words(np.zeros((3, 4), np.uint64))


_rc = np.random.default_rng(5)


def _random_field_column(n):
    return [int.from_bytes(_rc.bytes(40), "little") % R for _ in range(n)]


COLUMNS = {
    "empty": [],
    "all_zeros": [0] * 1000,
    "small": [int(v) for v in _rc.integers(0, 256, 1000)],
    "word_edges": [0, 1, W64 - 2, W64 - 1, W64, W64 + 1],
    "mixed_with_r_minus_1": [0, 5, R - 1, 2, R - 1, W64 - 1, R - 2],
    "values_at_least_r": [R, R + 1, 2 * R - 1, 2 * R, 7, TOP, 1 << 400],
    "negatives": [-1, -R, -R - 1, -(W64), 3, -(1 << 300), 0],
    "random_2^16_rows": _random_field_column(1 << 16),
    "random_2^16_rows_with_blanks": [v if i % 3 else 0 for i, v in enumerate(_random_field_column(1 << 16))],
    "numpy_ints": [np.int64(-3), np.uint64(W64 - 1), np.int64(9)],
    "bools": [True, False, 1],
    "tuple": (1, R + 2, -1),
}


@pytest.mark.parametrize("case", sorted(COLUMNS))
def test_col_from_ints_fast_matches_copy(case):
    vals = COLUMNS[case]
    want = col_from_ints(vals)
    got = columns.col_from_ints_fast(vals)
    assert got.dtype == np.uint64 and got.shape == (len(vals), 4)
    assert (got == want.reshape(len(vals), 4)).all()


_ra = _random_field_column(500)
ADVICE = {
    "empty": [],
    "no_unassigned_rows": _ra,
    "all_unassigned": [None] * 64,
    "trailing_run": _ra + [None] * 300,
    "leading_and_trailing": [None] * 3 + _ra + [None] * 300,
    "interspersed_and_trailing": [v if i % 7 else None for i, v in enumerate(_ra)] + [None] * 30,
    "interspersed_only": [v if i % 7 else None for i, v in enumerate(_ra)] + [5],
    "a_value_inside_the_trailing_run": _ra + [None] * 10 + [5] + [None] * 10,
    "trailing_run_wide_and_negative": [-1, R + 3, W64, 0] + [None] * 10,
}


@pytest.mark.parametrize("case", sorted(ADVICE))
def test_advice_column_matches_copy(case):
    vals = ADVICE[case]
    want = col_from_ints([0 if v is None else v for v in vals])
    got = columns.advice_column(vals)
    assert got.dtype == np.uint64 and got.shape == (len(vals), 4)
    assert (got == want.reshape(len(vals), 4)).all()
