"""The permutation argument's arrays from an assignment's copy constraints,
on whole arrays.

`permutation_arrays(assignment)` returns what the pinned
`Assignment.build_permutation_arrays` (`plonk/circuit.py`) returns, bit for
bit and with its dtypes: (cp, rp), int32 and int64 arrays of shape
(permutation columns, n) with sigma[col][row] = (cp[col, row],
rp[col, row]), the identity on every cell no copy touches.

The pinned method unions the copies in a Python dict, then walks each
cycle in ascending cell order (cell = column position * n + row), each
member pointing at the next and the last at the first.  So its result
depends only on the partition of the touched cells into cycles, not on
which representative its union-find picks.  Here the partition comes from
`scipy.sparse.csgraph.connected_components` over the touched cells, and a
stable sort by component keeps each cycle's cells in ascending order.  A
copy of a cell to itself, a repeated copy and a cell copied to nothing
else all leave that cell on the identity, as in the pinned method.
"""

from __future__ import annotations

from operator import itemgetter

import numpy as np


def _positions(columns: tuple, col_pos: dict) -> np.ndarray:
    """The permutation position of each column object of `columns`: one
    dict lookup for each distinct object, found by its `id` (the objects
    stay alive in the copies, so their ids are distinct)."""
    ids = np.fromiter(map(id, columns), np.uint64, len(columns))
    _, first, inverse = np.unique(ids, return_index=True, return_inverse=True)
    table = np.array([col_pos[columns[i]] for i in first], np.int64)
    return table[inverse.reshape(-1)]


def copy_cells(assignment) -> tuple:
    """(a, b): the two cells (column position * n + row, int64) of each
    copy constraint, in the order the copies were made."""
    copies = assignment.copies
    m = len(copies)
    col_pos = {c: i for i, c in enumerate(assignment.cs.permutation_columns)}
    n = assignment.n
    cells = []
    for col, row in ((0, 1), (2, 3)):
        pos = _positions(tuple(map(itemgetter(col), copies)), col_pos)
        rows = np.fromiter(map(itemgetter(row), copies), np.int64, m)
        if m and not (0 <= rows.min() and rows.max() < n):
            raise ValueError(f"a copy names a row outside [0, {n})")
        cells.append(pos * n + rows)
    return cells[0], cells[1]


def next_in_cycle(a: np.ndarray, b: np.ndarray) -> tuple:
    """(touched cells ascending, the next cell of each in its cycle) for
    the copies a[i] ~ b[i]: cycles in ascending cell order, the last member
    pointing at the first, a cell alone in its cycle at itself."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    cells, index = np.unique(np.concatenate([a, b]), return_inverse=True)
    t, m = cells.shape[0], a.shape[0]
    if t == 0:
        return cells, cells
    index = index.reshape(-1)
    graph = coo_matrix((np.ones(m, np.int8), (index[:m], index[m:])), shape=(t, t)).tocsr()
    _, labels = connected_components(graph, directed=False)
    order = np.argsort(labels, kind="stable")  # by cycle, each in ascending cell order
    lab = labels[order]
    start = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])  # each cycle's first slot
    size = np.diff(np.r_[start, t])
    first = np.repeat(start, size)
    last = np.repeat(start + size - 1, size)
    slot = np.arange(t)
    nxt = np.where(slot == last, first, slot + 1)
    out = np.empty(t, np.int64)
    out[order] = cells[order[nxt]]
    return cells, out


def permutation_arrays(assignment) -> tuple:
    """(cp, rp) equal to `assignment.build_permutation_arrays()`: int32
    column positions and int64 rows of each cell's successor in its cycle,
    shape (permutation columns, n)."""
    cols = len(assignment.cs.permutation_columns)
    n = assignment.n
    cp = np.tile(np.arange(cols, dtype=np.int32)[:, None], (1, n))
    rp = np.tile(np.arange(n, dtype=np.int64)[None, :], (cols, 1))
    cells, nxt = next_in_cycle(*copy_cells(assignment))
    cp.reshape(-1)[cells] = (nxt // n).astype(np.int32)
    rp.reshape(-1)[cells] = nxt % n
    return cp, rp
