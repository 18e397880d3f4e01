"""`plonk/permutation.py::permutation_arrays` (numpy and scipy) against the
pinned `Assignment.build_permutation_arrays` (a Python union-find, held to
the JAX package's by tests/test_torch_host_copies.py): equal arrays, equal
dtypes, on the edge cases of the copy constraints, on seeded random copies,
on the simple example's assignment at k = 9 and on the outer circuit's
assignment at N = 1 (k = 21, 2.9 M copies, ~45 s of synthesis).  On the
small cases the dense `build_permutation` gives the same cycles too."""

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu_torch.config import H2AConfig
from halo2_aggregation_tpu_torch.models import simple_example as se
from halo2_aggregation_tpu_torch.plonk.circuit import Assignment, ConstraintSystem
from halo2_aggregation_tpu_torch.plonk.permutation import permutation_arrays
from halo2_aggregation_tpu_torch.tools import outer_prove

torch.set_num_threads(1)  # the test workers share the cores

N = 8


def small_assignment(n: int = N):
    """An assignment of `n` rows over four permutation columns: two
    advice, one fixed, one instance (positions 0-3)."""
    cs = ConstraintSystem()
    cols = [cs.advice_column(), cs.advice_column(), cs.fixed_column(), cs.instance_column()]
    for c in cols:
        cs.enable_equality(c)
    return Assignment(cs, n), cols


#: each case: copies as (column position, row, column position, row)
EDGE_CASES = {
    "no_copies": [],
    "cell_to_itself": [(0, 3, 0, 3)],
    "cell_to_itself_and_a_pair": [(1, 2, 1, 2), (0, 4, 2, 4), (2, 4, 2, 4)],
    "repeated_copies": [(0, 1, 1, 2)] * 3 + [(1, 2, 0, 1)],
    "cycle_over_every_column": [(0, 0, 1, 5), (1, 5, 2, 2), (2, 2, 3, 7), (3, 7, 0, 6)],
    "rows_0_and_n_minus_1": [(0, 0, 1, N - 1), (2, N - 1, 0, 0), (3, 0, 3, N - 1)],
    "two_cycles_merged_by_a_late_copy": [(0, 1, 0, 2), (1, 3, 1, 4), (2, 5, 3, 6), (0, 2, 3, 6)],
    "chain_given_in_descending_order": [(3, 7, 3, 6), (3, 6, 2, 5), (2, 5, 1, 4), (1, 4, 0, 3)],
    "every_cell_one_cycle": [(c, r, (c + (r + 1) // N) % 4, (r + 1) % N) for c in range(4) for r in range(N)],
}


def copied(case):
    asg, cols = small_assignment()
    for c1, r1, c2, r2 in case:
        asg.copy(cols[c1], r1, cols[c2], r2)
    return asg


def assert_equal_to_pinned(asg):
    cp, rp = permutation_arrays(asg)
    want_cp, want_rp = asg.build_permutation_arrays()
    assert cp.dtype == want_cp.dtype == np.int32 and rp.dtype == want_rp.dtype == np.int64
    assert cp.shape == want_cp.shape == rp.shape == (len(asg.cs.permutation_columns), asg.n)
    assert np.array_equal(cp, want_cp) and np.array_equal(rp, want_rp)
    return cp, rp


def assert_a_permutation(cp, rp):
    """Every cell is the successor of exactly one cell."""
    n = cp.shape[1]
    targets = cp.astype(np.int64) * n + rp
    assert np.array_equal(np.sort(targets.reshape(-1)), np.arange(cp.size))


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_cases_equal_the_pinned_method(name):
    asg = copied(EDGE_CASES[name])
    cp, rp = assert_equal_to_pinned(asg)
    assert_a_permutation(cp, rp)
    dense = asg.build_permutation()
    assert [[(int(cp[c, r]), int(rp[c, r])) for r in range(N)] for c in range(4)] == dense


def test_no_copies_is_the_identity():
    cp, rp = permutation_arrays(copied([]))
    assert np.array_equal(cp, np.repeat(np.arange(4, dtype=np.int32)[:, None], N, 1))
    assert np.array_equal(rp, np.tile(np.arange(N), (4, 1)))


def test_cycle_walks_cells_in_ascending_order():
    """Column position * n + row is the cell's order: (0, 6) -> (1, 5) ->
    (2, 2) -> (3, 7) -> back to (0, 6), whichever order the copies came in."""
    cp, rp = permutation_arrays(copied(EDGE_CASES["cycle_over_every_column"]))
    cycle = [(0, 0), (0, 6), (1, 5), (2, 2), (3, 7)]
    for here, there in zip(cycle, cycle[1:] + cycle[:1]):
        assert (cp[here], rp[here]) == there


def test_a_row_outside_the_assignment_raises():
    asg, cols = small_assignment()
    asg.copy(cols[0], 1, cols[1], N)
    with pytest.raises(ValueError, match="outside"):
        permutation_arrays(asg)


@pytest.mark.parametrize("seed", range(6))
def test_random_copies_equal_the_pinned_method(seed):
    """Seeded copies at n = 64: few (mostly pairs), many (a few large
    cycles), and a mix with cells copied to themselves."""
    rng = np.random.default_rng(seed)
    asg, cols = small_assignment(64)
    m = [5, 40, 300][seed % 3]
    for _ in range(m):
        c1, c2 = rng.integers(0, 4, 2)
        r1 = int(rng.integers(0, 64))
        r2 = r1 if rng.random() < 0.1 else int(rng.integers(0, 64))
        asg.copy(cols[c1], r1, cols[c2], r2)
    cp, rp = assert_equal_to_pinned(asg)
    assert_a_permutation(cp, rp)
    assert [[(int(cp[c, r]), int(rp[c, r])) for r in range(64)] for c in range(4)] == asg.build_permutation()


@pytest.mark.parametrize("witness", [True, False])
def test_simple_example_k9(witness):
    """The inner circuit at k = 9, with its witness and blank (keygen's)."""
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    _, _, asg = se.build(circuit if witness else circuit.without_witnesses(), k=9)
    assert len(asg.copies) > 0
    assert_a_permutation(*assert_equal_to_pinned(asg))


def test_outer_circuit_n1_k21():
    """The outer circuit's assignment at N = 1 (phases A-C of
    `tools/outer_prove.py`): 1,265,640 rows, 2,942,317 copies."""
    cfg = H2AConfig(k_inner=9, k_outer=21, num_proofs=1, constrained_fs=True)
    inner = outer_prove.inner_proofs(cfg)
    outer, pis = outer_prove.outer_circuit(cfg, inner)
    _, asg, rows, _, _ = outer_prove.synthesize(cfg, outer, pis, inner["efws"])
    assert rows == 1265640 and len(asg.copies) == 2942317
    assert_a_permutation(*assert_equal_to_pinned(asg))
