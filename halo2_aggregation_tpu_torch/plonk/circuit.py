"""Constraint system: columns, expression AST, gates, lookups, permutation.

The TPU-first re-design of what the reference gets from its halo2 fork's
`ConstraintSystem`/`Expression` (`reference/src/verifier.rs:14-18`,
§2b).  Differences from halo2 that are deliberate:

* Gates are *data*: expressions over query indices, evaluated either
  columnwise over whole domains (prover/MockProver — vectorized on TPU) or
  pointwise on scalars (verifier).  This matches the reference's
  `compute_expr` walk (`reference/src/verifier.rs:58-151`), which
  indexes `advice_evals[query_index]` — our ASTs carry the same indices.
* No virtual selectors: `selector()` just allocates a fixed column (the
  reference panics on `Expression::Selector` because halo2 lowers them to
  fixed columns before verification — we start lowered).
* Assignment is columnar: a circuit fills columns/selectors/copies through
  an `Assignment`, no region/floor-planner indirection.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from ..fields import R


class Any(enum.Enum):
    ADVICE = "advice"
    FIXED = "fixed"
    INSTANCE = "instance"


@dataclass(frozen=True)
class Column:
    kind: Any
    index: int


@dataclass(frozen=True)
class Rotation:
    value: int

    @staticmethod
    def cur():
        return Rotation(0)

    @staticmethod
    def next():
        return Rotation(1)

    @staticmethod
    def prev():
        return Rotation(-1)


# ---------------------------------------------------------------------------
# Expression AST
# ---------------------------------------------------------------------------


class Expression:
    """Base class; combinators build the tree used by gates/lookups."""

    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_lift(other)))

    def __mul__(self, other):
        other = _lift(other)
        if isinstance(other, Constant):
            return Scaled(self, other.value)
        return Product(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Negated(self)

    def degree(self) -> int:
        raise NotImplementedError

    def fold(self, handlers):
        """Generic recursion: handlers is a dict of node-type -> fn."""
        raise NotImplementedError


def _lift(v) -> "Expression":
    if isinstance(v, Expression):
        return v
    return Constant(int(v) % R)


@dataclass
class Constant(Expression):
    value: int

    def degree(self):
        return 0


@dataclass
class FixedQuery(Expression):
    query_index: int
    column_index: int
    rotation: Rotation

    def degree(self):
        return 1


@dataclass
class AdviceQuery(Expression):
    query_index: int
    column_index: int
    rotation: Rotation

    def degree(self):
        return 1


@dataclass
class InstanceQuery(Expression):
    query_index: int
    column_index: int
    rotation: Rotation

    def degree(self):
        return 1


@dataclass
class Negated(Expression):
    expr: Expression

    def degree(self):
        return self.expr.degree()


@dataclass
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())


@dataclass
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()


@dataclass
class Scaled(Expression):
    expr: Expression
    scalar: int

    def degree(self):
        return self.expr.degree()


def evaluate_expr(
    expr: Expression,
    constant: Callable,
    fixed: Callable,
    advice: Callable,
    instance: Callable,
    add: Callable,
    mul: Callable,
    negate: Callable,
    scale: Callable,
):
    """Generic evaluator — the one verifier/prover/mock all share (the
    analog of the reference's recursive `compute_expr`)."""

    def go(e):
        if isinstance(e, Constant):
            return constant(e.value)
        if isinstance(e, FixedQuery):
            return fixed(e.query_index)
        if isinstance(e, AdviceQuery):
            return advice(e.query_index)
        if isinstance(e, InstanceQuery):
            return instance(e.query_index)
        if isinstance(e, Negated):
            return negate(go(e.expr))
        if isinstance(e, Sum):
            return add(go(e.a), go(e.b))
        if isinstance(e, Product):
            return mul(go(e.a), go(e.b))
        if isinstance(e, Scaled):
            return scale(go(e.expr), e.scalar)
        raise TypeError(f"unknown expression node {e!r}")

    return go(expr)


# ---------------------------------------------------------------------------
# Selectors / table columns
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Selector:
    """A fixed column used as an on/off gate switch (pre-lowered)."""

    column: Column


@dataclass(frozen=True)
class TableColumn:
    """A fixed column holding a lookup table."""

    column: Column


@dataclass
class LookupArgument:
    input_expressions: List[Expression]
    table_expressions: List[Expression]

    def required_degree(self) -> int:
        in_deg = max((e.degree() for e in self.input_expressions), default=1)
        tb_deg = max((e.degree() for e in self.table_expressions), default=1)
        # active(1) * Z(1) * (compressed_input) * (compressed_table)
        return max(4, 2 + in_deg + tb_deg, 3)


# ---------------------------------------------------------------------------
# ConstraintSystem
# ---------------------------------------------------------------------------


class ConstraintSystem:
    def __init__(self):
        self.num_advice_columns = 0
        self.num_fixed_columns = 0
        self.num_instance_columns = 0
        self.gates: List[Tuple[str, Expression]] = []
        self.lookups: List[LookupArgument] = []
        # (column, rotation) query lists, deduped, per kind
        self.advice_queries: List[Tuple[Column, Rotation]] = []
        self.fixed_queries: List[Tuple[Column, Rotation]] = []
        self.instance_queries: List[Tuple[Column, Rotation]] = []
        # columns participating in the copy-constraint argument, in order
        self.permutation_columns: List[Column] = []
        self.constants: List[Column] = []  # fixed columns for constants

    # -- column allocation --------------------------------------------------
    def advice_column(self) -> Column:
        c = Column(Any.ADVICE, self.num_advice_columns)
        self.num_advice_columns += 1
        return c

    def fixed_column(self) -> Column:
        c = Column(Any.FIXED, self.num_fixed_columns)
        self.num_fixed_columns += 1
        return c

    def instance_column(self) -> Column:
        c = Column(Any.INSTANCE, self.num_instance_columns)
        self.num_instance_columns += 1
        return c

    def selector(self) -> Selector:
        return Selector(self.fixed_column())

    def complex_selector(self) -> Selector:
        return Selector(self.fixed_column())

    def lookup_table_column(self) -> TableColumn:
        return TableColumn(self.fixed_column())

    def enable_equality(self, column: Column):
        if column not in self.permutation_columns:
            self.permutation_columns.append(column)
            # every permutation column needs a cur-rotation query so its
            # eval is available to the permutation expressions
            # (cf. reference/src/permutation.rs:277-299)
            self.query_any(column, Rotation.cur())

    def enable_constant(self, column: Column):
        assert column.kind == Any.FIXED
        if column not in self.constants:
            self.constants.append(column)
        self.enable_equality(column)

    # -- queries ------------------------------------------------------------
    def _query(self, queries, column, rotation, cls):
        for i, (c, r) in enumerate(queries):
            if c == column and r == rotation:
                return cls(i, column.index, rotation)
        queries.append((column, rotation))
        return cls(len(queries) - 1, column.index, rotation)

    def query_advice(self, column: Column, rotation: Rotation) -> Expression:
        assert column.kind == Any.ADVICE
        return self._query(self.advice_queries, column, rotation, AdviceQuery)

    def query_fixed(self, column: Column, rotation: Rotation) -> Expression:
        assert column.kind == Any.FIXED
        return self._query(self.fixed_queries, column, rotation, FixedQuery)

    def query_instance(self, column: Column, rotation: Rotation) -> Expression:
        assert column.kind == Any.INSTANCE
        return self._query(self.instance_queries, column, rotation, InstanceQuery)

    def query_any(self, column: Column, rotation: Rotation) -> Expression:
        return {
            Any.ADVICE: self.query_advice,
            Any.FIXED: self.query_fixed,
            Any.INSTANCE: self.query_instance,
        }[column.kind](column, rotation)

    def query_selector(self, s: Selector) -> Expression:
        return self.query_fixed(s.column, Rotation.cur())

    # -- gates / lookups ----------------------------------------------------
    def create_gate(self, name: str, make: Callable[["ConstraintSystem"], list]):
        exprs = make(self)
        for e in exprs:
            self.gates.append((name, e))

    def lookup(self, make: Callable[["ConstraintSystem"], list]):
        pairs = make(self)
        inputs = [p[0] for p in pairs]
        tables = []
        for p in pairs:
            t = p[1]
            if isinstance(t, TableColumn):
                t = self.query_fixed(t.column, Rotation.cur())
            tables.append(t)
        self.lookups.append(LookupArgument(inputs, tables))

    # -- derived quantities (mirror the fork's accessors, §2b) --------------
    def degree(self) -> int:
        d = 3  # permutation argument minimum
        for _, e in self.gates:
            d = max(d, e.degree())
        for lk in self.lookups:
            d = max(d, lk.required_degree())
        # chunked permutation: active(1) * Z(1) * chunk_len terms, and
        # chunk_len = degree - 2 keeps it exactly at `degree`
        return d

    def blinding_factors(self) -> int:
        """Number of blinded rows at the tail of each advice column
        (mirrors halo2's formula: enough for the max number of openings of
        any advice column, plus h/r correlations)."""
        per_col = {}
        for c, _ in self.advice_queries:
            per_col[c.index] = per_col.get(c.index, 0) + 1
        factors = max(per_col.values(), default=1)
        factors = max(3, factors)
        return factors + 2

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)

    def quotient_poly_degree(self) -> int:
        return self.degree() - 1


# ---------------------------------------------------------------------------
# Assignment: columnar witness/fixed storage
# ---------------------------------------------------------------------------


class TableAssignment:
    """Lookup-table filling helper (reference analog: `layouter.assign_table`,
    `reference/examples/simple-example.rs:353-361`)."""

    def __init__(self, assignment: "Assignment"):
        self.assignment = assignment
        self.used_rows = {}

    def assign_cell(self, table: TableColumn, row: int, value: int):
        self.assignment.assign_fixed(table.column, row, value)
        self.used_rows.setdefault(table.column.index, set()).add(row)


class Assignment:
    """Columnar circuit assignment: all values are Python ints mod r.

    `None` advice values = keygen mode (shape only), the analog of the
    reference's `transcript: None` duality (SURVEY.md §1)."""

    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.advice = [[None] * n for _ in range(cs.num_advice_columns)]
        self.fixed = [[0] * n for _ in range(cs.num_fixed_columns)]
        self.instance = [[0] * n for _ in range(cs.num_instance_columns)]
        self.copies: List[Tuple[Column, int, Column, int]] = []
        # rows used by lookup tables, per fixed column index
        self.table_rows = {}

    def assign_advice(self, column: Column, row: int, value: Optional[int]):
        assert column.kind == Any.ADVICE and row < self.n
        self.advice[column.index][row] = None if value is None else int(value) % R

    def assign_fixed(self, column: Column, row: int, value: int):
        assert column.kind == Any.FIXED and row < self.n
        self.fixed[column.index][row] = int(value) % R

    def set_instance(self, column: Column, values):
        assert column.kind == Any.INSTANCE
        col = self.instance[column.index]
        for i, v in enumerate(values):
            col[i] = int(v) % R

    def enable_selector(self, s: Selector, row: int):
        self.assign_fixed(s.column, row, 1)

    def copy(self, c1: Column, r1: int, c2: Column, r2: int):
        assert c1 in self.cs.permutation_columns, f"{c1} lacks equality"
        assert c2 in self.cs.permutation_columns, f"{c2} lacks equality"
        self.copies.append((c1, r1, c2, r2))

    def table(self) -> TableAssignment:
        return TableAssignment(self)

    # -- permutation assembly ----------------------------------------------
    def build_permutation_arrays(self):
        """Sparse equivalent of build_permutation for large circuits: the
        union-find runs only over cells touched by copy constraints (the
        dense version allocates num_cols * n parents — prohibitive at
        k=23).  Returns (cp, rp) int arrays of shape (num_cols, n) with
        sigma[ci][row] = (cp[ci, row], rp[ci, row]); identity elsewhere.
        Produces exactly the same mapping as build_permutation (cycle
        members are walked in ascending cell order in both)."""
        import numpy as np

        cols = self.cs.permutation_columns
        col_pos = {c: i for i, c in enumerate(cols)}
        n = self.n
        parent = {}

        def find(x):
            path = []
            while parent.get(x, x) != x:
                path.append(x)
                x = parent[x]
            for p in path:
                parent[p] = x
            return x

        touched = set()
        for c1, r1, c2, r2 in self.copies:
            a = col_pos[c1] * n + r1
            b = col_pos[c2] * n + r2
            touched.add(a)
            touched.add(b)
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        groups = {}
        for cell in sorted(touched):
            groups.setdefault(find(cell), []).append(cell)
        cp = np.tile(
            np.arange(len(cols), dtype=np.int32)[:, None], (1, n)
        )
        rp = np.tile(np.arange(n, dtype=np.int64)[None, :], (len(cols), 1))
        for members in groups.values():
            if len(members) < 2:
                continue
            for i, cell in enumerate(members):
                nxt = members[(i + 1) % len(members)]
                cp[cell // n, cell % n] = nxt // n
                rp[cell // n, cell % n] = nxt % n
        return cp, rp

    def build_permutation(self) -> List[List[Tuple[int, int]]]:
        """Union copy constraints into cycles; return sigma as, for each
        permutation column, a list mapping row -> (col_position, row) of the
        *next* cell in its cycle (identity where unconstrained)."""
        cols = self.cs.permutation_columns
        col_pos = {c: i for i, c in enumerate(cols)}
        n = self.n
        # cell id = col_position * n + row
        parent = list(range(len(cols) * n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for c1, r1, c2, r2 in self.copies:
            union(col_pos[c1] * n + r1, col_pos[c2] * n + r2)

        # gather cycles
        groups = {}
        for cell in range(len(cols) * n):
            groups.setdefault(find(cell), []).append(cell)
        sigma = [[(ci, row) for row in range(n)] for ci in range(len(cols))]
        for members in groups.values():
            if len(members) < 2:
                continue
            for i, cell in enumerate(members):
                nxt = members[(i + 1) % len(members)]
                sigma[cell // n][cell % n] = (nxt // n, nxt % n)
        return sigma
