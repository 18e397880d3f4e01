"""Key generation: VerifyingKey / ProvingKey.

Fork-API parity (SURVEY.md §2b): `keygen_vk`, `keygen_pk`, plus the
VerifyingKey accessors the reference verifier consumes
(`reference/src/verifier.rs:233-259`): cs(), gates(),
permutation_columns(), fixed_commitments(), *_queries(), omega,
quotient_poly_degree, sigma commitments, and the pinned-vk transcript hash
(`reference/src/verifier.rs:341-358`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

from ..fields import FR_DELTA, R, fr_omega
from ..utils.serialization import g1_compress
from ..utils.transcript import challenge_from_wide
from .circuit import Assignment, ConstraintSystem
from .kzg import Params

VK_HASH_PERSONALIZATION = b"Halo2-Verify-Key"


@dataclass(frozen=True)
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: List  # per fixed column, affine int pairs or None
    sigma_commitments: List  # per permutation column

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def omega(self) -> int:
        return fr_omega(self.k)

    def pinned(self) -> str:
        """Canonical description string covered by the transcript hash —
        our analog of halo2's `format!("{:?}", vk.pinned())`."""
        cs = self.cs
        parts = [
            f"k={self.k}",
            f"adv={cs.num_advice_columns}",
            f"fix={cs.num_fixed_columns}",
            f"inst={cs.num_instance_columns}",
            f"gates={[repr(e) for _, e in cs.gates]}",
            f"aq={cs.advice_queries}",
            f"fq={cs.fixed_queries}",
            f"iq={cs.instance_queries}",
            f"lookups={cs.lookups}",
            f"perm={cs.permutation_columns}",
            f"fixed_comms={[g1_compress(c).hex() for c in self.fixed_commitments]}",
            f"sigma_comms={[g1_compress(c).hex() for c in self.sigma_commitments]}",
        ]
        return ";".join(parts)

    def hash_scalar(self) -> int:
        """Blake2b-512 over the length-prefixed pinned string, mapped to Fr
        (the reference's vk->transcript hash, verifier.rs:341-358).
        Cached: the vk is immutable after keygen and every transcript
        replay (64/batch in the aggregation pipeline) starts here."""
        cached = getattr(self, "_hash_scalar_cache", None)
        if cached is not None:
            return cached
        h = hashlib.blake2b(digest_size=64, person=VK_HASH_PERSONALIZATION)
        s = self.pinned().encode()
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        v = challenge_from_wide(h.digest())
        object.__setattr__(self, "_hash_scalar_cache", v)
        return v


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_columns: List[List[int]]  # Lagrange values per fixed column
    sigma_columns: List[List[int]]  # sigma poly Lagrange values per perm col
    permutation: List[List[tuple]]  # raw sigma mapping (colpos,row) per col


def sigma_values(cs: ConstraintSystem, assignment: Assignment, k: int):
    """Sigma polynomial Lagrange values: sigma_c[row] = delta^{c'} w^{row'}
    for the cycle-successor cell (c', row') — the permutation argument's
    coset labeling (cf. reference/src/permutation.rs:252-309)."""
    n = 1 << k
    omega = fr_omega(k)
    mapping = assignment.build_permutation()
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % R
    deltas = [1]
    for _ in range(len(cs.permutation_columns) - 1):
        deltas.append(deltas[-1] * FR_DELTA % R)
    out = []
    for ci in range(len(cs.permutation_columns)):
        col = [
            deltas[cp] * omega_pows[rp] % R for (cp, rp) in mapping[ci]
        ]
        out.append(col)
    return out, mapping


def keygen(params: Params, cs: ConstraintSystem, assignment: Assignment):
    """Build (vk, pk) from a witness-free assignment (the reference's
    keygen path: synthesize with `transcript: None`, SURVEY.md §1)."""
    k = params.k
    assert assignment.n == params.n
    fixed_comms = [params.commit_lagrange(col) for col in assignment.fixed]
    sig_cols, mapping = sigma_values(cs, assignment, k)
    sigma_comms = [params.commit_lagrange(col) for col in sig_cols]
    vk = VerifyingKey(k, cs, fixed_comms, sigma_comms)
    pk = ProvingKey(vk, [list(c) for c in assignment.fixed], sig_cols, mapping)
    return vk, pk


def keygen_native(params: Params, cs: ConstraintSystem, assignment: Assignment):
    """Scaled keygen over the C++ engine: sparse union-find permutation
    assembly + vectorized sigma columns + native MSM commitments.  Produces
    the same (vk, pk) as keygen (tests pin equality); pk columns are
    (n, 4) uint64 arrays, which create_proof_native consumes directly."""
    import numpy as np

    from ..utils import native
    from . import engine

    if not engine.available():
        return keygen(params, cs, assignment)
    k = params.k
    n = 1 << k
    assert assignment.n == params.n
    fixed_plain = [engine.col_from_ints(col) for col in assignment.fixed]

    fixed_comms = [params.commit_lagrange(c) for c in fixed_plain]

    cp, rp = assignment.build_permutation_arrays()
    omega_pows_m = engine.pow_series(engine.mont_scalar(fr_omega(k)), n)
    deltas = [1]
    for _ in range(len(cs.permutation_columns) - 1):
        deltas.append(deltas[-1] * FR_DELTA % R)
    deltas_m = np.vstack([engine.mont_scalar(d) for d in deltas])
    sig_cols = []
    for ci in range(len(cs.permutation_columns)):
        col_m = native.fr_vec_binop(
            2, np.ascontiguousarray(deltas_m[cp[ci]]), 0,
            np.ascontiguousarray(omega_pows_m[rp[ci]]), 0, n,
        )
        sig_cols.append(engine.from_mont(col_m))
    sigma_comms = [params.commit_lagrange(c) for c in sig_cols]
    vk = VerifyingKey(k, cs, fixed_comms, sigma_comms)
    pk = ProvingKey(vk, fixed_plain, sig_cols, None)
    return vk, pk
