"""State carried over from the JAX package into the port.

This is the one place that takes the JAX package's objects, and it takes
them by attribute: nothing of that package (and nothing of jax) is
imported here.  Two kinds of state cross over:

* host objects (`Params`, `VerifyingKey`, `ProvingKey`, `Assignment`, and
  the constraint system they hold): `params_from_reference`,
  `keys_from_reference`, `constraint_system_from_reference` and
  `assignment_from_reference` rebuild each as the
  port's own class of the same name, from its numpy arrays, ints and
  nested objects, so both packages compute on the same SRS, keys and
  witness;
* limb arrays: the JAX `VerifierBatch` (numpy or jax array leaves), point
  and scalar arrays, the quotient engine's coefficient columns, the NTT
  plan's twiddle tables and the resident SRS of `Params._device_points`,
  from `(..., 32)` 8-bit limbs to the port's `(..., 8)` 32-bit limbs.
  Montgomery form is the same (R = 2^256), so this is repacking (and, for
  the quotient columns, the bit-reversal permutation) only.
"""

from __future__ import annotations

import enum
import importlib

import numpy as np
import torch

from .device import resolve_device
from .ops.curve_ops import AffinePoint, JacPoint
from .ops.limbs import jax_to_port
from .ops.ntt import bit_reverse_indices
from .plonk.protocol import LookupEvals, PermutationSetEvals
from .plonk.verifier_device import VerifierBatch


_REFERENCE = "halo2_aggregation_tpu"


def _rehome(obj, memo):
    """`obj` with every instance of a class of the JAX package replaced by
    an instance of the port's class of the same module path and name,
    attributes converted in turn.  Containers are rebuilt (dict and set
    keys re-hash under the new classes); arrays, numbers, strings and
    bytes pass as they are.  `memo` keeps shared objects shared."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes, np.ndarray, np.generic)):
        return obj
    if id(obj) in memo:
        return memo[id(obj)]
    cls = type(obj)
    mod = cls.__module__
    ours = None
    if mod == _REFERENCE or mod.startswith(_REFERENCE + "."):
        target = importlib.import_module(__package__ + mod[len(_REFERENCE):])
        ours = getattr(target, cls.__qualname__)
    if isinstance(obj, enum.Enum):
        return ours[obj.name] if ours is not None else obj
    if isinstance(obj, list):
        out = memo[id(obj)] = []
        out.extend(_rehome(v, memo) for v in obj)
        return out
    if isinstance(obj, tuple):
        items = [_rehome(v, memo) for v in obj]
        if ours is not None:
            return ours(*items)  # a NamedTuple of the package
        return tuple(items) if cls is tuple else cls(*items)
    if isinstance(obj, dict):
        out = memo[id(obj)] = cls() if cls is not dict else {}
        for key, v in obj.items():
            out[_rehome(key, memo)] = _rehome(v, memo)
        return out
    if isinstance(obj, (set, frozenset)):
        return cls(_rehome(v, memo) for v in obj)
    if ours is None:
        raise TypeError(f"cannot carry over a {mod}.{cls.__qualname__}")
    out = memo[id(obj)] = ours.__new__(ours)
    for name, v in vars(obj).items():
        object.__setattr__(out, name, _rehome(v, memo))
    return out


def params_from_reference(params):
    """A JAX-package `kzg.Params` -> the port's `Params` over the same SRS
    arrays (not copied) and G2 points."""
    from .plonk.kzg import Params

    return Params(params.k, params.g_lagrange_u64, params.g_lagrange_inf, params.g2, params.s_g2)


def keys_from_reference(key):
    """A JAX-package `VerifyingKey` or `ProvingKey` (its vk, constraint
    system and columns included) -> the port's."""
    return _rehome(key, {})


def constraint_system_from_reference(cs):
    """A JAX-package `ConstraintSystem` (columns, gates, lookups, queries,
    permutation) -> the port's."""
    return _rehome(cs, {})


def assignment_from_reference(assignment):
    """A JAX-package `Assignment` (with its constraint system) -> the
    port's.  Convert keys and assignment that share a constraint system
    separately: each gets its own equal copy."""
    return _rehome(assignment, {})


def scalars_from_jax(arr, device) -> torch.Tensor:
    """JAX `(..., 32)` limb array -> port `(..., 8)` tensor (same values)."""
    return torch.from_numpy(jax_to_port(np.asarray(arr))).to(resolve_device(device))


def points_from_jax(p, device) -> JacPoint:
    """JAX `JacPoint` (x, y, z of (..., 32)) -> port JacPoint."""
    return JacPoint(*(scalars_from_jax(c, device) for c in (p.x, p.y, p.z)))


def srs_from_jax(points, device="cpu") -> AffinePoint:
    """The JAX package's resident SRS, `kzg.Params._device_points` (an
    `AffinePoint` of (n, 32) Montgomery 8-bit limbs and (n,) infinity
    flags, `plonk/kzg.py:139-150`) -> the port's `DeviceSRS.points` (the
    same values as (n, 8) limbs)."""
    device = resolve_device(device)
    inf = torch.from_numpy(np.asarray(points.inf).astype(bool)).to(device)
    return AffinePoint(scalars_from_jax(points.x, device), scalars_from_jax(points.y, device), inf)


def from_jax_batch(jb, device) -> VerifierBatch:
    """JAX `verifier_tpu.VerifierBatch` -> the port's VerifierBatch."""

    def S(a):
        return None if a is None else scalars_from_jax(a, device)

    def P(p):
        return points_from_jax(p, device)

    return VerifierBatch(
        theta=S(jb.theta),
        beta=S(jb.beta),
        gamma=S(jb.gamma),
        y=S(jb.y),
        x=S(jb.x),
        v=S(jb.v),
        u=S(jb.u),
        inst_evals=[S(a) for a in jb.inst_evals],
        adv_evals=[S(a) for a in jb.adv_evals],
        fix_evals=[S(a) for a in jb.fix_evals],
        r_eval=S(jb.r_eval),
        sigma_evals=[S(a) for a in jb.sigma_evals],
        perm_sets=[
            PermutationSetEvals(z=S(ps.z), z_next=S(ps.z_next), z_last=S(ps.z_last))
            for ps in jb.perm_sets
        ],
        lookup_evs=[
            LookupEvals(
                z=S(lv.z),
                z_next=S(lv.z_next),
                a_prime=S(lv.a_prime),
                a_prime_prev=S(lv.a_prime_prev),
                s_prime=S(lv.s_prime),
            )
            for lv in jb.lookup_evs
        ],
        inst_comms=[P(p) for p in jb.inst_comms],
        adv_comms=[P(p) for p in jb.adv_comms],
        lookups_permuted=[(P(a), P(s)) for a, s in jb.lookups_permuted],
        perm_z_comms=[P(p) for p in jb.perm_z_comms],
        lookup_z_comms=[P(p) for p in jb.lookup_z_comms],
        r_comm=P(jb.r_comm),
        h_comms=[P(p) for p in jb.h_comms],
        w_comms=[P(p) for p in jb.w_comms],
    )


def quotient_columns_from_jax(dq_jax) -> torch.Tensor:
    """The JAX `DeviceQuotient`'s CPU-path `store` (packed (n, 32) u8
    natural-order Montgomery coefficient columns,
    `quotient_device.py:408,446-448`) -> the port's resident (C, n, 8)
    stack: the same columns in `key_order`, coefficients bit-reversed
    (`DeviceQuotient.finalize_coefficients` takes it)."""
    cols = [np.asarray(dq_jax.store[key], dtype=np.uint8) for key in dq_jax.key_order]
    stack = np.ascontiguousarray(np.stack(cols)).view("<i4").reshape(len(cols), dq_jax.n, 8)
    return torch.from_numpy(np.ascontiguousarray(stack[:, bit_reverse_indices(dq_jax.k)]))


def twiddles_from_jax(plan, device="cpu") -> torch.Tensor:
    """JAX `ops/ntt.py::NttPlan.stage_twiddles` ((2^s, 32) 8-bit limbs per
    stage s) -> the port's one natural-order table of root powers,
    (n/2, 8) (`ops/ntt.py::NttTables`).  The last stage's table is that
    table; every other stage's must be its stride-2^(k-1-s) slice, and a
    plan whose tables disagree raises."""
    stages = [jax_to_port(np.asarray(t)) for t in plan.stage_twiddles]
    table = stages[-1]
    k = len(stages)
    for s, t in enumerate(stages):
        if not np.array_equal(t, table[:: 1 << (k - 1 - s)]):
            raise ValueError(f"stage {s} table is not a slice of the last stage's")
    return torch.from_numpy(np.ascontiguousarray(table)).to(resolve_device(device))
