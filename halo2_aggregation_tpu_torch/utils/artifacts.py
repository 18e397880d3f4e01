"""Proof-artifact containers: vk + proof persistence WITHOUT pickle.

The level-1/level-2 recursion artifacts (docs/artifacts/) carry a
VerifyingKey between processes — Phase D saves it, the recursion tools
reload it to verify real outer proofs inside a second-level circuit.
Round 4 pickled the vk, at odds with the repo's no-pickle posture
(README security notes; the SRS cache is npz for the same reason,
plonk/kzg.py:15).  This module stores a vk as a pure-numeric `.npz`:

  * the CONSTRAINT SYSTEM is not serialized at all — the aggregation
    circuit's structure is a deterministic function of the code
    (`models.aggregation_circuit.configure`), so the loader rebuilds it
    and the pinned Blake2b vk hash (keygen.py:pinned) PROVES the rebuilt
    cs matches the one the proof was made under;
  * commitments are (m, 2, 4)-uint64 limb arrays + a None mask;
  * `allow_pickle=False` on load, like the SRS cache.

Reference analog: the fork's VerifyingKey is `Serialize`-derived Rust
(SURVEY.md §2b); this is the TPU framework's typed container.
"""

from __future__ import annotations

import numpy as np

from .u64 import ints_to_u64, u64_to_ints


def _points_to_arrays(points):
    """List of ((x, y) | None) -> ((m, 2, 4) u64, (m,) bool mask)."""
    m = len(points)
    arr = np.zeros((m, 2, 4), np.uint64)
    mask = np.zeros(m, bool)
    for i, p in enumerate(points):
        if p is None:
            continue
        mask[i] = True
        arr[i, 0] = ints_to_u64([p[0]])[0]
        arr[i, 1] = ints_to_u64([p[1]])[0]
    return arr, mask


def _arrays_to_points(arr, mask):
    out = []
    for i in range(arr.shape[0]):
        if not mask[i]:
            out.append(None)
            continue
        x = u64_to_ints(arr[i, 0:1])[0]
        y = u64_to_ints(arr[i, 1:2])[0]
        out.append((x, y))
    return out


def save_vk_npz(path: str, vk) -> None:
    """Persist an aggregation-circuit VerifyingKey as numerics + the
    pinned hash that pins the (rebuilt-at-load) constraint system."""
    fixed, fixed_mask = _points_to_arrays(vk.fixed_commitments)
    sigma, sigma_mask = _points_to_arrays(vk.sigma_commitments)
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        k=np.asarray([vk.k], np.int64),
        hash_scalar=ints_to_u64([vk.hash_scalar()]),
        fixed=fixed,
        fixed_mask=fixed_mask,
        sigma=sigma,
        sigma_mask=sigma_mask,
    )


def load_vk_npz(path: str):
    """Rebuild the VerifyingKey: numeric fields from the npz, the
    constraint system from `aggregation_circuit.configure` (deterministic
    code), cross-checked by the pinned Blake2b hash."""
    from ..models import aggregation_circuit as ac
    from ..plonk.circuit import ConstraintSystem
    from ..plonk.keygen import VerifyingKey

    with np.load(path, allow_pickle=False) as d:
        k = int(d["k"][0])
        want_hash = u64_to_ints(d["hash_scalar"])[0]
        fixed = _arrays_to_points(d["fixed"], d["fixed_mask"])
        sigma = _arrays_to_points(d["sigma"], d["sigma_mask"])
    cs = ConstraintSystem()
    ac.configure(cs)
    vk = VerifyingKey(k=k, cs=cs, fixed_commitments=fixed,
                      sigma_commitments=sigma)
    got = vk.hash_scalar()
    if got != want_hash:
        raise ValueError(
            f"vk hash mismatch after cs rebuild: {path} was produced by a "
            "different circuit structure than the current code configures"
        )
    return vk


def load_vk(stem: str):
    """Load `<stem>.vk.npz` (every checked-in artifact was migrated off
    the round-4 pickle container in round 5)."""
    return load_vk_npz(f"{stem}.vk.npz")
