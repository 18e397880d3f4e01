"""Multi-proof verification sharded over a device mesh.

Counterpart of `halo2_aggregation_tpu/parallel/batch_verify.py`.  The
batched verifier is batch-polymorphic, so scaling to many devices is data
parallelism: every rank holds the whole `VerifierBatch` and the parsed
proofs (as a JAX caller holds global arrays), works on its `dp` slice of
the proofs and its `mp` share of their multiopen lanes, and the partial
sums meet in `all_gather`s over the mesh axes.  Every rank returns the
whole batch's result.

Two formulations of the production step, which check each other:

* `shmap_verify_algebra_fast`, the JAX default (`shard_map` with explicit
  collectives): each component's lanes split evenly over `mp`, the e-lane
  on every rank with its scalar zeroed off `mp` rank 0;
* `sharded_verify_algebra_fast`, the decomposition the JAX package's GSPMD
  variant leaves to the partitioner (PyTorch has none): the concatenated
  lane axis split contiguously over `mp`, so a shard may cross a component
  boundary, the segment offsets cut to each shard, the e-lane in the last.

Each rank runs K2 (`field_algebra_fused` with the e-lane's scalar) on its
proofs, one K1 over its lanes and one segmented sum into (w, zw, f, e)
partials; the gathered `mp` partials are added by one more segmented sum
(the JAX package's `jac_sum` over them; on the card its plain version took
43-63 ms at mp = 2, twenty times the rank's device stage).  B must divide
by dp, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..ops.curve_ops import JacPoint
from ..ops.ec_kernels import jac_segment_sum, scalar_mul
from ..plonk.fa_fused import field_algebra_fused
from ..plonk.verifier_device import VerifierBatch, fast_prep, field_algebra, segment_offsets, with_e_lane
from .mesh import axis, gather

PARTIALS = ("w", "zw", "f", "e")  # the segments of one proof's lanes, in order


def _map_leaves(fn, x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, JacPoint):
        return JacPoint(*(fn(c) for c in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(fn, v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _map_leaves(fn, getattr(x, f.name)) for f in dataclasses.fields(x)})
    raise TypeError(f"unexpected leaf {type(x).__name__}")


def _proof_slice(mesh, B: int, name: str = "dp") -> tuple:
    size, idx, group = axis(mesh, name)
    if B % size:
        raise ValueError(f"proof batch {B} must divide over {name} = {size}")
    return idx * (B // size), (idx + 1) * (B // size), group


def shard_batch(mesh, batch: VerifierBatch, axis: str = "dp") -> VerifierBatch:
    """This rank's slice of every (B, ...) leaf, the proof axis split over
    the mesh axis `axis` (views, no copies)."""
    lo, hi, _ = _proof_slice(mesh, batch.x.shape[0], axis)
    return _map_leaves(lambda t: t[lo:hi], batch)


def sharded_field_algebra(mesh, vk, batch: VerifierBatch, B: int):
    """The unfused `field_algebra` (plain torch) on this rank's dp slice,
    then an `all_gather` over dp: every rank holds the whole (B, 8)
    (h_eval, x^n, x^n - 1)."""
    lo, hi, group = _proof_slice(mesh, B)
    local = field_algebra(vk, shard_batch(mesh, batch), hi - lo)
    return tuple(gather(t, group).reshape(B, 8) for t in local)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _combine(mesh, partial: JacPoint, h_eval, B: int, t0: float, timings) -> dict:
    """(4, B_loc, 8) partials of this rank -> the whole batch's quads: an
    `all_gather` over mp and a segmented sum over it, then an `all_gather`
    over dp."""
    device = h_eval.device
    _sync(device)
    t1 = time.perf_counter()
    mp, _, mp_group = axis(mesh, "mp")
    _, _, dp_group = axis(mesh, "dp")
    g = JacPoint(*(gather(c, mp_group).reshape(mp, -1, 8) for c in partial))  # (mp, 4 B_loc, 8)
    t2 = time.perf_counter()
    tot = JacPoint(*(c.reshape(partial.x.shape) for c in jac_segment_sum(g, [0, mp])))
    _sync(device)
    t3 = time.perf_counter()
    # (dp, 4, B_loc, 8) -> (4, B, 8), proofs in dp order
    full = [gather(c, dp_group).movedim(0, 1).reshape(len(PARTIALS), B, 8) for c in tot]
    h_full = gather(h_eval, dp_group).reshape(B, 8)
    _sync(device)
    t4 = time.perf_counter()
    if timings is not None:
        timings.update(device=t1 - t0, collective=(t2 - t1) + (t4 - t3), mp_sum=t3 - t2)
    quads = {name: JacPoint(*(c[j] for c in full)) for j, name in enumerate(PARTIALS)}
    quads["h_eval"] = h_full
    return quads


def shmap_verify_algebra_fast(mesh, vk, batch: VerifierBatch, parsed, timings: dict | None = None) -> dict:
    """The production verifier step under a dp x mp mesh, the JAX default
    (`shard_map`): proofs over dp; each component's multiopen lanes, padded
    by `fast_prep(lane_pad=mp)` from the rank's slice of the batch, split
    evenly over mp.  Every rank runs K2 on its proofs, one K1 over its lanes
    plus the e-lane (its scalar zeroed on mp ranks other than 0, so that e
    is counted once), and one segmented sum into (w, zw, f, e) partials,
    combined over mp and gathered over dp.
    Returns {e, f, w, zw: JacPoint of (B, 8), h_eval: (B, 8)} on every rank.
    `timings`, if given, receives this rank's seconds: prep (host), device
    (up to the partials), collective (the all_gathers) and mp_sum."""
    mp, m, _ = axis(mesh, "mp")
    B = len(parsed)
    lo, hi, _ = _proof_slice(mesh, B)
    device = batch.x.device
    local = shard_batch(mesh, batch)
    t0 = time.perf_counter()
    lane_pts, lane_ss, ms, h_coeff, known = fast_prep(vk, parsed[lo:hi], device, lane_pad=mp, batch=local)
    share = [c // mp for c in ms]
    idx = torch.cat(
        [torch.arange(off + m * c, off + (m + 1) * c) for off, c in zip(segment_offsets(ms), share)]
    ).to(device)
    t1 = time.perf_counter()
    h_eval, _, _, e_scalar = field_algebra_fused(vk, local, hi - lo, h_coeff, known)
    if m != 0:
        e_scalar = torch.zeros_like(e_scalar)
    pts, ss = with_e_lane(JacPoint(*(c[:, idx] for c in lane_pts)), lane_ss[:, idx], e_scalar)
    partial = jac_segment_sum(scalar_mul(pts, ss), segment_offsets((*share, 1)), lane_axis=1)
    if timings is not None:
        timings["prep"] = t1 - t0
    return _combine(mesh, partial, h_eval, B, t1, timings)


def sharded_verify_algebra_fast(mesh, vk, batch: VerifierBatch, parsed, timings: dict | None = None) -> dict:
    """The same step as the decomposition of the JAX package's GSPMD
    variant: proofs over dp; the concatenated lane axis of M lanes (M a
    multiple of mp by `fast_prep(lane_pad=mp)`) split contiguously over mp,
    M / mp lanes a rank, with the e-lane (lane M) in the last rank's shard.
    A shard may cross a component boundary: the segment offsets
    [0, w, w + zw, M, M + 1] are cut to it, and a component that misses the
    shard is an empty segment (the identity).  Then combined as
    `shmap_verify_algebra_fast`, with the same result and `timings`."""
    mp, m, _ = axis(mesh, "mp")
    B = len(parsed)
    lo, hi, _ = _proof_slice(mesh, B)
    device = batch.x.device
    local = shard_batch(mesh, batch)
    t0 = time.perf_counter()
    lane_pts, lane_ss, ms, h_coeff, known = fast_prep(vk, parsed[lo:hi], device, lane_pad=mp, batch=local)
    n_lanes = sum(ms)
    a = m * (n_lanes // mp)
    b = (m + 1) * (n_lanes // mp) + (m == mp - 1)  # the last shard also takes the e-lane
    offsets = [min(max(o, a), b) - a for o in segment_offsets((*ms, 1))]
    t1 = time.perf_counter()
    h_eval, _, _, e_scalar = field_algebra_fused(vk, local, hi - lo, h_coeff, known)
    pts, ss = with_e_lane(lane_pts, lane_ss, e_scalar)
    shard = JacPoint(*(c[:, a:b].contiguous() for c in pts))
    partial = jac_segment_sum(scalar_mul(shard, ss[:, a:b].contiguous()), offsets, lane_axis=1)
    if timings is not None:
        timings["prep"] = t1 - t0
    return _combine(mesh, partial, h_eval, B, t1, timings)
