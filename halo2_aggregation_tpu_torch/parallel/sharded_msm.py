"""Mesh-sharded MSM: points and scalars split over one mesh axis, the
partial sums combined with one collective.

Counterpart of `halo2_aggregation_tpu/parallel/sharded_msm.py`.  Each rank
runs `ops/msm.py::msm` over its slice of the points (kernel K7 on the card,
its plain bucket version on the CPU) to one Jacobian partial; the partials
are all-gathered (a point sum is not a ring all-reduce: EC addition is not
an arithmetic add) and added by one segmented sum (`ops/ec_kernels.py::
jac_segment_sum`), so every rank of the axis holds the sum.
"""

from __future__ import annotations

import torch

from ..ops.curve_ops import AffinePoint, JacPoint
from ..ops.ec_kernels import jac_segment_sum
from ..ops.limbs import ints_to_tensor
from ..ops.msm import msm
from .mesh import axis as mesh_axis
from .mesh import gather


def sharded_msm(mesh, axis: str, points: AffinePoint, scalars: torch.Tensor, nbits: int = 254) -> JacPoint:
    """sum_i (s_i mod 2^nbits) * P_i for (N, 8) Montgomery affine points
    with (N,) infinity flags and (N, 8) plain scalars, every rank holding
    all N; N must divide by the size of the mesh axis `axis`.  Returns the
    sum, the same point on every rank of the axis, as (8,) Jacobian
    coordinates."""
    size, idx, group = mesh_axis(mesh, axis)
    n = points.x.shape[0]
    if n % size:
        raise ValueError(f"{n} points do not divide over the {size} ranks of {axis!r}")
    if not 1 <= nbits <= 256:
        raise ValueError(f"nbits = {nbits}: expected 1 .. 256")
    lo, hi = idx * (n // size), (idx + 1) * (n // size)
    s = scalars[lo:hi] & ints_to_tensor([(1 << nbits) - 1], scalars.device)
    part = msm(AffinePoint(*(c[lo:hi] for c in points)), s)
    total = jac_segment_sum(JacPoint(*(gather(c, group)[:, None] for c in part)), [0, size])  # (1, 1, 8)
    return JacPoint(*(c[0, 0] for c in total))
