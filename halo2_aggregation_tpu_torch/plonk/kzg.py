"""The Lagrange SRS resident on a device, and commitments through the MSM.

Counterpart of the device branch of
`halo2_aggregation_tpu/plonk/kzg.py::Params._msm` (:132-156), which kept
`_device_points` resident and ran `ops/msm.py::msm` under
`H2A_DEVICE_MSM=1`.  Here the device is explicit: a `DeviceSRS` made on a
CUDA device commits through kernel K7 (or K9 with `signed=False`), one
made on the CPU through their plain version.  `Params` itself (setup, the
host copy of the points, the native MSM) is the JAX package's host class,
shared as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from halo2_aggregation_tpu.fields import R
from halo2_aggregation_tpu.plonk.kzg import Params
from halo2_aggregation_tpu.utils.u64 import ints_to_u64

from ..device import resolve_device
from ..ops import curve_ops as co
from ..ops import field_ops as fo
from ..ops.curve_ops import AffinePoint, JacPoint
from ..ops.limbs import u64_to_port
from ..ops.msm import msm

# rows a Montgomery conversion step takes: bounds the wide-form products'
# temporaries (about 10 KB a row)
_TO_MONT_CHUNK = 1 << 18


def _to_mont_fq(plain: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(plain)
    for i in range(0, plain.shape[0], _TO_MONT_CHUNK):
        out[i : i + _TO_MONT_CHUNK] = fo.to_mont(plain[i : i + _TO_MONT_CHUNK], fo.FQ)
    return out


class DeviceSRS:
    """`params.g_lagrange_u64` uploaded once to `device` (plain x || y,
    converted to Montgomery Fq there) with its infinity flags, as
    `self.points`; `commit_lagrange` commits with it.  At k = 21 the points
    take 128 MiB."""

    def __init__(self, params: Params, device):
        self.device = resolve_device(device)
        self.n = params.n
        xy = np.asarray(params.g_lagrange_u64, dtype=np.uint64)
        if xy.shape != (self.n, 8):
            raise ValueError(f"g_lagrange_u64: expected ({self.n}, 8), got {xy.shape}")
        x = torch.from_numpy(u64_to_port(xy[:, :4])).to(self.device)
        y = torch.from_numpy(u64_to_port(xy[:, 4:])).to(self.device)
        inf = torch.from_numpy(np.asarray(params.g_lagrange_inf).astype(bool)).to(self.device)
        self.points = AffinePoint(_to_mont_fq(x), _to_mont_fq(y), inf)

    def commit_lagrange(self, values, *, signed: bool = True):
        """A commitment to the polynomial with Lagrange `values`, as
        `Params.commit_lagrange` takes them (an (m <= n, 4) uint64 array of
        plain values, zero-padded, or a list of ints) and gives it (an
        affine int pair, or None for the identity).  The MSM runs on the
        SRS's device: K7, or K9 with `signed=False`, on a card."""
        if isinstance(values, np.ndarray) and values.dtype == np.uint64:
            scalars_u64 = values
            if scalars_u64.shape[0] > self.n or scalars_u64.shape[1:] != (4,):
                raise ValueError(f"values: expected (m <= {self.n}, 4), got {scalars_u64.shape}")
            if scalars_u64.shape[0] < self.n:
                pad = np.zeros((self.n - scalars_u64.shape[0], 4), dtype=np.uint64)
                scalars_u64 = np.vstack([scalars_u64, pad])
        else:
            vals = [int(v) % R for v in values]
            if len(vals) > self.n:
                raise ValueError("polynomial larger than the domain")
            scalars_u64 = ints_to_u64(vals + [0] * (self.n - len(vals)))
        scalars = torch.from_numpy(u64_to_port(scalars_u64)).to(self.device)
        acc = msm(self.points, scalars, signed=signed)
        return co.jac_to_ints(JacPoint(*(c[None] for c in acc)))[0]
