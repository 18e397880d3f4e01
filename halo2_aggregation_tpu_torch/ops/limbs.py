"""Layout converters for the port's field elements.

Port layout: `(..., 8)` int32, the 32-bit little-endian limbs of a 256-bit
integer as raw bits (a limb >= 2^31 reads negative).  That is the same 32
bytes as the native engine's `(n, 4)` u64 layout (`utils/u64.py`) and as
the JAX package's `(..., 32)` int32 8-bit limbs (`ops/limbs.py`) narrowed to
bytes.  Montgomery values share R = 2^256 in all three, so converting is
repacking only: no arithmetic.

Counterpart of `halo2_aggregation_tpu/ops/limbs.py` and `utils/u64.py`.
"""

from __future__ import annotations

import numpy as np
import torch

NL = 8  # 32-bit limbs per element
_NBYTES = 4 * NL


def ints_to_np(xs) -> np.ndarray:
    """Non-negative ints < 2^256 -> (n, 8) int32."""
    buf = b"".join(int(x).to_bytes(_NBYTES, "little") for x in xs)
    return np.frombuffer(buf, dtype="<i4").reshape(-1, NL).copy()


def np_to_ints(arr) -> list:
    """(..., 8) int32 -> flat list of ints."""
    buf = np.ascontiguousarray(np.asarray(arr), dtype="<i4").tobytes()
    return [
        int.from_bytes(buf[i : i + _NBYTES], "little")
        for i in range(0, len(buf), _NBYTES)
    ]


def ints_to_tensor(xs, device) -> torch.Tensor:
    """Non-negative ints < 2^256 -> (n, 8) int32 tensor on `device`."""
    return torch.from_numpy(ints_to_np(list(xs))).to(device)


def tensor_to_ints(t: torch.Tensor) -> list:
    """(..., 8) int32 tensor -> flat list of ints (row-major)."""
    return np_to_ints(t.detach().cpu().numpy())


def jax_to_port(arr) -> np.ndarray:
    """JAX `(..., 32)` int32 8-bit limbs (canonical bytes) -> `(..., 8)`."""
    a = np.asarray(arr)
    if a.shape[-1] != 32:
        raise ValueError(f"expected (..., 32) limbs, got {a.shape}")
    b = np.ascontiguousarray(a.astype(np.uint8))
    return b.view("<i4").reshape(*a.shape[:-1], NL)


def port_to_jax(arr) -> np.ndarray:
    """`(..., 8)` -> JAX `(..., 32)` int32 8-bit limbs."""
    a = np.ascontiguousarray(_as_np(arr), dtype="<i4")
    return a.view(np.uint8).reshape(*a.shape[:-1], 32).astype(np.int32)


def port_to_u64(arr) -> np.ndarray:
    """`(n, 8)` -> native `(n, 4)` u64."""
    a = np.ascontiguousarray(_as_np(arr), dtype="<i4")
    return a.view("<u8").reshape(*a.shape[:-1], 4).astype(np.uint64)


def u64_to_port(arr) -> np.ndarray:
    """Native `(n, 4)` u64 -> `(n, 8)` int32."""
    a = np.ascontiguousarray(np.asarray(arr), dtype="<u8")
    return a.view("<i4").reshape(*a.shape[:-1], NL)


def _as_np(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)
