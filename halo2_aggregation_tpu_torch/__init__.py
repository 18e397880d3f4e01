"""PyTorch + CUDA port of the batched-verifier aggregation path.

The JAX package `halo2_aggregation_tpu` stays the reference.  This package
ports its main path (B inner proofs folded into one accumulator and
checked with one pairing) to PyTorch, with the two TPU kernels on that
path rewritten by hand in CUDA C++ for Hopper (`csrc/`):

* K1 `csrc/ec_win.cu`: the 4-bit windowed G1 scalar-mul
  (replaces `ops/ec_pallas.py::_win_kernel` + `_final_kernel`);
* K2 `csrc/fa_tape.cu`: the verifier's fused field algebra as a tape
  interpreter (replaces `plonk/fa_fused.py::_fa_kernel`).

It imports `torch` and never `jax`; the host halves (transcript replay,
keygen, KZG params, the oracle and the native pairing) are the JAX
package's JAX-free host modules, reused as they are.  Field elements are
`(..., 8)` int32 tensors holding the 32-bit little-endian limbs of a
canonical Montgomery value (R = 2^256): the same 32 bytes as the native
engine's `(n, 4)` u64 layout.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
