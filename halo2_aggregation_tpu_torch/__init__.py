"""PyTorch + CUDA port of the halo2 aggregation framework's device paths.

The JAX package `halo2_aggregation_tpu` stays the reference.  This package
ports two of its paths to PyTorch, with every TPU kernel on them rewritten
by hand in CUDA C++ for Hopper (`csrc/`):

* the batched verifier's aggregation path (B inner proofs folded into one
  accumulator, one pairing), `plonk/verifier_device.py::verify_batch`:
  K1 `csrc/ec_win.cu`, the 4-bit windowed G1 scalar-mul (replaces
  `ops/ec_pallas.py::_win_kernel` + `_final_kernel`), and K2
  `csrc/fa_tape.cu`, the verifier's fused field algebra as a tape
  interpreter (replaces `plonk/fa_fused.py::_fa_kernel`);
* the prover's device quotient, `plonk/prover_device.py::create_proof_device`
  over `plonk/quotient_device.py::DeviceQuotient`: K3/K4 `csrc/ntt.cu`, the
  batched forward and inverse NTT (replace the `ops/ntt_pallas.py` stage
  kernels), K5 `csrc/ew.cu`, elementwise products and the power series
  (replace `_ew_mul_kernel`, `_ew_mul_scalar_kernel`), and K6
  `csrc/quotient_tape.cu`, the quotient numerator per row (replaces
  `plonk/quotient_device.py::_build_tile_fn`'s kernel).

It imports `torch` and never `jax`; the host halves (transcript, keygen,
KZG params, the native engine, the oracle and the native pairing) are the
JAX package's JAX-free host modules, reused as they are.  Field elements
are `(..., 8)` int32 tensors holding the 32-bit little-endian limbs of a
canonical Montgomery value (R = 2^256): the same 32 bytes as the native
engine's `(n, 4)` u64 layout.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
