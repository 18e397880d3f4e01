"""PyTorch + CUDA port of the halo2 aggregation framework, for one H100.

The JAX package `halo2_aggregation_tpu` stays the reference.  This package
ports its device paths to PyTorch, with every TPU kernel on them rewritten
by hand in CUDA C++ for Hopper (`csrc/`):

* the batched verifier's aggregation path (B inner proofs folded into one
  accumulator, one pairing), `plonk/verifier_device.py::verify_batch`:
  K1 `csrc/ec_win.cu`, the 4-bit windowed G1 scalar-mul (replaces
  `ops/ec_pallas.py::_win_kernel` + `_final_kernel`; K8
  `csrc/ec_ladder.cu` with `method="ladder"`), and K2 `csrc/fa_tape.cu`,
  the verifier's fused field algebra as a tape interpreter (replaces
  `plonk/fa_fused.py::_fa_kernel`);
* the prover's device quotient, `plonk/prover_device.py::create_proof_device`
  over `plonk/quotient_device.py::DeviceQuotient`: K3/K4 `csrc/ntt.cu`, the
  batched forward and inverse NTT (replace the `ops/ntt_pallas.py` stage
  kernels), K5 `csrc/ew.cu`, elementwise products and the power series
  (replace `_ew_mul_kernel`, `_ew_mul_scalar_kernel`), and K6
  `csrc/quotient_tape.cu`, the quotient numerator per row (replaces
  `plonk/quotient_device.py::_build_tile_fn`'s kernel);
* every commitment of keygen and the prover, `plonk/kzg.py::DeviceSRS` and
  `plonk/keygen_device.py::keygen_device`: K7 and K9 `csrc/msm.cu`, the
  bucket MSM (replace `ops/ec_pallas.py::_msm_kernel_s5` and `_msm_kernel`).

It stands alone: it imports `torch`, never `jax`, and nothing of the JAX
package.  The host halves (`fields`, `utils/`: transcript, serialization,
u64, the native engine's bindings; `oracle/`; `plonk/`: circuit, protocol,
engine, KZG params and setup, keygen, the host provers, verifier, mock;
`aggregation/`; `models/`) are this package's own copies of the JAX
package's host modules, less their JAX branches; `convert.py` carries that
package's objects over by attribute, for the tests that hold the two
together.  Entry points run on the card unless the caller asks for the CPU.
Field elements are `(..., 8)` int32 tensors holding the 32-bit
little-endian limbs of a canonical Montgomery value (R = 2^256): the same
32 bytes as the native engine's `(n, 4)` u64 layout.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
