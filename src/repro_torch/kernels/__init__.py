"""Hand-written Hopper kernels of the port and their plain versions.

- ``stencil7.py`` — K1, the 7-point stencil SpMV (``csrc/stencil7.cu``).
- ``fused_cg.py`` — K2, the fused PCG update, the order-pinned block
  dot it shares, and K4, the update plus the erasure stripe's staging
  (``csrc/fused_cg.cu``).
- ``gf256_encode.py`` — K3, the GF(2^8) Reed-Solomon parity encode
  (``csrc/gf256_encode.cu``; tables in ``csrc/gf256.cuh``).
- ``ops.py`` — the seam: dispatch by the tensor's device.
- ``ref.py`` — the plain versions under the reference's names.
- ``_build.py`` — ``nvcc`` at first use, ``ctypes`` binding.
"""
