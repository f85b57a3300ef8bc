"""Hand-written Hopper kernels of the port and their plain versions.

- ``stencil7.py`` — K1, the 7-point stencil SpMV (``csrc/stencil7.cu``).
- ``fused_cg.py`` — K2, the fused PCG update, and the order-pinned
  block dot it shares (``csrc/fused_cg.cu``).
- ``ops.py`` — the seam: dispatch by the tensor's device.
- ``ref.py`` — the plain versions under the reference's names.
- ``_build.py`` — ``nvcc`` at first use, ``ctypes`` binding.
"""
