"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` package.

It mirrors the reference package module for module
(``repro_torch/core/poisson.py`` ports ``repro/core/poisson.py``) and
imports neither JAX nor the reference package.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; the hot kernels
(7-point stencil, fused PCG update) are hand-written CUDA for Hopper
under ``kernels/``.  Start at :mod:`repro_torch.api`.
"""
