"""The kernel seam: ``stencil7``, ``fused_cg_update``, ``det_dot``,
``rs_encode`` and ``fused_cg_update_persist``.

Each call dispatches on its tensor's device and nothing else: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises.  There is no fallback from a failed build
or launch to the plain version, and no mode switch (the reference's
``auto`` resolution to jnp off-TPU has no counterpart for device
tensors).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import fused_cg as _fused_cg
from repro_torch.kernels import gf256_encode as _gf256_encode
from repro_torch.kernels import stencil7 as _stencil7


def _route(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {t.device}: tensors "
                         f"must live on 'cpu' or 'cuda'")
    return kind


def stencil7(u: torch.Tensor) -> torch.Tensor:
    """7-point stencil SpMV on ``(..., nz, ny, nx)`` (K1 on CUDA)."""
    if _route(u) == "cuda":
        return _stencil7.stencil7_cuda(u)
    return _stencil7.stencil7_plain(u)


def fused_cg_update(x, r, p, ap, alpha, inv_diag, nblocks: int = 1
                    ) -> Tuple[torch.Tensor, ...]:
    """PCG lines 4-7a in one pass; returns ``(x', r', z', rz')`` (K2 on
    CUDA).  ``rz'`` is the order-pinned block dot over ``nblocks``."""
    if _route(x) == "cuda":
        return _fused_cg.fused_cg_update_cuda(x, r, p, ap, alpha, inv_diag,
                                              nblocks)
    return _fused_cg.fused_cg_update_plain(x, r, p, ap, alpha, inv_diag,
                                           nblocks)


def det_dot(a: torch.Tensor, b: torch.Tensor, nblocks: int = 1) -> torch.Tensor:
    """Order-pinned inner product over ``nblocks`` partition blocks (K2's
    reduction on CUDA); a 0-d tensor on ``a``'s device."""
    if _route(a) == "cuda":
        return _fused_cg.det_dot_cuda(a, b, nblocks)
    return _fused_cg.block_dot_plain(a, b, nblocks)


def rs_encode(data: torch.Tensor, nparity: int) -> torch.Tensor:
    """GF(2^8) P/Q parity ``(P, L)`` of the ``(K, L)`` uint8 data shards
    (K3 on CUDA); bitwise ``nvm.gf256.rs_encode``."""
    if _route(data) == "cuda":
        return _gf256_encode.gf256_rs_encode_cuda(data, nparity)
    return _gf256_encode.gf256_rs_encode_plain(data, nparity)


def fused_cg_update_persist(x, r, p, ap, alpha, inv_diag, nblocks: int,
                            k_data: int, nparity: int
                            ) -> Tuple[torch.Tensor, ...]:
    """:func:`fused_cg_update` plus the erasure stripe's staging of ``p``:
    ``(x', r', z', rz', chunks, parity)`` (K4 on CUDA); the first four are
    bitwise :func:`fused_cg_update`'s."""
    if _route(x) == "cuda":
        return _fused_cg.fused_cg_update_persist_cuda(
            x, r, p, ap, alpha, inv_diag, nblocks, k_data, nparity)
    return _fused_cg.fused_cg_update_persist_plain(
        x, r, p, ap, alpha, inv_diag, nblocks, k_data, nparity)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"stencil7": _stencil7.launches,
            "fused_cg_update": _fused_cg.update_launches,
            "det_dot": _fused_cg.dot_launches,
            "gf256_rs_encode": _gf256_encode.launches,
            "fused_cg_update_persist": _fused_cg.persist_launches}


def reset_launch_counts() -> None:
    _stencil7.launches = 0
    _fused_cg.update_launches = 0
    _fused_cg.dot_launches = 0
    _gf256_encode.launches = 0
    _fused_cg.persist_launches = 0
