"""The kernel seam: ``stencil7``, ``fused_cg_update``, ``det_dot``,
``rs_encode`` and ``fused_cg_update_persist``, the lane modes
``fused_cg_update_lanes`` and ``det_dot_lanes`` (the service's bucket
step, and one shard's blocks of a sharded solve), and ``stencil7_halo``
(one z-slab shard of a sharded apply).

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


def stencil7_halo(u: torch.Tensor, lo, hi, out=None) -> torch.Tensor:
    """K1 on one z-slab shard ``(nz_s, ny, nx)`` with its halo planes
    ``lo`` (below) and ``hi`` (above), ``(ny, nx)`` each or ``None`` for
    the domain's zero boundary (K1's halo mode on CUDA); into ``out``
    when given.  The shards' outputs side by side are bitwise
    :func:`stencil7` of the whole grid."""
    if _route(u) == "cuda":
        return _stencil7.stencil7_halo_cuda(u, lo, hi, out)
    return _stencil7.stencil7_halo_plain(u, lo, hi, out)


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


def fused_cg_update_lanes(x, r, p, ap, alpha, inv_diag, out=None
                          ) -> Tuple[torch.Tensor, ...]:
    """:func:`fused_cg_update` on every lane of ``(lanes, n)`` tensors in
    one pass, ``alpha`` one value a lane: ``(x', r', z', rz')`` with
    ``rz'`` of shape ``(lanes,)`` (K2's lane mode on CUDA); ``x', r',
    z'`` into ``out`` (three tensors) when given.  Lane ``i`` is bitwise
    ``fused_cg_update`` of lane ``i`` with ``nblocks=1``, and ``rz'[i]``
    is the block sum the ``nblocks`` launch chains."""
    if _route(x) == "cuda":
        return _fused_cg.fused_cg_update_lanes_cuda(x, r, p, ap, alpha,
                                                    inv_diag, out)
    return _fused_cg.fused_cg_update_lanes_plain(x, r, p, ap, alpha, inv_diag,
                                                 out)


def det_dot_lanes(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Per-lane inner products of two ``(lanes, n)`` tensors, ``(lanes,)``
    (det_dot's lane mode on CUDA), into ``out`` when given; lane ``i`` is
    bitwise ``det_dot(a[i], b[i], 1)``, the block sum a ``det_dot`` over
    those blocks chains."""
    if _route(a) == "cuda":
        return _fused_cg.det_dot_lanes_cuda(a, b, out)
    return _fused_cg.det_dot_lanes_plain(a, b, out)


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


#: launches made by CUDA-graph replays since the last reset (a replay
#: runs no Python, so the wrappers' own counters never see them)
_replayed: Dict[str, int] = {}


def _wrapper_counts() -> Dict[str, int]:
    return {"stencil7": _stencil7.launches,
            "fused_cg_update": _fused_cg.update_launches,
            "det_dot": _fused_cg.dot_launches,
            "gf256_rs_encode": _gf256_encode.launches,
            "fused_cg_update_persist": _fused_cg.persist_launches,
            "fused_cg_update_lanes": _fused_cg.update_lanes_launches,
            "det_dot_lanes": _fused_cg.dot_lanes_launches,
            "stencil7_halo": _stencil7.halo_launches}


def _set_wrapper_counts(counts: Dict[str, int]) -> None:
    _stencil7.launches = counts["stencil7"]
    _fused_cg.update_launches = counts["fused_cg_update"]
    _fused_cg.dot_launches = counts["det_dot"]
    _gf256_encode.launches = counts["gf256_rs_encode"]
    _fused_cg.persist_launches = counts["fused_cg_update_persist"]
    _fused_cg.update_lanes_launches = counts["fused_cg_update_lanes"]
    _fused_cg.dot_lanes_launches = counts["det_dot_lanes"]
    _stencil7.halo_launches = counts["stencil7_halo"]


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, graph
    replays included."""
    return {name: count + _replayed.get(name, 0)
            for name, count in _wrapper_counts().items()}


def reset_launch_counts() -> None:
    _set_wrapper_counts(dict.fromkeys(_wrapper_counts(), 0))
    _replayed.clear()


def uncount_capture(before: Dict[str, int]) -> Dict[str, int]:
    """Undo the counts the wrappers recorded since ``before`` (a
    :func:`launch_counts` reading taken just before a CUDA-graph
    capture: a captured launch is recorded, not run) and return them:
    the launches one replay of the graph makes."""
    after = launch_counts()
    per_replay = {name: after[name] - before[name] for name in after}
    _set_wrapper_counts({name: count - per_replay[name]
                         for name, count in _wrapper_counts().items()})
    return per_replay


def count_replay(per_replay: Dict[str, int]) -> None:
    """Count the launches of one CUDA-graph replay."""
    for name, count in per_replay.items():
        _replayed[name] = _replayed.get(name, 0) + count
