"""Exact state reconstruction for PCG (port of
``repro/core/reconstruction.py``, paper Algorithm 3 / 5).

Given the persisted minimal set ``(p^(k-1)_F, p^(k)_F, beta^(k-1))`` for
the failed block union F, plus the surviving shards of ``x, r`` and the
static data (A rows, P rows, b), the failed state is rebuilt exactly:

    z_F = p^(k)_F - beta^(k-1) * p^(k-1)_F                      (line 4)
    solve  P[F,F] r_F = z_F - P[F,~F] r_~F                      (lines 5-6)
    solve  A[F,F] x_F = b_F - r_F - A[F,~F] x_~F                (lines 7-8)

``A[F,F]`` is SPD, so the local solve is a dense Cholesky for small
unions or matrix-free local CG for large ones.  Every stencil apply runs
through K1 (``ops.stencil7``, and for the restrictions ``A[F,F]`` and
``A[F,~F]`` its halo mode over the failed slabs alone).  On the card the
local CG runs as a CUDA graph replayed chunk by chunk
(:func:`_local_cg_chunked`), bitwise the plain loop the CPU runs.  On a
sharded solve the failed union's pieces move to the device of the first
failed shard (``op.partition.restrict``), where the local solve runs,
and the restored blocks move back into their shards' slabs.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.pcg import LoopChunk, chunk_stats, run_chunks
from repro_torch.core.spmv import make_det_dot
from repro_torch.core.state import PCGState

#: inner product of the replacement-node local solve (one block: the
#: union is solved as a single local vector)
_local_dot = make_det_dot(1)
#: iterations of one chunk of the local CG on the card (one host read
#: each)
LOCAL_CG_CHUNK = 32


def _cg_iteration(apply_fn, x, r, p, rs):
    """One iteration of the local CG: ``(x, r, p, r.r)`` after it."""
    ap = apply_fn(p)
    alpha = rs / _local_dot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    rs_new = _local_dot(r, r)
    p = r + (rs_new / rs) * p
    return x, r, p, rs_new


def _local_cg_plain(apply_fn, rhs: torch.Tensor, tol: float = 1e-14,
                    maxiter: int = 10000, info: Optional[dict] = None
                    ) -> torch.Tensor:
    """Matrix-free CG on the failed-block operator (replacement-node
    solve), the reference's ``while_loop`` run from the host: it stops at
    the first iteration where ``r.r`` is not above ``tol^2 * rhs.rhs``,
    or at ``maxiter``, and pulls one scalar an iteration for that test.
    ``info`` gets the iteration count."""
    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    rs = _local_dot(rhs, rhs)
    threshold = tol * tol * rs
    it = 0
    while it < maxiter and bool(rs > threshold):
        x, r, p, rs = _cg_iteration(apply_fn, x, r, p, rs)
        it += 1
    if info is not None:
        info["iterations"] = it
    return x


class _LocalCGChunk(LoopChunk):
    """``size`` local-CG iterations on static ``x, r, p, rs``; each one's
    stop value is its ``rs``."""

    #: det_dot(p, ap) and det_dot(r, r)
    SCALARS = 2

    def __init__(self, apply_fn, rhs: torch.Tensor, rs: torch.Tensor,
                 size: int):
        self.apply_fn = apply_fn
        super().__init__({"x": torch.zeros_like(rhs), "r": rhs, "p": rhs,
                          "rs": rs}, size)

    def iterate(self, vals):
        x, r, p, rs = _cg_iteration(self.apply_fn, vals["x"], vals["r"],
                                    vals["p"], vals["rs"])
        return {"x": x, "r": r, "p": p, "rs": rs}, rs


def _local_cg_chunked(apply_fn, rhs: torch.Tensor, tol: float = 1e-14,
                      maxiter: int = 10000, chunk: int = LOCAL_CG_CHUNK,
                      info: Optional[dict] = None) -> torch.Tensor:
    """:func:`_local_cg_plain`'s loop in chunks of ``chunk`` iterations
    (``core.pcg.run_chunks``: a CUDA graph on the card, eager on the
    CPU, one host read a chunk and an eager rerun of the chunk the stop
    falls in): the same calls, so the same ``x`` bitwise at the same
    iteration.  ``info`` gets the iteration count and the chunks'
    statistics."""
    stats = chunk_stats(info, rhs.device.type == "cuda")
    rs = _local_dot(rhs, rhs)
    threshold = float(tol * tol * rs)
    if maxiter <= 0 or not float(rs) > threshold:
        stats["iterations"] = 0
        return torch.zeros_like(rhs)
    body = _LocalCGChunk(apply_fn, rhs, rs, min(chunk, maxiter))
    stats["iterations"] = run_chunks(body, 1, threshold, maxiter, stats)
    return body.buf["x"]


def _local_cg(apply_fn, rhs: torch.Tensor, tol: float = 1e-14,
              maxiter: int = 10000, info: Optional[dict] = None
              ) -> torch.Tensor:
    """The local CG, dispatched on ``rhs``'s device: chunked and captured
    as a CUDA graph on the card (the reference compiles its
    ``while_loop``), the plain loop on the CPU.  On a mesh over distinct
    cards ``rhs`` lives on the first failed shard's card, which is made
    current for the loop."""
    if rhs.device.type == "cuda":
        with torch.cuda.device(rhs.device):
            return _local_cg_chunked(apply_fn, rhs, tol, maxiter, info=info)
    return _local_cg_plain(apply_fn, rhs, tol, maxiter, info)


def _local_dense_solve(apply_fn, rhs: torch.Tensor) -> torch.Tensor:
    """Materialize A[F,F] column by column (one batched apply) and
    Cholesky-solve (small F)."""
    m = rhs.shape[0]
    eye = torch.eye(m, dtype=rhs.dtype, device=rhs.device)
    a_ff = apply_fn(eye).T
    chol = torch.linalg.cholesky(a_ff)
    y = torch.linalg.solve_triangular(chol, rhs[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]


def solve_local(apply_fn, rhs: torch.Tensor, method: str = "auto") -> torch.Tensor:
    if method == "auto":
        method = "dense" if rhs.shape[0] <= 1024 else "cg"
    if method == "dense":
        return _local_dense_solve(apply_fn, rhs)
    if method == "cg":
        return _local_cg(apply_fn, rhs)
    raise ValueError(f"unknown local solve method {method!r}")


def solve_x_from_residual(op, b: torch.Tensor, x_surviving: torch.Tensor,
                          r_f: torch.Tensor, failed: Sequence[int],
                          local_method: str = "auto") -> torch.Tensor:
    """Algorithm 3 lines 7-8: solve ``A[F,F] x_F = b_F - r_F - A[F,~F]
    x_{~F}`` and return the full ``x`` with the failed union restored."""
    part = op.partition
    x_clean = part.scatter(x_surviving, torch.zeros_like(r_f), failed)
    w = part.restrict(b, failed) - r_f - op.offblock_apply(x_clean, failed)
    x_f = solve_local(lambda u: op.inblock_apply(u, failed), w, local_method)
    return part.scatter(x_surviving, x_f, failed)


def residual_on_failed(op, b: torch.Tensor, x: torch.Tensor,
                       failed: Sequence[int]) -> torch.Tensor:
    """``r_F = b_F - A[F,F] x_F - A[F,~F] x_{~F}`` — the direct residual
    restriction, used by solvers whose recovery set contains ``x``."""
    part = op.partition
    return (part.restrict(b, failed)
            - op.inblock_apply(part.restrict(x, failed), failed)
            - op.offblock_apply(x, failed))


def reconstruct_direction_form(
    op, precond, b: torch.Tensor, state_surviving,
    failed_blocks: Sequence[int], p_prev_f: torch.Tensor,
    p_cur_f: torch.Tensor, beta: float, local_method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 3 core for any solver with the three-term direction
    structure ``p^(k) = z^(k) + beta^(k) p^(k-1)``.  Returns the restored
    ``(x, r, z, p)``; the failed shards of ``state_surviving`` may be
    garbage."""
    part = op.partition
    failed = list(failed_blocks)

    # Line 4: z_F = p^(k)_F - beta * p^(k-1)_F
    z_f = p_cur_f - beta * p_prev_f

    # Lines 5-6: solve P[F,F] r_F = z_F - P[F,~F] r_{~F}
    r_clean = part.scatter(state_surviving.r, torch.zeros_like(z_f), failed)
    v = z_f - precond.offblock_apply(r_clean, failed)
    r_f = precond.block_solve(v, failed)

    # Lines 7-8: solve A[F,F] x_F = b_F - r_F - A[F,~F] x_{~F}
    x = solve_x_from_residual(op, b, state_surviving.x, r_f, failed, local_method)

    r = part.scatter(state_surviving.r, r_f, failed)
    z = part.scatter(state_surviving.z, z_f, failed)
    p = part.scatter(state_surviving.p, p_cur_f, failed)
    return x, r, z, p


def reconstruct(
    op, precond, b: torch.Tensor, state_surviving: PCGState,
    failed_blocks: Sequence[int], p_prev_f: torch.Tensor,
    p_cur_f: torch.Tensor, beta: float, local_method: str = "auto",
    dot: Optional[Callable] = None,
) -> PCGState:
    """Run Algorithm 3 and return the reconstructed PCG state at ``k``.

    ``dot`` must be the solve loop's inner product (default: the
    ``op.nblocks`` block dot, K2's reduction on CUDA) so the restored
    ``rz`` carries the same rounding as the unfailed trajectory's."""
    dot = make_det_dot(op.nblocks) if dot is None else dot
    x, r, z, p = reconstruct_direction_form(
        op, precond, b, state_surviving, failed_blocks,
        p_prev_f, p_cur_f, beta, local_method)
    return PCGState(
        x=x, r=r, z=z, p=p, rz=dot(r, z),
        beta_prev=torch.tensor(beta, dtype=x.dtype, device=x.device),
        k=state_surviving.k,
    )
