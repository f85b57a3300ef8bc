"""Problem operators for the PCG solver (port of ``repro/core/poisson.py``).

The paper's workload is the 7-point stencil of the 3-D Poisson equation
(the HPCG kernel), applied matrix-free through ``ops.stencil7`` (kernel
K1 on CUDA tensors).  Per-block restrictions needed by exact state
reconstruction (``A[F,F]``, ``A[F,~F]``) are derived from the stencil by
masked application.

Block convention: the flat index space ``I = [0, n)`` is split into
``nblocks`` contiguous equal blocks — block ``b`` owns
``I_b = [b*bs, (b+1)*bs)``.  For the stencil, blocks are z-slabs.

Vectors may carry leading batch dimensions: every partition method and
operator ``apply`` acts on the last dimension, which is how the dense
local solve applies ``A[F,F]`` to the columns of an identity at once.

The stencil's restrictions never touch the whole grid: ``A[F,F] v``
runs K1 over each contiguous run of failed z-slabs with zero halo
planes, and ``A[F,~F] x[~F]`` over a zero slab with the run's two true
neighbour planes (K1's halo mode, bitwise the full launch), so a
recovery's local CG works on the failed slabs alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops


def stencil7(u: torch.Tensor) -> torch.Tensor:
    """7-point Poisson stencil with homogeneous Dirichlet boundary on a
    ``(..., nz, ny, nx)`` grid (K1 on CUDA, the plain version on CPU)."""
    return ops.stencil7(u)


@dataclass(frozen=True)
class BlockPartition:
    """Contiguous equal-size block partition of ``[0, n)``."""

    n: int
    nblocks: int

    def __post_init__(self):
        if self.n % self.nblocks != 0:
            raise ValueError(f"n={self.n} not divisible by nblocks={self.nblocks}")

    @property
    def block_size(self) -> int:
        return self.n // self.nblocks

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.nblocks, self.block_size)

    def _index(self, blocks: Sequence[int], device) -> torch.Tensor:
        """``blocks`` as a long tensor on ``device``, made once a (blocks,
        device): recovery's local CG captures ``embed`` and ``restrict``
        in a CUDA graph, where no host-to-device copy may run."""
        key = (tuple(blocks), torch.device(device))
        cache = self.__dict__.setdefault("_indices", {})
        index = cache.get(key)
        if index is None:
            index = cache[key] = torch.as_tensor(list(blocks), dtype=torch.long,
                                                 device=device)
        return index

    def restrict(self, x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        """``x[I_F]`` for the union F of ``blocks`` (concatenated, flat)."""
        sel = self._blocks(x)[..., self._index(blocks, x.device), :]
        return sel.reshape(*x.shape[:-1], -1)

    def zero_blocks(self, x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        """``x`` with ``x[I_F] = 0`` (a new tensor)."""
        xb = self._blocks(x).clone()
        xb[..., self._index(blocks, x.device), :] = 0.0
        return xb.reshape(x.shape)

    def embed(self, v: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        """Scatter a concatenated union vector back into a zero full vector."""
        lead = v.shape[:-1]
        xb = torch.zeros(*lead, self.nblocks, self.block_size, dtype=v.dtype,
                         device=v.device)
        xb[..., self._index(blocks, v.device), :] = v.reshape(
            *lead, len(blocks), self.block_size)
        return xb.reshape(*lead, self.n)

    def scatter(self, x: torch.Tensor, v: torch.Tensor,
                blocks: Sequence[int]) -> torch.Tensor:
        """``x`` with ``x[I_F] <- v`` (a new tensor)."""
        xb = self._blocks(x).clone()
        xb[..., self._index(blocks, x.device), :] = v.reshape(
            *x.shape[:-1], len(blocks), self.block_size)
        return xb.reshape(x.shape)

    def fill_blocks(self, x: torch.Tensor, blocks: Sequence[int],
                    value: float) -> torch.Tensor:
        """``x`` with ``x[I_F] = value`` (a new tensor)."""
        xb = self._blocks(x).clone()
        xb[..., self._index(blocks, x.device), :] = value
        return xb.reshape(x.shape)

    def map_blocks(self, x: torch.Tensor,
                   fn: Callable[[torch.Tensor, Tuple[int, ...]], torch.Tensor]
                   ) -> torch.Tensor:
        """``fn(part, blocks)`` over the parts of ``x`` that live
        together: here ``x`` whole with every block (a sharded partition
        calls it once a shard)."""
        return fn(x, tuple(range(self.nblocks)))

    def device_of(self, x: torch.Tensor, blocks: Sequence[int]) -> torch.device:
        """Where a restriction of ``x`` to ``blocks`` lands: ``x``'s
        device (a sharded vector's is the first block's shard's)."""
        return x.device


class StencilOperator:
    """Matrix-free 7-point stencil operator on a 3-D grid.

    Blocks are z-slabs: ``nblocks`` must divide ``nz``.
    """

    def __init__(self, nz: int, ny: int, nx: int, nblocks: int = 1,
                 dtype: torch.dtype = torch.float64,
                 device: Union[str, torch.device] = "cuda"):
        self.grid = (nz, ny, nx)
        self.n = nz * ny * nx
        self.dtype = dtype
        self.device = resolve_device(device)
        if nz % nblocks != 0:
            raise ValueError(f"nz={nz} not divisible by nblocks={nblocks}")
        self.partition = BlockPartition(self.n, nblocks)

    @property
    def nblocks(self) -> int:
        return self.partition.nblocks

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        return stencil7(x.reshape(*lead, *self.grid)).reshape(*lead, self.n)

    def diag(self) -> torch.Tensor:
        return torch.full((self.n,), 6.0, dtype=self.dtype, device=self.device)

    # ------- restrictions used by exact state reconstruction -------
    def runs(self, blocks: Sequence[int]) -> List[Tuple[int, int, int]]:
        """The maximal runs of consecutive blocks in ``blocks`` order, as
        ``(start, z0, z1)``: the run's first value in the union vector
        and its planes ``[z0, z1)`` of the grid."""
        planes = self.grid[0] // self.nblocks
        bs = self.partition.block_size
        out: List[Tuple[int, int, int]] = []
        for i, blk in enumerate(blocks):
            if i and blk == blocks[i - 1] + 1:
                start, z0, _ = out[-1]
                out[-1] = (start, z0, (blk + 1) * planes)
            else:
                out.append((i * bs, blk * planes, (blk + 1) * planes))
        return out

    def offblock_from_planes(self, blocks: Sequence[int],
                             plane: Callable[[int], torch.Tensor],
                             dtype: torch.dtype,
                             device: torch.device) -> torch.Tensor:
        """``A[F, ~F] @ x[~F]`` from the planes of ``x`` next to each run
        of F (``plane(z)``: ``x``'s plane ``z`` on ``device``): K1's halo
        mode over a zero slab of the run with those two planes, bitwise
        ``restrict(apply(zero_blocks(x)))``."""
        nz, ny, nx = self.grid
        out = torch.empty(len(blocks) * self.partition.block_size,
                          dtype=dtype, device=device)
        for start, z0, z1 in self.runs(blocks):
            zero = torch.zeros((z1 - z0, ny, nx), dtype=dtype, device=device)
            ops.stencil7_halo(zero, plane(z0 - 1) if z0 > 0 else None,
                              plane(z1) if z1 < nz else None,
                              out=out[start:start + zero.numel()].view(
                                  zero.shape))
        return out

    def offblock_apply(self, x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        """``A[F, ~F] @ x[~F]`` for a vector ``x`` (one dimension): the
        planes around each run of F, never the whole grid."""
        if x.dim() != 1:
            raise ValueError(f"offblock_apply takes one vector, got shape "
                             f"{tuple(x.shape)}")
        u = x.reshape(self.grid)
        return self.offblock_from_planes(blocks, lambda z: u[z], x.dtype,
                                         x.device)

    def inblock_apply(self, v: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        """``A[F, F] @ v`` for the (possibly multi-block) union F, on the
        union alone: K1's halo mode with zero halo planes over each run
        of consecutive blocks (K1 on the run's sub-grid for a batch of
        vectors), bitwise ``restrict(apply(embed(v)))``."""
        _, ny, nx = self.grid
        lead = v.shape[:-1]
        out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        for start, z0, z1 in self.runs(blocks):
            shape = (z1 - z0, ny, nx)
            m = shape[0] * ny * nx
            seg, dst = v[..., start:start + m], out[..., start:start + m]
            if v.dim() == 1:
                ops.stencil7_halo(seg.reshape(shape), None, None,
                                  out=dst.view(shape))
            else:
                dst.copy_(stencil7(seg.reshape(*lead, *shape)).reshape(
                    *lead, m))
        return out

    def to_dense(self) -> np.ndarray:
        eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
        return self.apply(eye).T.cpu().numpy()


class DenseOperator:
    """Explicit SPD matrix operator (used by property tests)."""

    def __init__(self, a, nblocks: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        a = torch.as_tensor(np.asarray(a), device=resolve_device(device))
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError("square matrix required")
        self.a = a
        self.n = a.shape[0]
        self.dtype = a.dtype
        self.device = a.device
        self.partition = BlockPartition(self.n, nblocks)

    @property
    def nblocks(self) -> int:
        return self.partition.nblocks

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            return torch.matmul(self.a, x)
        return torch.matmul(x, self.a.T)

    def diag(self) -> torch.Tensor:
        return torch.diagonal(self.a).clone()

    def offblock_apply(self, x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        xm = self.partition.zero_blocks(x, blocks)
        return self.partition.restrict(self.apply(xm), blocks)

    def inblock_apply(self, v: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        xf = self.partition.embed(v, blocks)
        return self.partition.restrict(self.apply(xf), blocks)

    def to_dense(self) -> np.ndarray:
        return self.a.cpu().numpy()


def random_spd(n: int, seed: int = 0, cond: float = 50.0) -> np.ndarray:
    """Well-conditioned random SPD matrix for tests."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.geomspace(1.0, cond, n)
    return (q * eigs) @ q.T


# ======================================================================
# Preconditioners.  ``apply`` computes z = P r.  Reconstruction needs
# ``block_solve`` (solve P[F,F] r_F = v) and ``offblock_apply``
# (P[F,~F] r[~F]).  The diagonal families expose ``inv_diag``, which the
# fused update (K2) reads directly; block Jacobi does not, so PCG takes
# its unfused step with it.
# ======================================================================
class IdentityPreconditioner:
    def __init__(self, op):
        self.op = op
        self.inv_diag = torch.ones(op.n, dtype=op.dtype, device=op.device)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return r

    def block_solve(self, v: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        return v

    def offblock_apply(self, r: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        return torch.zeros_like(self.op.partition.restrict(r, blocks))


class JacobiPreconditioner:
    """P = D^{-1}; diagonal, hence P[F,~F] = 0 and block solves are local."""

    def __init__(self, op):
        self.op = op
        self.inv_diag = 1.0 / op.diag()

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.inv_diag

    def block_solve(self, v: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        # P[F,F] r_F = v  =>  r_F = v / inv_diag[F]
        return v / self.op.partition.restrict(self.inv_diag, blocks)

    def offblock_apply(self, r: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        return torch.zeros_like(self.op.partition.restrict(r, blocks))


class BlockJacobiPreconditioner:
    """P = blockdiag(A[s,s]^{-1}) aligned with the process blocks.

    ``apply`` solves the per-block systems with dense Cholesky factors
    made once on the operator's device (test scale, as in the
    reference; production would use a local CG).  For reconstruction,
    ``P[F,F]^{-1} = blockdiag(A[s,s])``: the *forward* local stencil
    application, so ``block_solve`` is exact and runs K1.
    """

    def __init__(self, op):
        self.op = op
        bs = op.partition.block_size
        eye = torch.eye(bs, dtype=op.dtype, device=op.device)
        # column j of A[s,s] is A[s,s] e_j: one batched apply per block
        self._chol = torch.stack([
            torch.linalg.cholesky(op.inblock_apply(eye, [b]).T)
            for b in range(op.nblocks)])

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.op.partition.map_blocks(r, self._solve_blocks)

    def _solve_blocks(self, r: torch.Tensor, blocks: Tuple[int, ...]
                      ) -> torch.Tensor:
        """``P r`` on the part ``r`` of a vector over the consecutive
        ``blocks`` (leading dimensions a batch)."""
        rb = r.reshape(*r.shape[:-1], len(blocks),
                       self.op.partition.block_size, 1)
        return torch.cholesky_solve(rb, self.factors(blocks)).reshape(r.shape)

    def factors(self, blocks: Tuple[int, ...]) -> torch.Tensor:
        """The Cholesky factors of the consecutive ``blocks``: those made
        at construction, or the copy a mesh placed on their shard's
        device (``sharding.place_preconditioner``)."""
        placed = self.__dict__.get("placed_factors", {}).get(tuple(blocks))
        if placed is not None:
            return placed
        return self._chol[blocks[0]:blocks[-1] + 1]

    def block_solve(self, v: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        # P[F,F] r_F = v  =>  r_F = blockdiag(A[s,s]) v : per-block forward apply
        vb = v.reshape(len(blocks), self.op.partition.block_size)
        return torch.cat([self.op.inblock_apply(vb[i], [b])
                          for i, b in enumerate(blocks)])

    def offblock_apply(self, r: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
        return torch.zeros_like(self.op.partition.restrict(r, blocks))


PRECONDITIONERS = {
    "identity": IdentityPreconditioner,
    "jacobi": JacobiPreconditioner,
    "block_jacobi": BlockJacobiPreconditioner,
}


def make_poisson_problem(
    nz: int, ny: int, nx: int, nblocks: int,
    dtype: torch.dtype = torch.float64, seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[StencilOperator, torch.Tensor]:
    """Stencil operator + smooth right-hand side (paper's benchmark
    problem), built on ``device``.  ``seed`` is accepted for the
    reference's signature; the right-hand side is deterministic."""
    op = StencilOperator(nz, ny, nx, nblocks, dtype, device)
    lin = [torch.linspace(0, 1, m, dtype=torch.float64, device=op.device)
           for m in (nz, ny, nx)]
    z, y, x = torch.meshgrid(*lin, indexing="ij")
    b = torch.sin(torch.pi * x) * torch.sin(torch.pi * y) * torch.sin(torch.pi * z) + 0.1
    return op, b.reshape(-1).to(dtype)
