"""The paper's own workload: PCG on the 7-point stencil of a 3-D Poisson
equation (HPCG-style), with ESR / NVM-ESR recovery (port of
``repro/configs/poisson_pcg.py``).

``GRIDS`` defines the dry-run problem sizes of the production layouts
(z sharded over 256 or 512 shards; on one card every shard lives on the
card, :func:`repro_torch.launch.mesh.make_data_mesh`) and ``SMOKE`` the
CPU test problem.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    name: str
    grid: Tuple[int, int, int]     # (nz, ny, nx)
    nblocks: int                   # process blocks (z-slabs)
    precond: str = "jacobi"
    esr_mode: str = "nvm"          # "none" | "nvm" | "inmemory"
    tol: float = 1e-10
    maxiter: int = 10_000
    persistence_period: int = 1
    persist_mode: str = "sync"     # "sync" | "overlap" (driver pipeline)
    variant: str = "auto"          # "auto" (baseline) | "shardmap" (explicit halos)

    def solve_config(self):
        """The generic-driver :class:`repro_torch.solvers.SolveConfig`
        slice of this launch config (grid/mesh/precond fields are
        launch-side)."""
        from repro_torch.solvers import SolveConfig

        return SolveConfig(tol=self.tol, maxiter=self.maxiter,
                           persistence_period=self.persistence_period,
                           persist_mode=self.persist_mode)


# dry-run cells: one pod-scale grid per ESR mode (512-way z sharding)
GRIDS = {
    "pcg_1g": SolverConfig("pcg_1g", (1024, 1024, 1024), 512),
    "pcg_1g_esr": SolverConfig("pcg_1g_esr", (1024, 1024, 1024), 512, esr_mode="inmemory"),
    "pcg_128m": SolverConfig("pcg_128m", (512, 512, 512), 512),
    "pcg_128m_esr": SolverConfig("pcg_128m_esr", (512, 512, 512), 512, esr_mode="inmemory"),
    # explicit-halo variants: one plane a neighbour, float32 shard sums
    "pcg_1g_opt": SolverConfig("pcg_1g_opt", (1024, 1024, 1024), 512, variant="shardmap"),
    "pcg_1g_esr_opt": SolverConfig("pcg_1g_esr_opt", (1024, 1024, 1024), 512,
                                   esr_mode="inmemory", variant="shardmap"),
}

SMOKE = SolverConfig("pcg_smoke", (16, 12, 10), 8)
