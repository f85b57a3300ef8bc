"""Core numerics of the port: operators, state and wire format, the PCG
iteration and its fused perf path, exact reconstruction, and the ESR and
NVM-ESR backends.

Public API (the reference's ``repro/core/__init__.py`` names that the
port has):

- :func:`repro_torch.core.pcg.solve_jit` (the CUDA-graph perf path),
  :func:`~repro_torch.core.pcg.init_state`,
  :func:`~repro_torch.core.pcg.make_step`
- operators/preconditioners in :mod:`repro_torch.core.poisson`
- recovery backends: :class:`repro_torch.core.esr.InMemoryESR`,
  :class:`repro_torch.core.nvm_esr.NVMESRHomogeneous`,
  :class:`repro_torch.core.nvm_esr.NVMESRPRD`
- :func:`repro_torch.core.reconstruction.reconstruct` (Algorithm 3/5)
"""
from repro_torch.core.pcg import init_state, make_step, solve_jit  # noqa: F401
from repro_torch.core.poisson import (  # noqa: F401
    BlockJacobiPreconditioner,
    BlockPartition,
    DenseOperator,
    IdentityPreconditioner,
    JacobiPreconditioner,
    PRECONDITIONERS,
    StencilOperator,
    make_poisson_problem,
    random_spd,
    stencil7,
)
from repro_torch.core.esr import InMemoryESR, UnrecoverableFailure  # noqa: F401
from repro_torch.core.nvm_esr import NVMESRHomogeneous, NVMESRPRD  # noqa: F401
from repro_torch.core.reconstruction import reconstruct  # noqa: F401
from repro_torch.core.state import (  # noqa: F401
    PCG_SCHEMA,
    PCGState,
    RecoverySchema,
    RecoverySet,
)
