"""Plain PyTorch oracles for the hand-written kernels, under the
reference package's names (``repro/kernels/ref.py``).  Each is the plain
version that lives beside its kernel."""
from repro_torch.kernels.fused_cg import (  # noqa: F401
    block_dot_plain,
    fused_cg_update_plain as fused_cg_update_ref,
)
from repro_torch.kernels.stencil7 import stencil7_plain as stencil7_ref  # noqa: F401
