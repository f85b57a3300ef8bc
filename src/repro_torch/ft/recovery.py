"""Training-side failure handling: detection, restore, elastic re-place
(port of ``repro/ft/recovery.py``).

The runtime loop (``launch/train.py``) wraps every step with
:class:`TrainingRecovery`.  On a (simulated or real) host failure the
volatile training state is lost; recovery restores the newest valid NVM
checkpoint and resumes, placing the restored arrays on the current
device.  Straggler mitigation: persistently slow persist drains push the
Young/Daly period up via the tuner, and the async drain keeps stragglers
off the critical path entirely.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.ft.checkpoint import NVMCheckpointManager
from repro_torch.ft.period import PersistencePeriodTuner


def inject_host_failure(tree: Any) -> Any:
    """Simulate loss of volatile state: every tensor of ``tree`` (nested
    dicts, lists and tuples; a module stands for its parameters) becomes
    garbage in place — NaN for floats, zero for integers — as the state
    a model and its optimizer hold is lost where it lives.  Returns
    ``tree``."""
    if isinstance(tree, torch.nn.Module):
        inject_host_failure(list(tree.parameters()))
    elif isinstance(tree, dict):
        for v in tree.values():
            inject_host_failure(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            inject_host_failure(v)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.fill_(float("nan") if tree.is_floating_point() else 0)
    return tree


@dataclasses.dataclass
class TrainingRecovery:
    manager: NVMCheckpointManager
    tuner: PersistencePeriodTuner
    device: Optional[Union[str, torch.device]] = None
    failures_recovered: int = 0
    steps_wasted: int = 0

    def maybe_persist(self, state: Any, step: int,
                      extra: Optional[Dict[str, Any]] = None) -> bool:
        """Persist iff the adaptive period says so.  Async (PSCW overlap).
        ``state`` is a tree, or a function returning one, called only
        when the step persists."""
        if step % self.tuner.period == 0:
            t0 = time.monotonic()
            self.manager.save_async(state, step, extra)
            # origin-visible cost only (snapshot); drain overlaps compute
            self.tuner.observe(max(time.monotonic() - t0, 1e-9),
                               self.tuner._step or 1e-3)
            return True
        return False

    def observe_step(self, step_time_s: float) -> None:
        self.tuner.observe(self.tuner._delta or 1e-9, step_time_s)

    def recover(self, like: Any, failed_step: int
                ) -> Tuple[Any, int, Dict[str, Any]]:
        """Restore newest valid checkpoint; count wasted steps (ESRP cost)."""
        self.manager.join()
        got = self.manager.restore(like, self.device)
        if got is None:
            raise RuntimeError("no valid checkpoint to recover from")
        state, step, extra = got
        self.failures_recovered += 1
        self.steps_wasted += max(failed_step - step, 0)
        return state, step, extra
