"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; with no
card visible a CUDA request raises instead of quietly running on the
CPU."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default, but no CUDA "
            "device is visible; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
