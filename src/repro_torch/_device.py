"""Device selection for the port's entry points, and CUDA-graph capture.

Entry points run on the card unless the caller asks for the CPU; with no
card visible a CUDA request raises instead of quietly running on the
CPU."""
from __future__ import annotations

import contextlib
from typing import Iterator, Union

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


@contextlib.contextmanager
def capturing(graph: "torch.cuda.CUDAGraph",
              stream: "torch.cuda.Stream") -> Iterator[None]:
    """Capture the launches of the block into ``graph`` on ``stream``:
    ``torch.cuda.graph`` without the device synchronisation and the
    cache flushes it makes first, which cost each capture tens of
    milliseconds and which a capture after an eager warm-up on the same
    stream does not need.  A capture that fails raises."""
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            yield
        finally:
            graph.capture_end()
