"""Device selection for the port's entry points, and CUDA-graph capture.

Entry points run on the card unless the caller asks for the CPU; with no
card visible a CUDA request raises instead of quietly running on the
CPU."""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence, Union

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
def capturing(graph: "torch.cuda.CUDAGraph", stream: "torch.cuda.Stream",
              devices: Sequence[int] = ()) -> Iterator[None]:
    """Capture the launches of the block into ``graph`` on ``stream``:
    ``torch.cuda.graph`` without the device synchronisation and the
    cache flushes it makes first, which cost each capture tens of
    milliseconds and which a capture after an eager warm-up on the same
    stream does not need.  A capture that fails raises.

    ``devices`` are the other cards whose streams join the capture.
    PyTorch routes only the capture's own card's allocations into the
    graph's private memory pool; on each card of ``devices`` this
    thread's allocations go into a pool of the same id for as long as
    the capture runs, so that no later allocation there reuses memory
    the graph writes.  Release those pools with :func:`release_pools`
    once the graph is gone."""
    pool = torch.cuda.graph_pool_handle() if devices else None
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        for d in devices:
            torch._C._cuda_beginAllocateToPool(d, pool)
        try:
            yield
        finally:
            for d in devices:
                torch._C._cuda_endAllocateToPool(d, pool)
            graph.capture_end()


def release_pools(devices: Sequence[int], pool) -> None:
    """Give back the other cards' pools of a capture made with
    :func:`capturing`'s ``devices`` (the graph's own card's pool goes
    with the graph)."""
    for d in devices:
        torch._C._cuda_releasePool(d, pool)
