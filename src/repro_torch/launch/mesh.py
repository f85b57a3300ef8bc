"""The card's constants and the production layouts on one card (port of
``repro/launch/mesh.py``).

This module is the one home of what the port knows about the card: its
HBM rate by model name, the peak operation rates by dtype and its
memory.  Every roofline bound of the port (:mod:`repro_torch.launch.
roofline`, ``chip_smoke.py``) divides by these.  The rates are NVIDIA's
data-sheet figures; a card whose name matches none of them raises rather
than being guessed at.

The reference's production meshes (16x16 = 256 devices, 2x16x16 = 512)
become one-card :class:`~repro_torch.distributed.sharding.DataMesh` es
of 256 or 512 shards for the solver (:func:`make_data_mesh`): every
shard's z-slab lives on the card; for the LM dry run they are
:class:`~repro_torch.distributed.sharding.LogicalMesh` es of axis names
and extents (:func:`make_production_mesh`), whose collectives cross the
network at :data:`NETWORK_RATE`.  The reference's elastic ``make_mesh_for`` (the
``(data, model)`` mesh of the LM axis rules) keeps its arithmetic
(:func:`mesh_shape_for`); for more than one device it is a
:class:`~repro_torch.distributed.sharding.DeviceMesh` the LM stack
serves over, its shards spanning the visible cards or repeating one.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed import sharding

#: HBM rate (bytes/s) by card model, from NVIDIA's data sheets, matched
#: in order against the card's name: the SXM part is the default for an
#: H100 whose name says neither PCIe nor NVL.
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
#: peak rates (op/s) by dtype, NVIDIA's H100 SXM data sheet: float64
#: and float32 outside the tensor cores, bfloat16 the tensor cores'
#: dense rate (without sparsity)
PEAK_OPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
#: the reference's production layouts and their device (here: shard)
#: counts
LAYOUTS = {"16x16": 256, "2x16x16": 512}
#: the network rate (bytes/s, one direction) a GPU has to the rest of a
#: cluster: one ConnectX-7 NDR InfiniBand link of 400 Gb/s a GPU (NVIDIA
#: DGX H100 data sheet: eight 400 Gb/s compute ports for its eight GPUs).
#: It bounds every collective over a mesh axis longer than one 8-GPU
#: HGX H100 node, as both production axes (16) are; NVLink's 450 GB/s a
#: direction holds only inside a node.
NETWORK_RATE = 400e9 / 8


def hbm_rate(name: str) -> float:
    """The HBM rate (bytes/s) of the card called ``name``
    (``torch.cuda.get_device_name``); raises for a card with no known
    rate."""
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise ValueError(f"no memory rate known for card {name!r}")


def device_hbm_rate(device: Union[str, torch.device] = "cuda",
                    rate: Optional[float] = None) -> float:
    """The HBM rate (bytes/s) of the device the shards live on: on the
    card, :func:`hbm_rate` of its name; on the CPU, the caller's
    ``rate`` (no card's rate is assumed)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return hbm_rate(torch.cuda.get_device_name(dev))
    if rate is None:
        raise ValueError("on the CPU the memory rate must be given "
                         "(hbm_rate); no card's rate is assumed")
    return float(rate)


def peak_ops(dtype: Union[str, torch.dtype]) -> float:
    """The card's peak operation rate (op/s) for ``dtype``."""
    key = str(dtype).replace("torch.", "")
    if key not in PEAK_OPS:
        raise ValueError(f"no peak rate known for dtype {key!r}")
    return PEAK_OPS[key]


def device_memory_bytes(device: Union[str, torch.device] = "cuda",
                        memory_bytes: Optional[int] = None) -> int:
    """The memory of the device the shards live on: on the card, read
    from ``torch.cuda.get_device_properties``; on the CPU, the caller's
    ``memory_bytes`` (no card's size is assumed)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    if memory_bytes is None:
        raise ValueError("on the CPU the device memory must be given "
                         "(memory_bytes); no card's size is assumed")
    return int(memory_bytes)


def card_identity(device: Union[str, torch.device] = "cuda") -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (``{"name": "cpu",
    "power_limit": None}`` on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    name, _, limit = smi.stdout.strip().partition(", ")
    return {"name": name, "power_limit": limit}


def make_data_mesh(shards: int, device: Union[str, torch.device] = "cuda"
                   ) -> sharding.DataMesh:
    """The one-card data mesh of a production layout: 256 shards (the
    16x16 layout) or 512 (2x16x16), all on ``device``."""
    if shards not in LAYOUTS.values():
        raise ValueError(f"a production layout has {sorted(LAYOUTS.values())} "
                         f"shards, got {shards}")
    return sharding.make_data_mesh(shards, device)


def make_production_mesh(multi_pod: bool = False) -> sharding.LogicalMesh:
    """The reference's production mesh as axis names and extents:
    ``(data=16, model=16)``, 256 chips, or with ``multi_pod`` ``(pod=2,
    data=16, model=16)``, 512.  Nothing is placed on it: the LM dry run
    reads per-device shapes and collective extents from it
    (:func:`repro_torch.distributed.sharding.shard_shape`)."""
    if multi_pod:
        return sharding.LogicalMesh(("pod", "data", "model"),
                                    {"pod": 2, "data": 16, "model": 16})
    return sharding.LogicalMesh(("data", "model"), {"data": 16, "model": 16})


def mesh_shape_for(devices: int, model_parallel: Optional[int] = None
                   ) -> Tuple[int, int]:
    """The ``(data, model)`` layout of the LM axis rules for ``devices``
    devices, the reference's arithmetic: the model axis is
    ``model_parallel`` (default ``min(devices, 16)``) shrunk to a
    divisor of ``devices``."""
    model = model_parallel or min(devices, 16)
    while devices % model:
        model -= 1
    return devices // model, model


def make_mesh_for(devices: int, model_parallel: Optional[int] = None,
                  device: Union[str, torch.device] = "cuda"):
    """The ``(data, model)`` mesh for ``devices`` devices, with the
    reference's arithmetic (:func:`mesh_shape_for`).  One device is the
    ``(1, 1)`` :class:`~repro_torch.distributed.sharding.LogicalMesh`,
    under which the axis rules map every tensor whole and the LM stack
    runs mesh-less.  More are a :class:`~repro_torch.distributed.
    sharding.DeviceMesh` of ``devices`` shards on ``device``: with
    ``"cuda"`` (no index) they span the visible cards, shard ``s`` on
    card ``s * c // devices``, the one card repeated when there is one;
    an indexed card or ``"cpu"`` holds every shard."""
    data, model = mesh_shape_for(devices, model_parallel)
    if devices == 1:
        return sharding.LogicalMesh(("data", "model"),
                                    {"data": data, "model": model})
    return sharding.make_device_mesh(data, model, device)
