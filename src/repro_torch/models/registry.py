"""Architecture registry (port of ``repro/models/registry.py``): config
discovery, parameter and cache initialisation, the training forward the
train step differentiates, and the prefill and decode step functions
the :class:`~repro_torch.serving.engine.ServeEngine` runs.

Every architecture is a module in :mod:`repro_torch.configs` exposing
``CONFIG`` (the published shape) and ``SMOKE`` (a reduced same-family
config for CPU tests).  The dry-run cells (``build_cell``,
``abstract_*``, ``batch_structs``, ``Cell``) come with the LM dry-run
slice (ROADMAP, Queue 1, item 3.3).

The reference keeps parameters in a pytree with a pattern group's layers
stacked along a leading axis; :func:`reference_path` says where each of
the port's parameters lives in it, and :func:`reference_leaf_order`
lists them in that tree's flatten order.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init

ARCH_IDS = [
    "moonshot_v1_16b_a3b",
    "dbrx_132b",
    "granite_20b",
    "starcoder2_3b",
    "llama3_8b",
    "gemma3_12b",
    "whisper_small",
    "mamba2_370m",
    "recurrentgemma_9b",
    "qwen2_vl_72b",
]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str      # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.SMOKE if smoke else mod.CONFIG


def cells_for(cfg: ModelConfig) -> List[str]:
    """The assigned shape cells applicable to this arch (long_500k only
    for the sub-quadratic families)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.long_ok:
        cells.append("long_500k")
    return cells


# ----------------------------------------------------------------------
# init / forward dispatch
# ----------------------------------------------------------------------
def build_model(cfg: ModelConfig, init: Init) -> nn.Module:
    """The family's module, its parameters made by ``init``."""
    if cfg.family == "encdec":
        return E.EncDec(cfg, init)
    return T.Decoder(cfg, init)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda") -> nn.Module:
    """The model of ``cfg`` with random parameters, made on ``device``
    (the card unless the caller asks for the CPU) and drawn from
    ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    none is given).  There are no pretrained weights: the reference
    initialises from ``jax.random`` the same way."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters on {dev}")
    return build_model(cfg, Init(dev, generator))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: Union[str, torch.device] = "cuda") -> list:
    """Zeroed decode caches in the compute dtype on ``device``: one entry
    a layer."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return E.init_encdec_cache(cfg, batch, max_seq, cfg.cdt, dev)
    return T.init_decoder_cache(cfg, batch, max_seq, cfg.cdt, dev)


def reference_path(cfg: ModelConfig, name: str
                   ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where the port's parameter ``name`` lives in the reference's tree:
    its path and, for a stacked leaf, its row (layer ``g * period + j``
    is row ``g`` of group slot ``j``; the encoder-decoder stacks every
    ``enc``/``dec`` layer)."""
    parts = tuple(name.split("."))
    if parts[0] == "layers":
        layer, rest = int(parts[1]), parts[2:]
        period = cfg.group_size
        if layer < cfg.n_groups * period:
            g, j = divmod(layer, period)
            return ("groups", str(j)) + rest, g
        return ("tail", str(layer - cfg.n_groups * period)) + rest, None
    if parts[0] in ("enc", "dec"):
        return (parts[0],) + parts[2:], int(parts[1])
    return parts, None


def reference_leaf_order(model: nn.Module) -> List[List[str]]:
    """The model's parameter names grouped by the reference's leaves, in
    the order ``jax.tree.leaves`` visits them (sorted dict keys, so
    sorted paths), a stacked leaf's rows in row order."""
    leaves: Dict[Tuple[str, ...], list] = {}
    for name, _ in model.named_parameters():
        path, row = reference_path(model.cfg, name)
        leaves.setdefault(path, []).append((row or 0, name))
    return [[name for _, name in sorted(rows)]
            for _, rows in sorted(leaves.items())]


def make_train_forward(cfg: ModelConfig) -> Callable:
    """forward(model, batch) -> (logits, aux), every layer checkpointed
    (``remat=True``); the encoder-decoder's aux is a zero f32 scalar."""
    if cfg.family == "encdec":
        def forward(model, batch):
            enc_out = E.encode(model, batch["frames"], cfg, remat=True)
            logits, _ = E.decode(model, batch["tokens"], enc_out, cfg,
                                 remat=True)
            return logits, torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
        return forward

    def forward(model, batch):
        logits, _, aux = T.decoder_forward(
            model, batch["tokens"], cfg, positions=batch.get("positions"),
            remat=True)
        return logits, aux
    return forward


def make_prefill(cfg: ModelConfig) -> Callable:
    """prefill(model, inputs, caches) -> (logits, caches)."""
    if cfg.family == "encdec":
        def prefill(model, inputs, caches):
            enc_out = E.encode(model, inputs["frames"], cfg)
            return E.decode(model, inputs["tokens"], enc_out, cfg,
                            caches=caches, cache_index=0)
        return prefill

    def prefill(model, inputs, caches):
        tokens = inputs["tokens"] if isinstance(inputs, dict) else inputs
        pos = inputs.get("positions") if isinstance(inputs, dict) else None
        logits, caches, _ = T.decoder_forward(
            model, tokens, cfg, caches=caches, cache_index=0, positions=pos)
        return logits, caches
    return prefill


def make_decode(cfg: ModelConfig) -> Callable:
    """decode(model, tok (B,1), caches, index) -> (logits, caches)."""
    if cfg.family == "encdec":
        def decode(model, tok, caches, index):
            return E.decode(model, tok, None, cfg, caches=caches,
                            cache_index=index)
        return decode

    def decode(model, tok, caches, index):
        logits, caches, _ = T.decoder_forward(model, tok, cfg, caches=caches,
                                              cache_index=index)
        return logits, caches
    return decode
