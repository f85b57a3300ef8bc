"""Architecture registry (port of ``repro/models/registry.py``): config
discovery, parameter and cache initialisation, the training forward the
train step differentiates, and the prefill and decode step functions
the :class:`~repro_torch.serving.engine.ServeEngine` runs.

Every architecture is a module in :mod:`repro_torch.configs` exposing
``CONFIG`` (the published shape) and ``SMOKE`` (a reduced same-family
config for CPU tests).  The dry run's half builds, per (arch, shape)
cell, the step function with abstract (``meta``) stand-ins of its
inputs, their logical specs and, under an :class:`~repro_torch.
distributed.sharding.AxisRules`, each leaf's physical spec and
per-device shape (``build_cell``, ``abstract_*``, ``batch_structs``,
``specs_to_physical``, ``Cell``): nothing is allocated.

Over a :class:`~repro_torch.distributed.sharding.DeviceMesh` (``mesh=``)
every family serves tensor-, expert- and data-parallel: the decoder LMs
with token prompts or the vision frontend's patch embeddings and M-RoPE
positions, the hybrid RG-LRU and SSD stacks and the encoder-decoder.
:func:`init_params` and :func:`init_caches` place every leaf by its
logical spec under :func:`serving_rules` (one
:class:`~repro_torch.distributed.sharding.Placed` a leaf, made leaf by
leaf, never the whole model on one device), and the step functions run
under those rules.  Every family also trains over a mesh
(:func:`make_train_forward`).

The reference keeps parameters in a pytree with a pattern group's layers
stacked along a leading axis; :func:`reference_path` says where each of
the port's parameters lives in it, and :func:`reference_leaf_order`
lists them in that tree's flatten order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import (DEFAULT_RULES, AxisRules,
                                              DeviceMesh, Placed, Spec,
                                              physical_spec, place,
                                              placed_full, shard_shape,
                                              spec_for_shape, use_rules)
from repro_torch.models import encdec as E
from repro_torch.models import moe as M
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
                device: Union[str, torch.device] = "cuda",
                mesh: Optional[DeviceMesh] = None) -> nn.Module:
    """The model of ``cfg`` with random parameters, made on ``device``
    (the card unless the caller asks for the CPU) and drawn from
    ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    none is given).  There are no pretrained weights: the reference
    initialises from ``jax.random`` the same way.

    With ``mesh`` every parameter is drawn whole on the mesh's first
    device, in the order the one-device model draws them (so the values
    are that model's), placed by :func:`place_parameters` and dropped
    before the next is drawn."""
    dev = resolve_device(device if mesh is None else mesh.device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters on {dev}")
    if mesh is None:
        return build_model(cfg, Init(dev, generator))
    recorder = _Recorder()
    model = build_model(cfg, recorder)
    names = {id(p): name for name, p in model.named_parameters()}
    init = Init(dev, generator)
    values = ((names[id(p)], getattr(init, kind)(*args))
              for p, kind, args in recorder.made)
    return place_parameters(model, mesh, values)


class _Recorder(Init):
    """An :class:`Init` on the meta device that records, in construction
    order, each parameter it makes with the call that made it."""

    def __init__(self):
        super().__init__(META)
        self.made: list = []

    def dense(self, shape, dtype, fan_in=None):
        p = super().dense(shape, dtype, fan_in)
        self.made.append((p, "dense", (shape, dtype, fan_in)))
        return p

    def full(self, shape, value, dtype):
        p = super().full(shape, value, dtype)
        self.made.append((p, "full", (shape, value, dtype)))
        return p

    def const(self, values):
        p = super().const(values)
        self.made.append((p, "const", (values,)))
        return p


def serving_rules(cfg: ModelConfig, mesh) -> AxisRules:
    """The reference's axis rules over ``mesh`` as it serves: the
    default rules, without the fsdp axis when ``cfg.serve_resident``
    keeps the weights resident (``registry.py:219-226``; no config sets
    it, so fsdp stays on ``data``)."""
    rules = dict(DEFAULT_RULES)
    if cfg.serve_resident:
        rules["fsdp"] = None
    return AxisRules(mesh, rules)


def check_mesh_config(cfg: ModelConfig, mesh) -> None:
    """Raise ``ValueError`` for what the reference refuses to serve over
    ``mesh``: an MoE whose expert count the ``model`` extent does not
    divide (:func:`~repro_torch.models.moe.check_expert_split`).  Every
    family serves over a mesh."""
    M.check_expert_split(cfg, mesh)


def place_parameters(model: nn.Module, mesh: DeviceMesh, values
                     ) -> nn.Module:
    """``model`` (built on ``meta``) with its parameters placed on
    ``mesh``: ``values`` yields ``(name, whole tensor)`` pairs, one at a
    time, and each is placed by its logical spec under
    :func:`serving_rules` and set on its module as a :class:`Placed` in
    place of the parameter.  The model gets ``mesh`` and ``rules``.  The
    pieces require no grad until the model trains (:func:`trainable`):
    a serving step's matrix products then take the path they took before
    training existed, and give its bits."""
    cfg = model.cfg
    check_mesh_config(cfg, mesh)
    rules = serving_rules(cfg, mesh)
    specs = param_specs(cfg)
    for name, value in values:
        path, row = reference_path(cfg, name)
        logical = specs[path][1:] if row is not None else specs[path]
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        value = value.detach().to(module._parameters[leaf].dtype)
        del module._parameters[leaf]
        setattr(module, leaf, place(value, mesh, physical_spec(
            rules, value.shape, logical)))
    model.mesh, model.rules = mesh, rules
    return model


def trainable(model: nn.Module) -> nn.Module:
    """``model`` with every placed piece a leaf that requires grad, its
    ``.grad`` landing on its own shard, as a one-device model's
    parameters are (the training forward calls it on a placed model)."""
    for _, leaf in placed_leaves(model):
        for piece in leaf.pieces:
            if not piece.requires_grad:
                piece.requires_grad_(True)
    return model


def placed_leaves(tree) -> List[Tuple[str, Placed]]:
    """Every :class:`Placed` of a placed model (its parameters, by
    name) or of placed caches (by layer and entry, an encoder-decoder's
    ``self`` and ``cross`` entries by part)."""
    if isinstance(tree, nn.Module):
        return [((f"{prefix}." if prefix else "") + key, val)
                for prefix, module in tree.named_modules()
                for key, val in vars(module).items()
                if isinstance(val, Placed)]
    return [(f"{i}.{key}" + ("" if sub is None else f".{sub}"), leaf)
            for i, cache in enumerate(tree) for key, val in cache.items()
            for sub, leaf in (val.items() if isinstance(val, dict)
                              else [(None, val)])]


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: Union[str, torch.device] = "cuda",
                mesh: Optional[DeviceMesh] = None) -> list:
    """Zeroed decode caches in the compute dtype on ``device``: one entry
    a layer.  With ``mesh`` each entry is placed from its logical spec
    (``kv_seq`` on ``model``, ``batch`` on ``data``, the recurrent and
    SSD states' channels and heads on ``model``; an encoder-decoder's
    ``self`` and ``cross`` K/V as a global layer's) under
    :func:`serving_rules`, each piece made on its shard."""
    if mesh is not None:
        rules = serving_rules(cfg, mesh)

        def placed(layer, specs):
            return {key: placed(t, specs[key]) if isinstance(t, dict)
                    else placed_full(t.shape, physical_spec(
                        rules, t.shape, specs[key]), mesh,
                        -1 if key == "pos" else 0, t.dtype)
                    for key, t in layer.items()}

        if cfg.family == "encdec":
            kv = T.layer_cache_specs("global")
            return [placed(layer, {"self": kv, "cross": kv})
                    for layer in E.init_encdec_cache(cfg, batch, max_seq,
                                                     cfg.cdt, META)]
        return [placed(layer, T.layer_cache_specs(kind))
                for kind, layer in zip(T.layer_kinds(cfg), T.init_decoder_cache(
                    cfg, batch, max_seq, cfg.cdt, META))]
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


def reference_cache_path(cfg: ModelConfig, layer: int
                         ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where layer ``layer``'s decode cache lives in the reference's
    cache tree: its entry's path and, for a stacked entry, its row (a
    pattern group's caches are stacked as its parameters are; the
    encoder-decoder's ``self`` and ``cross`` caches stack every decoder
    layer under the root)."""
    if cfg.family == "encdec":
        return (), layer
    period = cfg.group_size
    if layer < cfg.n_groups * period:
        g, j = divmod(layer, period)
        return ("groups", str(j)), g
    return ("tail", str(layer - cfg.n_groups * period)), None


def named_leaves(model: nn.Module) -> List[Tuple[str, Union[torch.Tensor,
                                                          Placed]]]:
    """The model's parameters by name: ``named_parameters()`` for a
    one-device model, :func:`placed_leaves` for a placed one (whose
    leaves ``named_parameters()`` does not see)."""
    if getattr(model, "mesh", None) is not None:
        return placed_leaves(model)
    return list(model.named_parameters())


def reference_leaf_order(model: nn.Module) -> List[List[str]]:
    """The model's parameter names grouped by the reference's leaves, in
    the order ``jax.tree.leaves`` visits them (sorted dict keys, so
    sorted paths), a stacked leaf's rows in row order."""
    leaves: Dict[Tuple[str, ...], list] = {}
    for name, _ in named_leaves(model):
        path, row = reference_path(model.cfg, name)
        leaves.setdefault(path, []).append((row or 0, name))
    return [[name for _, name in sorted(rows)]
            for _, rows in sorted(leaves.items())]


def make_train_forward(cfg: ModelConfig) -> Callable:
    """forward(model, batch) -> (logits, aux), every layer checkpointed
    (``remat=True``); the encoder-decoder's aux is a zero f32 scalar.  A
    placed model runs under its mesh rules, as prefill and decode do,
    its pieces made leaves that require grad (:func:`trainable`): the
    logits come back whole and the aux averaged over the shards, on the
    mesh's first device."""
    if cfg.family == "encdec":
        def forward(model, batch):
            if getattr(model, "mesh", None) is not None:
                trainable(model)
            with _rules_of(model):
                enc_out = E.encode(model, batch["frames"], cfg, remat=True)
                logits, _ = E.decode(model, batch["tokens"], enc_out, cfg,
                                     remat=True)
            return logits, torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
        return forward

    def forward(model, batch):
        if getattr(model, "mesh", None) is not None:
            trainable(model)
        with _rules_of(model):
            logits, _, aux = T.decoder_forward(
                model, batch["tokens"], cfg, positions=batch.get("positions"),
                remat=True)
        return logits, aux
    return forward


def _rules_of(model):
    """The axis rules a placed model runs under (a no-op context for a
    one-device model)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return contextlib.nullcontext()
    return use_rules(mesh, model.rules.rules)


def make_prefill(cfg: ModelConfig) -> Callable:
    """prefill(model, inputs, caches) -> (logits, caches), under the
    model's mesh rules when it is placed."""
    if cfg.family == "encdec":
        def prefill(model, inputs, caches):
            with _rules_of(model):
                enc_out = E.encode(model, inputs["frames"], cfg)
                return E.decode(model, inputs["tokens"], enc_out, cfg,
                                caches=caches, cache_index=0)
        return prefill

    def prefill(model, inputs, caches):
        tokens = inputs["tokens"] if isinstance(inputs, dict) else inputs
        pos = inputs.get("positions") if isinstance(inputs, dict) else None
        with _rules_of(model):
            logits, caches, _ = T.decoder_forward(
                model, tokens, cfg, caches=caches, cache_index=0,
                positions=pos)
        return logits, caches
    return prefill


def make_decode(cfg: ModelConfig) -> Callable:
    """decode(model, tok (B,1), caches, index) -> (logits, caches), under
    the model's mesh rules when it is placed."""
    if cfg.family == "encdec":
        def decode(model, tok, caches, index):
            with _rules_of(model):
                return E.decode(model, tok, None, cfg, caches=caches,
                                cache_index=index)
        return decode

    def decode(model, tok, caches, index):
        with _rules_of(model):
            logits, caches, _ = T.decoder_forward(
                model, tok, cfg, caches=caches, cache_index=index)
        return logits, caches
    return decode


# ----------------------------------------------------------------------
# dry-run cell construction (meta stand-ins and their layout, no
# allocation)
# ----------------------------------------------------------------------
META = torch.device("meta")


class Physical(NamedTuple):
    """One leaf's layout under the axis rules: its physical spec
    (``spec_for_shape``) and per-device shape (``shard_shape``)."""

    spec: Spec
    shape: Tuple[int, ...]


def param_specs(cfg: ModelConfig) -> Dict[Tuple[str, ...], Spec]:
    """Every parameter leaf's logical spec by its reference path."""
    if cfg.family == "encdec":
        return E.param_specs(cfg)
    return T.param_specs(cfg)


def cache_specs(cfg: ModelConfig) -> Dict[Tuple[str, ...], Spec]:
    """Every cache leaf's logical spec by its reference path."""
    if cfg.family == "encdec":
        return E.cache_specs(cfg)
    return T.cache_specs(cfg)


def _stacked(rows: Dict[Tuple[str, ...], list]) -> Dict[Tuple[str, ...],
                                                        torch.Tensor]:
    """Meta stand-ins of the reference's leaves from the port's tensors
    grouped by leaf: ``[(row, tensor), ...]``, a stacked leaf's rows
    along a new leading axis."""
    out = {}
    for path, ts in rows.items():
        row, t = ts[0]
        shape = tuple(t.shape) if row is None else (len(ts),) + tuple(t.shape)
        out[path] = torch.empty(shape, dtype=t.dtype, device=META)
    return out


def abstract_params(cfg: ModelConfig
                    ) -> Tuple[Dict[Tuple[str, ...], torch.Tensor],
                               Dict[Tuple[str, ...], Spec]]:
    """``(structs, specs)``: a meta tensor of every reference parameter
    leaf (stacked leaves whole), keyed by its path, and its logical
    spec.  The model is built on the ``meta`` device: nothing is
    allocated."""
    model = build_model(cfg, Init(META))
    rows: Dict[Tuple[str, ...], list] = {}
    for name, param in model.named_parameters():
        path, row = reference_path(cfg, name)
        rows.setdefault(path, []).append((row, param))
    return _stacked(rows), param_specs(cfg)


def abstract_caches(cfg: ModelConfig, batch: int, max_seq: int
                    ) -> Tuple[Dict[Tuple[str, ...], torch.Tensor],
                               Dict[Tuple[str, ...], Spec]]:
    """``(structs, specs)`` of the decode caches in the compute dtype,
    as :func:`abstract_params` gives the parameters."""
    if cfg.family == "encdec":
        layers = E.init_encdec_cache(cfg, batch, max_seq, cfg.cdt, META)
    else:
        layers = T.init_decoder_cache(cfg, batch, max_seq, cfg.cdt, META)
    rows: Dict[Tuple[str, ...], list] = {}
    for layer, cache in enumerate(layers):
        prefix, row = reference_cache_path(cfg, layer)
        for key, val in cache.items():
            leaves = val.items() if isinstance(val, dict) else [(None, val)]
            for sub, t in leaves:
                path = prefix + (key,) + (() if sub is None else (sub,))
                rows.setdefault(path, []).append((row, t))
    return _stacked(rows), cache_specs(cfg)


def batch_structs(cfg: ModelConfig, shape: Shape
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """(meta structs, logical specs) of one training batch: int32
    ``tokens (b, s)``, or for the vision frontend ``(b, s, d_model)``
    patch embeddings in ``cdt`` with int32 ``positions (3, b, s)``; the
    encoder-decoder's ``frames (b, enc_seq, d_model)`` in ``cdt``; int32
    ``targets (b, s)``."""
    b, s = shape.batch, shape.seq
    empty = functools.partial(torch.empty, device=META)
    structs: Dict[str, torch.Tensor] = {}
    specs: Dict[str, Spec] = {}
    if cfg.frontend == "vision":
        structs["tokens"] = empty((b, s, cfg.d_model), dtype=cfg.cdt)
        specs["tokens"] = ("batch", None, None)
        structs["positions"] = empty((3, b, s), dtype=torch.int32)
        specs["positions"] = (None, "batch", None)
    else:
        structs["tokens"] = empty((b, s), dtype=torch.int32)
        specs["tokens"] = ("batch", None)
    if cfg.family == "encdec":
        structs["frames"] = empty((b, cfg.enc_seq, cfg.d_model), dtype=cfg.cdt)
        specs["frames"] = ("batch", None, None)
    structs["targets"] = empty((b, s), dtype=torch.int32)
    specs["targets"] = ("batch", None)
    return structs, specs


def specs_to_physical(spec_tree, rules: AxisRules, struct_tree):
    """Logical specs -> :class:`Physical` leaves, shape-aware (a
    dimension whose mesh extent does not divide it degrades to
    replication, per tensor): the counterpart of the reference's
    ``_specs_to_shardings(spec_tree, rules, struct_tree)``.  The trees
    are dicts with the same keys; their leaves are spec tuples and
    tensors."""
    if isinstance(struct_tree, dict):
        return {k: specs_to_physical(spec_tree[k], rules, v)
                for k, v in struct_tree.items()}
    shape = tuple(struct_tree.shape)
    return Physical(spec_for_shape(rules, shape, spec_tree),
                    shard_shape(rules, shape, spec_tree))


def tree_leaves(tree):
    """The leaves of a tree of dicts, in its order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def _serving(fn: Callable) -> Callable:
    """``fn`` under ``torch.inference_mode``, as the engine runs it."""
    @functools.wraps(fn)
    def run(*args):
        with torch.inference_mode():
            return fn(*args)
    return run


@dataclasses.dataclass
class Cell:
    """One (arch x shape) dry-run cell: its step function, the meta
    stand-ins of its arguments in the reference's layout, their layout
    under ``rules`` (one :class:`Physical` a leaf, same trees), the
    arguments the step updates in place (the reference's donated ones),
    and the config and rules it was built with.

    ``fn`` takes the port's arguments: ``(model, opt_state, batch)`` for
    training, ``(model, inputs, caches)`` for prefill and ``(model, tok,
    caches, index)`` for decode."""

    arch: str
    shape: Shape
    fn: Callable
    in_structs: Tuple
    in_shardings: Tuple
    donate: Tuple[int, ...] = ()
    cfg: Optional[ModelConfig] = None
    rules: Optional[AxisRules] = None

    def argument_bytes(self) -> int:
        """The per-device bytes of every argument: each leaf's
        per-device shape times its item size, summed."""
        total = 0
        for structs, phys in zip(self.in_structs, self.in_shardings):
            for st, ph in zip(tree_leaves(structs), tree_leaves(phys)):
                total += math.prod(ph.shape) * st.element_size()
        return total


def build_cell(cfg: ModelConfig, arch: str, shape_name: Union[str, Shape],
               rules: AxisRules, opt_cfg=None) -> Cell:
    """The cell of ``cfg`` at ``SHAPES[shape_name]`` (or at the
    :class:`Shape` given) under ``rules``.

    Training: ``(params, opt_state, batch)``, the first two updated in
    place (donated).  Prefill: ``(params, inputs, caches)`` (no
    ``targets``), the caches written.  Decode: one new token a row
    against a ``seq``-long cache: ``(params, tok (b, 1), caches,
    index)``.  With ``cfg.serve_resident`` a serving cell drops the
    ``fsdp`` axis from the rules (weights stay resident, replicated over
    ``data``)."""
    from repro_torch.training.optimizer import AdamWConfig, adamw_init_specs
    from repro_torch.training.train_step import TrainConfig, make_train_step

    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if cfg.serve_resident and shape.kind != "train":
        r = dict(rules.rules)
        r["fsdp"] = None
        rules = AxisRules(rules.mesh, r)
    params_structs, p_specs = abstract_params(cfg)
    params_sh = specs_to_physical(p_specs, rules, params_structs)

    if shape.kind == "train":
        step = make_train_step(make_train_forward(cfg), opt_cfg or AdamWConfig(),
                               TrainConfig(microbatches=cfg.microbatches))
        moments = {k: torch.empty(v.shape, dtype=torch.float32, device=META)
                   for k, v in params_structs.items()}
        opt_structs = {"m": moments, "v": dict(moments),
                       "step": torch.empty((), dtype=torch.int32, device=META)}
        opt_sh = specs_to_physical(adamw_init_specs(p_specs), rules,
                                   opt_structs)
        bstructs, bspecs = batch_structs(cfg, shape)
        b_sh = specs_to_physical(bspecs, rules, bstructs)
        return Cell(arch, shape, step, (params_structs, opt_structs, bstructs),
                    (params_sh, opt_sh, b_sh), donate=(0, 1), cfg=cfg,
                    rules=rules)

    cache_structs, c_specs = abstract_caches(cfg, shape.batch, shape.seq)
    cache_sh = specs_to_physical(c_specs, rules, cache_structs)
    if shape.kind == "prefill":
        bstructs, bspecs = batch_structs(cfg, shape)
        bstructs.pop("targets")
        bspecs.pop("targets")
        b_sh = specs_to_physical(bspecs, rules, bstructs)
        return Cell(arch, shape, _serving(make_prefill(cfg)),
                    (params_structs, bstructs, cache_structs),
                    (params_sh, b_sh, cache_sh), donate=(2,), cfg=cfg,
                    rules=rules)

    tok = torch.empty((shape.batch, 1), dtype=torch.int32, device=META)
    idx = torch.empty((), dtype=torch.int32, device=META)
    return Cell(arch, shape, _serving(make_decode(cfg)),
                (params_structs, tok, cache_structs, idx),
                (params_sh, specs_to_physical(("batch", None), rules, tok),
                 cache_sh, specs_to_physical((), rules, idx)),
                donate=(2,), cfg=cfg, rules=rules)
