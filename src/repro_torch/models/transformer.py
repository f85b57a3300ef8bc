"""Decoder-stack assembly for the "lm", "ssm" and "hybrid" families (port
of ``repro/models/transformer.py``).

The reference scans *pattern groups* of stacked parameters (gemma3's 5
local + 1 global, recurrentgemma's rec/rec/local) and runs the remainder
layers unrolled (recurrentgemma: 38 = 12*3 + 2).  Here every layer is
its own module in one ``nn.ModuleList``, in layer order: group ``g``,
pattern slot ``j`` is layer ``g * period + j``, and the tail layers
follow — the order of the reference's ``jnp.stack(ls, axis=1).reshape(
n_layers, ...)`` flattening.  Each layer runs its own kind, so the
reference's ``uniform_attn`` flattening with a traced ``lax.cond`` needs
no counterpart.

Caches are per-layer: a list with one dict a layer, in layer order.

The reference's logical spec trees come beside the modules, keyed by
each leaf's path in the reference's tree (:func:`param_specs`,
:func:`cache_specs`); the modules carry none.

Training runs the stack with ``remat=True``: each layer is checkpointed
on its own (:func:`remat_call`), so the backward holds one layer's
activations at a time.  Where the reference checkpoints a pattern group
and each layer inside it (a group of several layers that is not
gemma3's uniform local/global run: recurrentgemma's rec/rec/local), the
port nests the same way, one checkpoint over the group around the
per-layer ones, so the backward keeps only the groups' inputs until it
reaches a group.  Inside a layer the attention and SSD loops checkpoint
each chunk (``layers._chunk_checkpoint``).
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (Placed, Spec, each,
                                              gather_axis, mean_over_mesh,
                                              on_every_shard, physical_spec,
                                              place, ranges, reshard,
                                              to_whole)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Cache = Dict[str, torch.Tensor]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's kind, in layer order: the pattern repeated over the
    groups, then the tail."""
    pattern = list(cfg.attn_pattern)
    return pattern * cfg.n_groups + pattern[: cfg.n_tail]


class Layer(nn.Module):
    """One block: ``ln1``, the mixer (``attn``, ``rec`` or ``ssm``), and
    with ``d_ff > 0`` ``ln2`` and the ``mlp`` or ``moe``."""

    def __init__(self, cfg: ModelConfig, kind: str, init: L.Init):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        if kind in ("global", "local"):
            self.attn = L.Attention(cfg, init)
        elif kind == "rec":
            self.rec = R.RGLRUBlock(cfg, init)
        elif kind == "ssm":
            self.ssm = S.SSMBlock(cfg, init)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if cfg.d_ff > 0:
            self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdt, init)
            if cfg.n_experts > 0:
                self.moe = M.MoE(cfg, init)
            else:
                self.mlp = L.MLP(cfg, init)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Optional[L.Position] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache], Optional[torch.Tensor]]:
        """Returns (x, new_cache, aux): ``aux`` is the MoE's aux loss, None
        for a layer without experts."""
        cfg, kind = self.cfg, self.kind
        h = self.ln1(x, cfg.norm_eps)
        if kind in ("global", "local"):
            mix, new_cache = self.attn(h, kind=kind, positions=positions,
                                       cache=cache, cache_index=cache_index)
        elif kind == "rec":
            mix, new_cache = self.rec(h, cache, cache_index)
        else:
            mix, new_cache = self.ssm(h, cache, cache_index)
        x = _residual(x, mix)
        aux = None
        if cfg.d_ff > 0:
            h2 = self.ln2(x, cfg.norm_eps)
            if cfg.n_experts > 0:
                y, aux = self.moe(h2)
            else:
                y = self.mlp(h2)
            x = _residual(x, y)
        return x, new_cache, aux


def _residual(x, y):
    """``x + y``, shard by shard for a placed residual stream: its pieces
    and the block output's, both in the stream's layout (each model
    shard's positions where it is seq-placed, whole otherwise)."""
    if isinstance(x, Placed):
        return each(torch.add, x, y, spec=x.spec)
    return x + y



def layer_specs(cfg: ModelConfig, kind: str) -> Dict[str, Dict[str, Spec]]:
    """The logical specs of one :class:`Layer`'s parameters, by block
    (``transformer.py::init_layer``'s spec tree)."""
    specs = {"ln1": L.RMSNORM_SPECS}
    if kind in ("global", "local"):
        specs["attn"] = L.ATTENTION_SPECS
    elif kind == "rec":
        specs["rec"] = R.RGLRU_SPECS
    elif kind == "ssm":
        specs["ssm"] = S.SSM_SPECS
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.d_ff > 0:
        specs["ln2"] = L.RMSNORM_SPECS
        if cfg.n_experts > 0:
            specs["moe"] = M.moe_specs(cfg)
        else:
            specs["mlp"] = L.mlp_specs(cfg)
    return specs


def flat_specs(tree: Dict, prefix: Tuple[str, ...] = (), stacked: bool = False
               ) -> Dict[Tuple[str, ...], Spec]:
    """A nested spec tree as ``{path: spec}``; ``stacked`` prepends the
    unsharded layer axis of a stacked leaf (``_stack_init``'s leading
    ``None``)."""
    out = {}
    for key, val in tree.items():
        path = prefix + (key,)
        if isinstance(val, dict):
            out.update(flat_specs(val, path, stacked))
        else:
            out[path] = ((None,) if stacked else ()) + tuple(val)
    return out


def param_specs(cfg: ModelConfig) -> Dict[Tuple[str, ...], Spec]:
    """Every parameter leaf's logical spec, keyed by its path in the
    reference's tree (``registry.reference_path``;
    ``transformer.py::init_decoder``'s spec tree): a pattern group's
    stacked leaves carry the leading layer axis."""
    specs = {("embed",): ("vocab", "fsdp")}
    if not cfg.use_rope and cfg.max_pos > 0:
        specs[("pos_embed",)] = (None, "fsdp")
    pattern = cfg.attn_pattern
    if cfg.n_groups > 0:
        for j, kind in enumerate(pattern):
            specs.update(flat_specs(layer_specs(cfg, kind),
                                    ("groups", str(j)), stacked=True))
    for i, kind in enumerate(pattern[: cfg.n_tail]):
        specs.update(flat_specs(layer_specs(cfg, kind), ("tail", str(i))))
    specs[("final_norm", "scale")] = L.RMSNORM_SPECS["scale"]
    if not cfg.tie_embeddings:
        specs[("unembed",)] = ("fsdp", "vocab")
    return specs


class Decoder(nn.Module):
    """``embed (padded_vocab, d)``, ``pos_embed (max_pos, d)`` with
    learned positions, ``layers``, ``final_norm`` and, untied,
    ``unembed (d, padded_vocab)``; run by :func:`decoder_forward`."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.cfg = cfg
        self.embed = init.dense((cfg.padded_vocab, cfg.d_model), cfg.pdt)
        self.pos_embed = (init.dense((cfg.max_pos, cfg.d_model), cfg.pdt)
                          if not cfg.use_rope and cfg.max_pos > 0 else None)
        self.layers = nn.ModuleList(Layer(cfg, kind, init)
                                    for kind in layer_kinds(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.unembed = (None if cfg.tie_embeddings else
                        init.dense((cfg.d_model, cfg.padded_vocab), cfg.pdt))


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device) -> Cache:
    """The decode cache of one layer: full-length K/V for "global", a
    ``window``-slot ring buffer with its positions for "local", the
    recurrent state for "rec" and "ssm"."""
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind == "global":
        return {"k": z(batch, max_seq, cfg.n_kv_heads, cfg.hd),
                "v": z(batch, max_seq, cfg.n_kv_heads, cfg.hd)}
    if kind == "local":
        w = min(cfg.window, max_seq)
        return {"k": z(batch, w, cfg.n_kv_heads, cfg.hd),
                "v": z(batch, w, cfg.n_kv_heads, cfg.hd),
                "pos": torch.full((w,), -1, dtype=torch.int32, device=device)}
    if kind == "rec":
        return R.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "ssm":
        return S.init_ssm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def layer_cache_specs(kind: str) -> Dict[str, Spec]:
    """The logical specs of one layer's decode cache
    (``transformer.py::init_layer_cache``'s spec tree)."""
    kv = ("batch", "kv_seq", None, None)
    if kind == "global":
        return {"k": kv, "v": kv}
    if kind == "local":
        return {"k": kv, "v": kv, "pos": ("kv_seq",)}
    if kind == "rec":
        return {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}
    if kind == "ssm":
        return {"ssm": ("batch", "mlp", None, None),
                "conv_x": ("batch", None, "mlp"),
                "conv_b": ("batch", None, None),
                "conv_c": ("batch", None, None)}
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig) -> Dict[Tuple[str, ...], Spec]:
    """Every cache leaf's logical spec, keyed by its path in the
    reference's cache tree (``init_decoder_cache``'s spec tree: a
    group's caches stacked with a leading layer axis, the tail's
    not)."""
    specs = {}
    pattern = cfg.attn_pattern
    if cfg.n_groups > 0:
        for j, kind in enumerate(pattern):
            specs.update(flat_specs(layer_cache_specs(kind),
                                    ("groups", str(j)), stacked=True))
    for i, kind in enumerate(pattern[: cfg.n_tail]):
        specs.update(flat_specs(layer_cache_specs(kind), ("tail", str(i))))
    return specs


def init_decoder_cache(cfg: ModelConfig, batch: int, max_seq: int,
                       dtype: torch.dtype, device: torch.device) -> List[Cache]:
    return [init_layer_cache(cfg, kind, batch, max_seq, dtype, device)
            for kind in layer_kinds(cfg)]


def _slice_clamped(table: torch.Tensor, start: L.Position,
                   size: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim(table, start, size, 0)``: the start is
    clamped so that the slice fits, as XLA clamps it; a tensor ``start``
    on the device, with no host read (a gather of the same rows)."""
    if isinstance(start, torch.Tensor):
        rows = (start.clamp(0, table.shape[0] - size)
                + torch.arange(size, device=table.device))
        return table.index_select(0, rows)
    start = min(max(int(start), 0), table.shape[0] - size)
    return table[start:start + size]


def unembed_logits(x: torch.Tensor, unembed: torch.Tensor,
                   cfg: ModelConfig, first: int = 0) -> torch.Tensor:
    """``x @ unembed`` in the compute dtype, cast to ``logit_dtype``, with
    the padded vocabulary's columns masked to ``-1e30``; ``first`` is the
    vocabulary index of ``unembed``'s first column (a vocab-parallel
    piece's)."""
    logits = (x @ unembed.to(cfg.cdt)).to(getattr(torch, cfg.logit_dtype))
    if first + logits.shape[-1] > cfg.vocab:
        logits[..., max(cfg.vocab - first, 0):] = -1e30
    return logits


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``: keep the weight products (``aten.mm``,
    the 2-D products of activations and weights; the counterpart of
    ``dots_with_no_batch_dims_saveable``), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _MeshCheckpoint:
    """Activation checkpointing of a call over a device mesh, saving
    nothing but its arguments: every tensor the call saves for the
    backward is packed as its index (:meth:`pack`, :meth:`unpack` as the
    call's saved-tensor hooks, :func:`remat_call`), and the first unpack
    recomputes the call (with grad, on the same shard streams: the mesh
    code names each shard's stream itself) and keeps what the recompute
    saves, in the same order.  ``torch.utils.checkpoint``'s
    non-reentrant form does the same, but the first unpacks of a mesh
    layer come from the worker thread of every card its shards live on
    at once, and its recompute is not guarded against that; here a lock
    makes one of them recompute and the others wait for it.  The
    recompute runs the same operations on the same inputs, so the
    values and gradients are those of the plain call.  The frame holds
    no reference to the hooks that hold it: it goes with the backward's
    graph, not with the next cyclic collection (the layer it holds
    holds its parameters)."""

    def __init__(self, fn: Callable, args, kwargs):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.packed = 0
        self.saved: Optional[list] = None
        self.lock = threading.Lock()

    def pack(self, t: torch.Tensor) -> int:
        self.packed += 1
        return self.packed - 1

    def unpack(self, i: int) -> torch.Tensor:
        with self.lock:
            if self.saved is None:
                self.saved = self._recompute()
            t, self.saved[i] = self.saved[i], None
        if t is None:
            raise RuntimeError("a tensor saved by a checkpointed mesh call "
                               "was unpacked twice")
        return t

    def _recompute(self) -> list:
        saved: list = []

        def keep(t):
            # detached: a tensor the recompute saves may be an output of
            # the op saving it, and holding it with its grad_fn would keep
            # the recompute's graph alive in a cycle
            saved.append(t.detach())
            return saved[-1]

        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
            self.fn(*self.args, **self.kwargs)
        if len(saved) != self.packed:
            raise RuntimeError(f"the recompute of a checkpointed mesh call "
                               f"saved {len(saved)} tensors, its forward "
                               f"{self.packed}")
        return saved


def remat_call(fn: Callable, policy: str, *args, **kwargs):
    """``fn(*args, **kwargs)`` under activation checkpointing: its
    activations are recomputed in the backward, except the weight
    products with ``policy="dots"`` (any other policy saves nothing).
    The recompute runs the same operations on the same inputs, so the
    values and gradients are those of the plain call.  With a placed
    argument (a layer over a device mesh) it is :class:`_MeshCheckpoint`,
    which saves nothing; the ``"dots"`` policy is not ported there and
    raises."""
    if any(isinstance(a, Placed) for a in args):
        if policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' over a device mesh: the mesh layers "
                "are checkpointed whole, saving nothing")
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        frame = _MeshCheckpoint(fn, args, kwargs)
        with torch.autograd.graph.saved_tensors_hooks(frame.pack,
                                                      frame.unpack):
            return fn(*args, **kwargs)
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def nests_groups(cfg: ModelConfig) -> bool:
    """Whether training checkpoints each pattern group around its
    layers, as the reference does: a pattern of several layers that is
    not a uniform local/global attention run without a tail (which the
    reference flattens to one checkpoint a layer)."""
    pattern = cfg.attn_pattern
    uniform_attn = set(pattern) <= {"local", "global"} and cfg.n_tail == 0
    return len(pattern) > 1 and cfg.n_groups > 0 and not uniform_attn


def _remat_group(layers: List[Layer], policy: str, x: torch.Tensor,
                 positions: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """One pattern group's layers, each under :func:`remat_call`: the
    group's output and its layers' aux losses."""
    auxes = []
    for layer in layers:
        x, _, aux = remat_call(layer, policy, x, positions=positions)
        auxes.append(aux)
    return x, auxes


def decoder_forward(
    model: Decoder,
    tokens: torch.Tensor,                 # (B, S) int, or (B, S, d) embeds
    cfg: ModelConfig,
    caches: Optional[List[Cache]] = None,
    cache_index: Optional[L.Position] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Cache]], torch.Tensor]:
    """Returns (logits, new_caches, aux_loss).

    Teacher-forced with ``caches=None``; prefill-with-cache with zeroed
    caches and ``cache_index=0``; decode with one token a row and the
    caches at ``cache_index`` (an int, or a 0-d integer tensor on the
    device: then the step reads nothing back to the host).  Attention caches are written in place
    (the returned list holds the same tensors); recurrent and SSM states
    are returned anew.  ``remat=True`` without caches checkpoints each
    layer under ``cfg.remat_policy``, and each pattern group around its
    layers where the reference does (:func:`nests_groups`).  A model
    placed on a device mesh runs :func:`_decoder_forward_mesh`."""
    if isinstance(model.embed, Placed):
        return _decoder_forward_mesh(model, tokens, cfg, caches, cache_index,
                                     positions, remat)
    cdt = cfg.cdt
    if tokens.dim() == 3:
        x = tokens.to(cdt)                  # stubbed modality embeddings
    else:
        x = model.embed[tokens].to(cdt)
    if not cfg.use_rope and model.pos_embed is not None:
        start = 0 if cache_index is None else cache_index
        x = x + _slice_clamped(model.pos_embed, start, x.shape[1]).to(cdt)[None]

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = None if caches is None else []
    layers = list(model.layers)
    if remat and caches is None and nests_groups(cfg):
        # the reference's checkpointed scan body over a pattern group,
        # its layers checkpointed again inside (transformer.py:280-287)
        period = len(cfg.attn_pattern)
        for g in range(cfg.n_groups):
            x, auxes = remat_call(_remat_group, cfg.remat_policy,
                                  layers[g * period:(g + 1) * period],
                                  cfg.remat_policy, x, positions)
            for aux in auxes:
                if aux is not None:
                    aux_total = aux_total + aux
        layers = layers[cfg.n_groups * period:]
    for i, layer in enumerate(layers):
        c = None if caches is None else caches[i]
        if remat and c is None:
            x, nc, aux = remat_call(layer, cfg.remat_policy, x,
                                    positions=positions)
        else:
            x, nc, aux = layer(x, cache=c, cache_index=cache_index,
                               positions=positions)
        if aux is not None:
            aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)

    x = model.final_norm(x, cfg.norm_eps)
    unembed = model.embed.T if cfg.tie_embeddings else model.unembed
    return unembed_logits(x, unembed, cfg), new_caches, aux_total


# ----------------------------------------------------------------------
# over a device mesh
# ----------------------------------------------------------------------
def stream_spec(rules, shape) -> Spec:
    """The residual stream's layout for a ``(B, S, d)`` stream under the
    axis rules: ``(batch, seq, None)`` by :func:`physical_spec`, so the
    positions are on ``model`` (the default rules' ``"seq"``, the
    reference's sequence parallelism) where its extent divides ``S``,
    and whole where it does not (a decode step's one position), or where
    the rules map ``"seq"`` to ``None``."""
    return physical_spec(rules, shape, ("batch", "seq", None))


def _embed_mesh(embed: Placed, tokens: Placed, cfg: ModelConfig,
                stream: Spec) -> Placed:
    """The embedding looked up from the vocab-sharded table, in the
    residual stream's layout ``stream``: the table's fsdp parts gathered
    over ``data``, each model shard's rows of the tokens in its
    vocabulary range (zero elsewhere), summed over ``model`` in rank
    order (one term is the row, the rest exact zeros; reduce-scattered
    onto each shard's positions where the stream is seq-placed,
    :func:`~repro_torch.models.layers.to_stream`), then cast to the
    compute dtype.  A table whole on every model shard looks up each
    shard's own positions."""
    table = gather_axis(embed, "data")
    if table.spec[0] is None:
        return each(lambda t, i: t[i].to(cfg.cdt), table,
                    reshard(tokens, stream[:2]), spec=stream)
    rows = table.pieces[0].shape[0]

    def look(t, i, m):
        local = i - m * rows
        hit = (local >= 0) & (local < rows)
        return torch.where(hit[..., None], t[local.clamp(0, rows - 1)], 0)

    x = each(look, table, tokens, tokens.mesh.ranks("model"),
             spec=(tokens.spec[0], None, None))
    return each(lambda t: t.to(cfg.cdt), L.to_stream(x, stream, True),
                spec=stream)


def _unembed_mesh(x: Placed, model: nn.Module, cfg: ModelConfig) -> Placed:
    """Vocab-parallel logits (``transformer.py:260-267``): each model
    shard's columns of ``unembed`` (its fsdp parts gathered), or of a
    tied model's ``embed`` its vocabulary rows, transposed; the padded
    vocabulary masked in each piece."""
    if cfg.tie_embeddings:
        w = L.use_param(model.embed, cfg)
        vspec, cols = w.spec[0], w.pieces[0].shape[0]
    else:
        w = L.use_param(model.unembed, cfg)
        vspec, cols = w.spec[1], w.pieces[0].shape[1]

    def logits(x, w, m):
        return unembed_logits(x, w.T if cfg.tie_embeddings else w, cfg,
                              first=m * cols if vspec else 0)

    return each(logits, x, w, x.mesh.ranks("model"),
                spec=(x.spec[0], None, vspec))


def add_positions_mesh(x: Placed, table: Placed, start,
                       cfg: ModelConfig) -> Placed:
    """``x`` plus the rows ``start, ..., start + S - 1`` of a learned
    position table (its fsdp parts gathered over ``data``), clamped as
    the one-device slice is, in the compute dtype: each shard adds the
    rows of its own positions of ``x`` (the start clamped for the whole
    ``S``, then the shard's offset).  ``start`` is an int, a 0-d integer
    tensor or each shard's (``on_every_shard``'s): a tensor is read on
    each shard's device, never on the host."""
    table = gather_axis(table, "data")
    s = x.shape[1]

    def add(x, t, st, span):
        lo, hi = span
        return x + _slice_clamped(t, st, s)[lo:hi].to(cfg.cdt)[None]

    return each(add, x, table, on_every_shard(start, x.mesh), ranges(x, 1),
                spec=x.spec)


def place_inputs(x: torch.Tensor, mesh, rules, cfg: ModelConfig) -> Placed:
    """A whole ``(B, S, d)`` input (the vision frontend's patch
    embeddings, an encoder's frames) placed in the residual stream's
    layout (:func:`stream_spec`: each shard holds its own positions
    where the stream is seq-placed) and cast to the compute dtype."""
    placed = place(x, mesh, stream_spec(rules, x.shape))
    return each(lambda t: t.to(cfg.cdt), placed, spec=placed.spec)


def _decoder_forward_mesh(model: Decoder, tokens: torch.Tensor,
                          cfg: ModelConfig, caches, cache_index, positions,
                          remat: bool):
    """:func:`decoder_forward` over the model's device mesh, eagerly: the
    batch split over ``data`` (whole where the extent does not divide
    it), every layer tensor- and expert-parallel over ``model``.  The
    residual stream between blocks is placed by the rules'
    ``(batch, seq, None)`` (:func:`stream_spec`): with the default rules
    each model shard holds ``1 / model`` of the positions, and every
    block norms its own positions, gathers them over ``model``, runs its
    mixer or MLP and reduce-scatters the output back onto them
    (:func:`~repro_torch.models.layers.to_stream`); where the model
    extent does not divide ``S`` (a decode step) or the rules map
    ``"seq"`` to ``None`` the stream is whole on each model shard of a
    data group and the outputs are all-reduced.  Token ids are looked
    up in the vocab-sharded table; ``(B, S, d)`` embeddings are placed
    in the stream's layout, and M-RoPE ``positions (3, B, S)`` ``(None,
    batch, None)`` for every layer (attention reads them after its
    gather).  The final norm runs on the pieces, which are gathered
    before the vocab-parallel logits.  The logits come back
    whole on the mesh's first device; attention caches are written in
    place and recurrent states returned anew, placed; the aux loss is
    averaged over the shards.  A 0-d tensor position is moved to every
    shard once (``on_every_shard``) and read there, so a decode step
    reads nothing back to the host and can be captured as a CUDA graph
    (``serving.engine.DecodeGraph``).

    With ``remat=True`` (training, no caches) every layer runs under
    :func:`remat_call` over its placed input, and the backward goes
    through the mesh's collectives' rank-order transposes
    (:mod:`repro_torch.distributed.sharding`); each layer's checkpoint
    keeps its seq piece of the stream.  Every family trains so:
    the SSD heads, the RG-LRU channels and the vision frontend's patch
    embeddings with their M-RoPE positions as the decoder LMs' tokens.
    recurrentgemma's pattern groups are not checkpointed around their
    layers here (:func:`nests_groups` is the one-device path's): the
    values and gradients are the same, each layer's input is kept in
    place of each group's, and every layer runs forward twice, not
    three times."""
    mesh, rules = model.mesh, model.rules
    if cache_index is not None:
        cache_index = on_every_shard(cache_index, mesh)
    stream = stream_spec(rules, tokens.shape[:2] + (cfg.d_model,))
    bspec = stream[0]
    if tokens.dim() == 3:
        x = place_inputs(tokens, mesh, rules, cfg)
    else:
        x = _embed_mesh(model.embed, place(tokens, mesh, (bspec, None)), cfg,
                        stream)
    if not cfg.use_rope and model.pos_embed is not None:
        x = add_positions_mesh(x, model.pos_embed,
                               0 if cache_index is None else cache_index, cfg)
    if positions is not None:
        positions = place(positions, mesh, (None, bspec, None)
                          if positions.dim() == 3 else (bspec, None))
    aux_total = None
    new_caches = None if caches is None else []
    for i, layer in enumerate(model.layers):
        if remat and caches is None:
            x, nc, aux = remat_call(layer, cfg.remat_policy, x,
                                    positions=positions)
        else:
            x, nc, aux = layer(x, cache=None if caches is None else caches[i],
                               cache_index=cache_index, positions=positions)
        if aux is not None:
            aux_total = aux if aux_total is None else \
                each(torch.add, aux_total, aux, spec=())
        if new_caches is not None:
            new_caches.append(nc)
    x = model.final_norm(x, cfg.norm_eps)
    logits = to_whole(_unembed_mesh(gather_axis(x, "model"), model, cfg))
    aux_total = (torch.zeros((), dtype=torch.float32, device=mesh.device)
                 if aux_total is None else mean_over_mesh(aux_total))
    return logits, new_caches, aux_total
