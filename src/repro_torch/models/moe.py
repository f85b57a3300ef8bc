"""Mixture-of-Experts layer (port of ``repro/models/moe.py``).

Dispatch is sort-based, as in the reference's ``_moe_local`` with no
tensor- or data-parallel axis: tokens are ordered by expert id
(a stable sort), positioned within their expert's segment, and gathered
into ``(E, capacity, d)`` blocks; tokens over capacity go to the
overflow row and are dropped (Switch/GShard semantics,
``capacity_factor`` controls head-room).  The routing tables
(``tok_table``, ``w_table``) are the reference's, drops included.

The combine is a gather, not a scatter-add: each token sums its
experts' outputs in ascending expert-slot order starting from a zero row
in the compute dtype, the order the reference's ``.at[tok_table].add``
takes, with no atomics (``index_add_`` on the card is not
deterministic).

Over a :class:`~repro_torch.distributed.sharding.DeviceMesh` the block
is the reference's expert-parallel ``_moe_local`` (``moe.py:56-154``):
the router replicated, each model shard holding ``e / model`` experts,
routing and capacity computed per data shard from its local tokens (so
a ``data`` axis longer than 1 drops other tokens than one device
does), ``aux`` averaged over every shard.  The combine gathers the
experts' outputs over ``model`` and runs the one-device gather in its
slot order, so at ``data = 1`` the block is the one-device block.  A
``model`` extent longer than 1 that does not divide the expert count is
refused with ``ValueError`` (:func:`check_expert_split`), as the
reference's ``shard_map`` refuses it (``moe.py:147``).
Under axis rules over a :class:`~repro_torch.distributed.sharding.
LogicalMesh` with an axis longer than 1 nothing is placed, and
:func:`moe` raises.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (Placed, current_rules, each,
                                              gather_axis, reshard)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, gelu, use_param


def moe_specs(cfg: ModelConfig) -> dict:
    """The logical specs of a :class:`MoE`'s parameters
    (``moe.py::init_moe``'s spec tree)."""
    specs = {"router": (None, None), "w_in": ("experts", "fsdp", None),
             "w_out": ("experts", None, "fsdp")}
    if "gated" in cfg.mlp_act:
        specs["w_gate"] = ("experts", "fsdp", None)
    return specs


def check_expert_split(cfg: ModelConfig, mesh) -> None:
    """Raise ``ValueError`` where the reference's expert-parallel
    ``shard_map`` refuses ``cfg`` on ``mesh`` (its in_specs put the
    experts on ``model``, ``moe.py:147``): an MoE whose expert count a
    ``model`` extent longer than 1 does not divide."""
    model = int(dict(mesh.shape).get("model", 1))
    if cfg.n_experts > 0 and model > 1 and cfg.n_experts % model:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts over a model "
                         f"axis of {model}, which does not divide them: the "
                         f"expert-parallel block holds n_experts / model "
                         f"experts a shard")


class MoE(nn.Module):
    """``router (d, e)`` (fp32), ``w_in``/``w_gate (e, d, f)``, ``w_out
    (e, f, d)``."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.cfg = cfg
        self.router = init.dense((d, e), torch.float32)  # fp32 router
        self.w_in = init.dense((e, d, f), cfg.pdt)
        self.w_gate = (init.dense((e, d, f), cfg.pdt) if "gated" in cfg.mlp_act
                       else None)
        self.w_out = init.dense((e, f, d), cfg.pdt, fan_in=f)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe(self, x, self.cfg)


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, ties
    toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in ``[0, n)``, at a
    fixed length: ``bincount`` reads the largest id back to the host on
    the card, which a CUDA-graph capture cannot do (integer sums, so the
    counts are the same in any order)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router and sort-based dispatch of ``t`` tokens ``xt (t, d)``.

    Returns ``(tok_table, w_table, aux)``: ``tok_table (e, cap)`` the token
    in each expert slot (``t`` for an empty slot), ``w_table (e, cap)``
    its routing weight (0 when empty), and the Switch aux loss.
    """
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))
    dev = xt.device

    logits = (xt.float() @ router).float()                # (t, e)
    top_w, top_e = top_k(logits, k)
    top_w = torch.softmax(top_w, dim=-1)

    # Switch aux loss: e * sum_e( frac_tokens_e * mean_router_prob_e )
    probs = torch.softmax(logits, dim=-1)
    counts = _count(top_e.reshape(-1), e).float()
    frac = counts / (t * k)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))

    flat_e = top_e.reshape(-1)                            # (t*k,)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    pos = torch.arange(t * k, device=dev) - torch.searchsorted(se, se)

    valid = pos < cap
    dest = torch.where(valid, se * cap + pos,
                       torch.full_like(se, e * cap))      # overflow bucket
    # only the overflow row takes more than one write, and it is dropped
    tok_table = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    tok_table[dest] = st
    w_table = torch.zeros((e * cap + 1,), dtype=torch.float32, device=dev)
    w_table[dest] = sw
    return (tok_table[:-1].reshape(e, cap), w_table[:-1].reshape(e, cap), aux)


def combine(y: torch.Tensor, tok_table: torch.Tensor, t: int, k: int
            ) -> torch.Tensor:
    """``zeros((t + 1, d)).at[tok_table].add(y)[:t]`` as a gather: token
    ``i``'s rows of ``y (e*cap, d)`` (at most ``k``) summed in ascending
    slot order from a zero row of ``y``'s dtype."""
    flat_tok = tok_table.reshape(-1)
    nslots, d = y.shape
    # slots grouped by token, ascending within a token
    order = torch.argsort(flat_tok, stable=True)
    counts = _count(flat_tok, t + 1)[:t]
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(k, device=y.device)
    take = starts[:, None] + j[None, :]                   # (t, k)
    slot = torch.where(j[None, :] < counts[:, None],
                       order[take.clamp(max=nslots - 1)],
                       torch.full_like(take, nslots))     # -> the zero row
    ypad = torch.cat([y, y.new_zeros((1, d))], dim=0)
    out = y.new_zeros((t, d))
    for jj in range(k):
        out = out + ypad[slot[:, jj]]
    return out


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE block. x: (B, S, d). Returns (y, aux_loss)."""
    if isinstance(x, Placed):
        return _moe_mesh(p, x, cfg)
    mesh = current_rules().mesh
    if mesh is not None and any(int(n) > 1 for n in dict(mesh.shape).values()):
        raise NotImplementedError(
            "the expert-parallel MoE runs on tensors placed on a "
            "DeviceMesh (registry.init_params(cfg, ..., mesh=)); a "
            "LogicalMesh places nothing")
    b, s, d = x.shape
    t = b * s
    cdt = cfg.cdt
    xt = x.reshape(t, d)
    tok_table, w_table, aux = route(xt, p.router, cfg)

    xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xg = xpad[tok_table].to(cdt)                          # (e, cap, d)
    h = torch.bmm(xg, use_param(p.w_in, cfg))
    if p.w_gate is not None:
        g = torch.bmm(xg, use_param(p.w_gate, cfg))
        h = F.silu(g) * h if cfg.mlp_act == "silu_gated" else gelu(g) * h
    else:
        h = gelu(h)
    y = torch.bmm(h, use_param(p.w_out, cfg))
    y = y * w_table[..., None].to(cdt)
    out = combine(y.reshape(-1, d), tok_table, t, cfg.top_k)
    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_mesh(p: MoE, x: Placed, cfg: ModelConfig):
    """The expert-parallel block over ``x``'s device mesh: each shard
    routes its data shard's ``t`` local tokens with the replicated
    router (capacity from ``t``), runs its ``e / model`` experts on the
    slots it owns, and every shard of a data group gathers the group's
    expert outputs over ``model`` and combines them in the one-device
    slot order.  A seq-placed ``x`` is gathered over ``model`` first, so
    each data shard routes the same tokens with the same capacity as a
    whole stream; the combined output is whole on every model shard, and
    each keeps its own positions of it (no sum).  Returns the output and
    each shard's aux loss."""
    mesh = x.mesh
    stream, x = x.spec, gather_axis(x, "model")
    check_expert_split(cfg, mesh)
    if mesh.shape["data"] > 1 and x.spec[0] is None:
        raise ValueError(f"the expert-parallel MoE splits the batch over "
                         f"data={mesh.shape['data']}, which does not divide "
                         f"a batch of {x.shape[0]}")
    d, k, cdt = cfg.d_model, cfg.top_k, cfg.cdt
    routed = each(lambda xp, r: route(xp.reshape(-1, d), r, cfg), x, p.router,
                  spec=None)
    w_in = use_param(p.w_in, cfg)
    w_gate = None if p.w_gate is None else use_param(p.w_gate, cfg)
    w_out = use_param(p.w_out, cfg)
    espec = w_in.spec[0]
    local = w_in.pieces[0].shape[0]

    def experts(xp, tables, wi, wo, m, wg=None):
        tok_table, w_table, _ = tables
        lo = m * local
        tok, wt = tok_table[lo:lo + local], w_table[lo:lo + local]
        xt = xp.reshape(-1, d)
        xg = torch.cat([xt, xt.new_zeros((1, d))], dim=0)[tok].to(cdt)
        h = torch.bmm(xg, wi)
        if wg is not None:
            g = torch.bmm(xg, wg)
            h = F.silu(g) * h if cfg.mlp_act == "silu_gated" else gelu(g) * h
        else:
            h = gelu(h)
        return torch.bmm(h, wo) * wt[..., None].to(cdt)

    y = each(experts, x, routed, w_in, w_out, mesh.ranks("model"),
             *([] if w_gate is None else [w_gate]), spec=(espec, None, None))
    y = gather_axis(y, "model")

    def out(xp, y, tables):
        t = xp.shape[0] * xp.shape[1]
        return combine(y.reshape(-1, d), tables[0], t, k).reshape(
            xp.shape).to(xp.dtype)

    aux = each(lambda tables: tables[2], routed, spec=(), mesh=mesh)
    return reshard(each(out, x, y, routed, spec=x.spec), stream), aux
