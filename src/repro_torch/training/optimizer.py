"""AdamW over a model's named parameters (port of
``repro/training/optimizer.py``).

The arithmetic is the reference's, operation for operation: the global
norm's leaf terms summed in the reference's leaf order, the clip scale
``min(1, clip / (gnorm + 1e-12))``, the warmup ``lr * min(step /
warmup, 1)`` in f32, ``mhat / (sqrt(vhat) + eps) + wd * p`` and the
moments stored in ``moment_dtype``.  ``torch.optim.AdamW`` is not used:
it puts ``eps`` after ``sqrt(v) / sqrt(bc2)`` and rounds differently.

The optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": 0-d int32 tensor}`` on the parameters' device, keyed by the
module's parameter names.  The update writes parameters and moments in
place, ``UPDATE_CHUNK`` values of a leaf at a time, and returns its
metrics as 0-d tensors: it never waits for the card.
``moment_dtype="bfloat16"`` halves optimizer memory.

A model placed on a device mesh (``registry.init_params(..., mesh=)``)
has placed parameters and gradients
(:class:`~repro_torch.distributed.sharding.Placed`): its moments are
placed with the parameters' specs, ``step`` lives on the mesh's first
device, and the update runs piece by piece on each shard's stream.  The
global norm counts each leaf's whole gradient once: one replica of each
part, the parts' sums of squares added in rank order on the first
device, the leaves in the reference's order; the clip scale, the
learning rate and the bias corrections are moved from there to every
shard, so every replica of a part takes the same update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import torch

from repro_torch.distributed.sharding import (Placed, join_current,
                                              on_every_shard, placed_full,
                                              replica_groups)


#: the values of a leaf one pass of the update works on: the update is
#: elementwise, so a leaf updated chunk by chunk has the bits of one
#: updated whole, and its f32 temporaries (about eight) stay a chunk's
#: size, 256 MiB each, where a 262144 x 3840 embedding's would be 4 GB
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


Leaf = Union[torch.Tensor, Placed]


def _named(params) -> Dict[str, Leaf]:
    """A module's named parameters (a placed model's placed leaves), or
    a mapping of names to tensors."""
    if isinstance(params, torch.nn.Module):
        from repro_torch.models.registry import named_leaves
        return dict(named_leaves(params))
    return dict(params)


def leaf_device(p: Leaf) -> torch.device:
    """Where a leaf's scalars live: its device, or a placed leaf's
    mesh's first device."""
    return p.mesh.device if isinstance(p, Placed) else p.device


def zeros_like_leaf(p: Leaf, dtype: torch.dtype = torch.float32) -> Leaf:
    """Zeros of ``p``'s shape in ``dtype``: a placed leaf's placed with
    its spec, each piece made on its shard."""
    if isinstance(p, Placed):
        return placed_full(p.shape, p.spec, p.mesh, 0.0, dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def adamw_init(params) -> Dict[str, object]:
    """Zero f32 moments for every parameter of ``params`` (a module or a
    mapping of names to tensors) and step 0, on the parameters'
    device; a placed parameter's moments placed with its spec."""
    named = _named(params)
    zeros = lambda: {n: zeros_like_leaf(p) for n, p in named.items()}
    dev = leaf_device(next(iter(named.values())))
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_init_specs(param_specs: Mapping) -> Dict[str, object]:
    """The optimizer state's logical specs: the moments mirror the
    parameters' (``param_specs``, keyed as the parameters are, by the
    reference's leaf paths in the dry run) and ``step`` is replicated
    (the reference's ``adamw_init_specs``; the layout of
    ``convert.train_state_to_numpy``'s ``"opt"``)."""
    return {"m": dict(param_specs), "v": dict(param_specs), "step": ()}


def default_order(names: Iterable[str]) -> List[List[str]]:
    """Each name its own leaf, in the order a nested dict of the dotted
    names flattens (sorted paths)."""
    return [[n] for n in sorted(names, key=lambda n: n.split("."))]


def _sum_sq(g: Leaf) -> torch.Tensor:
    """A leaf's sum of squares in f32: for a placed one, one replica of
    each part summed on its shard, the parts added in rank order on the
    mesh's first device."""
    if not isinstance(g, Placed):
        return torch.sum(torch.square(g.float()))
    mesh, parts = g.mesh, []
    for group in replica_groups(g):
        s = group[0]
        with mesh.on(s):
            part = torch.sum(torch.square(g.pieces[s].float()))
        parts.append(mesh.move(part, None, src=s))
    return sum(parts[1:], parts[0])


def _global_norm(grads: Mapping[str, Leaf],
                 order: Optional[Sequence[Sequence[str]]] = None
                 ) -> torch.Tensor:
    """``sqrt`` of the sum of the leaves' sums of squares, the leaves
    summed in ``order``: groups of names, one group a reference leaf (a
    stacked leaf's rows are summed in row order into one term).  The
    default order is :func:`default_order`'s.  A placed gradient counts
    each part once (:func:`_sum_sq`)."""
    order = default_order(grads) if order is None else order
    terms = []
    for group in order:
        sq = [_sum_sq(grads[n]) for n in group]
        terms.append(sum(sq[1:], sq[0]))
    return torch.sqrt(sum(terms))


def _update_tensor(p: torch.Tensor, grad: torch.Tensor, m_old: torch.Tensor,
                   v_old: torch.Tensor, scale, lr, bc1, bc2,
                   cfg: AdamWConfig, mdt: torch.dtype):
    """One tensor's AdamW update in place, ``UPDATE_CHUNK`` values at a
    time: returns its new moments (the old ones, written in place, when
    they are already in ``mdt``)."""
    b1, b2 = cfg.b1, cfg.b2
    m_out, v_out = (old if old.dtype == mdt else
                    torch.empty(old.shape, dtype=mdt, device=old.device)
                    for old in (m_old, v_old))
    grad = grad.reshape(-1)
    for start in range(0, p.numel(), UPDATE_CHUNK):
        sl = slice(start, start + UPDATE_CHUNK)
        pc = p.view(-1)[sl]
        g = grad[sl].float() * scale
        m_new = b1 * m_old.view(-1)[sl].float() + (1 - b1) * g
        v_new = b2 * v_old.view(-1)[sl].float() + (1 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * pc.float()
        pc.copy_(pc.float() - lr * delta)
        m_out.view(-1)[sl].copy_(m_new)
        v_out.view(-1)[sl].copy_(v_new)
    return m_out, v_out


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 params, cfg: AdamWConfig,
                 order: Optional[Sequence[Sequence[str]]] = None
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step: ``params`` (a module or a mapping of names to
    tensors) and ``opt_state``'s moments and step are updated in place
    from ``grads`` (keyed as the parameters); ``order`` is the global
    norm's leaf order (:func:`_global_norm`).  Returns ``{"grad_norm",
    "lr"}`` as 0-d f32 tensors."""
    named = _named(params)
    opt_state["step"].add_(1)
    step = opt_state["step"]
    gnorm = _global_norm(grads, order)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = _schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    mdt = getattr(torch, cfg.moment_dtype)
    ms, vs = opt_state["m"], opt_state["v"]
    scalars = {}
    for name, p in named.items():
        if not isinstance(p, Placed):
            ms[name], vs[name] = _update_tensor(
                p, grads[name], ms[name], vs[name], scale, lr, bc1, bc2, cfg,
                mdt)
            continue
        mesh = p.mesh
        if mesh not in scalars:
            scalars[mesh] = [on_every_shard(v, mesh)
                             for v in (scale, lr, bc1, bc2)]
        moments = []
        for s, piece in enumerate(p.pieces):
            with mesh.on(s):
                moments.append(_update_tensor(
                    piece, grads[name].pieces[s], ms[name].pieces[s],
                    vs[name].pieces[s], *(v[s] for v in scalars[mesh]),
                    cfg, mdt))
        ms[name], vs[name] = (Placed([mv[i] for mv in moments], mesh, p.spec)
                              for i in (0, 1))
    for mesh in scalars:
        join_current(mesh)
    return {"grad_norm": gnorm, "lr": lr}
