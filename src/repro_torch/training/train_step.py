"""Train step: loss, gradients, optimizer update, microbatching (port of
``repro/training/train_step.py``).

The step is family-agnostic: it takes a ``forward(model, batch) ->
(logits, aux)`` closure from the registry
(:func:`repro_torch.models.registry.make_train_forward`, every layer
checkpointed), differentiates ``ce + z_weight * mean(logz^2) +
aux_weight * aux`` with autograd, and applies
:func:`~repro_torch.training.optimizer.adamw_update` in place.

A model placed on a ``(data, model)`` device mesh trains the same way:
the forward runs over the mesh and returns the whole logits on its
first device, where the loss is taken; the backward goes through the
collectives' rank-order transposes into each piece's ``.grad`` on its
shard (:mod:`repro_torch.distributed.sharding`); then each parameter's
gradient is a :class:`~repro_torch.distributed.sharding.Placed` with
its spec, its replicas' partials summed once in rank order
(:func:`~repro_torch.distributed.sharding.sum_replica_grads`).
Microbatches are split off the whole batch and their gradients
accumulate in order in ``.grad`` before that sum.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import (Placed, each, join_current,
                                              sum_replica_grads, wait_current)
from repro_torch.models.registry import named_leaves, reference_leaf_order
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            leaf_device)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    aux_weight: float = 1e-2   # MoE load-balance loss weight
    z_weight: float = 1e-4     # z-loss (logit drift regularizer)
    # int8 + error-feedback gradient compression (4x less gradient
    # traffic than fp32; see training/compression.py)
    compress_grads: bool = False


def token_xent(logits: torch.Tensor, targets: torch.Tensor, z_weight: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over tokens (+z-loss). logits fp32 (B,S,V); targets (B,S).

    The gold logit is gathered: the reference's sum of ``logits *
    one_hot(targets)`` adds exact zeros to the one product that is the
    gathered value, so the two agree, and the gather builds no (B, S, V)
    f32 one-hot (1.5 GiB at batch 4, seq 2048, vocab 49152)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    zloss = torch.mean(torch.square(logz))
    return ce + z_weight * zloss, ce


def make_loss_fn(forward: Callable, tcfg: TrainConfig):
    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = forward(model, batch)
        loss, ce = token_xent(logits, batch["targets"], tcfg.z_weight)
        total = loss + tcfg.aux_weight * aux
        return total, {"loss": ce, "aux": aux}
    return loss_fn


def _split(batch: Dict[str, torch.Tensor], n: int):
    """``n`` microbatches of ``batch``: the batch axis is 0, except for
    M-RoPE ``positions`` (3, B, S)."""
    parts = {k: torch.chunk(v, n, dim=1 if k == "positions" else 0)
             for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _pieces(p):
    return p.pieces if isinstance(p, Placed) else (p,)


def _clear_grads(named) -> None:
    for p in named.values():
        for t in _pieces(p):
            t.grad = None


def _take_grads(named, n: int) -> Dict[str, object]:
    """Every parameter's gradient, divided by ``n`` microbatches when
    ``n > 1`` (zeros where none reached it), taken off the parameters:
    a placed one's pieces' partials summed over its replicas."""
    grads = {}
    for k, p in named.items():
        if isinstance(p, Placed):
            g = sum_replica_grads(p, [t.grad for t in p.pieces])
            if n > 1:
                g = each(lambda t: t / n, g, spec=g.spec)
        else:
            g = p.grad if n == 1 or p.grad is None else p.grad / n
            if g is None:
                g = torch.zeros_like(p)
        grads[k] = g
    _clear_grads(named)
    return grads


def make_train_step(forward: Callable, opt_cfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig()) -> Callable:
    """Returns ``step(model, opt_state, batch) -> metrics``: the model's
    parameters and ``opt_state`` are updated in place; ``metrics`` holds
    ``loss`` (the mean CE), ``aux``, ``grad_norm`` and ``lr`` as 0-d
    tensors.  With ``microbatches > 1`` the f32 gradients of the
    microbatches accumulate in order and are divided by their count, and
    ``aux`` is 0, as in the reference.  A placed model's batch lives on
    its mesh's first device, as do the metrics; its gradients are
    placed (module docstring)."""
    loss_fn = make_loss_fn(forward, tcfg)

    def step(model, opt_state, batch):
        named = dict(named_leaves(model))
        mesh = getattr(model, "mesh", None)
        _clear_grads(named)
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            lsum = 0.0
            for mb in _split(batch, n):
                total, m = loss_fn(model, mb)
                total.backward()
                lsum = lsum + m["loss"].detach()
            dev = leaf_device(next(iter(named.values())))
            metrics = {"loss": lsum / n,
                       "aux": torch.zeros((), dtype=torch.float32, device=dev)}
        else:
            n = 1
            total, m = loss_fn(model, batch)
            total.backward()
            metrics = {k: v.detach() for k, v in m.items()}
        if mesh is not None:
            # the leaves' .grad is ordered on the current streams
            wait_current(mesh)
        grads = _take_grads(named, n)

        order = reference_leaf_order(model)
        if tcfg.compress_grads:
            from repro_torch.training.compression import GradCompression
            from repro_torch.training.compression import apply as _ef
            ef = opt_state.get("ef")
            if ef is None:
                ef = GradCompression.init(named)
            grads, opt_state["ef"] = _ef(grads, ef, order)

        metrics.update(adamw_update(grads, opt_state, named, opt_cfg, order))
        if mesh is not None:
            join_current(mesh)
        return metrics

    return step
