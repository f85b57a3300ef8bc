"""The port's training forward and its gradients (``repro_torch.models``
with ``remat``) against the reference's (``jax.grad`` of
``repro.training.train_step.make_loss_fn``) on the CPU, for all ten
SMOKE configs in f32 compute; and remat's bitwise neutrality.

The reference's parameters come from ``init_params(PRNGKey(0))`` and are
carried across by ``repro_torch.convert``; inputs are numpy arrays from
a seed.  Tolerances:
- logits and aux within ``LM_TOL`` (5e-4, the reference's own
  decode-consistency tolerance; the forward already matches within
  5e-5);
- each parameter's gradient within 1e-4 of that leaf's largest |grad|:
  the backward sums the same f32 terms in other orders (XLA's fused
  reductions against torch's), 6e-8 a rounding over sums of a few
  thousand terms at the SMOKE widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import (LM_TOL, max_abs_diff, port_lm, ref_lm, ref_rows,
                         to_torch, train_inputs)
from repro.models import registry as RR
from repro.training import train_step as RT
from repro_torch.models import encdec as PE
from repro_torch.models import registry as PR
from repro_torch.models import transformer as PT
from repro_torch.training import train_step as PTS

GRAD_REL = 1e-4
B, S = 2, 16

_REF = {}


def _reference(arch):
    """The reference's logits, aux and per-leaf gradients of the total
    loss on the seeded batch (one jitted ``value_and_grad`` an arch)."""
    if arch not in _REF:
        rcfg, params, _ = ref_lm(arch)
        np_in = train_inputs(rcfg, 4, B, S)
        fwd = RR.make_train_forward(rcfg)
        tcfg = RT.TrainConfig()

        def loss(p, batch):
            logits, aux = fwd(p, batch)
            l, _ = RT.token_xent(logits, batch["targets"], tcfg.z_weight)
            return l + tcfg.aux_weight * aux, (logits, aux)

        (total, (logits, aux)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in np_in.items()})
        _REF[arch] = dict(inputs=np_in, total=np.asarray(total),
                          logits=np.asarray(logits), aux=np.asarray(aux),
                          grads=jax.tree.map(np.asarray, grads))
    return _REF[arch]


def _port_loss(model, cfg, batch, forward=None):
    forward = forward or PR.make_train_forward(cfg)
    logits, aux = forward(model, batch)
    loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
    return loss + 1e-2 * aux, logits, aux


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_train_forward_matches_the_reference(arch):
    ref = _reference(arch)
    cfg, model = port_lm(arch)
    with torch.no_grad():
        total, logits, aux = _port_loss(model, cfg, to_torch(ref["inputs"]))
    assert logits.shape == ref["logits"].shape
    assert max_abs_diff(logits.numpy(), ref["logits"]) < LM_TOL
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(ref["aux"])) < LM_TOL
    assert abs(float(total) - float(ref["total"])) < LM_TOL


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_gradients_match_jax_grad(arch):
    ref = _reference(arch)
    cfg, model = port_lm(arch)
    total, _, _ = _port_loss(model, cfg, to_torch(ref["inputs"]))
    total.backward()
    names = [n for n, _ in model.named_parameters()]
    want = ref_rows(ref["grads"], cfg, names)
    for name, p in model.named_parameters():
        scale = float(np.max(np.abs(want[name])))
        if p.grad is None:      # unused (qwen2-vl's embed under patch inputs)
            assert scale == 0.0, name
            continue
        err = max_abs_diff(p.grad.numpy(), want[name])
        assert err <= GRAD_REL * max(scale, 1e-30), (name, err, scale)


def _grads(model, cfg, batch, remat):
    for p in model.parameters():
        p.grad = None
    if cfg.family == "encdec":
        enc = PE.encode(model, batch["frames"], cfg, remat=remat)
        logits, _ = PE.decode(model, batch["tokens"], enc, cfg, remat=remat)
        aux = torch.zeros(())
    else:
        logits, _, aux = PT.decoder_forward(
            model, batch["tokens"], cfg, positions=batch.get("positions"),
            remat=remat)
    loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
    (loss + 1e-2 * aux).backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_remat_is_bitwise_neutral(arch):
    """The loss and every gradient are bitwise equal with remat off, with
    full remat, and with the ``"dots"`` policy."""
    cfg, model = port_lm(arch)
    batch = to_torch(train_inputs(cfg, 4, B, S))
    runs = [_grads(model, cfg, batch, False), _grads(model, cfg, batch, True),
            _grads(model, dataclasses.replace(cfg, remat_policy="dots"),
                   batch, True)]
    loss0, g0 = runs[0]
    for loss, g in runs[1:]:
        assert torch.equal(loss, loss0)
        for name, grad in g0.items():
            if grad is None:
                assert g[name] is None, name
            else:
                assert torch.equal(g[name], grad), name


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m"])
def test_dots_policy_saves_the_weight_products(arch):
    """The backward of full remat recomputes every layer's ``aten.mm``;
    under ``"dots"`` they are saved, so the backward runs fewer of them
    (only the gradients' own products)."""
    cfg, model = port_lm(arch)
    batch = to_torch(train_inputs(cfg, 4, B, S))
    counts = {}
    for policy in ("none", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        logits, _, _ = PT.decoder_forward(model, batch["tokens"], c, remat=True)
        loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
        with _CountMM() as count:
            loss.backward()
        counts[policy] = count.mm
    per_layer = counts["none"] - counts["dots"]
    assert per_layer > 0 and per_layer % cfg.n_layers == 0, counts


def test_make_train_forward_checkpoints_every_layer(monkeypatch):
    """The training forward runs each layer (and the encoder-decoder's
    encoder and decoder layers) through ``remat_call``."""
    calls = []
    real = PT.remat_call

    def spy(fn, policy, *args, **kwargs):
        calls.append(policy)
        return real(fn, policy, *args, **kwargs)

    monkeypatch.setattr(PT, "remat_call", spy)
    monkeypatch.setattr(PE, "remat_call", spy)
    for arch in ("llama3_8b", "whisper_small"):
        calls.clear()
        cfg, model = port_lm(arch)
        batch = to_torch(train_inputs(cfg, 4, B, S))
        PR.make_train_forward(cfg)(model, batch)
        want = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
        assert calls == ["none"] * want
