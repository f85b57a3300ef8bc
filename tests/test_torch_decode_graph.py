"""The decode step with its position as a device tensor, the form a CUDA
graph captures, on the CPU.

- Decode with a 0-d ``int32`` position is bitwise decode with the same
  position as a Python int, logits and every cache leaf, for all ten
  SMOKE configs: past a local layer's window (the ring buffer wraps),
  past the end of the cache and past a learned position table (XLA's
  clamps).
- With a tensor position the port's decode stays within the reference
  decode tolerance (``LM_TOL``, 5e-4 in f32) of the reference's jitted
  ``make_decode``, which takes the position as a device ``int32``.
- The engine on the CPU runs every decode step eagerly and says so.
- The sync-free MoE counts give routing tables bitwise those of
  ``torch.bincount`` and ``repeat_interleave``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (LM_TOL, lm_cfg, lm_inputs, max_abs_diff, port_lm,
                         ref_lm, to_torch, tree_max_abs_diff)
from repro.models import registry as RR
from repro_torch.convert import lm_caches_to_numpy
from repro_torch.models import moe as PM
from repro_torch.models import registry as PR
from repro_torch.serving import ServeEngine

SERVING_ARCHS = [a for a in PR.ARCH_IDS if a != "qwen2_vl_72b"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _prefilled(cfg, model, b, s, max_seq, seed=3):
    """Caches after a prefill of ``s`` seeded tokens (token ids for every
    config: the vision config's decoder takes them too), and the next
    tokens to feed."""
    np_in = lm_inputs(cfg, seed, b, s)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s + 16)))
    inputs = {"tokens": tokens[:, :s]}
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(np_in["frames"])
    caches = PR.init_caches(cfg, b, max_seq, device="cpu")
    with torch.no_grad():
        _, caches = PR.make_prefill(cfg)(model, inputs, caches)
    return caches, tokens


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_tensor_position_decode_is_the_int_decode_bitwise(arch):
    """Decode steps at positions ``s .. s+5`` (over a local layer's
    window: the ring wraps), then past the end of the cache and past any
    learned position table, from the same prefilled caches with the
    position as an int and as a 0-d int32 tensor: equal logits and
    caches, bit for bit."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    model = PR.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = 2
    s = cfg.window - 2 if cfg.window else 8
    max_seq = s + 6
    caches, tokens = _prefilled(cfg, model, b, s, max_seq)
    positions = list(range(s, s + 6)) + [max_seq + 2, 4 * max_seq + 200]
    assert positions[-1] > max(cfg.max_pos, max_seq)
    if cfg.window:
        assert positions[-3] >= cfg.window       # the ring has wrapped
    decode = PR.make_decode(cfg)
    by_int, by_tensor = caches, _clone(caches)
    with torch.no_grad():
        for t, pos in enumerate(positions):
            tok = tokens[:, s + t:s + t + 1]
            want, by_int = decode(model, tok, by_int, pos)
            got, by_tensor = decode(model, tok, by_tensor,
                                    torch.tensor(pos, dtype=torch.int32))
            assert torch.equal(got, want), (arch, pos)
            for g, w in zip(_leaves(by_tensor), _leaves(by_int)):
                assert g.dtype == w.dtype and torch.equal(g, w), (arch, pos)


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_tensor_position_decode_matches_the_reference(arch):
    """Prefill, then two decode steps with the position as a 0-d int32
    tensor, against the reference's jitted steps on the same caches:
    logits and caches within ``LM_TOL``."""
    rcfg, params, _ = ref_lm(arch)
    pcfg, model = port_lm(arch)
    b, s, extra = 2, 12, 2
    np_in = lm_inputs(pcfg, 8, b, s + extra)
    pre = {"tokens": np_in["tokens"][:, :s]}
    if "frames" in np_in:
        pre["frames"] = np_in["frames"]
    rc, _ = RR.init_caches(rcfg, b, s + extra)
    rc = jax.jit(RR.make_prefill(rcfg))(
        params, {k: jnp.asarray(v) for k, v in pre.items()}, rc)[1]
    pc = PR.init_caches(pcfg, b, s + extra, device="cpu")
    with torch.no_grad():
        pc = PR.make_prefill(pcfg)(model, to_torch(pre), pc)[1]
    rdec, pdec = jax.jit(RR.make_decode(rcfg)), PR.make_decode(pcfg)
    for t in range(extra):
        tok = np_in["tokens"][:, s + t:s + t + 1]
        rl, rc = rdec(params, jnp.asarray(tok), rc,
                      jnp.asarray(s + t, jnp.int32))
        with torch.no_grad():
            pl, pc = pdec(model, torch.as_tensor(tok).long(), pc,
                          torch.tensor(s + t, dtype=torch.int32))
        assert max_abs_diff(pl.numpy(), rl) < LM_TOL, t
        assert tree_max_abs_diff(lm_caches_to_numpy(pcfg, pc),
                                 jax.tree.map(np.asarray, rc)) < LM_TOL, t


def test_engine_on_the_cpu_decodes_eagerly_with_a_tensor_position():
    """``generate`` on the CPU: every decode step eager, none captured;
    ``on_step`` sees the prefill and each step; the tokens are those of
    a hand-written loop over ``make_decode`` with int positions."""
    cfg = lm_cfg(PR.get_config("gemma3_12b", smoke=True))
    model = PR.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 14)))
    eng = ServeEngine(PR.make_prefill(cfg), PR.make_decode(cfg),
                      lambda bb, ss: PR.init_caches(cfg, bb, ss, device="cpu"))
    seen = []
    out = eng.generate(model, prompt, 6,
                       on_step=lambda i, logits: seen.append(
                           (i, logits.clone())))
    assert eng.stats == {"graph": False, "eager_steps": 5, "replays": 0,
                         "capture_s": 0.0}
    assert [i for i, _ in seen] == list(range(6))
    with torch.no_grad():
        caches = PR.init_caches(cfg, 2, 20, device="cpu")
        logits, caches = PR.make_prefill(cfg)(model, prompt, caches)
        want = [torch.argmax(logits[:, -1:], dim=-1)]
        for i in range(1, 6):
            logits, caches = PR.make_decode(cfg)(model, want[-1], caches,
                                                 14 + i - 1)
            assert torch.equal(logits, seen[i][1])
            want.append(torch.argmax(logits[:, -1:], dim=-1))
    assert torch.equal(out, torch.cat(want, dim=1))


# ----------------------------------------------------------------------
# MoE routing without host reads
# ----------------------------------------------------------------------
def _route_with_bincount(xt, router, cfg):
    """The routing tables as the port built them with ``torch.bincount``
    and ``repeat_interleave``, which read back to the host on the card."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))
    logits = (xt.float() @ router).float()
    top_w, top_e = PM.top_k(logits, k)
    top_w = torch.softmax(top_w, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    counts = torch.bincount(top_e.reshape(-1), minlength=e).float()
    aux = e * torch.sum(counts / (t * k) * torch.mean(probs, dim=0))
    flat_e = top_e.reshape(-1)
    flat_t = torch.repeat_interleave(torch.arange(t), k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], top_w.reshape(-1)[order]
    pos = torch.arange(t * k) - torch.searchsorted(se, se)
    dest = torch.where(pos < cap, se * cap + pos, torch.full_like(se, e * cap))
    tok_table = torch.full((e * cap + 1,), t, dtype=torch.int64)
    tok_table[dest] = st
    w_table = torch.zeros((e * cap + 1,), dtype=torch.float32)
    w_table[dest] = sw
    return (tok_table[:-1].reshape(e, cap), w_table[:-1].reshape(e, cap), aux)


def _combine_with_bincount(y, tok_table, t, k):
    flat_tok = tok_table.reshape(-1)
    nslots, d = y.shape
    order = torch.argsort(flat_tok, stable=True)
    counts = torch.bincount(flat_tok, minlength=t + 1)[:t]
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(k)
    take = starts[:, None] + j[None, :]
    slot = torch.where(j[None, :] < counts[:, None],
                       order[take.clamp(max=nslots - 1)],
                       torch.full_like(take, nslots))
    ypad = torch.cat([y, y.new_zeros((1, d))], dim=0)
    out = y.new_zeros((t, d))
    for jj in range(k):
        out = out + ypad[slot[:, jj]]
    return out


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "dbrx_132b"])
@pytest.mark.parametrize("capacity", [0.5, 1.0, 16.0])
@pytest.mark.parametrize("t", [1, 7, 64])
def test_sync_free_moe_routing_is_bitwise_bincount(arch, capacity, t):
    """``route`` and ``combine`` with the fixed-length counts: token and
    weight tables (drops included, at capacity factor 0.5), the aux
    loss and the combined rows bitwise the ``bincount`` versions."""
    import dataclasses

    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              capacity_factor=capacity)
    gen = torch.Generator().manual_seed(t)
    xt = torch.randn((t, cfg.d_model), generator=gen)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen)
    got = PM.route(xt, router, cfg)
    want = _route_with_bincount(xt, router, cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    y = torch.randn((got[0].numel(), cfg.d_model), generator=gen)
    assert torch.equal(PM.combine(y, got[0], t, cfg.top_k),
                       _combine_with_bincount(y, want[0], t, cfg.top_k))
