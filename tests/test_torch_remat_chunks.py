"""The port's inner rematerialisation in training against its unwrapped
run and against the reference's memory design, on the CPU.

The reference checkpoints each attention query chunk
(``repro/models/layers.py::_sdpa_chunked``, ``_sdpa_banded``) and each
SSD chunk (``repro/models/ssm.py::ssd_chunked``) with
``nothing_saveable``, and nests its remat over a pattern group of
several layers (``repro/models/transformer.py::decoder_forward``).  The
port does the same through ``layers._chunk_checkpoint`` and
``transformer.nests_groups``:

- the gradients of the three chunked loops, and of five families'
  training forward under remat ``none`` and ``"dots"``, are bitwise
  those of the run with the helper patched to a plain call (and of the
  run with remat off);
- the bytes one attention or SSD call holds through its forward and
  backward (a dispatch-mode high-water mark of live storages) grow
  about 2x from S to 2S, not 4x, as the reference's compiled temp bytes
  do (``memory_analysis()`` of the jitted gradient on the CPU);
- with grad off (prefill, the decode step) no checkpoint is entered;
- recurrentgemma runs one outer and three inner ``remat_call`` s a
  group, then one a tail layer.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from _torch_port import to_torch, train_inputs
from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import train_step as TS

#: the five families' configs whose training forward is held bitwise,
#: at a length that gives every loop several chunks at SMOKE (attention
#: chunks of 16-32 tokens, SSD chunks of 16)
ARCHS = ("llama3_8b", "starcoder2_3b", "mamba2_370m", "recurrentgemma_9b",
         "whisper_small")
B, SEQ = 2, 64
#: the loops' shapes: one row, four heads of 16; the gradient test at
#: 128 tokens in chunks of 16 with a 32-token window (8 chunks, a band
#: of 3), the memory test at S and 2S in chunks of 64 with a 128-token
#: window
HEADS, HD = 4, 16
GRAD_SEQ, GRAD_CHUNK, GRAD_WINDOW = 128, 16, 32
SEQS, CHUNK, WINDOW = (512, 1024), 64, 128
#: S -> 2S: the held bytes' growth with the chunks checkpointed (linear
#: in S, plus the fixed chunk), and the least growth of the unwrapped
#: chunked attention (its saved softmax is S x S)
LINEAR, QUADRATIC = 2.3, 3.0


def _plain(fn, *args):
    return fn(*args)


class _HighWater(TorchDispatchMode):
    """The most bytes of storage that ops made inside the mode hold at
    once: each new storage is counted until it is freed."""

    def __init__(self):
        super().__init__()
        self.live, self.now, self.peak = {}, 0, 0

    def _free(self, key):
        self.now -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st.data_ptr()
                if key and key not in self.live:
                    self.live[key] = st.nbytes()
                    self.now += st.nbytes()
                    self.peak = max(self.peak, self.now)
                    weakref.finalize(st, self._free, key)
        return out


def _loop_inputs(loop, s, dtype, seed=0):
    """Seeded numpy inputs of one loop at length ``s``."""
    rng = np.random.default_rng(seed)
    if loop == "ssd":
        nh, hp, n = HEADS, HD, 8
        return [rng.standard_normal((1, s, nh, hp)).astype(dtype),
                rng.uniform(0.01, 0.5, (1, s, nh)).astype(np.float32),
                -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32),
                rng.standard_normal((1, s, n)).astype(dtype),
                rng.standard_normal((1, s, n)).astype(dtype)]
    return [rng.standard_normal((1, s, HEADS, HD)).astype(dtype)
            for _ in range(3)]


def _port_loop(loop, chunk, window):
    if loop == "ssd":
        return lambda x, dt, a, bm, cm: S.ssd_chunked(x, dt, a, bm, cm, chunk)
    if loop == "banded":
        return lambda q, k, v: L._sdpa_banded(q, k, v, window=window,
                                              chunk=chunk)
    return lambda q, k, v: L._sdpa_chunked(
        q, k, v, causal=loop == "chunked causal", window=0, chunk_q=chunk)


def _is_f32(loop, i):
    """The SSD's ``dt`` and ``a`` are f32 whatever the compute dtype."""
    return loop == "ssd" and i in (1, 2)


def _loop_grads(loop, arrays, dtype, chunk, window):
    """The loop's outputs and its inputs' gradients of a seeded
    cotangent's dot with them (the SSD's final state among them)."""
    leaves = [torch.tensor(a, dtype=torch.float32 if _is_f32(loop, i)
                           else dtype).requires_grad_()
              for i, a in enumerate(arrays)]
    out = _port_loop(loop, chunk, window)(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator().manual_seed(1)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum()
               for o in outs)
    loss.backward()
    return [o.detach() for o in outs], [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("loop", ["chunked causal", "chunked", "banded",
                                  "ssd"])
def test_chunk_gradients_are_bitwise_the_unwrapped_run(monkeypatch, loop,
                                                       dtype):
    """Each loop at 128 tokens (8 chunks; the band 3 chunks wide): its
    outputs and every input's gradient are bitwise those of the same
    loop with the checkpoint helper patched to a plain call."""
    arrays = _loop_inputs(loop, GRAD_SEQ, np.float32)
    args = (GRAD_CHUNK, GRAD_WINDOW)
    outs, grads = _loop_grads(loop, arrays, dtype, *args)
    monkeypatch.setattr(L, "_chunk_checkpoint", _plain)
    want_outs, want_grads = _loop_grads(loop, arrays, dtype, *args)
    for got, want in zip(outs + grads, want_outs + want_grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _model(arch, policy):
    cfg = dataclasses.replace(R.get_config(arch, smoke=True),
                              remat_policy=policy)
    model = R.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    return cfg, model


def _train_grads(model, cfg, batch, remat=True):
    """The training loss (the train step's, aux included) and every
    parameter's gradient, taken off the model."""
    if remat:
        logits, aux = R.make_train_forward(cfg)(model, batch)
    elif cfg.family == "encdec":
        from repro_torch.models import encdec as E
        enc = E.encode(model, batch["frames"], cfg)
        logits, _ = E.decode(model, batch["tokens"], enc, cfg)
        aux = torch.zeros(())
    else:
        logits, _, aux = T.decoder_forward(model, batch["tokens"], cfg)
    loss, _ = TS.token_xent(logits, batch["targets"], 1e-4)
    (loss + 1e-2 * aux).backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name], p.grad = p.grad, None
    return loss.detach(), grads


@pytest.mark.parametrize("policy", ["none", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_forward_is_bitwise_the_unwrapped_run(monkeypatch, arch,
                                                       policy):
    """The family's SMOKE config in its own compute dtype (bf16) at 2 x
    64 tokens: the loss and every gradient with the chunk checkpoints
    (nested in the layer checkpoints, and in recurrentgemma's group
    checkpoints) are bitwise those with the helper patched to a plain
    call, and those of the forward with remat off."""
    cfg, model = _model(arch, policy)
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    runs = [_train_grads(model, cfg, batch)]
    with monkeypatch.context() as m:
        m.setattr(L, "_chunk_checkpoint", _plain)
        runs.append(_train_grads(model, cfg, batch))
    runs.append(_train_grads(model, cfg, batch, remat=False))
    loss0, g0 = runs[0]
    assert torch.isfinite(loss0)
    for loss, grads in runs[1:]:
        assert torch.equal(loss, loss0)
        for name, grad in g0.items():
            if grad is None:
                assert grads[name] is None, name
            else:
                assert torch.equal(grads[name], grad), name


def _held_bytes(loop, s):
    """The high-water mark of one bf16 call of ``loop`` at length ``s``
    and its backward."""
    arrays = _loop_inputs(loop, s, np.float32)
    with _HighWater() as hw:
        _loop_grads(loop, arrays, torch.bfloat16, CHUNK, WINDOW)
    return hw.peak


def _reference_temp_bytes(loop, s):
    """The temp bytes XLA's CPU backend allocates for the reference
    loop's jitted gradient at length ``s`` (bf16 operands)."""
    args = [jnp.asarray(a, jnp.float32 if _is_f32(loop, i) else jnp.bfloat16)
            for i, a in enumerate(_loop_inputs(loop, s, np.float32))]
    if loop == "ssd":
        fn = lambda *a: RS.ssd_chunked(*a, CHUNK)[0]
    elif loop == "banded":
        fn = lambda q, k, v: RL._sdpa_banded(q, k, v, window=WINDOW,
                                             chunk=CHUNK)
    else:
        fn = lambda q, k, v: RL._sdpa_chunked(
            q, k, v, causal=loop == "chunked causal", window=0, chunk_q=CHUNK)
    grad = jax.grad(lambda *a: fn(*a).astype(jnp.float32).sum(),
                    argnums=tuple(range(len(args))))
    compiled = jax.jit(grad).lower(*args).compile()
    return compiled.memory_analysis().temp_size_in_bytes


@pytest.mark.parametrize("loop", ["chunked causal", "banded", "ssd"])
def test_held_bytes_grow_linearly_in_s(monkeypatch, loop):
    """From S to 2S the bytes one call holds through its backward grow
    about 2x with the chunks checkpointed, as the reference's compiled
    temp bytes do; unwrapped, the chunked attention's grow about 4x (its
    saved softmax is S x S), and the banded and SSD loops hold more."""
    held = [_held_bytes(loop, s) for s in SEQS]
    ref = [_reference_temp_bytes(loop, s) for s in SEQS]
    monkeypatch.setattr(L, "_chunk_checkpoint", _plain)
    unwrapped = [_held_bytes(loop, s) for s in SEQS]
    assert held[1] <= LINEAR * held[0], held
    assert ref[1] <= LINEAR * ref[0], ref
    if loop == "chunked causal":
        assert unwrapped[1] >= QUADRATIC * unwrapped[0], unwrapped
    assert held[1] < unwrapped[1], (held, unwrapped)


class _Spy:
    """Counts the calls of a wrapped function."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, fn, *args, **kwargs):
        self.calls.append(fn)
        return self.fn(fn, *args, **kwargs)


@pytest.mark.parametrize("arch", ["llama3_8b", "starcoder2_3b",
                                  "mamba2_370m"])
def test_grad_off_enters_no_checkpoint(monkeypatch, arch):
    """Serving (``ServeEngine.generate``: the prefill of a 64-token
    prompt, several chunks, and eager decode steps) enters no
    checkpoint; the training forward of the same model does."""
    spy = _Spy(L.checkpoint)
    monkeypatch.setattr(L, "checkpoint", spy)
    cfg, model = _model(arch, "none")
    prompt = torch.as_tensor(train_inputs(cfg, 4, B, SEQ)["tokens"]).long()
    engine = ServeEngine(R.make_prefill(cfg), R.make_decode(cfg),
                         lambda b, s: R.init_caches(cfg, b, s, device="cpu"))
    tokens = engine.generate(model, prompt, 3)
    assert tokens.shape[0] == B and spy.calls == []
    with torch.no_grad():
        T.decoder_forward(model, prompt, cfg, remat=True)
    assert spy.calls == []
    R.make_train_forward(cfg)(model, to_torch(train_inputs(cfg, 4, B, SEQ)))
    assert len(spy.calls) > 0


def test_recurrentgemma_nests_each_group(monkeypatch):
    """recurrentgemma (rec, rec, local; one group and two tail layers at
    SMOKE) checkpoints each group once around its three layers, then
    each tail layer; no other config nests.  Its gradients are bitwise
    those of one checkpoint a layer."""
    assert [a for a in R.ARCH_IDS
            if T.nests_groups(R.get_config(a))] == ["recurrentgemma_9b"]
    cfg, model = _model("recurrentgemma_9b", "none")
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    spy = _Spy(T.remat_call)
    monkeypatch.setattr(T, "remat_call", spy)
    R.make_train_forward(cfg)(model, batch)
    period = len(cfg.attn_pattern)
    want = ([T._remat_group] + [T.Layer] * period) * cfg.n_groups \
        + [T.Layer] * cfg.n_tail
    assert [fn if fn is T._remat_group else type(fn)
            for fn in spy.calls] == want
    assert cfg.n_groups >= 1 and period == 3
    nested = _train_grads(model, cfg, batch)
    monkeypatch.setattr(T, "nests_groups", lambda cfg: False)
    flat = _train_grads(model, cfg, batch)
    assert torch.equal(nested[0], flat[0])
    for name, grad in nested[1].items():
        assert torch.equal(flat[1][name], grad), name
