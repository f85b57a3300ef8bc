"""Batched LM serving engine: prefill + decode over per-layer caches
(port of ``repro/serving/engine.py``).

``prefill`` consumes the prompt and fills the caches (global layers:
full-length caches; local layers: O(window) ring buffers; SSM/RG-LRU
layers: constant-size recurrent state).  ``decode`` appends one token.
Greedy sampling; batch-synchronous (all requests share a position).

The reference compiles its two step functions with ``jax.jit`` and
passes the decode position as a device ``int32``, on one device and
over a mesh alike.  Here both run under ``torch.inference_mode()``, and
the position is a 0-d ``int32`` tensor on the prompt's device, so a
decode step reads nothing back to the host.  The prefill runs eagerly
(one call a request).  On the card the decode step is captured once a
:meth:`ServeEngine.generate` as a CUDA graph (:class:`DecodeGraph`),
after one eager step on the graph's stream, and replayed for every
later token; on the CPU every step runs eagerly.  The choice follows
the prompt's device.

A model placed on a ``(data, model)`` device mesh
(:func:`repro_torch.models.registry.init_params` with ``mesh=``) is
captured the same way, the card repeated or the shards on distinct
cards: inside the capture each shard's stream first waits on the
capture stream and the capture stream waits on each of them last
(:meth:`DataMesh.fork` and :meth:`DataMesh.join`), so every shard's work
is in the graph, and the position reaches each shard as a copy recorded
in the graph.  On distinct cards the other cards' allocations during the
capture go into private pools of their own (``_device.capturing``'s
``devices``), as the capture's own card's do.

A capture allocates from its private pool, which cannot reuse what the
regular pool holds cached: before it, :class:`DecodeGraph` gives the
caching allocator's unused blocks back on every card of the step
(:func:`release_cached`), so that the memory the eager steps left
cached is free for the graph.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Optional

import torch

from repro_torch._device import capturing, release_pools
from repro_torch.distributed.sharding import Placed


def release_cached(devices) -> None:
    """Give the caching allocator's unused blocks back to the driver on
    each card of ``devices`` (indices): what a capture's private pool
    cannot take from the regular pool otherwise."""
    for d in sorted(set(devices)):
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def _write_back(caches, new) -> None:
    """Copy each leaf of ``new`` into the same leaf of ``caches`` where
    the two are distinct tensors: a decode step writes the attention
    caches in place and returns the recurrent states anew.  A placed leaf
    is copied piece by piece, each on its shard's stream."""
    if isinstance(caches, dict):
        for key, leaf in caches.items():
            _write_back(leaf, new[key])
    elif isinstance(caches, (list, tuple)):
        for leaf, new_leaf in zip(caches, new):
            _write_back(leaf, new_leaf)
    elif isinstance(caches, Placed):
        for s, (piece, new_piece) in enumerate(zip(caches.pieces, new.pieces)):
            if new_piece is not piece:
                with caches.mesh.on(s):
                    piece.copy_(new_piece)
    elif new is not caches:
        caches.copy_(new)


class DecodeGraph:
    """One decode step ``decode_fn(params, tok, caches, index)`` captured
    as a CUDA graph on ``stream``, over static inputs: a token tensor
    shaped like ``tok``, a 0-d ``int32`` position and ``caches``
    themselves, which every replay reads and updates in place (new
    recurrent states are copied back into them inside the graph).

    For a model placed on a device mesh, the shards' streams join the
    capture before the step and are joined back after it (and after the
    copies of the new recurrent states), so the graph holds every
    shard's work; the moves of the token and the position onto the
    shards are part of it.  Shards on other cards than ``stream``'s
    allocate into private pools there during the capture, given back
    when the graph goes.

    Capture after at least one eager step on ``stream`` (and on the
    shards' streams), so that the libraries the step calls set up their
    per-stream state outside the capture.  The unused cached blocks of
    every card of the step are released first (:func:`release_cached`).
    A capture that fails raises; nothing falls back to eager.  :meth:`__call__` writes the token and
    the position into the static inputs and replays; the logits it
    returns are a static tensor that the next replay overwrites."""

    def __init__(self, decode_fn: Callable, params, tok: torch.Tensor,
                 caches, stream: torch.cuda.Stream):
        mesh = getattr(params, "mesh", None)
        others = [] if mesh is None else sorted(
            {d.index for d in mesh.devices} - {tok.device.index})
        t0 = time.perf_counter()
        release_cached([tok.device.index, *others])
        self.caches = caches
        self.replays = 0
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode():
            self.tok = tok.clone()
            self.index = torch.zeros((), dtype=torch.int32, device=tok.device)
            with capturing(self.graph, stream, others):
                if mesh is not None:
                    mesh.fork()
                logits, new = decode_fn(params, self.tok, caches, self.index)
                _write_back(caches, new)
                if mesh is not None:
                    mesh.join()
        if others:
            weakref.finalize(self, release_pools, others, self.graph.pool())
        self.logits = logits
        self.capture_s = time.perf_counter() - t0

    def __call__(self, tok: torch.Tensor, index: int) -> torch.Tensor:
        with torch.inference_mode():
            self.tok.copy_(tok)
            self.index.fill_(index)
        self.graph.replay()
        self.replays += 1
        return self.logits


class ServeEngine:
    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 cache_init: Callable):
        """All three callables come from the arch registry:
        - prefill_fn(model, tokens_or_embeds, caches) -> (logits, caches)
        - decode_fn(model, last_tokens (B,1), caches, index) -> (logits, caches)
        - cache_init(batch, max_seq) -> caches

        ``stats`` describes the last :meth:`generate`: whether its decode
        ran as a graph, its eager decode steps, its replays and the host
        seconds of the capture."""
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._cache_init = cache_init
        self._streams: dict = {}
        self.stats: dict = {}

    def generate(self, params, prompt: torch.Tensor, steps: int,
                 max_seq: Optional[int] = None,
                 on_step: Optional[Callable] = None) -> torch.Tensor:
        """``steps`` greedy tokens a row after ``prompt (B, S)``, as a
        ``(B, steps)`` tensor of ``prompt``'s dtype.  ``on_step(i,
        logits)``, when given, is called after the prefill (``i = 0``)
        and after each decode step ``i``, with that step's logits (on
        the card, the graph's static output)."""
        b, s = prompt.shape[0], prompt.shape[1]
        max_seq = max_seq if max_seq is not None else s + steps
        graph = prompt.device.type == "cuda"
        self.stats = {"graph": graph, "eager_steps": 0, "replays": 0,
                      "capture_s": 0.0}
        with torch.inference_mode():
            caches = self._cache_init(b, max_seq)
            logits, caches = self._prefill(params, prompt, caches)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            if on_step is not None:
                on_step(0, logits)
            if not graph:
                out = [tok]
                idx = torch.tensor(s, dtype=torch.int32)
                for i in range(1, steps):
                    logits, caches = self._decode(params, tok, caches, idx)
                    tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
                    out.append(tok)
                    if on_step is not None:
                        on_step(i, logits)
                    idx = idx + 1
                self.stats["eager_steps"] = steps - 1
                return torch.cat(out, dim=1)
            return self._generate_on_card(params, prompt, tok, caches, steps,
                                          on_step)

    def _generate_on_card(self, params, prompt, tok, caches, steps, on_step):
        """The decode loop on the card: the first step eagerly on the
        engine's stream for the device (made once, so that the libraries'
        per-stream state is set up once; a mesh's shard streams are
        shared by every mesh on the card, and set up by the same step),
        then one capture replayed for the other steps.  A mesh's shard
        streams wait for the replays before any later work of theirs."""
        dev = prompt.device
        s = prompt.shape[1]
        current = torch.cuda.current_stream(dev)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(current)
        out = [tok]
        graph = None
        with torch.cuda.stream(stream):
            for i in range(1, steps):
                if graph is None:
                    idx = torch.full((), s, dtype=torch.int32, device=dev)
                    logits, caches = self._decode(params, tok, caches, idx)
                    self.stats["eager_steps"] += 1
                    if i + 1 < steps:
                        graph = DecodeGraph(self._decode, params, tok,
                                            caches, stream)
                        self.stats["capture_s"] = graph.capture_s
                else:
                    logits = graph(tok, s + i - 1)
                    self.stats["replays"] = graph.replays
                tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
                out.append(tok)
                if on_step is not None:
                    on_step(i, logits)
            result = torch.cat(out, dim=1)
            mesh = getattr(params, "mesh", None)
            if mesh is not None:
                mesh.fork()
        current.wait_stream(stream)
        result.record_stream(current)
        return result
