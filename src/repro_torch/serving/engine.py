"""Batched LM serving engine: prefill + decode over per-layer caches
(port of ``repro/serving/engine.py``).

``prefill`` consumes the prompt and fills the caches (global layers:
full-length caches; local layers: O(window) ring buffers; SSM/RG-LRU
layers: constant-size recurrent state).  ``decode`` appends one token.
Greedy sampling; batch-synchronous (all requests share a position).
The reference compiles its two step functions with ``jax.jit``; here
they run eagerly under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class ServeEngine:
    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 cache_init: Callable):
        """All three callables come from the arch registry:
        - prefill_fn(model, tokens_or_embeds, caches) -> (logits, caches)
        - decode_fn(model, last_tokens (B,1), caches, index) -> (logits, caches)
        - cache_init(batch, max_seq) -> caches
        """
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._cache_init = cache_init

    def generate(self, params, prompt: torch.Tensor, steps: int,
                 max_seq: Optional[int] = None) -> torch.Tensor:
        """``steps`` greedy tokens a row after ``prompt (B, S)``, as a
        ``(B, steps)`` tensor of ``prompt``'s dtype."""
        b, s = prompt.shape[0], prompt.shape[1]
        max_seq = max_seq if max_seq is not None else s + steps
        with torch.inference_mode():
            caches = self._cache_init(b, max_seq)
            logits, caches = self._prefill(params, prompt, caches)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            out = [tok]
            idx = s
            for _ in range(steps - 1):
                logits, caches = self._decode(params, tok, caches, idx)
                tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
                out.append(tok)
                idx = idx + 1
            return torch.cat(out, dim=1)
