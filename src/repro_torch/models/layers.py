"""Neural building blocks of the LM families (port of
``repro/models/layers.py``).

Conventions
-----------
- Parameters keep the reference's shapes (``wq (d, h, hd)``, ``wo (h,
  hd, d)``, ``w_in (d, f)``, ...) and names, so carrying the reference's
  parameters across is a copy (:func:`repro_torch.convert.
  lm_params_from_numpy`).
- Every block's parameters have the reference's logical specs beside
  them (``RMSNORM_SPECS``, ``ATTENTION_SPECS``, :func:`mlp_specs`, and
  their kin in the other family modules): plain data, never tensor
  attributes, read by the dry run
  (:func:`repro_torch.models.registry.param_specs`).
- Parameters are stored in ``cfg.pdt`` (float32) and cast to ``cfg.cdt``
  (bfloat16) at each use (:func:`use_param`), as the reference does.
- Compute runs in ``cfg.cdt`` with fp32 where the reference keeps it:
  attention scores and softmax, norms, rotary angles, logits.  A score
  einsum the reference asks for with ``preferred_element_type=float32``
  runs here on fp32 copies of its bf16 operands (their products are
  exact in fp32, so it is the same contraction).
- Attention is plain tensor ops (``einsum``, ``softmax``) with the
  reference's ``-1e30`` masks, never a library attention: those mask and
  scale differently and would hide the reference's numerics.
- Every module is built on the device its caller names
  (:func:`repro_torch.models.registry.init_params`) and filled from an
  explicit ``torch.Generator`` on that device.
- Over a device mesh every mixer and MLP takes the residual stream's
  normed block input in the stream's layout and gives its output in the
  same layout: a stream placed ``(batch, "model", None)`` (the
  reference's sequence parallelism, the ``"seq"`` rule) is gathered
  over ``model`` first (:func:`gather_axis`, in the compute dtype) and
  the output brought back by :func:`to_stream`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (Placed, Spec, each,
                                              gather_axis, group_pieces,
                                              heads_to_seq, on_every_shard,
                                              ranges, reduce_scatter,
                                              reduce_sum, reshard)
from repro_torch.models.config import ModelConfig

Cache = Dict[str, torch.Tensor]
#: a decode position: an int, or a 0-d integer tensor on the model's
#: device (the reference's traced ``int32`` index), which keeps the step
#: free of host reads so that it can be captured as a CUDA graph
Position = Union[int, torch.Tensor]


# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------
class Init:
    """Where a model's parameters are made: the device, and the generator
    every random draw comes from, in construction order (on the meta
    device nothing is drawn: shapes only)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = device
        self.generator = generator

    def dense(self, shape: Sequence[int], dtype: torch.dtype,
              fan_in: Optional[int] = None) -> nn.Parameter:
        """``normal(shape) / sqrt(fan_in)`` (``fan_in`` defaults to
        ``shape[0]``), the reference's ``_dense_init``."""
        fan = fan_in if fan_in is not None else shape[0]
        t = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        if self.device.type != "meta":
            t.normal_(generator=self.generator)
            t.mul_(1.0 / math.sqrt(max(fan, 1)))
        return nn.Parameter(t)

    def const(self, values: torch.Tensor) -> nn.Parameter:
        """A parameter initialised to ``values`` (made on the CPU)."""
        return nn.Parameter(values.to(self.device))

    def full(self, shape: Sequence[int], value: float,
             dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.full(tuple(shape), value, dtype=dtype,
                                       device=self.device))


def use_param(param: Union[torch.Tensor, Placed], cfg: ModelConfig):
    """Bring a parameter to the compute dtype at its point of use (no
    copy when the two dtypes agree).  A placed parameter is cast piece by
    piece and then has its fsdp parts gathered over ``data``: the
    reference's cast-then-gather order (``layers.py:41-52``), which moves
    compute-dtype bytes."""
    if isinstance(param, Placed):
        cast = each(lambda t: t.to(cfg.cdt), param, spec=param.spec)
        return gather_axis(cast, "data")
    return param.to(cfg.cdt)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


#: the logical spec of an :class:`RMSNorm`'s parameter
#: (``layers.py::init_rmsnorm``'s spec tree)
RMSNORM_SPECS = {"scale": ("embed",)}


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, init: Init):
        super().__init__()
        self.scale = init.full((d,), 1.0, dtype)

    def forward(self, x, eps: float):
        if isinstance(x, Placed):
            return each(lambda sc, t: rmsnorm(sc, t, eps), self.scale, x,
                        spec=x.spec)
        return rmsnorm(self.scale, x, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation is its default."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``log(1 + exp(x))`` with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """fp32 softmax of ``scores`` with ``-1e30`` where ``mask`` is false,
    cast to ``dtype``."""
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  dtype=scores.dtype,
                                                  device=scores.device))
    return torch.softmax(scores, dim=-1).to(dtype)


# ----------------------------------------------------------------------
# rotary embeddings (RoPE + M-RoPE)
# ----------------------------------------------------------------------
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs) of ``x``'s last axis by
    ``ang`` (..., S, hd/2), broadcast over the head axis."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): 3 position streams (t, h, w) rotate
    disjoint sections of the frequency spectrum.

    x: (B, S, H, hd); positions3: (3, B, S).  For text-only inputs the
    three streams are identical and M-RoPE reduces to RoPE.
    """
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)  # (hd/2,)
    sec = torch.cumsum(torch.tensor((0,) + tuple(sections), device=x.device),
                       dim=0)
    idx = torch.arange(hd // 2, device=x.device)
    which = torch.clamp(torch.searchsorted(sec[1:], idx, right=True), 0, 2)
    ang_all = positions3[..., None].float() * freqs  # (3, B, S, hd/2)
    ang = torch.gather(ang_all.movedim(0, -1), -1,
                       which[:, None].expand(ang_all.shape[1:] + (1,)))[..., 0]
    return _rotate(x, ang)


# ----------------------------------------------------------------------
# attention (GQA, chunked-causal / banded-local / decode)
# ----------------------------------------------------------------------
def _divisor_chunk(chunk: int, s: int) -> int:
    """``min(chunk, s)`` shrunk to a divisor of ``s`` (odd lengths)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _f32_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``einsum("bqhd,bshd->bhqs")`` accumulated in fp32."""
    return torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale


def _chunk_checkpoint(fn, *args):
    """``fn(*args)``, one chunk of a chunked loop (an attention query
    chunk, an SSD chunk), checkpointed with nothing saved but its inputs
    when autograd records it: the reference's ``jax.checkpoint(...,
    policy=nothing_saveable)`` around its scan bodies.  Without it the
    loop saves every chunk's scores for the backward, the whole S x S
    matrix; with it the backward recomputes one chunk at a time and the
    live memory stays O(S * chunk).  The recompute runs the same
    operations on the same inputs, so the values and gradients are
    those of the plain call; with grad off (serving) it is the plain
    call.  The bodies draw no random numbers, so no RNG state is stashed
    for the recompute.  On the card the recompute is enqueued on the
    stream the chunk ran on (a mesh shard's, inside ``sharding.each``),
    whichever stream the backward that needs it runs on."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            body = fn

            def fn(*a):
                with torch.cuda.stream(stream):
                    return body(*a)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _chunk_scores(qc, k, v, mask: torch.Tensor) -> torch.Tensor:
    """One query chunk's attention: fp32 scores of ``qc`` against ``k``,
    the ``-1e30`` mask, the fp32 softmax cast to ``v``'s dtype, and the
    product with ``v``."""
    scores = _f32_scores(qc, k, 1.0 / math.sqrt(qc.shape[-1]))
    p = masked_softmax(scores, mask, v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, chunk_q: int,
                  q_offset: int = 0) -> torch.Tensor:
    """Attention over q chunks against full K/V.

    Flat-head layout: q (B, S, H, hd); k/v (B, Skv, H, hd) — K/V already
    repeated to full heads.  O(S * chunk) live memory instead of
    O(S^2), in the backward too: with more than one chunk each is
    checkpointed (:func:`_chunk_checkpoint`).  fp32 softmax.
    """
    b, s, h, hd = q.shape
    skv = k.shape[1]
    cq = _divisor_chunk(chunk_q, s)
    kv_pos = torch.arange(skv, device=q.device)

    def one_chunk(i: int, qc, k, v):
        q_pos = q_offset + i * cq + torch.arange(cq, device=qc.device)
        m = torch.ones((cq, skv), dtype=torch.bool, device=qc.device)
        if causal:
            m &= kv_pos[None, :] <= q_pos[:, None]
        if window > 0:
            m &= kv_pos[None, :] > q_pos[:, None] - window
        return _chunk_scores(qc, k, v, m)

    if s == cq:
        return one_chunk(0, q, k, v)
    return torch.cat([_chunk_checkpoint(one_chunk, i, q[:, i * cq:(i + 1) * cq],
                                        k, v)
                      for i in range(s // cq)], dim=1)


def _sdpa_banded(q, k, v, *, window: int, chunk: int) -> torch.Tensor:
    """Sliding-window attention with *static banded* kv access: each q
    chunk gathers only the ``band`` kv chunks that intersect its window
    (clamped chunk ids, masked where the id was negative).  With more
    than one chunk each is checkpointed, its gathered band and f32 keys
    with it (:func:`_chunk_checkpoint`)."""
    b, s, h, hd = q.shape
    c = _divisor_chunk(chunk, s)
    n = s // c
    band = min(n, window // c + 2)
    ks_ = k.reshape(b, n, c, h, hd)
    vs = v.reshape(b, n, c, h, hd)
    ar_c = torch.arange(c, device=q.device)

    def one(i: int, qc, ks_, vs):
        # gather kv chunks [i-band+1 .. i] (clamped; masked below)
        offs = i - torch.arange(band - 1, -1, -1, device=qc.device)
        offs_c = torch.clamp(offs, 0, n - 1)
        kg = ks_[:, offs_c].reshape(b, band * c, h, hd)
        vg = vs[:, offs_c].reshape(b, band * c, h, hd)
        q_pos = i * c + ar_c
        kv_pos = (offs_c[:, None] * c + ar_c[None, :]).reshape(-1)
        valid_chunk = torch.repeat_interleave(offs >= 0, c)
        m = ((kv_pos[None, :] <= q_pos[:, None])
             & (kv_pos[None, :] > q_pos[:, None] - window)
             & valid_chunk[None, :])
        return _chunk_scores(qc, kg, vg, m)

    if n == 1:
        return one(0, q, ks_, vs)
    return torch.cat([_chunk_checkpoint(one, i, q[:, i * c:(i + 1) * c],
                                        ks_, vs)
                      for i in range(n)], dim=1)


def _update_slice(buf: torch.Tensor, update: torch.Tensor, start: Position,
                  dim: int) -> None:
    """``lax.dynamic_update_slice_in_dim`` in place: the start index is
    *clamped* so that the update fits, as XLA clamps it.  A tensor
    ``start`` (0-d, on ``buf``'s device) is clamped and written on the
    device, with no host read, bitwise the int form."""
    size = update.shape[dim]
    if isinstance(start, torch.Tensor):
        rows = (start.clamp(0, buf.shape[dim] - size)
                + torch.arange(size, device=buf.device))
        buf.index_copy_(dim, rows, update)
        return
    start = min(max(int(start), 0), buf.shape[dim] - size)
    buf.narrow(dim, start, size).copy_(update)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def merge_heads(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, w)``."""
    h, k, d = w.shape
    return out.reshape(out.shape[:-2] + (h * k,)) @ w.reshape(h * k, d)


#: the logical specs of an :class:`Attention`'s parameters
#: (``layers.py::init_attention``'s spec tree)
ATTENTION_SPECS = {
    "wq": ("fsdp", "heads", None),
    "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None),
    "wo": ("heads", None, "fsdp"),
}


class Attention(nn.Module):
    """GQA attention: ``wq (d, h, hd)``, ``wk``/``wv (d, kv, hd)``, ``wo
    (h, hd, d)``."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.cfg = cfg
        self.wq = init.dense((d, h, hd), cfg.pdt)
        self.wk = init.dense((d, k, hd), cfg.pdt)
        self.wv = init.dense((d, k, hd), cfg.pdt)
        self.wo = init.dense((h, hd, d), cfg.pdt, fan_in=h * hd)

    def forward(
        self,
        x: torch.Tensor,
        *,
        kind: str = "global",          # "global" | "local"
        positions: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_index: Optional[Position] = None,
        kv_source: Optional[torch.Tensor] = None,   # cross-attention
        causal: bool = True,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Returns (output, updated_cache).

        Modes:
          - train/prefill: ``cache is None`` -> chunked causal / banded
            local.  (prefill-with-cache: pass a zeroed cache to also
            fill it with K/V.)
          - decode: ``cache`` + ``cache_index`` -> attend over the cache.
            A cache with a ``pos`` entry is a *ring buffer*
            (sliding-window layers keep only ``window`` slots).  The
            index is an int or a 0-d integer tensor (:data:`Position`).
          - cross: ``kv_source`` given -> no causal mask, no cache update.

        The cache's tensors are updated in place and returned in a new
        dict (the reference returns new arrays).
        """
        if isinstance(x, Placed):
            return self._forward_mesh(x, kind, cache, cache_index, positions,
                                      kv_source, causal)
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        g = h // kh
        cdt = cfg.cdt
        dev = x.device

        q = project_heads(x, use_param(self.wq, cfg))
        kv_in = x if kv_source is None else kv_source
        k = project_heads(kv_in, use_param(self.wk, cfg))
        v = project_heads(kv_in, use_param(self.wv, cfg))

        if kv_source is None and cfg.use_rope:
            if positions is None:
                pos = torch.arange(s, device=dev)[None]
                if cache_index is not None:
                    pos = pos + cache_index
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
            elif cfg.mrope:
                q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
                k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
            else:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)

        new_cache = None
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            cdtc = ck.dtype
            if "pos" in cache:           # ring buffer
                cpos = cache["pos"]
                w = ck.shape[1]
                if s == 1:
                    slot = cache_index % w
                    _update_slice(ck, k.to(cdtc), slot, 1)
                    _update_slice(cv, v.to(cdtc), slot, 1)
                    if isinstance(cache_index, torch.Tensor):
                        _update_slice(cpos, cache_index.reshape(1).to(cpos.dtype),
                                      slot, 0)
                    else:
                        cpos[slot] = cache_index
                elif s >= w:
                    # prefill into the ring: keep the last `w` positions
                    shift = (s - w) % w
                    ck.copy_(torch.roll(k[:, -w:].to(cdtc), shift, dims=1))
                    cv.copy_(torch.roll(v[:, -w:].to(cdtc), shift, dims=1))
                    cpos.copy_(torch.roll(torch.arange(s - w, s, dtype=cpos.dtype,
                                                       device=dev), shift))
                else:
                    _update_slice(ck, k.to(cdtc), 0, 1)
                    _update_slice(cv, v.to(cdtc), 0, 1)
                    cpos[:s] = torch.arange(s, dtype=cpos.dtype, device=dev)
                new_cache = {"k": ck, "v": cv, "pos": cpos}
                kv_pos = cpos[None, :]
            else:
                _update_slice(ck, k.to(cdtc), cache_index, 1)
                _update_slice(cv, v.to(cdtc), cache_index, 1)
                new_cache = {"k": ck, "v": cv}
                kv_pos = torch.arange(ck.shape[1], device=dev)[None, :]

            if s == 1:
                valid = _decode_valid(kv_pos, cache_index, kind, cfg)
                out = _decode_attend(q, ck, cv, valid, cfg)
                return merge_heads(out, use_param(self.wo, cfg)), new_cache

        # train / prefill path (flat heads: K/V repeated to all H)
        kf = torch.repeat_interleave(k, g, dim=2)
        vf = torch.repeat_interleave(v, g, dim=2)
        if kv_source is not None or not causal:
            out = _sdpa_chunked(q, kf, vf, causal=False, window=0,
                                chunk_q=cfg.attn_chunk)
        elif kind == "local" and cfg.window > 0:
            out = _sdpa_banded(q, kf, vf, window=cfg.window, chunk=cfg.attn_chunk)
        else:
            out = _sdpa_chunked(q, kf, vf, causal=True, window=0,
                                chunk_q=cfg.attn_chunk)
        return merge_heads(out, use_param(self.wo, cfg)), new_cache

    # ------------------------------------------------------------------
    # over a device mesh
    # ------------------------------------------------------------------
    def _forward_mesh(self, x: Placed, kind: str, cache: Optional[Dict],
                      cache_index: Optional[Position],
                      positions: Optional[Placed] = None,
                      kv_source: Optional[Placed] = None,
                      causal: bool = True):
        """Tensor-parallel attention over a :class:`DeviceMesh` (the
        reference's GSPMD layout of ``layers.py:250-271``): q, k and v
        column-parallel over ``heads`` and ``kv_heads`` (whole where the
        model extent does not divide them), K/V repeated to the shard's
        query heads, ``wo`` row-parallel with its partials summed over
        ``model`` in rank order.  A seq-placed ``x`` is gathered over
        ``model`` first and the output reduce-scattered back onto its
        positions (:func:`to_stream`).  Placed ``positions`` (M-RoPE's three
        streams, or plain RoPE positions) rotate each shard's heads;
        cross-attention takes k and v from the placed ``kv_source`` and
        attends without a mask, as ``causal=False`` does.  A prefill
        writes its keys and values into the ``kv_seq``-sharded cache
        through the head-to-sequence relayout; a decode step attends with
        :meth:`_decode_mesh`.  ``cache_index`` is an int, a 0-d integer
        tensor, or either already on every shard (a ``PerShard`` of
        :func:`~repro_torch.distributed.sharding.on_every_shard`, as the
        decoder hands it to each layer): a tensor is read on each shard's
        device, never on the host."""
        cfg = self.cfg
        mesh = x.mesh
        if cache_index is not None:
            cache_index = on_every_shard(cache_index, mesh)
        stream, x = x.spec, gather_axis(x, "model")
        b, s, _ = x.shape
        h, kh = cfg.n_heads, cfg.n_kv_heads
        g = h // kh
        bspec = x.spec[0]
        kv_in = x if kv_source is None else kv_source
        wq, wk, wv = (use_param(w, cfg) for w in (self.wq, self.wk, self.wv))
        hspec, kvspec = wq.spec[1], wk.spec[1]
        q = each(project_heads, x, wq, spec=(bspec, None, hspec, None))
        k = each(project_heads, kv_in, wk, spec=(bspec, None, kvspec, None))
        v = each(project_heads, kv_in, wv, spec=k.spec)
        if kv_source is None and cfg.use_rope:
            if positions is None:
                # each shard's first position: its rows are counted from it
                positions = on_every_shard(
                    0 if cache_index is None else cache_index, mesh)

                def rope(t, start):
                    pos = torch.arange(s, device=t.device)[None] + start
                    return apply_rope(t, pos, cfg.rope_theta)
            elif cfg.mrope:
                def rope(t, pos):
                    return apply_mrope(t, pos, cfg.rope_theta,
                                       cfg.mrope_sections)
            else:
                def rope(t, pos):
                    return apply_rope(t, pos, cfg.rope_theta)

            q = each(rope, q, positions, spec=q.spec)
            k = each(rope, k, positions, spec=k.spec)
        if cache is not None and s == 1 and kv_source is None:
            return self._decode_mesh(q, k, v, kind, cache, cache_index,
                                     stream)
        new_cache = None if cache is None else _prefill_cache(k, v, cache, s)

        hl = h // mesh.shape["model"] if hspec else h

        def full(t, m):
            # K/V repeated to all heads, the shard's query heads kept
            rep = torch.repeat_interleave(t, g, dim=2)
            return rep if hspec is None or kvspec else rep[:, :, m * hl:(m + 1) * hl]

        ranks = mesh.ranks("model")
        kf = each(full, k, ranks, spec=q.spec)
        vf = each(full, v, ranks, spec=q.spec)
        if kv_source is not None or not causal:
            def attend(q, k, v):
                return _sdpa_chunked(q, k, v, causal=False, window=0,
                                     chunk_q=cfg.attn_chunk)
        elif kind == "local" and cfg.window > 0:
            def attend(q, k, v):
                return _sdpa_banded(q, k, v, window=cfg.window,
                                    chunk=cfg.attn_chunk)
        else:
            def attend(q, k, v):
                return _sdpa_chunked(q, k, v, causal=True, window=0,
                                     chunk_q=cfg.attn_chunk)
        out = each(attend, q, kf, vf, spec=q.spec)
        return _row_parallel(out, use_param(self.wo, cfg), merge_heads,
                             stream), new_cache

    def _decode_mesh(self, q: Placed, k: Placed, v: Placed, kind: str,
                     cache: Dict, cache_index, stream: Spec):
        """One decode step against the ``kv_seq``-sharded cache (the
        reference's flash-decode layout, ``transformer.py:95-115``): the
        new row, every kv head, written by the shard whose part of the
        cache holds its slot (a ring's ``pos`` with it), then every query
        head against the cache through :func:`attend_kv_seq`.
        ``cache_index`` holds each shard's position (a ``PerShard``):
        with tensors, every shard computes its clamped local row on its
        device and writes it, the owner the new row and every other shard
        its old row back (:func:`_write_decode_row`)."""
        cfg = self.cfg
        ck, cv = cache["k"], cache["v"]
        ring = "pos" in cache
        n = ck.shape[1]
        k_all, v_all = gather_axis(k, "model"), gather_axis(v, "model")

        def write(ck, cv, k, v, span, index, cpos=None):
            _write_decode_row(ck, cv, k, v, span, index, n, ring, cpos)

        pos = [cache["pos"]] if ring else []
        each(write, ck, cv, k_all, v_all, ranges(ck, 1), cache_index, *pos,
             spec=None)

        def valid(span, device, index, cpos=None):
            kv_pos = (cpos[None, :] if cpos is not None else
                      torch.arange(span[0], span[1], device=device)[None, :])
            return _decode_valid(kv_pos, index, kind, cfg)

        out = attend_kv_seq(gather_axis(q, "model"), ck, cv, valid, cfg,
                            [cache_index] + pos)
        return heads_out(out, q, use_param(self.wo, cfg), stream), cache


def _write_decode_row(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, span: Tuple[int, int], index: Position,
                      n: int, ring: bool, cpos: Optional[torch.Tensor] = None
                      ) -> None:
    """A decode step's key and value row (and a ring's position) written
    into one shard's part ``span = (lo, hi)`` of an ``n``-slot cache, at
    the slot of position ``index`` (``index % n`` in a ring), clamped
    into the cache as XLA clamps it.  An int index is resolved on the
    host and only the owning shard writes.  A 0-d tensor index stays on
    the device: every shard writes its clamped local row, the owner's
    new row and any other shard's old row, so that no shard reads back
    which one owns it; the result is the int form's bit for bit."""
    lo, hi = span
    if not isinstance(index, torch.Tensor):
        slot = min(max(index % n if ring else index, 0), n - 1)
        if lo <= slot < hi:
            ck.narrow(1, slot - lo, 1).copy_(k.to(ck.dtype))
            cv.narrow(1, slot - lo, 1).copy_(v.to(cv.dtype))
            if cpos is not None:
                cpos[slot - lo] = index
        return
    slot = (index % n if ring else index).clamp(0, n - 1)
    owner = (slot >= lo) & (slot < hi)
    row = (slot - lo).clamp(0, hi - lo - 1).reshape(1).long()
    for buf, new in ((ck, k), (cv, v)):
        buf.index_copy_(1, row, torch.where(owner, new.to(buf.dtype),
                                            buf.index_select(1, row)))
    if cpos is not None:
        cpos.index_copy_(0, row, torch.where(owner, index.reshape(1).to(
            cpos.dtype), cpos.index_select(0, row)))


def attend_kv_seq(q_all: Placed, ck: Placed, cv: Placed, valid,
                  cfg: ModelConfig, extra=()) -> Placed:
    """Every query head of ``q_all (b, sq, h, hd)`` (whole on each model
    shard) against a ``kv_seq``-sharded K/V cache (the reference's
    flash-decode layout, ``transformer.py:95-115``): each shard scores
    the queries against its part of the positions and keeps a partial
    softmax (running max, sum and weighted values, f32), and the
    partials combine in rank order on each shard of the group.
    ``valid(span, device, *extra)`` is the ``(1, n)`` mask of the
    positions ``span`` of a shard's part (``extra``: per-shard arguments,
    placed or ``PerShard``, such as the decode position and a ring's
    ``pos``).  A cache whose positions the model
    extent does not divide is whole on every shard, which attends as
    one device does (:func:`_decode_attend`)."""
    mesh = q_all.mesh
    b, sq = q_all.pieces[0].shape[:2]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kh
    cdt = cfg.cdt
    spans = ranges(ck, 1)
    if ck.spec[1] is None:
        def attend(q, ck, cv, span, *extra):
            return _decode_attend(q, ck, cv, valid(span, ck.device, *extra),
                                  cfg)
        return each(attend, q_all, ck, cv, spans, *extra, spec=q_all.spec)

    def partial(q, ck, cv, span, *extra):
        qg = q.reshape(b, sq, kh, g, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                              ck.to(cdt).float()) / math.sqrt(hd)
        scores = torch.where(valid(span, ck.device, *extra)[:, None, None, None],
                             scores, torch.full((), -1e30, device=ck.device))
        top = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - top)
        o = torch.einsum("bkgqs,bskh->bkgqh", e, cv.to(cdt).float())
        return torch.cat([top, e.sum(dim=-1, keepdim=True), o], dim=-1)

    parts = each(partial, q_all, ck, cv, spans, *extra, spec=None)

    def combine(group):
        top = group[0][..., :1]
        for p in group[1:]:
            top = torch.maximum(top, p[..., :1])
        acc = None
        for p in group:
            term = torch.exp(p[..., :1] - top) * p[..., 1:]
            acc = term if acc is None else acc + term
        o = acc[..., 1:] / acc[..., :1]                  # (b, kh, g, sq, hd)
        return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(cdt)

    return each(combine, group_pieces(parts, "model", mesh),
                spec=q_all.spec, mesh=mesh)


def heads_out(out: Placed, q: Placed, wo: Placed, stream: Spec) -> Placed:
    """The output projection of attention computed with every head on
    each shard (``out``): each shard keeps the query heads of its ``q``
    piece where ``wo`` is sharded over ``heads``, then ``wo``
    row-parallel, its output in the residual stream's layout
    ``stream``."""
    if wo.spec[0] is not None:
        hl = q.pieces[0].shape[2]
        out = each(lambda o, m: o[:, :, m * hl:(m + 1) * hl], out,
                   out.mesh.ranks("model"), spec=q.spec)
    return _row_parallel(out, wo, merge_heads, stream)


def _prefill_cache(k: Placed, v: Placed, cache: Dict, s: int) -> Dict:
    """A prefill's keys and values written into a ``kv_seq``-sharded
    cache, as the one-device prefill writes them (a full cache from
    position 0; a ring keeps the last ``w`` positions rolled into their
    slots, or the first ``s`` from slot 0), each shard taking the
    positions its part holds through :func:`heads_to_seq`."""
    ck, cv = cache["k"], cache["v"]
    ring = "pos" in cache
    w = ck.shape[1]
    if ring and s >= w:
        shift = (s - w) % w
        k = each(lambda t: torch.roll(t[:, -w:], shift, dims=1), k, spec=k.spec)
        v = each(lambda t: torch.roll(t[:, -w:], shift, dims=1), v, spec=v.spec)
        n = w
    else:
        n = s
    spans = ranges(ck, 1)
    written = [(min(lo, n), min(hi, n)) for lo, hi in spans]
    ks, vs = heads_to_seq(k, written), heads_to_seq(v, written)

    def write(ck, cv, kr, vr, span, cpos=None):
        lo, hi = span
        m = min(hi, n) - lo
        if m > 0:
            ck.narrow(1, 0, m).copy_(kr.to(ck.dtype))
            cv.narrow(1, 0, m).copy_(vr.to(cv.dtype))
        if cpos is not None:
            if s >= w:
                ring_pos = torch.roll(torch.arange(s - w, s, dtype=cpos.dtype,
                                                   device=cpos.device), shift)
                cpos.copy_(ring_pos[lo:hi])
            elif m > 0:
                cpos[:m] = torch.arange(lo, lo + m, dtype=cpos.dtype,
                                        device=cpos.device)

    each(write, ck, cv, ks, vs, spans, *([cache["pos"]] if ring else []),
         spec=None)
    return cache


def to_stream(y: Placed, stream: Spec, partial: bool) -> Placed:
    """A block's output ``y`` (positions whole on every shard) in the
    residual stream's layout ``stream``.  A ``partial`` output (each
    model shard's share of a sum) is reduce-scattered onto the positions
    where the stream is seq-placed (``stream[1] == "model"``) and
    all-reduced where it is whole, both in rank order
    (:func:`reduce_scatter`, :func:`reduce_sum`).  A whole output (the
    MoE combine, a block every model shard runs whole) is narrowed to
    each shard's positions, and never summed."""
    if stream[1] is not None:
        return reduce_scatter(y, stream[1], 1) if partial else \
            reshard(y, stream)
    return reduce_sum(y, "model") if partial else y


def _row_parallel(x: Placed, w: Placed, product, stream: Spec) -> Placed:
    """``product(x, w)`` shard by shard, in the residual stream's
    layout ``stream`` (:func:`to_stream`): its partials summed over
    ``model`` when ``w``'s contracted (first) dimension is on ``model``,
    whole otherwise."""
    y = each(product, x, w, spec=(x.spec[0], None, None))
    return to_stream(y, stream, w.spec[0] is not None)


def _decode_valid(kv_pos: torch.Tensor, cache_index: Position, kind: str,
                  cfg: ModelConfig) -> torch.Tensor:
    """The cache positions a decode step at ``cache_index`` attends:
    written, not in the future, and for a local layer inside the
    window."""
    valid = (kv_pos <= cache_index) & (kv_pos >= 0)
    if kind == "local" and cfg.window > 0:
        valid &= kv_pos > cache_index - cfg.window
    return valid


def _decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   valid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decode step's attention over a whole cache: GROUPED einsums over
    (kv_heads, g), the reference's layout; ``(b, sq, h, hd)``."""
    b, sq = q.shape[:2]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kh
    cdt = cfg.cdt
    qg = q.reshape(b, sq, kh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), ck.to(cdt).float())
    scores = scores / math.sqrt(hd)
    pr = masked_softmax(scores, valid[:, None, None, None], cdt)
    out = torch.einsum("bkgqs,bskh->bqkgh", pr, cv.to(cdt))
    return out.reshape(b, sq, h, hd)


# ----------------------------------------------------------------------
# dense MLP
# ----------------------------------------------------------------------
def _act(name: str, h: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
    if name == "silu_gated":
        return F.silu(g) * h
    if name == "gelu_gated":
        return gelu(g) * h
    return gelu(h)


def mlp_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical specs of an :class:`MLP`'s parameters
    (``layers.py::init_mlp``'s spec tree)."""
    specs = {"w_in": ("fsdp", "mlp"), "w_out": ("mlp", "fsdp")}
    if "gated" in cfg.mlp_act:
        specs["w_gate"] = ("fsdp", "mlp")
    return specs


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.w_in = init.dense((d, f), cfg.pdt)
        self.w_gate = (init.dense((d, f), cfg.pdt) if "gated" in cfg.mlp_act
                       else None)
        self.w_out = init.dense((f, d), cfg.pdt, fan_in=f)

    def forward(self, x):
        cfg = self.cfg
        if isinstance(x, Placed):
            return self._forward_mesh(x)
        h = x @ use_param(self.w_in, cfg)
        g = None if self.w_gate is None else x @ use_param(self.w_gate, cfg)
        return _act(cfg.mlp_act, h, g) @ use_param(self.w_out, cfg)

    def _forward_mesh(self, x: Placed) -> Placed:
        """Column-parallel ``w_in``/``w_gate`` over ``mlp``, then
        row-parallel ``w_out``, its partials summed over ``model`` in
        rank order; the input gathered from, and the output brought back
        to, the residual stream's layout (:func:`to_stream`)."""
        cfg = self.cfg
        stream, x = x.spec, gather_axis(x, "model")
        w_in = use_param(self.w_in, cfg)
        spec = (x.spec[0], None, w_in.spec[1])
        h = each(torch.matmul, x, w_in, spec=spec)
        if self.w_gate is None:
            a = each(lambda h: _act(cfg.mlp_act, h, None), h, spec=spec)
        else:
            g = each(torch.matmul, x, use_param(self.w_gate, cfg), spec=spec)
            a = each(lambda h, g: _act(cfg.mlp_act, h, g), h, g, spec=spec)
        return _row_parallel(a, use_param(self.w_out, cfg), torch.matmul,
                             stream)
