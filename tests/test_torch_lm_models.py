"""The port's LM families (``repro_torch.models``) against the reference
(``repro.models``) on the CPU: teacher-forced logits of all ten SMOKE
configs, the building blocks one by one, MoE routing tables, and
bf16-compute logits.

The reference's parameters come from ``init_params(PRNGKey(0))`` and are
carried across by ``repro_torch.convert.lm_params_from_numpy``; inputs
are numpy arrays from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (LM_TOL, lm_inputs, max_abs_diff, port_lm, ref_lm,
                         to_torch)
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import recurrent as RR
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RefConfig
from repro_torch.models import encdec as PE
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import recurrent as PRC
from repro_torch.models import registry as PR
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig

#: bf16 compute: the port's logits within 1/8 of the largest |logit| of
#: the reference's at worst and 1/100 of it on average.  The reference's
#: own bf16 logits sit 0.06-0.11 (max) and 0.003-0.008 (mean) of that
#: scale from its f32 logits on these inputs: the tolerance is the bf16
#: rounding noise of the residual stream and the bf16 logits, not a
#: difference in the arithmetic.
BF16_MAX_REL, BF16_MEAN_REL = 0.125, 0.01


def _forward_both(arch, compute_dtype, seed=1, b=2, s=24):
    """Teacher-forced logits of the reference and the port (numpy)."""
    rcfg, params, _ = ref_lm(arch, compute_dtype)
    pcfg, model = port_lm(arch, compute_dtype)
    np_in = lm_inputs(pcfg, seed, b, s)
    t_in = to_torch(np_in)
    j_in = {k: jnp.asarray(v) for k, v in np_in.items()}
    with torch.no_grad():
        if pcfg.family == "encdec":
            ref, _ = jax.jit(lambda p, t, f: RE.decode(
                p, t, RE.encode(p, f, rcfg), rcfg))(params, j_in["tokens"],
                                                   j_in["frames"])
            got, _ = PE.decode(model, t_in["tokens"],
                               PE.encode(model, t_in["frames"], pcfg), pcfg)
        else:
            ref, _, _ = jax.jit(lambda p, t, pos: RT.decoder_forward(
                p, t, rcfg, positions=pos))(params, j_in["tokens"],
                                            j_in.get("positions"))
            got, _, _ = PT.decoder_forward(model, t_in["tokens"], pcfg,
                                           positions=t_in.get("positions"))
    return np.asarray(ref), got.numpy(), pcfg


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_teacher_forced_logits_match_the_reference_f32(arch):
    ref, got, cfg = _forward_both(arch, "float32")
    assert got.shape == ref.shape == (2, 24, cfg.padded_vocab)
    assert max_abs_diff(got, ref) < LM_TOL
    # the padded vocabulary's columns are masked to -1e30 on both sides
    assert np.array_equal(got[..., cfg.vocab:], ref[..., cfg.vocab:])


@pytest.mark.parametrize("arch", ["llama3_8b", "gemma3_12b", "mamba2_370m",
                                  "recurrentgemma_9b", "whisper_small"])
def test_teacher_forced_logits_match_the_reference_bf16(arch):
    ref, got, cfg = _forward_both(arch, "bfloat16")
    ref, got = ref[..., :cfg.vocab], got[..., :cfg.vocab]
    scale = float(np.max(np.abs(ref)))
    err = np.abs(got.astype(np.float64) - ref)
    assert np.isfinite(got).all()
    assert float(err.max()) <= BF16_MAX_REL * scale, (float(err.max()), scale)
    assert float(err.mean()) <= BF16_MEAN_REL * scale, (float(err.mean()), scale)


def test_layer_order_is_the_reference_flattening():
    """Layer g*period + j of the port is group g's slot j of the
    reference (gemma3's 5:1 pattern, and recurrentgemma's tail)."""
    for arch in ("gemma3_12b", "recurrentgemma_9b"):
        cfg = PR.get_config(arch)
        kinds = PT.layer_kinds(cfg)
        period = len(cfg.attn_pattern)
        flat = [cfg.attn_pattern[j] for g in range(cfg.n_groups)
                for j in range(period)] + list(cfg.attn_pattern[:cfg.n_tail])
        assert kinds == flat and len(kinds) == cfg.n_layers
    assert PT.layer_kinds(PR.get_config("recurrentgemma_9b"))[-2:] == ["rec", "rec"]


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------
def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_the_reference(theta):
    x = _rng(0).standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None] + 11
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = PL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    assert max_abs_diff(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 3, 3), (16, 24, 24)])
def test_apply_mrope_matches_the_reference(sections):
    hd = 2 * sum(sections)
    x = _rng(1).standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos3 = _rng(2).integers(0, 50, (3, 2, 5))
    ref = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = PL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6,
                         sections)
    assert max_abs_diff(got.numpy(), ref) < 1e-5
    # identical streams: M-RoPE reduces to RoPE
    same = np.ascontiguousarray(np.broadcast_to(pos3[0], pos3.shape))
    assert torch.equal(
        PL.apply_mrope(torch.as_tensor(x), torch.as_tensor(same), 1e6, sections),
        PL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3[0]), 1e6))


def test_rmsnorm_scales_by_one_plus_scale():
    x = _rng(3).standard_normal((2, 4, 8)).astype(np.float32)
    scale = _rng(4).standard_normal(8).astype(np.float32)
    ref = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = PL.rmsnorm(torch.as_tensor(scale), torch.as_tensor(x), 1e-6)
    assert max_abs_diff(got.numpy(), ref) < 1e-6


@pytest.mark.parametrize("s,chunk,causal", [(24, 16, True), (21, 8, True),
                                            (13, 32, False), (30, 7, True)])
def test_sdpa_chunked_matches_the_reference(s, chunk, causal):
    """Odd lengths shrink the chunk to a divisor, as the reference does."""
    q, k, v = (_rng(i).standard_normal((2, s, 4, 8)).astype(np.float32)
               for i in (5, 6, 7))
    ref = RL._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                           window=0, chunk_q=chunk)
    got = PL._sdpa_chunked(*map(torch.as_tensor, (q, k, v)), causal=causal,
                           window=0, chunk_q=chunk)
    assert max_abs_diff(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("s,chunk,window", [(24, 16, 16), (40, 8, 12),
                                            (21, 8, 5), (16, 32, 32)])
def test_sdpa_banded_matches_the_reference(s, chunk, window):
    """Clamped kv-chunk ids with ``offs < 0`` masked."""
    q, k, v = (_rng(i).standard_normal((1, s, 2, 8)).astype(np.float32)
               for i in (8, 9, 10))
    ref = RL._sdpa_banded(*map(jnp.asarray, (q, k, v)), window=window,
                          chunk=chunk)
    got = PL._sdpa_banded(*map(torch.as_tensor, (q, k, v)), window=window,
                          chunk=chunk)
    assert max_abs_diff(got.numpy(), ref) < 1e-5


def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    assert max_abs_diff(PL.gelu(torch.as_tensor(x)).numpy(),
                        jax.nn.gelu(jnp.asarray(x))) < 1e-6
    assert max_abs_diff(PL.softplus(torch.as_tensor(x * 10)).numpy(),
                        jax.nn.softplus(jnp.asarray(x * 10))) < 1e-5


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_the_reference_recursion(n):
    """The odd/even recursion of ``jax.lax.associative_scan``: on an
    integer-valued combine the two agree exactly."""
    a = _rng(11).integers(-3, 4, (2, n, 3)).astype(np.float64)
    b = _rng(12).integers(-3, 4, (2, n, 3)).astype(np.float64)

    def comb(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
    ref = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                   axis=1)
    got = PRC.associative_scan(comb, (torch.as_tensor(a), torch.as_tensor(b)),
                               dim=1)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())


def _ref_block(init_fn, cfg):
    p, _ = init_fn(jax.random.PRNGKey(3), cfg)
    return p, jax.tree.map(np.asarray, p)


def _load(module, tree):
    with torch.no_grad():
        for name, param in module.named_parameters():
            param.copy_(torch.as_tensor(np.array(tree[name])))
    return module


def _small_cfg(**kw):
    base = dict(name="t", family="hybrid", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=1, d_ff=32, vocab=64, compute_dtype="float32")
    base.update(kw)
    return base


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_block_matches_the_reference(with_h0):
    """RG-LRU prefill (h0 folded in as a virtual step at t = -1) and one
    recurrent decode step."""
    rcfg, pcfg = RefConfig(**_small_cfg()), ModelConfig(**_small_cfg())
    p, tree = _ref_block(RR.init_rglru_block, rcfg)
    blk = _load(PRC.RGLRUBlock(pcfg, PL.Init(torch.device("cpu"))), tree)
    u = _rng(13).standard_normal((2, 9, 16)).astype(np.float32)
    cache = None
    if with_h0:
        cache = {"h": _rng(14).standard_normal((2, 16)).astype(np.float32),
                 "conv": _rng(15).standard_normal((2, 3, 16)).astype(np.float32)}
    jc = None if cache is None else jax.tree.map(jnp.asarray, cache)
    tc = None if cache is None else {k: torch.as_tensor(v) for k, v in cache.items()}
    ry, rc = RR.rglru_block(p, jnp.asarray(u), rcfg, jc)
    with torch.no_grad():
        gy, gc = PRC.rglru_block(blk, torch.as_tensor(u), pcfg, tc)
    assert max_abs_diff(gy.numpy(), ry) < 1e-5
    if with_h0:
        for k in ("h", "conv"):
            assert max_abs_diff(gc[k].numpy(), rc[k]) < 1e-5
        step = _rng(16).standard_normal((2, 1, 16)).astype(np.float32)
        ry, rc = RR.rglru_block(p, jnp.asarray(step), rcfg, rc, jnp.asarray(9))
        with torch.no_grad():
            gy, gc = PRC.rglru_block(blk, torch.as_tensor(step), pcfg, gc, 9)
        assert max_abs_diff(gy.numpy(), ry) < 1e-5
        assert max_abs_diff(gc["h"].numpy(), rc["h"]) < 1e-5


@pytest.mark.parametrize("s,chunk", [(16, 8), (12, 5), (7, 16)])
def test_ssd_chunked_matches_the_reference(s, chunk):
    b, nh, hp, n = 2, 3, 4, 5
    r = _rng(17)
    x = r.standard_normal((b, s, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, nh)))).astype(np.float32)
    a = -np.arange(1, nh + 1, dtype=np.float32)
    bm, cm = (r.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    h0 = r.standard_normal((b, nh, n, hp)).astype(np.float32)
    args = (x, dt, a, bm, cm)
    ry, rh = RS.ssd_chunked(*map(jnp.asarray, args), chunk, jnp.asarray(h0))
    gy, gh = PS.ssd_chunked(*map(torch.as_tensor, args), chunk,
                            torch.as_tensor(h0))
    assert max_abs_diff(gy.numpy(), ry) < 1e-4
    assert max_abs_diff(gh.numpy(), rh) < 1e-4


# ----------------------------------------------------------------------
# MoE routing
# ----------------------------------------------------------------------
def _moe_cfgs(capacity_factor=1.25, **kw):
    base = dict(name="m", family="lm", n_layers=1, d_model=8, n_heads=2,
                n_kv_heads=1, d_ff=16, vocab=32, n_experts=4, top_k=2,
                capacity_factor=capacity_factor, compute_dtype="float32")
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _ref_tables(x, router, cfg):
    """The reference's dispatch, ``repro/models/moe.py:72-97`` with no
    tensor-parallel axis (rank 0, all experts local), line for line: the
    reference builds its tables inside ``_moe_local`` and returns only
    their product."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(np.ceil(t * k / e * cfg.capacity_factor))
    logits = (x.astype(jnp.float32) @ router).astype(jnp.float32)
    top_w, top_e = jax.lax.top_k(logits, k)
    top_w = jax.nn.softmax(top_w, axis=-1)
    flat_e = top_e.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(t), k)
    flat_w = top_w.reshape(-1)
    order = jnp.argsort(flat_e)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(se, se, side="left")
    valid = (se >= 0) & (se < e) & (pos < cap)
    dest = jnp.where(valid, se * cap + pos, e * cap)
    tok = jnp.full((e * cap + 1,), t, jnp.int32).at[dest].set(st.astype(jnp.int32))
    w = jnp.zeros((e * cap + 1,), jnp.float32).at[dest].set(sw)
    return np.asarray(tok[:-1].reshape(e, cap)), np.asarray(w[:-1].reshape(e, cap))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 16.0])
@pytest.mark.parametrize("tied", [False, True])
def test_moe_routing_tables_and_output_match_the_reference(capacity_factor,
                                                           tied):
    """Token tables equal, drops included (the default 1.25 drops tokens
    on these inputs), weight tables to rounding; ``tied`` zeroes the router so every logit ties and
    ``top_k`` must pick the lowest expert ids."""
    rcfg, pcfg = _moe_cfgs(capacity_factor)
    p, _ = RM.init_moe(jax.random.PRNGKey(0), rcfg)
    if tied:
        p = dict(p, router=jnp.zeros_like(p["router"]))
    x = _rng(20).standard_normal((3, 8, 8)).astype(np.float32)
    tok, w = _ref_tables(jnp.asarray(x.reshape(-1, 8)), p["router"], rcfg)
    g_tok, g_w, _ = PM.route(torch.as_tensor(x.reshape(-1, 8)),
                             torch.as_tensor(np.asarray(p["router"])), pcfg)
    assert np.array_equal(g_tok.numpy(), tok)
    # the weights are a softmax of the top-k logits: exp differs between
    # XLA and torch in the last bits
    np.testing.assert_allclose(g_w.numpy(), w, rtol=1e-6, atol=0)
    kept = int((tok < 24).sum())              # 24 tokens x top-2
    assert kept < 48 if capacity_factor < 16 else kept == 48
    ref, raux = RM._moe_local(jnp.asarray(x), p["router"], p["w_in"],
                              p.get("w_gate"), p["w_out"], cfg=rcfg,
                              tp_axis=None, fsdp_axis=None, batch_axes=())
    blk = _load(PM.MoE(pcfg, PL.Init(torch.device("cpu"))),
                jax.tree.map(np.asarray, p))
    with torch.no_grad():
        got, aux = PM.moe(blk, torch.as_tensor(x), pcfg)
    assert max_abs_diff(got.numpy(), ref) < 1e-5
    assert abs(float(aux) - float(raux)) < 1e-6


def test_moe_combine_sums_in_ascending_slot_order():
    """Each token's rows summed in ascending slot order from a zero row,
    empty slots and dropped tokens contributing nothing."""
    tok = torch.tensor([[0, 2, 3], [1, 0, 3], [2, 3, 3]])   # t = 3; 3 = empty
    y = torch.arange(9 * 2, dtype=torch.float32).reshape(9, 2) + 1
    out = PM.combine(y, tok, 3, 2)
    want = torch.zeros(3, 2)
    for slot, t in enumerate(tok.reshape(-1).tolist()):
        if t < 3:
            want[t] += y[slot]
    assert torch.equal(out, want)


def test_moe_over_a_mesh_raises():
    """Under a logical mesh nothing is placed: the (1, 1) mesh runs the
    mesh-less block and a longer axis raises.  Over a device mesh the
    expert-parallel block runs (tests/test_torch_lm_mesh.py holds it)."""
    from repro_torch.distributed.sharding import (LogicalMesh, make_device_mesh,
                                                  place, to_whole, use_rules)

    _, pcfg = _moe_cfgs()
    blk = PM.MoE(pcfg, PL.Init(torch.device("cpu"),
                               torch.Generator().manual_seed(0)))
    x = torch.zeros(1, 2, 8)
    with use_rules(LogicalMesh(("data", "model"), {"data": 1, "model": 1})):
        want, _ = PM.moe(blk, x, pcfg)   # the one card: the mesh-less path
    with use_rules(LogicalMesh(("data", "model"), {"data": 1, "model": 2})):
        with pytest.raises(NotImplementedError, match="DeviceMesh"):
            PM.moe(blk, x, pcfg)
    mesh = make_device_mesh(1, 2, device="cpu")
    placed = PM.MoE(pcfg, PL.Init(torch.device("meta")))
    for name, p in blk.named_parameters():
        del placed._parameters[name]
        spec = ("model", None, None) if p.dim() == 3 else (None, None)
        setattr(placed, name, place(p.detach(), mesh, spec))
    with torch.no_grad():
        got, _ = PM.moe(placed, place(x, mesh, (None, None, None)), pcfg)
    assert torch.equal(to_whole(got), want)


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_params_round_trip_through_convert(arch):
    """Reference tree -> port modules -> reference tree, bitwise, with
    every leaf accounted for."""
    from repro_torch.convert import lm_params_to_numpy

    _, _, tree = ref_lm(arch)
    _, model = port_lm(arch)
    back = lm_params_to_numpy(model)
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        assert np.array_equal(flat_back[path], leaf), path
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(leaf).size for _, leaf in flat_ref)
