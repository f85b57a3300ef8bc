"""The port's LM serving path against the reference on the CPU: prefill
and every decode step's logits and caches against the reference's
``make_prefill``/``make_decode``, the port's own decode-consistency
(prefill + decode = the teacher-forced forward, the ring cache 50 steps
past its window), and greedy ``ServeEngine.generate`` tokens equal to
the reference engine's.  f32 compute, the reference's tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (LM_TOL, lm_inputs, max_abs_diff, port_lm,
                         ref_lm, to_torch, tree_max_abs_diff)
from repro.models import registry as RR
from repro_torch.convert import lm_caches_from_numpy, lm_caches_to_numpy
from repro_torch.models import encdec as PE
from repro_torch.models import registry as PR
from repro_torch.models import transformer as PT
from repro_torch.serving import ServeEngine

#: the nine archs that serve token prompts (qwen2-vl takes embeddings)
SERVING_ARCHS = [a for a in PR.ARCH_IDS if a != "qwen2_vl_72b"]


def _prefill_inputs(cfg, np_in, s):
    out = {"tokens": np_in["tokens"][:, :s]}
    if "frames" in np_in:
        out["frames"] = np_in["frames"]
    return out


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Logits and caches after the prefill and after each of 5 decode
    steps, within the reference's TOL."""
    rcfg, params, _ = ref_lm(arch)
    pcfg, model = port_lm(arch)
    b, s, extra = 2, 24, 5
    np_in = lm_inputs(pcfg, 2, b, s + extra)
    pre = _prefill_inputs(pcfg, np_in, s)
    rc, _ = RR.init_caches(rcfg, b, s + extra)
    pc = PR.init_caches(pcfg, b, s + extra, device="cpu")
    assert tree_max_abs_diff(lm_caches_to_numpy(pcfg, pc),
                             jax.tree.map(np.asarray, rc)) == 0

    rl, rc = jax.jit(RR.make_prefill(rcfg))(
        params, {k: jnp.asarray(v) for k, v in pre.items()}, rc)
    with torch.no_grad():
        pl, pc = PR.make_prefill(pcfg)(model, to_torch(pre), pc)
    assert max_abs_diff(pl.numpy(), rl) < LM_TOL
    assert tree_max_abs_diff(lm_caches_to_numpy(pcfg, pc),
                             jax.tree.map(np.asarray, rc)) < LM_TOL

    rdec, pdec = jax.jit(RR.make_decode(rcfg)), PR.make_decode(pcfg)
    for t in range(extra):
        tok = np_in["tokens"][:, s + t:s + t + 1]
        rl, rc = rdec(params, jnp.asarray(tok), rc, jnp.asarray(s + t, jnp.int32))
        with torch.no_grad():
            pl, pc = pdec(model, torch.as_tensor(tok).long(), pc, s + t)
        assert max_abs_diff(pl.numpy(), rl) < LM_TOL, t
        assert tree_max_abs_diff(lm_caches_to_numpy(pcfg, pc),
                                 jax.tree.map(np.asarray, rc)) < LM_TOL, t


def test_decode_from_the_reference_caches():
    """A decode step from the reference's prefilled caches carried across
    by ``lm_caches_from_numpy`` (ring positions included) equals the
    reference's step."""
    arch = "gemma3_12b"
    rcfg, params, _ = ref_lm(arch)
    pcfg, model = port_lm(arch)
    b, s = 2, 20
    np_in = lm_inputs(pcfg, 3, b, s + 1)
    rc, _ = RR.init_caches(rcfg, b, s + 1)
    _, rc = jax.jit(RR.make_prefill(rcfg))(
        params, {"tokens": jnp.asarray(np_in["tokens"][:, :s])}, rc)
    pc = lm_caches_from_numpy(pcfg, jax.tree.map(np.asarray, rc), device="cpu")
    assert pc[0]["pos"].dtype == torch.int32
    tok = np_in["tokens"][:, s:]
    rl, _ = jax.jit(RR.make_decode(rcfg))(params, jnp.asarray(tok), rc,
                                          jnp.asarray(s, jnp.int32))
    with torch.no_grad():
        pl, _ = PR.make_decode(pcfg)(model, torch.as_tensor(tok).long(), pc, s)
    assert max_abs_diff(pl.numpy(), rl) < LM_TOL


def _teacher_forced(cfg, model, np_in):
    t_in = to_torch(np_in)
    with torch.no_grad():
        if cfg.family == "encdec":
            enc = PE.encode(model, t_in["frames"], cfg)
            return PE.decode(model, t_in["tokens"], enc, cfg)[0]
        return PT.decoder_forward(model, t_in["tokens"], cfg)[0]


def _consistency(arch, b, s, extra, seed=4):
    """Largest gap between prefill + decode logits and the teacher-forced
    forward over the same tokens (the port alone)."""
    cfg, model = port_lm(arch)
    np_in = lm_inputs(cfg, seed, b, s + extra)
    ref = _teacher_forced(cfg, model, np_in)
    caches = PR.init_caches(cfg, b, s + extra, device="cpu")
    with torch.no_grad():
        lp, caches = PR.make_prefill(cfg)(
            model, to_torch(_prefill_inputs(cfg, np_in, s)), caches)
        worst = float((lp[:, -1] - ref[:, s - 1]).abs().max())
        tokens = torch.as_tensor(np_in["tokens"]).long()
        for t in range(extra - 1):
            ld, caches = PR.make_decode(cfg)(model, tokens[:, s + t:s + t + 1],
                                             caches, s + t)
            worst = max(worst, float((ld[:, 0] - ref[:, s + t]).abs().max()))
    return worst


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_port_decode_matches_its_teacher_forced_forward(arch):
    assert _consistency(arch, 2, 24, 5) < LM_TOL


def test_ring_cache_long_generation_past_window():
    """Sliding-window ring caches stay correct well past one window
    wrap-around (starcoder2's window of 32: 40 prompt tokens, 50 more)."""
    assert PR.get_config("starcoder2_3b", smoke=True).window == 32
    assert _consistency("starcoder2_3b", 1, 40, 50) < LM_TOL


def test_vision_prefill_matches_its_forward():
    """qwen2-vl on patch embeddings with three M-RoPE streams: the
    prefill-with-cache logits are the teacher-forced forward's."""
    cfg, model = port_lm("qwen2_vl_72b")
    np_in = lm_inputs(cfg, 5, 2, 24)
    t_in = to_torch(np_in)
    with torch.no_grad():
        ref, _, _ = PT.decoder_forward(model, t_in["tokens"], cfg,
                                       positions=t_in["positions"])
        got, caches = PR.make_prefill(cfg)(
            model, t_in, PR.init_caches(cfg, 2, 24, device="cpu"))
    assert torch.equal(got, ref) and len(caches) == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m", "whisper_small"])
def test_generate_tokens_equal_the_reference_engine(arch):
    """Greedy tokens of ``ServeEngine.generate`` in f32, against the
    reference engine's on the same prompt and parameters."""
    from repro.serving.engine import ServeEngine as RefEngine

    rcfg, params, _ = ref_lm(arch)
    pcfg, model = port_lm(arch)
    b, s, steps = 2, 12, 8
    np_in = lm_inputs(pcfg, 6, b, s)
    frames = np_in.get("frames")

    def ref_prefill(p, t, c):
        inputs = {"tokens": t}
        if frames is not None:
            inputs["frames"] = jnp.asarray(frames)
        return RR.make_prefill(rcfg)(p, inputs, c)

    def port_prefill(p, t, c):
        inputs = {"tokens": t}
        if frames is not None:
            inputs["frames"] = torch.as_tensor(frames)
        return PR.make_prefill(pcfg)(p, inputs, c)

    ref_eng = RefEngine(ref_prefill, RR.make_decode(rcfg),
                        lambda bb, ss: RR.init_caches(rcfg, bb, ss)[0])
    eng = ServeEngine(port_prefill, PR.make_decode(pcfg),
                      lambda bb, ss: PR.init_caches(pcfg, bb, ss, device="cpu"))
    want = np.asarray(ref_eng.generate(params, jnp.asarray(np_in["tokens"]), steps))
    got = eng.generate(model, torch.as_tensor(np_in["tokens"]).long(), steps)
    assert got.shape == (b, steps) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_generate_runs_under_inference_mode():
    cfg, model = port_lm("llama3_8b")
    eng = ServeEngine(PR.make_prefill(cfg), PR.make_decode(cfg),
                      lambda bb, ss: PR.init_caches(cfg, bb, ss, device="cpu"))
    out = eng.generate(model, torch.zeros((1, 4), dtype=torch.int64), 3)
    assert out.shape == (1, 3) and out.is_inference()
    assert all(p.grad is None for p in model.parameters())
