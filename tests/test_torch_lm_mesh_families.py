"""The port's other four LM families served over a ``(data, model)``
device mesh on the CPU: mamba2's SSD stack, recurrentgemma's RG-LRU
hybrid, whisper's encoder-decoder and qwen2_vl's patch embeddings with
M-RoPE positions, on ``make_mesh_for(4)`` (a (1, 4) mesh),
``make_mesh_for(4, 2)`` (a (2, 2) mesh) and ``make_mesh_for(3)`` (a (1,
3) mesh, where some extents do not divide: the SSD heads, the padded
vocabulary, qwen2_vl's heads), every shard on the CPU.

Each placed leaf's pieces and every shard's bytes are held against
``shard_shape``; prefill and three teacher-forced decode steps, their
logits and the caches after them, against the reference's own mesh run
(one ``multi_device`` subprocess of four XLA host devices, f32, the
steps jitted as the reference's ``ServeEngine`` jits them) and against
the port's one-device run; the SSD block's gated RMSNorm over a sharded
``d_inner`` apart; bf16 within bf16 noise; the engine's greedy tokens;
caches across ``convert``; the MoE refusal both packages share; and the
decode step with its position a 0-d ``int32`` tensor, the form the
engine captures as a CUDA graph on the card: no host read, bitwise the
int-position step, within ``LM_TOL`` of the reference's mesh run."""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import LM_TOL, lm_cfg, max_abs_diff
from repro_torch.convert import (lm_caches_from_numpy, lm_caches_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import registry as PR
from repro_torch.models import ssm as PS
from repro_torch.serving import ServeEngine
from test_torch_lm_models import BF16_MAX_REL

FAMILY_ARCHS = ["mamba2_370m", "recurrentgemma_9b", "whisper_small",
                "qwen2_vl_72b"]
#: make_mesh_for's arguments: the (1, 4), (2, 2) and (1, 3) meshes
MESHES = {"1x4": (4, None), "2x2": (4, 2), "1x3": (3, None)}
REF_MESHES = ["1x4", "2x2"]
#: batch, prompt, decode steps, cache length (recurrentgemma's 16-slot
#: local ring wraps during the decode steps)
B, PROMPT, STEPS, MAX_SEQ = 4, 14, 3, 20
#: the expert counts the reference's expert-parallel block refuses on
#: the (1, 4) mesh (dbrx_132b's SMOKE config has 4)
REFUSED_EXPERTS = (2, 6)

_REF_FAMILY_RUNS = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.distributed.sharding import use_rules
from repro.launch.mesh import make_mesh_for
from repro.models import registry as RR

B, PROMPT, STEPS, MAX_SEQ = {dims}
out = {{}}
for arch in {archs}:
    base = RR.get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, compute_dtype="float32")
    params = jax.jit(lambda key: RR.init_params(base, key)[0])(
        jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out[arch + "|params|" + "/".join(k.key for k in path)] = \\
            np.asarray(leaf)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    out[arch + "|tokens"] = toks
    inputs = {{"tokens": toks[:, :PROMPT]}}
    if cfg.family == "encdec":
        inputs["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        inputs = {{"tokens": rng.standard_normal(
                      (B, PROMPT, cfg.d_model)).astype(np.float32),
                  "positions": rng.integers(
                      0, 4 * PROMPT, (3, B, PROMPT)).astype(np.int32)}}
    for key, val in inputs.items():
        out[arch + "|inputs|" + key] = val
    for mp in (None, 2):
        mesh = make_mesh_for(4, mp)
        tag = f"{{arch}}|{{mesh.shape['data']}}x{{mesh.shape['model']}}"
        with use_rules(mesh):
            caches = RR.init_caches(cfg, B, MAX_SEQ)[0]
            prefill = jax.jit(RR.make_prefill(cfg))
            decode = jax.jit(RR.make_decode(cfg))
            logits, caches = prefill(
                params, {{k: jnp.asarray(v) for k, v in inputs.items()}},
                caches)
            out[tag + "|0"] = np.asarray(logits)
            for t in range(STEPS):
                logits, caches = decode(
                    params, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
                    caches, jnp.asarray(PROMPT + t, jnp.int32))
                out[tag + f"|{{t + 1}}"] = np.asarray(logits)
        for path, leaf in jax.tree_util.tree_leaves_with_path(caches):
            out[tag + "|caches|" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
refused = {{}}
for n_experts in {refused}:
    base = dataclasses.replace(RR.get_config("dbrx_132b", smoke=True),
                               n_experts=n_experts)
    cfg = dataclasses.replace(base, compute_dtype="float32")
    params = jax.jit(lambda key: RR.init_params(base, key)[0])(
        jax.random.PRNGKey(0))
    try:
        with use_rules(make_mesh_for(4)):
            jax.jit(RR.make_prefill(cfg))(
                params, {{"tokens": jnp.zeros((B, PROMPT), jnp.int32)}},
                RR.init_caches(cfg, B, MAX_SEQ)[0])
        refused[n_experts] = None
    except ValueError as e:
        refused[n_experts] = type(e).__name__
np.savez(sys.argv[1], **out)
print(json.dumps({{"saved": len(out), "refused": refused}}))
"""


def ref_family_runs(multi_device, path, archs=FAMILY_ARCHS):
    """The reference's mesh runs of ``archs`` on both meshes (their
    parameters, inputs, logits and caches) and its verdict on the MoE
    expert counts of ``REFUSED_EXPERTS`` on the (1, 4) mesh, from one
    subprocess with four XLA host devices: ``(arrays, {n_experts: the
    exception's type name or None})``."""
    verdict = multi_device.run(
        _REF_FAMILY_RUNS.format(dims=(B, PROMPT, STEPS, MAX_SEQ),
                                archs=list(archs),
                                refused=list(REFUSED_EXPERTS)),
        ndevices=4, argv=(path,), timeout=600)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, {int(k): v for k, v in verdict["refused"].items()}


@pytest.fixture(scope="module")
def ref_runs(multi_device, tmp_path_factory):
    return ref_family_runs(multi_device,
                           tmp_path_factory.mktemp("ref_families") / "runs.npz")


def _ref_tree(runs, arch):
    tree = {"tail": {}}
    prefix = arch + "|params|"
    for key, val in runs.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "/"))
        else:
            out[prefix + key] = val
    return out


def _mesh(name):
    return make_mesh_for(*MESHES[name], device="cpu")


def _seeded(cfg, mesh=None):
    return PR.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", mesh=mesh)


def _inputs(cfg, seed=7):
    """Seeded token ids of the prompt and decode steps, and the prefill's
    inputs: the prompt's tokens, with frames for the encoder-decoder;
    patch embeddings and three M-RoPE streams for the vision frontend."""
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, PROMPT + STEPS)))
    inputs = {"tokens": tokens[:, :PROMPT]}
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vision":
        inputs = {"tokens": torch.as_tensor(rng.standard_normal(
                      (B, PROMPT, cfg.d_model)).astype(np.float32)),
                  "positions": torch.as_tensor(rng.integers(
                      0, 4 * PROMPT, (3, B, PROMPT)))}
    return tokens.long(), inputs


def _serve(cfg, model, tokens, inputs, caches):
    """The prefill's logits and each teacher-forced decode step's, and
    the caches after them."""
    out = []
    with torch.inference_mode():
        logits, caches = PR.make_prefill(cfg)(model, inputs, caches)
        out.append(logits)
        for t in range(PROMPT, tokens.shape[1]):
            logits, caches = PR.make_decode(cfg)(model, tokens[:, t:t + 1],
                                                 caches, t)
            out.append(logits)
    return out, caches


def _run(cfg, mesh=None, model=None, seed=7):
    tokens, inputs = _inputs(cfg, seed)
    model = _seeded(cfg, mesh) if model is None else model
    caches = PR.init_caches(cfg, B, MAX_SEQ, device="cpu", mesh=mesh)
    return _serve(cfg, model, tokens, inputs, caches)


def _assert_caches_close(got, want):
    """Every cache leaf (a reference-tree path: numpy) within the
    reference's tolerance; ring positions exactly."""
    assert set(got) == set(want)
    for key, val in want.items():
        if np.asarray(val).dtype.kind in "iu":
            assert np.array_equal(got[key], val), key
        else:
            assert max_abs_diff(got[key], val) < LM_TOL, key


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------
def _want_bytes(structs, specs, rules):
    phys = PR.specs_to_physical(specs, rules, structs)
    return sum(math.prod(ph.shape) * st.element_size()
               for st, ph in zip(PR.tree_leaves(structs),
                                 PR.tree_leaves(phys)))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_placed_leaves_have_shard_shapes_and_bytes(arch, mesh_name):
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    model = _seeded(cfg, mesh)
    caches = PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh)
    rules = model.rules
    assert not list(model.parameters())         # every leaf is placed
    specs = PR.param_specs(cfg)
    for name, leaf in PR.placed_leaves(model):
        path, row = PR.reference_path(cfg, name)
        logical = specs[path][1:] if row is not None else specs[path]
        want = S.shard_shape(rules, leaf.shape, logical)
        assert all(tuple(p.shape) == want for p in leaf.pieces), name
    per_shard = [0] * mesh.nshards
    for _, leaf in PR.placed_leaves(model) + PR.placed_leaves(caches):
        for s, piece in enumerate(leaf.pieces):
            per_shard[s] += piece.numel() * piece.element_size()
    want = (_want_bytes(*PR.abstract_params(cfg), rules)
            + _want_bytes(*PR.abstract_caches(cfg, B, MAX_SEQ), rules))
    assert per_shard == [want] * mesh.nshards
    one = sum(p.numel() * p.element_size() for p in _seeded(cfg).parameters())
    if mesh_name != "1x3":
        assert want < one        # no shard holds the whole model


# ----------------------------------------------------------------------
# against the reference's mesh run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", REF_MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_mesh_run_matches_the_references_mesh_run(arch, mesh_name, ref_runs):
    """f32: the prefill's and three decode steps' logits, and every cache
    leaf after them (the SSD state and convolutions, the RG-LRU state and
    convolution, the ring positions, self and cross K/V), within the
    reference's tolerance of its own mesh run."""
    runs, _ = ref_runs
    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              compute_dtype="float32")
    mesh = _mesh(mesh_name)
    model = lm_params_from_numpy(cfg, _ref_tree(runs, arch), mesh=mesh)
    tokens = torch.as_tensor(runs[arch + "|tokens"]).long()
    prefix = arch + "|inputs|"
    inputs = {k[len(prefix):]: torch.as_tensor(v) for k, v in runs.items()
              if k.startswith(prefix)}
    if "positions" in inputs:
        inputs["positions"] = inputs["positions"].long()
    if inputs["tokens"].dim() == 2:
        inputs["tokens"] = inputs["tokens"].long()
    logits, caches = _serve(cfg, model, tokens, inputs,
                            PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh))
    for t, got in enumerate(logits):
        want = runs[f"{arch}|{mesh_name}|{t}"]
        assert max_abs_diff(got.numpy(), want) < LM_TOL, t
    prefix = f"{arch}|{mesh_name}|caches|"
    _assert_caches_close(_flat(lm_caches_to_numpy(cfg, caches)),
                         {k[len(prefix):]: v for k, v in runs.items()
                          if k.startswith(prefix)})


# ----------------------------------------------------------------------
# against the port's one-device run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_mesh_run_matches_the_one_device_run(arch, mesh_name):
    """f32: logits and, gathered whole, the caches within the reference's
    tolerance of the one-device run; on the (1, 3) mesh the SSD heads,
    the padded vocabulary and qwen2_vl's heads stay whole."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    want, c1 = _run(cfg)
    got, cm = _run(cfg, mesh)
    for t, (g, w) in enumerate(zip(got, want)):
        assert max_abs_diff(g.numpy(), w.numpy()) < LM_TOL, t
    _assert_caches_close(_flat(lm_caches_to_numpy(cfg, cm)),
                         _flat(lm_caches_to_numpy(cfg, c1)))


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
def test_ssm_gated_norm_sums_squares_over_the_model_axis(mesh_name):
    """The SSD block's gated RMSNorm over a ``d_inner`` split four or two
    ways: each shard's squares summed over ``model`` before the ``rsqrt``,
    so the block's output is the one-device block's on a residual whose
    ``d_inner`` halves differ in scale by 1e3 (a shard-local mean would
    be off by that much); and the norm alone against the one-device
    formula."""
    cfg = lm_cfg(PR.get_config("mamba2_370m", smoke=True))
    mesh = _mesh(mesh_name)
    assert PS.heads_split(cfg, mesh)
    one = _seeded(cfg).layers[0].ssm
    placed = _seeded(cfg, mesh).layers[0].ssm
    di = cfg.expand * cfg.d_model
    gen = torch.Generator().manual_seed(3)
    y = torch.randn(B, 6, di, generator=gen)
    y[..., di // 2:] *= 1e3
    scale = torch.randn(di, generator=gen)
    rules = PR.serving_rules(cfg, mesh)
    yp = S.place(y, mesh, S.physical_spec(rules, y.shape,
                                          ("batch", None, "mlp")))
    sp = S.place(scale, mesh, S.physical_spec(rules, scale.shape, ("mlp",)))
    got = S.to_whole(PS.gated_rmsnorm_mesh(yp, sp, cfg))
    want = (y * torch.rsqrt(torch.mean(y * y, -1, keepdim=True)
                            + cfg.norm_eps)) * scale
    assert max_abs_diff(got.numpy(), want.numpy()) < 1e-5
    u = torch.randn(B, 6, cfg.d_model, generator=gen)
    with torch.inference_mode():
        want, _ = PS.ssm_block(one, u, cfg)
        bspec = S.physical_spec(rules, u.shape[:1], ("batch",))[0]
        got, _ = PS.ssm_block(placed, S.place(u, mesh, (bspec, None, None)),
                              cfg)
    assert max_abs_diff(S.to_whole(got).numpy(), want.numpy()) < LM_TOL


def test_ssm_heads_whole_where_the_model_extent_divides_d_inner_only():
    """mamba2 SMOKE with 64-wide heads on the (1, 4) mesh: the extent
    divides ``d_inner`` (128) and not the two heads, so ``conv_x`` and the
    ``d_inner`` leaves are split and the SSD state is whole; every shard
    runs the block whole (:func:`ssm.heads_split` decides it once) and
    keeps its part of ``conv_x``, within the reference's tolerance of one
    device, its bytes ``shard_shape``'s."""
    cfg = lm_cfg(dataclasses.replace(PR.get_config("mamba2_370m", smoke=True),
                                     ssm_head_dim=64))
    mesh = _mesh("1x4")
    assert not PS.heads_split(cfg, mesh)
    caches = PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh)
    assert caches[0]["conv_x"].spec == (None, None, "model")
    assert caches[0]["ssm"].spec == (None, None, None, None)
    want, c1 = _run(cfg)
    got, cm = _run(cfg, mesh)
    for t, (g, w) in enumerate(zip(got, want)):
        assert max_abs_diff(g.numpy(), w.numpy()) < LM_TOL, t
    assert cm[0]["conv_x"].spec == (None, None, "model")
    _assert_caches_close(_flat(lm_caches_to_numpy(cfg, cm)),
                         _flat(lm_caches_to_numpy(cfg, c1)))


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["mamba2_370m", "whisper_small"])
def test_mesh_run_in_bf16_is_within_bf16_noise(arch, mesh_name):
    """bf16 compute: within the bf16 noise ``BF16_MAX_REL`` of the
    one-device run (ROADMAP, N5)."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True), "bfloat16")
    want, _ = _run(cfg)
    got, _ = _run(cfg, _mesh(mesh_name))
    for g, w in zip(got, want):
        g, w = g[..., :cfg.vocab].float().numpy(), w[..., :cfg.vocab].float().numpy()
        assert max_abs_diff(g, w) < BF16_MAX_REL * np.abs(w).max()


@pytest.mark.parametrize("arch", ["mamba2_370m", "whisper_small"])
def test_engine_generates_over_a_mesh(arch):
    """Greedy tokens over the (2, 2) mesh: the one-device engine's, every
    decode step eager."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh("2x2")
    _, inputs = _inputs(cfg)
    prefill_fn = PR.make_prefill(cfg)

    def prefill(model, tokens, caches):
        return prefill_fn(model, {**inputs, "tokens": tokens}, caches)

    out = {}
    for name, m in (("one", None), ("mesh", mesh)):
        eng = ServeEngine(prefill, PR.make_decode(cfg),
                          lambda b, s, m=m: PR.init_caches(
                              cfg, b, s, device="cpu", mesh=m))
        out[name] = eng.generate(_seeded(cfg, m), inputs["tokens"], 5)
        assert eng.stats["eager_steps"] == 4 and not eng.stats["graph"]
    assert torch.equal(out["mesh"], out["one"])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_caches_cross_to_and_from_a_mesh(arch):
    """Placed caches after a served run, as the reference's tree and
    back onto the mesh: the same specs and the same pieces."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh("2x2")
    _, caches = _run(cfg, mesh)
    back = lm_caches_from_numpy(cfg, lm_caches_to_numpy(cfg, caches),
                                mesh=mesh)
    got, want = PR.placed_leaves(back), PR.placed_leaves(caches)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.spec == b.spec, name
        assert all(torch.equal(x, y) for x, y in zip(a.pieces, b.pieces)), name


# ----------------------------------------------------------------------
# the MoE's expert count over the model axis (N8)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_experts", REFUSED_EXPERTS)
def test_moe_refusal_is_the_references(n_experts, ref_runs):
    """dbrx_132b's SMOKE config with an expert count the (1, 4) mesh's
    model extent does not divide: the reference's ``shard_map`` raises
    ``ValueError`` and so does the port, before any parameter is
    drawn."""
    _, refused = ref_runs
    assert refused[n_experts] == "ValueError"
    cfg = dataclasses.replace(lm_cfg(PR.get_config("dbrx_132b", smoke=True)),
                              n_experts=n_experts)
    with pytest.raises(ValueError, match="does not divide"):
        _seeded(cfg, _mesh("1x4"))


# ----------------------------------------------------------------------
# the decode step with a device position: what a CUDA graph captures
# ----------------------------------------------------------------------
_HOST_READS = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.is_nonzero.default)


class HostReads(TorchDispatchMode):
    """The ATen calls that read a tensor's value back to the host
    (``.item()``, ``int()``, ``bool()`` of a tensor), by name, in the
    order seen: a decode step that makes one cannot be captured."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _copy_leaves(tree):
    if isinstance(tree, dict):
        return {k: _copy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_leaves(v) for v in tree]
    return S.Placed([p.clone() for p in tree.pieces], tree.mesh, tree.spec)


def tensor_position_steps(cfg, model, tokens, inputs, caches):
    """Prefill ``inputs``, then teacher-forced decode steps over the rest
    of ``tokens`` twice from the same caches: with the position an int,
    and with it a 0-d ``int32`` tensor under :class:`HostReads`.  Checks
    that the tensor steps read nothing back and that their logits and
    every cache piece are the int steps' bit for bit (the ring's ``pos``
    included); returns the tensor steps' logits (the prefill's first)
    and caches."""
    decode = PR.make_decode(cfg)
    with torch.inference_mode():
        logits, by_int = PR.make_prefill(cfg)(model, inputs, caches)
        by_tensor = _copy_leaves(by_int)
        out = [logits]
        for t in range(inputs["tokens"].shape[1], tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            want, by_int = decode(model, tok, by_int, t)
            with HostReads() as reads:
                got, by_tensor = decode(model, tok, by_tensor,
                                        torch.tensor(t, dtype=torch.int32))
            assert reads.seen == [], (t, reads.seen)
            assert torch.equal(got, want), t
            for (name, g), (_, w) in zip(PR.placed_leaves(by_tensor),
                                         PR.placed_leaves(by_int)):
                assert g.spec == w.spec and all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(g.pieces, w.pieces)), (t, name)
            out.append(got)
    return out, by_tensor


@pytest.mark.parametrize("mesh_name", REF_MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tensor_position_decode_reads_nothing_back(arch, mesh_name,
                                                   ref_runs):
    """The four families on the (1, 4) and (2, 2) meshes, from the
    reference's parameters and inputs (f32): three decode steps with the
    position a 0-d ``int32`` tensor make no host read (the SSD and RG-LRU
    states, the ring over recurrentgemma's 16 slots wrapping at position
    16, whisper's self and cross caches, qwen2_vl's RoPE at decode), are
    the int-position steps bit for bit, and their logits and caches are
    within ``LM_TOL`` of the reference's own mesh run."""
    runs, _ = ref_runs
    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              compute_dtype="float32")
    mesh = _mesh(mesh_name)
    model = lm_params_from_numpy(cfg, _ref_tree(runs, arch), mesh=mesh)
    tokens = torch.as_tensor(runs[arch + "|tokens"]).long()
    prefix = arch + "|inputs|"
    inputs = {k[len(prefix):]: torch.as_tensor(v) for k, v in runs.items()
              if k.startswith(prefix)}
    if "positions" in inputs:
        inputs["positions"] = inputs["positions"].long()
    if inputs["tokens"].dim() == 2:
        inputs["tokens"] = inputs["tokens"].long()
    logits, caches = tensor_position_steps(
        cfg, model, tokens, inputs, PR.init_caches(cfg, B, MAX_SEQ,
                                                   mesh=mesh))
    assert len(logits) == STEPS + 1
    for t, got in enumerate(logits):
        want = runs[f"{arch}|{mesh_name}|{t}"]
        assert max_abs_diff(got.numpy(), want) < LM_TOL, t
    prefix = f"{arch}|{mesh_name}|caches|"
    _assert_caches_close(_flat(lm_caches_to_numpy(cfg, caches)),
                         {k[len(prefix):]: v for k, v in runs.items()
                          if k.startswith(prefix)})
