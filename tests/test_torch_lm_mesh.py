"""The port's LM serving over a ``(data, model)`` device mesh on the CPU
(``repro_torch.launch.mesh.make_mesh_for(4)``, a (1, 4) mesh, and
``make_mesh_for(4, 2)``, a (2, 2) mesh, every shard on the CPU): each
placed leaf's pieces and every shard's bytes against ``shard_shape``;
prefill and three decode steps against the reference's own mesh run
(one ``multi_device`` subprocess of four XLA host devices, the steps
jitted as the reference's ``ServeEngine`` jits them, the MoE configs at
their default capacity factor, where the (2, 2) mesh drops other tokens
than one device); the mesh run against the port's one-device run, in
f32 and bf16; the MoE block at ``data = 1`` bitwise the one-device
block; the collectives against plain tensor ops; the decode step with
a 0-d ``int32`` position, the form a CUDA graph captures (no host read,
bitwise the int-position step); the engine, the serve CLI, the four
families' training forward over a mesh against one device, and an MoE whose expert count the model extent
does not divide refused as the reference refuses it (the other four families' serving: ``tests/test_torch_lm_mesh_families.py``)."""
import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest
import torch

from _torch_port import LM_TOL, lm_cfg, max_abs_diff
from repro_torch.convert import (lm_caches_from_numpy, lm_caches_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import moe as PM
from repro_torch.models import registry as PR
from repro_torch.serving import ServeEngine
from test_torch_lm_mesh_families import (ref_family_runs,
                                        tensor_position_steps)
from test_torch_lm_models import BF16_MAX_REL

#: the decoder LMs with token prompts, the ones that serve over a mesh
MESH_ARCHS = ["llama3_8b", "gemma3_12b", "starcoder2_3b", "granite_20b",
              "dbrx_132b", "moonshot_v1_16b_a3b"]
MOE_ARCHS = ["dbrx_132b", "moonshot_v1_16b_a3b"]
#: make_mesh_for's model_parallel: None is the (1, 4) mesh, 2 the (2, 2)
MESHES = {"1x4": None, "2x2": 2}
#: batch, prompt, decode steps, cache length: 20 positions split over
#: model=4 and 2; gemma3's 16-slot ring wraps during the decode steps
B, PROMPT, STEPS, MAX_SEQ = 4, 14, 3, 20

_REF_MESH_RUN = """
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
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    out[arch + "|tokens"] = toks
    for mp in (None, 2):
        mesh = make_mesh_for(4, mp)
        tag = f"{{arch}}|{{mesh.shape['data']}}x{{mesh.shape['model']}}"
        with use_rules(mesh):
            caches = RR.init_caches(cfg, B, MAX_SEQ)[0]
            prefill = jax.jit(RR.make_prefill(cfg))
            decode = jax.jit(RR.make_decode(cfg))
            logits, caches = prefill(
                params, {{"tokens": jnp.asarray(toks[:, :PROMPT])}}, caches)
            out[tag + "|0"] = np.asarray(logits)
            for t in range(STEPS):
                logits, caches = decode(
                    params, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
                    caches, jnp.asarray(PROMPT + t, jnp.int32))
                out[tag + f"|{{t + 1}}"] = np.asarray(logits)
np.savez(sys.argv[1], **out)
print(json.dumps({{"saved": len(out)}}))
"""


@pytest.fixture(scope="module")
def ref_mesh_runs(multi_device, tmp_path_factory):
    """The reference's mesh runs of the six configs on both meshes, its
    parameters and tokens, from one subprocess with four XLA host
    devices: ``{key: array}``."""
    path = tmp_path_factory.mktemp("ref_mesh") / "runs.npz"
    multi_device.run(_REF_MESH_RUN.format(dims=(B, PROMPT, STEPS, MAX_SEQ),
                                          archs=MESH_ARCHS),
                     ndevices=4, argv=(path,), timeout=600)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _ref_tree(runs, arch):
    """The reference's parameter tree of ``arch`` from the runs."""
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


def _mesh(name):
    return make_mesh_for(4, MESHES[name], device="cpu")


def _serve(cfg, model, tokens, caches, prompt=PROMPT):
    """The prefill's logits and each decode step's, fed ``tokens``
    (teacher-forced) after the first ``prompt``, and the caches after
    them."""
    out = []
    with torch.inference_mode():
        logits, caches = PR.make_prefill(cfg)(model, tokens[:, :prompt], caches)
        out.append(logits)
        for t in range(prompt, tokens.shape[1]):
            logits, caches = PR.make_decode(cfg)(model, tokens[:, t:t + 1],
                                                 caches, t)
            out.append(logits)
    return out, caches


def _seeded(cfg, mesh=None):
    return PR.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", mesh=mesh)


def _tokens(cfg, seed=7):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, PROMPT + STEPS))).long()


# ----------------------------------------------------------------------
# the mesh and its collectives
# ----------------------------------------------------------------------
def test_device_mesh_coordinates_and_groups():
    mesh = S.make_device_mesh(2, 3, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 3} and mesh.nshards == 6
    assert mesh.coords(4) == {"data": 1, "model": 1}
    assert mesh.group("model", 4) == (3, 4, 5)
    assert mesh.group("data", 4) == (1, 4)
    assert tuple(mesh.ranks("model")) == (0, 1, 2, 0, 1, 2)
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="does not divide"):
        S.DeviceMesh((torch.device("cpu"),) * 4, model=3)


@pytest.mark.parametrize("spec", [("data", "model"), ("model", None),
                                  (None, "data"), (None, None)])
def test_place_reshard_and_to_whole_are_exact(spec):
    mesh = S.make_device_mesh(2, 2, device="cpu")
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    p = S.place(x, mesh, spec)
    for s, piece in enumerate(p.pieces):
        c = mesh.coords(s)
        rows = (2 * c[spec[0]], 2 * c[spec[0]] + 2) if spec[0] else (0, 4)
        cols = (3 * c[spec[1]], 3 * c[spec[1]] + 3) if spec[1] else (0, 6)
        assert torch.equal(piece, x[rows[0]:rows[1], cols[0]:cols[1]])
    assert p.shape == (4, 6)
    assert torch.equal(S.to_whole(p), x)
    for target in [("model", "data"), (None, None), ("data", None)]:
        assert torch.equal(S.to_whole(S.reshard(p, target)), x)
    whole = S.gather_axis(S.gather_axis(p, "data"), "model")
    assert whole.spec == (None, None)
    assert all(torch.equal(piece, x) for piece in whole.pieces)


def test_reduce_sum_adds_in_rank_order():
    mesh = S.make_device_mesh(1, 4, device="cpu")
    vals = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8]),
            torch.tensor([1.0])]
    total = S.reduce_sum(S.Placed(vals, mesh, (None,)), "model")
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    assert all(torch.equal(piece, want) for piece in total.pieces)


def test_heads_to_seq_is_the_all_to_all():
    mesh = S.make_device_mesh(1, 2, device="cpu")
    k = torch.randn(2, 6, 4, 3, generator=torch.Generator().manual_seed(0))
    p = S.place(k, mesh, (None, None, "model", None))
    ranges = [(0, 3), (3, 5)]
    got = S.heads_to_seq(p, ranges)
    for (lo, hi), piece in zip(ranges, got):
        assert torch.equal(piece, k[:, lo:hi])


# ----------------------------------------------------------------------
# placement: every leaf's pieces and every shard's bytes
# ----------------------------------------------------------------------
def _want_bytes(structs, specs, rules):
    phys = PR.specs_to_physical(specs, rules, structs)
    return sum(math.prod(ph.shape) * st.element_size()
               for st, ph in zip(PR.tree_leaves(structs),
                                 PR.tree_leaves(phys)))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
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
    assert want < one            # no shard holds the whole model


def test_placed_values_are_the_one_device_models():
    cfg = lm_cfg(PR.get_config("dbrx_132b", smoke=True))
    one = dict(_seeded(cfg).named_parameters())
    for name, leaf in PR.placed_leaves(_seeded(cfg, _mesh("2x2"))):
        assert torch.equal(S.to_whole(leaf), one[name]), name


# ----------------------------------------------------------------------
# against the reference's mesh run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_run_matches_the_references_mesh_run(arch, mesh_name,
                                                  ref_mesh_runs):
    """f32, MoE at its default capacity factor: the prefill's and three
    decode steps' logits within the reference's tolerance."""
    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              compute_dtype="float32")
    mesh = _mesh(mesh_name)
    model = lm_params_from_numpy(cfg, _ref_tree(ref_mesh_runs, arch),
                                 mesh=mesh)
    tokens = torch.as_tensor(ref_mesh_runs[arch + "|tokens"]).long()
    logits, _ = _serve(cfg, model, tokens,
                       PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh))
    for t, got in enumerate(logits):
        want = ref_mesh_runs[f"{arch}|{mesh_name}|{t}"]
        assert max_abs_diff(got.numpy(), want) < LM_TOL, t


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_tensor_position_decode_reads_nothing_back(arch, mesh_name,
                                                   ref_mesh_runs):
    """The six decoder LMs on both meshes, from the reference's
    parameters (f32, MoE at its default capacity factor): three decode
    steps with the position a 0-d ``int32`` tensor make no host read
    (the sequence-sharded cache write, gemma3's ring wrapping at position
    16, the MoE routing, starcoder2's and granite's learned positions),
    are the int-position steps bit for bit, logits and every cache piece,
    and their logits are within ``LM_TOL`` of the reference's mesh run."""
    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              compute_dtype="float32")
    mesh = _mesh(mesh_name)
    model = lm_params_from_numpy(cfg, _ref_tree(ref_mesh_runs, arch),
                                 mesh=mesh)
    tokens = torch.as_tensor(ref_mesh_runs[arch + "|tokens"]).long()
    logits, _ = tensor_position_steps(
        cfg, model, tokens, {"tokens": tokens[:, :PROMPT]},
        PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh))
    assert len(logits) == STEPS + 1
    for t, got in enumerate(logits):
        want = ref_mesh_runs[f"{arch}|{mesh_name}|{t}"]
        assert max_abs_diff(got.numpy(), want) < LM_TOL, t


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_is_per_data_shard(arch, ref_mesh_runs):
    """At the default capacity factor the (2, 2) mesh routes each data
    shard's tokens with its own capacity, as the reference does: the
    port's one-device run is far from the reference's (2, 2) run, its
    mesh run is not (above)."""
    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              compute_dtype="float32")
    model = lm_params_from_numpy(cfg, _ref_tree(ref_mesh_runs, arch),
                                 device="cpu")
    tokens = torch.as_tensor(ref_mesh_runs[arch + "|tokens"]).long()
    logits, _ = _serve(cfg, model, tokens,
                       PR.init_caches(cfg, B, MAX_SEQ, device="cpu"))
    assert max_abs_diff(logits[0].numpy(),
                        ref_mesh_runs[f"{arch}|1x4|0"]) < LM_TOL
    assert max_abs_diff(logits[0].numpy(),
                        ref_mesh_runs[f"{arch}|2x2|0"]) > 100 * LM_TOL


# ----------------------------------------------------------------------
# against the port's one-device run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_run_matches_the_one_device_run(arch, mesh_name):
    """f32 (MoE at capacity factor 16, where no token is dropped): logits
    and, gathered whole, the caches within the reference's tolerance;
    the ring positions exactly."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    tokens = _tokens(cfg)
    want, c1 = _serve(cfg, _seeded(cfg), tokens,
                      PR.init_caches(cfg, B, MAX_SEQ, device="cpu"))
    got, cm = _serve(cfg, _seeded(cfg, mesh), tokens,
                     PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh))
    for t, (g, w) in enumerate(zip(got, want)):
        assert max_abs_diff(g.numpy(), w.numpy()) < LM_TOL, t
    for layer, (a, b) in enumerate(zip(cm, c1)):
        for key in b:
            whole = S.to_whole(a[key])
            if key == "pos":
                assert torch.equal(whole, b[key]), layer
            else:
                assert max_abs_diff(whole.numpy(), b[key].numpy()) < LM_TOL


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma3_12b"])
def test_mesh_run_where_the_extents_do_not_divide(arch, mesh_name):
    """A batch of 3 (whole on every data shard of the (2, 2) mesh) and an
    18-position cache (whole on every model shard of the (1, 4) mesh,
    which then attends as one device does; gemma3's 16-slot rings stay
    split): within the reference's tolerance of the one-device run."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    tokens = _tokens(cfg)[:3, :17]
    want, _ = _serve(cfg, _seeded(cfg), tokens,
                     PR.init_caches(cfg, 3, 18, device="cpu"), prompt=13)
    caches = PR.init_caches(cfg, 3, 18, mesh=mesh)
    assert caches[-1]["k"].spec[:2] == (
        (None, None) if mesh_name == "1x4" else (None, "model"))
    got, _ = _serve(cfg, _seeded(cfg, mesh), tokens, caches, prompt=13)
    for t, (g, w) in enumerate(zip(got, want)):
        assert max_abs_diff(g.numpy(), w.numpy()) < LM_TOL, t


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma3_12b"])
def test_mesh_run_in_bf16_is_within_bf16_noise(arch, mesh_name):
    """bf16 compute, the dense configs of the reference's own bf16 test:
    within the bf16 noise ``BF16_MAX_REL`` (ROADMAP, N5).  An MoE's
    routing flips on bf16 noise, so its rows are not held here."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True), "bfloat16")
    mesh = _mesh(mesh_name)
    tokens = _tokens(cfg)
    want, _ = _serve(cfg, _seeded(cfg), tokens,
                     PR.init_caches(cfg, B, MAX_SEQ, device="cpu"))
    got, _ = _serve(cfg, _seeded(cfg, mesh), tokens,
                    PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh))
    for g, w in zip(got, want):
        g, w = g[..., :cfg.vocab].numpy(), w[..., :cfg.vocab].numpy()
        assert max_abs_diff(g, w) < BF16_MAX_REL * np.abs(w).max()


@pytest.mark.parametrize("model_extent", [2, 4])
@pytest.mark.parametrize("capacity_factor", [None, 16.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_at_data_1_is_the_one_device_block(arch, capacity_factor,
                                                     model_extent):
    cfg = dataclasses.replace(PR.get_config(arch, smoke=True),
                              compute_dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    mesh = make_mesh_for(model_extent, model_extent, device="cpu")
    assert mesh.shape == {"data": 1, "model": model_extent}
    block, placed = _seeded(cfg).layers[0].moe, _seeded(cfg, mesh).layers[0].moe
    x = torch.randn(B, 12, cfg.d_model, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        want, aux = PM.moe(block, x, cfg)
        got, got_aux = PM.moe(placed, S.place(x, mesh, (None, None, None)),
                              cfg)
    assert torch.equal(S.to_whole(got), want)
    assert all(torch.equal(a, aux) for a in got_aux.pieces)


# ----------------------------------------------------------------------
# caches across, the engine, the CLI, the families that do not serve
# ----------------------------------------------------------------------
def test_caches_cross_to_and_from_a_mesh():
    cfg = lm_cfg(PR.get_config("gemma3_12b", smoke=True))
    mesh = _mesh("2x2")
    _, caches = _serve(cfg, _seeded(cfg, mesh), _tokens(cfg),
                       PR.init_caches(cfg, B, MAX_SEQ, mesh=mesh))
    tree = lm_caches_to_numpy(cfg, caches)
    back = lm_caches_from_numpy(cfg, tree, mesh=mesh)
    for a, b in zip(back, caches):
        for key in b:
            assert a[key].spec == b[key].spec
            assert all(torch.equal(x, y)
                       for x, y in zip(a[key].pieces, b[key].pieces))


def test_engine_generates_over_a_mesh():
    """Greedy tokens over the (2, 2) mesh: the one-device engine's, every
    decode step eager."""
    cfg = lm_cfg(PR.get_config("llama3_8b", smoke=True))
    mesh = _mesh("2x2")
    prompt = _tokens(cfg)[:, :PROMPT]
    out = {}
    for name, m in (("one", None), ("mesh", mesh)):
        eng = ServeEngine(PR.make_prefill(cfg), PR.make_decode(cfg),
                          lambda b, s, m=m: PR.init_caches(
                              cfg, b, s, device="cpu", mesh=m))
        out[name] = eng.generate(_seeded(cfg, m), prompt, 5)
        assert eng.stats["eager_steps"] == 4 and not eng.stats["graph"]
    assert torch.equal(out["mesh"], out["one"])


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b",
                                  "whisper_small", "qwen2_vl_72b"])
def test_training_over_a_mesh_returns_the_one_device_loss(arch):
    """The four families' training forward over the (1, 4) mesh (the SSD
    heads, the RG-LRU channels, the
    encoder-decoder, the patch embeddings with M-RoPE positions) returns
    the loss of the one-device forward on the same batch, within
    ``LM_TOL`` (their gradients: ``tests/test_torch_lm_mesh_train_families.py``)."""
    from _torch_port import to_torch, train_inputs
    from repro_torch.training import train_step as PTS

    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    batch = to_torch(train_inputs(cfg, 3, B, PROMPT))
    losses = []
    for mesh in (_mesh("1x4"), None):
        with torch.no_grad():
            logits, aux = PR.make_train_forward(cfg)(_seeded(cfg, mesh),
                                                     batch)
        loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
        losses.append(float(loss + 1e-2 * aux))
    assert math.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= LM_TOL * abs(losses[1])


@pytest.fixture(scope="module")
def ref_moe_refusals(multi_device, tmp_path_factory):
    """The reference's verdict on dbrx_132b's SMOKE config with 2 and 6
    experts on the (1, 4) mesh, from the families' reference subprocess
    run with no family."""
    return ref_family_runs(multi_device, tmp_path_factory.mktemp(
        "ref_moe") / "runs.npz", archs=())[1]


@pytest.mark.parametrize("n_experts,devices", [(2, 4), (6, 4), (4, 8)],
                         ids=["2 on (1, 4)", "6 on (1, 4)", "4 on (1, 8)"])
def test_moe_refuses_an_expert_count_the_model_extent_does_not_divide(
        n_experts, devices, ref_moe_refusals):
    """dbrx_132b's SMOKE config with an expert count the model extent of
    ``make_mesh_for(devices)`` does not divide (its own 4 experts on the
    (1, 8) mesh): the port raises ``ValueError`` where it used to keep
    whole experts on every shard, as the reference's ``shard_map`` raises
    on the (1, 4) mesh (its subprocess has four devices)."""
    if devices == 4:
        assert ref_moe_refusals[n_experts] == "ValueError"
    cfg = dataclasses.replace(lm_cfg(PR.get_config("dbrx_132b", smoke=True)),
                              n_experts=n_experts)
    mesh = make_mesh_for(devices, device="cpu")
    assert mesh.shape == {"data": 1, "model": devices}
    with pytest.raises(ValueError, match="does not divide"):
        _seeded(cfg, mesh)
    # the former fallback's layout, whole experts on every shard, is
    # refused by the block itself
    block = _seeded(cfg).layers[0].moe
    for name, p in list(block.named_parameters()):
        del block._parameters[name]
        setattr(block, name, S.place(p.detach(), mesh, (None,) * p.dim()))
    with pytest.raises(ValueError, match="does not divide"):
        PM.moe(block, S.place(torch.zeros(B, 2, cfg.d_model), mesh,
                              (None, None, None)), cfg)


def test_serve_cli_over_a_mesh():
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "llama3_8b", "--smoke", "--mesh", "4",
                    "--device", "cpu", "--prompt-len", "16", "--gen", "4"])
    line = buf.getvalue().strip()
    assert line.startswith("llama3-smoke: (4, 4) tokens in ")
    assert line.endswith("on a (1, 4) mesh")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "mamba2_370m", "--smoke", "--mesh", "4",
                    "--device", "cpu", "--prompt-len", "16", "--gen", "4"])
    line = buf.getvalue().strip()
    assert line.startswith("mamba2-smoke: (4, 4) tokens in ")
    assert line.endswith("on a (1, 4) mesh")
    for mesh in ([], ["--mesh", "4"]):
        with pytest.raises(SystemExit, match="patch embeddings"):
            serve.main(["--arch", "qwen2_vl_72b", "--smoke", "--device",
                        "cpu", "--gen", "2"] + mesh)
