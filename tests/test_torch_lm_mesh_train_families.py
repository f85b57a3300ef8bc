"""The port's training over a ``(data, model)`` device mesh on the CPU
for the other four LM families: mamba2's SSD heads, recurrentgemma's
RG-LRU channels, whisper's
encoder-decoder and qwen2_vl's patch embeddings with M-RoPE positions,
on ``make_mesh_for(4)`` (a (1, 4) mesh) and ``make_mesh_for(4, 2)`` (a
(2, 2) mesh), every shard on the CPU, in f32 compute.

- The mesh gradients against the port's one-device gradients of the
  same parameters, leaf by leaf, within 1e-4 of each leaf's largest
  magnitude, also in the two layouts that replicate compute over
  ``model``: mamba2 cut to 6 SSD heads of 16 (``d_model`` 48) on (1, 4),
  whose ``d_inner`` of 96 splits over ``model`` and whose heads do not,
  and recurrentgemma with 45 LRU channels, which neither extent
  divides.  After a step every replica of every leaf, and of its
  moments, is bitwise equal.
- The checkpointed mesh forward (``remat=True``) bitwise the plain mesh
  forward, the loss and every piece's gradient; one frame a layer, each
  recomputing once, and nothing of any recompute alive after the
  backward.
- Two train steps against the reference's own mesh train step
  (``set_rules(make_mesh_for(4[, 2]))``, then ``jax.jit(make_train_step(
  ...))``, from ``multi_device`` subprocesses of four XLA host devices
  started with the module, XLA's optimisation passes and its
  multi-threaded Eigen off): parameters, moments, loss and grad norm
  within ``REL = 1e-4`` (AdamW's epsilon at ``ADAM_EPS`` in both
  packages, where that comparison is well posed); whisper_small and
  qwen2_vl_72b also with
  microbatches and with int8 compression (the moments within 2/127
  there).  Both packages take the same numpy-seeded tokens, frames,
  patch embeddings and M-RoPE positions.
- The training forward never reaches the decode-only relayouts
  (``heads_to_seq``, ``attend_kv_seq``), which have no backward.
- A train state written from the (1, 4) mesh is the one-device state's
  of the same values, byte for byte, and restores onto (2, 2) and onto
  one device, each continuing within 1e-6 of the (1, 4) run.

The module runs torch on one thread, as ``test_torch_lm_mesh_train.py``
does.
"""
import dataclasses
import gc
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from _torch_port import lm_cfg, to_torch, train_inputs
from repro_torch import convert
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import encdec as PE
from repro_torch.models import registry as PR
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.training import optimizer as PO
from repro_torch.training import train_step as PTS
from test_torch_lm_mesh_train import (_REF_PROLOGUE, _assert_replicas_bitwise,
                                      _close_tree, _flat, _tree)

FAMILY_ARCHS = ["mamba2_370m", "recurrentgemma_9b", "whisper_small",
                "qwen2_vl_72b"]
#: make_mesh_for's model_parallel: None is the (1, 4) mesh, 2 the (2, 2)
MESHES = {"1x4": None, "2x2": 2}
GRAD_REL = 1e-4
REL = 1e-4
#: the gradient tests' batch: 32 positions, so that the attention and
#: the SSD scan run two chunks (``attn_chunk`` and ``ssm_chunk`` 16)
B, SEQ = 4, 32
#: the reference comparison's batch and steps
REF_B, REF_S, REF_STEPS, REF_SEED = 4, 16, 2, 5
LEVERS = {"microbatches": {"microbatches": 2},
          "compress_grads": {"compress_grads": True}}
#: AdamW's epsilon in the comparison with the reference.  Adam divides
#: each element's moment by its own root second moment, so an element
#: whose gradient is 1e-4 of its leaf's largest takes the f32 noise of
#: the leaf's gradient (about 3e-6 of the leaf's scale) 1e4 times
#: magnified into its update.  recurrentgemma's zero-initialised
#: ``b_a``/``b_i`` are such leaves: with the default 1e-8 the
#: reference's own one-device and (2, 2) runs differ by 1.3e-3 of the
#: leaf's scale after two steps, so no run can be held to 1e-4 there.
#: At 1e-3 an element's update is damped where its gradient is small
#: and the reference's runs agree within 1e-5 on every leaf.
ADAM_EPS = 1e-3
#: the layouts that replicate compute over ``model``: 6 SSD heads on a
#: model extent of 4 (``d_inner`` 96 split, the heads not), and 45 LRU
#: channels, which neither extent divides
REPLICATED = {"mamba2_370m": {"d_model": 48},
              "recurrentgemma_9b": {"lru_width": 45}}


def _mesh(name):
    return make_mesh_for(4, MESHES[name], device="cpu")


def _cfg(arch, cut=None):
    return dataclasses.replace(lm_cfg(PR.get_config(arch, smoke=True)),
                               **(cut or {}))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded(cfg, mesh=None):
    return PR.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", mesh=mesh)


def _loss(cfg, model, batch):
    logits, aux = PR.make_train_forward(cfg)(model, batch)
    loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
    return loss + 1e-2 * aux


# ----------------------------------------------------------------------
# 1. the mesh gradients against one device
# ----------------------------------------------------------------------
GRAD_CASES = ([(arch, mesh, False) for arch in FAMILY_ARCHS
               for mesh in MESHES]
              + [("mamba2_370m", "1x4", True),
                 ("recurrentgemma_9b", "1x4", True),
                 ("recurrentgemma_9b", "2x2", True)])


@pytest.mark.parametrize(
    "arch,mesh_name,replicated", GRAD_CASES,
    ids=[f"{a}-{m}" + ("-replicated" if r else "") for a, m, r in GRAD_CASES])
def test_mesh_gradients_match_the_one_device_gradients(arch, mesh_name,
                                                       replicated,
                                                       record_property):
    """Every leaf's mesh gradient within ``GRAD_REL`` of its scale of the
    one-device gradient; the worst leaf's reading, and mamba2's
    ``a_log`` readings, are recorded as the case's properties (pytest's
    ``--junitxml`` report)."""
    cfg = _cfg(arch, REPLICATED[arch] if replicated else None)
    mesh = _mesh(mesh_name)
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    one = _seeded(cfg)
    _loss(cfg, one, batch).backward()
    # qwen2_vl's embedding table takes no gradient: its prompts are
    # patch embeddings
    want = {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in one.named_parameters()}
    model = _seeded(cfg, mesh)
    if replicated and arch == "mamba2_370m":
        assert not PS.heads_split(cfg, mesh)
        assert model.layers[0].ssm.w_x.spec == (None, "model")
    if replicated and arch == "recurrentgemma_9b":
        assert model.layers[0].rec.w_gate.spec[1] is None
    _loss(cfg, model, batch).backward()
    worst = (0.0, "")
    for name, leaf in PR.placed_leaves(model):
        got = S.to_whole(S.sum_replica_grads(
            leaf, [p.grad for p in leaf.pieces]))
        scale = max(float(want[name].abs().max()), 1e-30)
        err = float((got - want[name]).abs().max())
        worst = max(worst, (err / scale, name))
        if name.endswith("a_log"):
            record_property(f"rel_{name}", err / scale)
        assert err <= GRAD_REL * scale, (name, err, scale)
    record_property("worst_rel", worst[0])
    record_property("worst_leaf", worst[1])
    # a step: every replica of every leaf and moment stays a copy
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())
    opt = PO.adamw_init(model)
    metrics = step(model, opt, batch)
    assert all(v.dim() == 0 for v in metrics.values())
    _assert_replicas_bitwise(PR.placed_leaves(model), "params")
    for part in ("m", "v"):
        _assert_replicas_bitwise(opt[part].items(), part)


# ----------------------------------------------------------------------
# 2. the checkpointed mesh forward
# ----------------------------------------------------------------------
def _mesh_loss(cfg, model, batch, remat):
    """The training loss of a placed model with the layers checkpointed
    (``remat=True``) or not."""
    with PR._rules_of(model):
        if cfg.family == "encdec":
            enc = PE.encode(model, batch["frames"], cfg, remat=remat)
            logits, _ = PE.decode(model, batch["tokens"], enc, cfg,
                                  remat=remat)
        else:
            logits, _, _ = PT.decoder_forward(
                model, batch["tokens"], cfg,
                positions=batch.get("positions"), remat=remat)
    return PTS.token_xent(logits, batch["targets"], 1e-4)[0]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_mesh_remat_is_bitwise_the_plain_mesh_forward(arch):
    """The layers checkpointed over the (2, 2) mesh give the loss and
    every piece's gradient of the plain mesh forward bit for bit."""
    cfg = _cfg(arch)
    batch = to_torch(train_inputs(cfg, 6, B, SEQ))
    runs = []
    for remat in (False, True):
        model = PR.trainable(_seeded(cfg, _mesh("2x2")))
        loss = _mesh_loss(cfg, model, batch, remat)
        loss.backward()
        runs.append([loss.detach()] + [p.grad for _, leaf in
                                       PR.placed_leaves(model)
                                       for p in leaf.pieces])
    # qwen2_vl's embedding table takes no gradient either way
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(*runs))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_mesh_remat_keeps_nothing_of_its_recompute(arch):
    """Over the (1, 4) mesh every layer is one checkpointed frame (the
    encoder's and the decoder's layers; recurrentgemma's layers one by
    one, its groups not checkpointed around them), each frame recomputes
    once in the backward and hands its saved tensors over detached, and
    with the cyclic collector off no recomputed tensor is alive after
    the backward, and no frame once its graph is gone."""
    cfg = _cfg(arch)
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    frames, saved_refs, recomputed = [], [], []
    init, recompute = PT._MeshCheckpoint.__init__, \
        PT._MeshCheckpoint._recompute

    def watched_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        frames.append(weakref.ref(self))

    def watched(self):
        recomputed.append(weakref.ref(self))
        saved = recompute(self)
        saved_refs.extend(weakref.ref(t) for t in saved)
        assert all(t.grad_fn is None for t in saved)
        return saved

    PT._MeshCheckpoint.__init__ = watched_init
    PT._MeshCheckpoint._recompute = watched
    gc.disable()
    try:
        loss = _loss(cfg, _seeded(cfg, _mesh("1x4")), batch)
        layers = (cfg.enc_layers + cfg.n_layers if cfg.family == "encdec"
                  else cfg.n_layers)
        assert len(frames) == layers
        loss.backward()
        assert sorted(id(r()) for r in recomputed) == \
            sorted(id(f()) for f in frames)
        assert saved_refs and not any(r() is not None for r in saved_refs)
        del loss
        assert not any(f() is not None for f in frames)
    finally:
        gc.enable()
        PT._MeshCheckpoint.__init__ = init
        PT._MeshCheckpoint._recompute = recompute


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_training_reaches_no_decode_only_collective(arch, monkeypatch):
    """A training forward writes no cache, so it never reaches the
    head-to-sequence relayout or the partial softmaxes of a
    ``kv_seq``-sharded cache, which have no backward."""
    from repro_torch.models import layers as PL

    reached = []

    def refuse(name):
        def call(*args, **kwargs):
            reached.append(name)
            raise AssertionError(f"a training forward reached {name}")
        return call

    for name in ("heads_to_seq", "attend_kv_seq"):
        monkeypatch.setattr(PL, name, refuse(name))
    cfg = _cfg(arch)
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    _loss(cfg, _seeded(cfg, _mesh("1x4")), batch).backward()
    assert reached == []


# ----------------------------------------------------------------------
# 3. against the reference's own mesh train step
# ----------------------------------------------------------------------
_REF_MESH_TRAIN = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.distributed.sharding import use_rules
from repro.launch.mesh import make_mesh_for
from repro.models import registry as RR
from repro.training import optimizer as RO
from repro.training import train_step as RT

STEPS = {steps}
out = {{}}
with np.load(sys.argv[2]) as z:
    inputs = {{k: z[k] for k in z.files}}


def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)


inits = {{}}
for arch, mp, lever, kw in {runs}:
    base = RR.get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, compute_dtype="float32")
    if arch not in inits:
        inits[arch] = jax.jit(lambda key: RR.init_params(base, key)[0])(
            jax.random.PRNGKey(0))
        flat(arch + "|init|", inits[arch])
    batch = {{k.split("|")[1]: jnp.asarray(v) for k, v in inputs.items()
             if k.startswith(arch + "|")}}
    mesh = make_mesh_for(4, mp)
    tag = f"{{arch}}|{{mesh.shape['data']}}x{{mesh.shape['model']}}|{{lever}}"
    try:
        with use_rules(mesh):
            step = jax.jit(RT.make_train_step(
                RR.make_train_forward(cfg), RO.AdamWConfig(eps={eps}),
                RT.TrainConfig(**kw)))
            p, o = inits[arch], RO.adamw_init(inits[arch])
            for t in range(STEPS):
                p, o, m = step(p, o, batch)
                for k in ("loss", "grad_norm", "lr", "aux"):
                    out[tag + f"|{{t}}|{{k}}"] = np.asarray(m[k])
    except Exception as e:
        out[tag + "|raised"] = np.asarray(type(e).__name__)
        continue
    flat(tag + "|params|", p)
    flat(tag + "|m|", o["m"])
    flat(tag + "|v|", o["v"])
np.savez(sys.argv[1], **out)
print(json.dumps({{"saved": len(out)}}))
"""

#: the reference's runs in five subprocesses side by side, each about a
#: fifth of the compile time (recurrentgemma's scan compiles longest)
_REF_GROUPS = (
    (("recurrentgemma_9b", None, ""),),
    (("recurrentgemma_9b", 2, ""),),
    (("mamba2_370m", None, ""), ("mamba2_370m", 2, ""),
     ("qwen2_vl_72b", None, ""), ("qwen2_vl_72b", 2, "")),
    (("whisper_small", None, ""), ("whisper_small", 2, ""),
     ("whisper_small", None, "microbatches")),
    (("whisper_small", None, "compress_grads"),
     ("qwen2_vl_72b", None, "microbatches"),
     ("qwen2_vl_72b", None, "compress_grads")),
)


def _ref_batch(cfg):
    """The reference comparison's seeded numpy batch of ``cfg``: tokens
    or patch embeddings and M-RoPE positions, frames, targets."""
    return train_inputs(cfg, REF_SEED, REF_B, REF_S)


@pytest.fixture(scope="module", autouse=True)
def _ref_procs(request, multi_device, tmp_path_factory):
    """The reference's subprocesses, started with the module's first
    test when any selected test reads them (:func:`ref_mesh_train`), so
    that they run beside the tests before them: ``[(npz path, process),
    ...]``, killed at the module's end if still running."""
    wanted = any(item.module is request.module
                 and "ref_mesh_train" in item.fixturenames
                 for item in request.session.items)
    try:
        if wanted:
            multi_device.require(4)
    except pytest.skip.Exception:
        wanted = False          # ref_mesh_train's own require skips
    if not wanted:
        yield []
        return
    base = tmp_path_factory.mktemp("ref_mesh_train_families")
    inputs = base / "inputs.npz"
    np.savez(inputs, **{f"{arch}|{k}": v for arch in FAMILY_ARCHS
                        for k, v in _ref_batch(_cfg(arch)).items()})
    procs = []
    for i, group in enumerate(_REF_GROUPS):
        runs = [(arch, mp, lever, LEVERS.get(lever, {}))
                for arch, mp, lever in group]
        src = _REF_PROLOGUE + _REF_MESH_TRAIN.format(
            steps=REF_STEPS, eps=ADAM_EPS, runs=runs)
        path = base / f"runs{i}.npz"
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", src, str(path), str(inputs)],
            env=multi_device._env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    yield procs
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref_mesh_train(_ref_procs, multi_device):
    """The reference's two mesh train steps of the four families on
    both meshes, and of whisper_small and qwen2_vl_72b on (1, 4) with
    each lever, with each arch's initial parameters: ``{key: array}``."""
    multi_device.require(4)
    out = {}
    for path, proc in _ref_procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-2000:]
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


def _against_the_reference(runs, arch, mesh_name, lever="",
                           moments_rel=REL):
    tag = f"{arch}|{mesh_name}|{lever}"
    assert tag + "|raised" not in runs, runs.get(tag + "|raised")
    cfg = _cfg(arch)
    model = convert.lm_params_from_numpy(cfg, _tree(runs, arch + "|init|"),
                                         mesh=_mesh(mesh_name))
    opt = PO.adamw_init(model)
    step = PTS.make_train_step(PR.make_train_forward(cfg),
                               PO.AdamWConfig(eps=ADAM_EPS),
                               PTS.TrainConfig(**LEVERS.get(lever, {})))
    batch = to_torch(_ref_batch(cfg))
    for t in range(REF_STEPS):
        metrics = step(model, opt, batch)
        for k in ("loss", "grad_norm", "lr", "aux"):
            _close_tree(metrics[k].numpy(), runs[f"{tag}|{t}|{k}"], REL)
    opt.pop("ef", None)
    _assert_replicas_bitwise(PR.placed_leaves(model), "params")
    got = convert.train_state_to_numpy(model, opt)
    _close_tree(got["params"], _tree(runs, tag + "|params|"), REL)
    assert int(got["opt"]["step"]) == REF_STEPS
    for part in ("m", "v"):
        _close_tree(got["opt"][part], _tree(runs, f"{tag}|{part}|"),
                    moments_rel)


# ----------------------------------------------------------------------
# 4. a placed train state restored onto other mesh shapes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_state_across_mesh_shapes(arch):
    """One step on (1, 4); its state gathered whole is the one-device
    state's of the same values, byte for byte (an encoder-decoder's
    ``enc``/``dec`` stacks and recurrentgemma's groups and tail in the
    reference's layout), and restored onto (2, 2) and onto one device a
    second step lands within 1e-6 of the (1, 4) run's."""
    cfg = _cfg(arch)
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())
    batches = [to_torch(train_inputs(cfg, 20 + s, B, 16)) for s in range(2)]
    model = _seeded(cfg, _mesh("1x4"))
    opt = PO.adamw_init(model)
    step(model, opt, batches[0])
    tree = convert.train_state_to_numpy(model, opt)
    one, one_opt = convert.train_state_from_numpy(cfg, tree, "cpu")
    assert not isinstance(one.embed, S.Placed)
    again = convert.train_state_to_numpy(one, one_opt)
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for (_, a), (_, b) in zip(_flat(tree), _flat(again)))
    step(model, opt, batches[1])
    want = dict(_flat(convert.train_state_to_numpy(model, opt)["params"]))
    for mesh in (_mesh("2x2"), None):
        restored, ropt = convert.train_state_from_numpy(cfg, tree, "cpu",
                                                        mesh=mesh)
        assert int(ropt["step"]) == 1
        step(restored, ropt, batches[1])
        got = convert.train_state_to_numpy(restored, ropt)["params"]
        for key, g in _flat(got):
            assert np.all(np.abs(g - want[key])
                          <= 1e-6 * (1 + np.abs(want[key]))), (mesh, key)


# ----------------------------------------------------------------------
# 3. (the tests) against the reference's own mesh train step, last, so
# that its subprocesses run beside everything before them
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_two_mesh_train_steps_match_the_references_mesh_steps(
        arch, mesh_name, ref_mesh_train):
    _against_the_reference(ref_mesh_train, arch, mesh_name)


@pytest.mark.parametrize("lever,moments_rel", [
    ("microbatches", REL), ("compress_grads", 2 / 127)])
@pytest.mark.parametrize("arch", ["whisper_small", "qwen2_vl_72b"])
def test_mesh_train_step_levers_match_the_reference(arch, lever, moments_rel,
                                                    ref_mesh_train):
    _against_the_reference(ref_mesh_train, arch, "1x4", lever, moments_rel)
