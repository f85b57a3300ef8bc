"""The port's LM training over a ``(data, model)`` device mesh on the CPU
(``repro_torch.launch.mesh.make_mesh_for(4)``, a (1, 4) mesh, and
``make_mesh_for(4, 2)``, a (2, 2) mesh, every shard on the CPU), for the
six decoder LMs with token prompts, in f32 compute (the MoE configs at
capacity factor 16, where no token is dropped).

- Each collective's backward against the gradient of the same op on the
  whole tensor, exactly, and the rank order of its sums made visible
  with values whose sum in the reverse order differs.
- The mesh gradients against the port's one-device gradients of the
  same parameters, leaf by leaf, within 1e-4 of each leaf's largest
  magnitude.  The reference averages an MoE's aux loss over the mesh,
  each data shard's aux from its own tokens (``moe.py::_moe_local``'s
  ``pmean``), so on the (2, 2) mesh the one-device loss takes the mean
  of the aux losses of the two halves of the batch.  After a step every
  replica of every leaf, and of its moments, is bitwise equal, and two
  runs of a step are bitwise equal.
- Two train steps against the reference's own mesh train step
  (``set_rules(make_mesh_for(4))`` and ``make_mesh_for(4, 2)``, then
  ``jax.jit(make_train_step(...))``, from three ``multi_device``
  subprocesses of four XLA host devices, started with the module and
  run beside its other tests, XLA's optimisation passes and its
  multi-threaded Eigen off to halve their compile time): parameters,
  moments, loss and grad norm within ``REL = 1e-4``, as
  ``tests/test_torch_train_steps.py`` holds the one-device step, with
  microbatches and int8 compression on llama3_8b (the moments within
  2/127 there, as that file allows).
- A checkpoint slot written from the (1, 4) state is byte for byte the
  one written from the one-device state of the same values, and restores
  onto the (2, 2) mesh and onto one device, each continuing within
  1e-6 (rtol = atol) of the uninterrupted run.
- The train CLI over ``--mesh 4`` and its resume over ``--mesh 2``,
  for a decoder LM and for each of the other four families, and its
  default mesh over four visible cards for every config.

The module runs torch on one thread: its SMOKE tensors gain nothing
from more, and under the test runner's workers the threads only
contend.
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import lm_cfg, to_torch, train_inputs
from repro_torch import convert
from repro_torch.distributed import sharding as S
from repro_torch.ft.checkpoint import CheckpointConfig, NVMCheckpointManager
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import registry as PR
from repro_torch.training import optimizer as PO
from repro_torch.training import train_step as PTS

MESH_ARCHS = ["llama3_8b", "gemma3_12b", "starcoder2_3b", "granite_20b",
              "dbrx_132b", "moonshot_v1_16b_a3b"]
#: make_mesh_for's model_parallel: None is the (1, 4) mesh, 2 the (2, 2)
MESHES = {"1x4": None, "2x2": 2}
GRAD_REL = 1e-4
REL = 1e-4
#: the gradient tests' batch: 32 positions, so that gemma3's and
#: starcoder2's attention runs chunked (``attn_chunk`` 16)
B, SEQ = 4, 32
#: the reference comparison's batch and steps
REF_B, REF_S, REF_STEPS, REF_SEED = 4, 16, 2, 5
LEVERS = {"microbatches": {"microbatches": 2},
          "compress_grads": {"compress_grads": True}}


def _mesh(name):
    return make_mesh_for(4, MESHES[name], device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded(cfg, mesh=None):
    return PR.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", mesh=mesh)


def _leaf(pieces, mesh, spec):
    """A placed tensor of leaf pieces that require grad."""
    return S.Placed([p.clone().requires_grad_(True) for p in pieces], mesh,
                    spec)


# ----------------------------------------------------------------------
# 1. the collectives' backward
# ----------------------------------------------------------------------
def test_move_backward_goes_back_to_the_producer():
    mesh = S.make_device_mesh(2, 2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    t = torch.randn(3, 5, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(3, 5, dtype=torch.float64, generator=gen)
    moved = mesh.move(t, 3, src=0)
    assert type(moved.grad_fn).__name__ == "_MoveBackward"
    (moved * w).sum().backward()
    assert torch.equal(t.grad, w)


SPEC_PAIRS = [(("data", "model"), ("model", "data")),
              (("data", "model"), (None, None)),
              (("model", None), ("data", None)),
              ((None, "data"), ("model", None)),
              ((None, None), ("data", "model"))]


@pytest.mark.parametrize("spec_in,spec_out", SPEC_PAIRS)
def test_reshard_backward_is_the_whole_ops_gradient(spec_in, spec_out):
    """place -> reshard -> to_whole is the identity on the whole tensor:
    its gradient is the output gradient, exactly (f64)."""
    mesh = S.make_device_mesh(2, 2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 6, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(4, 6, dtype=torch.float64, generator=gen)
    y = S.to_whole(S.reshard(S.place(x, mesh, spec_in), spec_out))
    assert torch.equal(y, x)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)


def _consume_everywhere(x: S.Placed, weights):
    """``mean_over_mesh`` of every shard's ``sum(piece * weights[s])``:
    every replica consumes its piece, and each piece's gradient is
    ``weights[s] / nshards`` exactly."""
    return S.mean_over_mesh(S.each(lambda p, w: (p * w).sum(), x,
                                   S.PerShard(weights), spec=()))


def test_gather_backward_is_the_reduce_scatter_in_rank_order():
    """The fsdp gather over ``data``: each source piece's gradient is the
    sum over the data ranks, in rank order, of its part of every copy's
    gradient (f64, exactly)."""
    mesh = S.make_device_mesh(2, 2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    whole = torch.randn(4, 3, dtype=torch.float64, generator=gen)
    x = _leaf(S.place(whole, mesh, ("data", None)).pieces, mesh,
              ("data", None))
    g = S.gather_axis(x, "data")
    assert g.spec == (None, None)
    ws = [torch.randn(4, 3, dtype=torch.float64, generator=gen)
          for _ in range(4)]
    _consume_everywhere(g, ws).backward()
    for s, piece in enumerate(x.pieces):
        c = mesh.coords(s)
        rows = slice(2 * c["data"], 2 * c["data"] + 2)
        group = mesh.group("data", s)
        want = ws[group[0]][rows] * 0.25 + ws[group[1]][rows] * 0.25
        assert torch.equal(piece.grad, want), s


#: four gradients whose sum in rank order is 1 and in reverse order 0
#: (f32: 1e8 + 1 rounds to 1e8)
ORDERED = [1e8, 1.0, -1e8, 1.0]


def test_reduce_sum_backward_sums_the_output_gradients_in_rank_order():
    mesh = S.make_device_mesh(1, 4, device="cpu")
    x = _leaf([torch.tensor([0.5]) for _ in range(4)], mesh, (None,))
    y = S.reduce_sum(x, "model")
    # each output's gradient is 4 * w / 4 = ORDERED[s]
    _consume_everywhere(y, [torch.tensor([4 * v]) for v in ORDERED]).backward()
    in_order = ((torch.tensor(ORDERED[0]) + ORDERED[1]) + ORDERED[2]) \
        + ORDERED[3]
    reverse = ((torch.tensor(ORDERED[3]) + ORDERED[2]) + ORDERED[1]) \
        + ORDERED[0]
    assert float(in_order) == 1.0 and float(reverse) == 0.0
    for piece in x.pieces:
        assert torch.equal(piece.grad, in_order.reshape(1))


def test_reduce_sum_backward_is_the_whole_ops_gradient():
    """The row-parallel partials summed over ``model``: with the sum
    read whole, each partial's gradient is the output gradient (f64)."""
    mesh = S.make_device_mesh(2, 2, device="cpu")
    gen = torch.Generator().manual_seed(4)
    parts = [torch.randn(2, 5, dtype=torch.float64, generator=gen)
             for _ in range(4)]
    x = _leaf(parts, mesh, ("data", None))
    w = torch.randn(4, 5, dtype=torch.float64, generator=gen)
    y = S.to_whole(S.reduce_sum(x, "model"))
    assert torch.equal(y[:2], parts[0] + parts[1])
    (y * w).sum().backward()
    for s, piece in enumerate(x.pieces):
        d = mesh.coords(s)["data"]
        assert torch.equal(piece.grad, w[2 * d:2 * d + 2]), s


def test_to_whole_backward_skips_the_replicas():
    mesh = S.make_device_mesh(2, 2, device="cpu")
    gen = torch.Generator().manual_seed(5)
    whole = torch.randn(4, 3, dtype=torch.float64, generator=gen)
    x = _leaf(S.place(whole, mesh, ("model", None)).pieces, mesh,
              ("model", None))
    w = torch.randn(4, 3, dtype=torch.float64, generator=gen)
    (S.to_whole(x) * w).sum().backward()
    for s, piece in enumerate(x.pieces):
        c = mesh.coords(s)
        if c["data"]:
            assert piece.grad is None, s
        else:
            assert torch.equal(piece.grad, w[2 * c["model"]:
                                             2 * c["model"] + 2]), s


def test_mean_over_mesh_backward_shares_the_gradient():
    mesh = S.make_device_mesh(2, 2, device="cpu")
    x = _leaf([torch.tensor(float(s), dtype=torch.float64)
               for s in range(4)], mesh, ())
    out = S.mean_over_mesh(x)
    assert float(out.detach()) == 1.5
    (3.0 * out).backward()
    assert all(torch.equal(p.grad, torch.tensor(0.75, dtype=torch.float64))
               for p in x.pieces)


def test_place_backward_sums_the_replicas_in_rank_order():
    mesh = S.make_device_mesh(1, 4, device="cpu")
    x = torch.full((3,), 0.5, requires_grad=True)
    placed = S.place(x, mesh, (None,))
    assert all(p.requires_grad for p in placed.pieces)
    _consume_everywhere(placed, [torch.full((3,), 4 * v)
                                 for v in ORDERED]).backward()
    assert torch.equal(x.grad, torch.ones(3))


def test_sum_replica_grads_sums_once_and_copies():
    """A replicated leaf's partials summed once in rank order on the
    part's first shard and copied to every replica; a leaf split over
    both axes has no replicas and keeps its gradients."""
    mesh = S.make_device_mesh(1, 4, device="cpu")
    leaf = _leaf([torch.zeros(1) for _ in range(4)], mesh, (None,))
    total = S.sum_replica_grads(leaf, [torch.tensor([v]) for v in ORDERED])
    assert [tuple(g) for g in S.replica_groups(leaf)] == [(0, 1, 2, 3)]
    assert all(torch.equal(p, torch.tensor([1.0])) for p in total.pieces)
    mesh = S.make_device_mesh(2, 2, device="cpu")
    split = _leaf([torch.zeros(1, 1) for _ in range(4)], mesh,
                  ("data", "model"))
    grads = [torch.full((1, 1), float(s)) for s in range(4)]
    kept = S.sum_replica_grads(split, grads)
    assert all(a is b for a, b in zip(kept.pieces, grads))
    # replicated over data, split over model: two groups of two
    half = _leaf([torch.zeros(1, 1) for _ in range(4)], mesh,
                 (None, "model"))
    assert S.replica_groups(half) == [(0, 2), (1, 3)]
    summed = S.sum_replica_grads(half, [None] + grads[1:])
    assert [float(p) for p in summed.pieces] == [2.0, 4.0, 2.0, 4.0]


def test_placed_parameters_become_leaves_that_require_grad():
    """Placed for serving, the pieces require no grad (the serving step
    keeps its bits); the training forward makes each a leaf that does,
    its ``.grad`` on its shard's device."""
    cfg = lm_cfg(PR.get_config("llama3_8b", smoke=True))
    model = _seeded(cfg, _mesh("2x2"))
    assert not any(p.requires_grad for _, leaf in PR.placed_leaves(model)
                   for p in leaf.pieces)
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    _loss(cfg, model, batch)[0].backward()
    for name, leaf in PR.placed_leaves(model):
        assert all(p.is_leaf and p.requires_grad for p in leaf.pieces), name
        assert all(p.grad is not None and p.grad.device == d
                   for p, d in zip(leaf.pieces, model.mesh.devices)), name
    assert [n for n, _ in PR.named_leaves(model)] == \
        [n for n, _ in PR.placed_leaves(model)]


# ----------------------------------------------------------------------
# 2. the six configs' gradients against one device
# ----------------------------------------------------------------------
def _loss(cfg, model, batch):
    logits, aux = PR.make_train_forward(cfg)(model, batch)
    loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
    return loss + 1e-2 * aux, aux


def _one_device_loss(cfg, model, batch, data: int):
    """The one-device counterpart of the mesh's loss: with an MoE and
    ``data`` shards, the aux loss is the mean of each data shard's rows'
    aux, as the mesh (and the reference over a mesh) computes it."""
    total, aux = _loss(cfg, model, batch)
    if cfg.n_experts == 0 or data == 1:
        return total
    rows = batch["tokens"].shape[0] // data
    halves = [_loss(cfg, model, {k: v[d * rows:(d + 1) * rows]
                                 for k, v in batch.items()})[1]
              for d in range(data)]
    return total - 1e-2 * aux + 1e-2 * (sum(halves) / data)


def _assert_replicas_bitwise(leaves, what):
    for name, leaf in leaves:
        for group in S.replica_groups(leaf):
            for r in group[1:]:
                assert torch.equal(leaf.pieces[r], leaf.pieces[group[0]]), \
                    (what, name, group)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_gradients_match_the_one_device_gradients(arch, mesh_name):
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    one = _seeded(cfg)
    _one_device_loss(cfg, one, batch, mesh.shape["data"]).backward()
    want = {n: p.grad for n, p in one.named_parameters()}
    model = _seeded(cfg, mesh)
    _loss(cfg, model, batch)[0].backward()
    for name, leaf in PR.placed_leaves(model):
        got = S.to_whole(S.sum_replica_grads(
            leaf, [p.grad for p in leaf.pieces]))
        scale = max(float(want[name].abs().max()), 1e-30)
        err = float((got - want[name]).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)
    # a step: every replica of every leaf and moment stays a copy
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())
    opt = PO.adamw_init(model)
    metrics = step(model, opt, batch)
    assert all(v.dim() == 0 for v in metrics.values())
    assert all(isinstance(g, S.Placed) for g in opt["m"].values())
    _assert_replicas_bitwise(PR.placed_leaves(model), "params")
    for part in ("m", "v"):
        _assert_replicas_bitwise(opt[part].items(), part)


@pytest.mark.parametrize("arch", MESH_ARCHS[4:])
def test_moe_aux_is_the_mean_of_the_data_shards_aux(arch):
    """On the (2, 2) mesh each data shard routes its own rows: the aux
    loss is the mean of the two halves' one-device aux losses."""
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    with torch.no_grad():
        _, aux = _loss(cfg, _seeded(cfg, _mesh("2x2")), batch)
        one = _seeded(cfg)
        halves = [_loss(cfg, one, {k: v[d * 2:(d + 1) * 2]
                                   for k, v in batch.items()})[1]
                  for d in range(2)]
        whole = _loss(cfg, one, batch)[1]
    want = (halves[0] + halves[1]) / 2
    assert abs(float(aux) - float(want)) <= 1e-6 * abs(float(want))
    assert abs(float(whole) - float(want)) > 1e-4 * abs(float(want))


def test_mesh_remat_is_bitwise_the_plain_mesh_forward():
    """The layers checkpointed over the mesh (``remat=True``) give the
    loss and every piece's gradient of the plain mesh forward bit for
    bit; two runs of a mesh train step are bitwise equal."""
    from repro_torch.models import transformer as PT

    cfg = lm_cfg(PR.get_config("gemma3_12b", smoke=True))
    batch = to_torch(train_inputs(cfg, 6, B, SEQ))
    grads = []
    for remat in (False, True):
        model = PR.trainable(_seeded(cfg, _mesh("2x2")))
        with PR._rules_of(model):
            logits, _, _ = PT.decoder_forward(model, batch["tokens"], cfg,
                                              remat=remat)
        loss, _ = PTS.token_xent(logits, batch["targets"], 1e-4)
        loss.backward()
        grads.append((loss.detach(), [p.grad for _, leaf in
                                      PR.placed_leaves(model)
                                      for p in leaf.pieces]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    runs = []
    for _ in range(2):
        model = _seeded(cfg, _mesh("2x2"))
        opt = PO.adamw_init(model)
        PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())(
            model, opt, batch)
        runs.append([p for _, leaf in PR.placed_leaves(model)
                     for p in leaf.pieces]
                    + [p for m in opt["m"].values() for p in m.pieces])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_mesh_remat_keeps_nothing_of_its_recompute():
    """A checkpointed mesh layer's recompute hands its saved tensors to
    the backward detached, and its frame holds nothing that holds the
    frame: with the cyclic collector off, no recomputed tensor is alive
    once the backward has run and no frame once its graph is gone (held
    with their ``grad_fn`` the tensors would keep every layer's
    recomputed graph alive, and a frame in a cycle its layer's
    parameters)."""
    import gc
    import weakref

    from repro_torch.models import transformer as PT

    cfg = lm_cfg(PR.get_config("starcoder2_3b", smoke=True))
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    saved_refs, frames = [], []
    recompute = PT._MeshCheckpoint._recompute

    def watched(self):
        frames.append(weakref.ref(self))
        saved = recompute(self)
        saved_refs.extend(weakref.ref(t) for t in saved)
        assert all(t.grad_fn is None for t in saved)
        return saved

    PT._MeshCheckpoint._recompute = watched
    gc.disable()
    try:
        loss, _ = _loss(cfg, _seeded(cfg, _mesh("1x4")), batch)
        loss.backward()
        assert saved_refs and not any(r() is not None for r in saved_refs)
        assert len(frames) == cfg.n_layers
        del loss
        assert not any(f() is not None for f in frames)
    finally:
        gc.enable()
        PT._MeshCheckpoint._recompute = recompute


def test_mesh_remat_with_the_dots_policy_raises():
    import dataclasses

    cfg = dataclasses.replace(lm_cfg(PR.get_config("llama3_8b", smoke=True)),
                              remat_policy="dots")
    batch = to_torch(train_inputs(cfg, 4, B, SEQ))
    with pytest.raises(NotImplementedError, match="dots"):
        _loss(cfg, _seeded(cfg, _mesh("1x4")), batch)


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

B, S, STEPS, SEED = {dims}
out = {{}}


def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)


inits = {{}}
for arch, mp, lever, kw in {runs}:
    base = RR.get_config(arch, smoke=True)
    extra = {{"capacity_factor": 16.0}} if base.n_experts else {{}}
    cfg = dataclasses.replace(base, compute_dtype="float32", **extra)
    if arch not in inits:
        inits[arch] = jax.jit(lambda key: RR.init_params(base, key)[0])(
            jax.random.PRNGKey(0))
        flat(arch + "|init|", inits[arch])
    batch = {{"tokens": np.random.default_rng(SEED).integers(
                  0, cfg.vocab, (B, S)).astype(np.int32),
             "targets": np.random.default_rng(SEED + 1000).integers(
                  0, cfg.vocab, (B, S)).astype(np.int32)}}
    batch = {{k: jnp.asarray(v) for k, v in batch.items()}}
    mesh = make_mesh_for(4, mp)
    tag = f"{{arch}}|{{mesh.shape['data']}}x{{mesh.shape['model']}}|{{lever}}"
    try:
        with use_rules(mesh):
            step = jax.jit(RT.make_train_step(
                RR.make_train_forward(cfg), RO.AdamWConfig(),
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

#: the reference runs in three subprocesses side by side, each about a
#: third of the compile time
_REF_GROUPS = (
    (("gemma3_12b", None, ""), ("dbrx_132b", None, ""),
     ("starcoder2_3b", None, ""), ("granite_20b", 2, "")),
    (("llama3_8b", None, ""), ("gemma3_12b", 2, ""),
     ("moonshot_v1_16b_a3b", None, ""), ("starcoder2_3b", 2, "")),
    (("dbrx_132b", 2, ""), ("moonshot_v1_16b_a3b", 2, ""),
     ("llama3_8b", 2, ""), ("granite_20b", None, ""),
     ("llama3_8b", None, "microbatches"),
     ("llama3_8b", None, "compress_grads")),
)
#: set before jax imports: four host devices, Eigen on one thread
_REF_PROLOGUE = ("import os\nos.environ['XLA_FLAGS'] = "
                 "'--xla_force_host_platform_device_count=4 "
                 "--xla_cpu_multi_thread_eigen=false'\n"
                 "import jax\n"
                 "jax.config.update('jax_disable_most_optimizations', True)\n")


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
    base = tmp_path_factory.mktemp("ref_mesh_train")
    procs = []
    for i, group in enumerate(_REF_GROUPS):
        runs = [(arch, mp, lever, LEVERS.get(lever, {}))
                for arch, mp, lever in group]
        src = _REF_PROLOGUE + _REF_MESH_TRAIN.format(
            dims=(REF_B, REF_S, REF_STEPS, REF_SEED), runs=runs)
        path = base / f"runs{i}.npz"
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", src, str(path)], env=multi_device._env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    yield procs
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref_mesh_train(_ref_procs, multi_device):
    """The reference's two mesh train steps of the six configs on both
    meshes, and of llama3_8b on (1, 4) with each lever, with each arch's
    initial parameters: ``{key: array}``."""
    multi_device.require(4)
    out = {}
    for path, proc in _ref_procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-2000:]
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


def _tree(runs, prefix):
    """The reference's tree of the keys under ``prefix``."""
    tree = {}
    for key, val in runs.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


def _close_tree(got, want, rel):
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], rel)
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size:
        scale = max(float(np.max(np.abs(want))), 1e-30)
        assert float(np.max(np.abs(got - want))) <= rel * scale


def _against_the_reference(runs, arch, mesh_name, lever="",
                           moments_rel=REL):
    tag = f"{arch}|{mesh_name}|{lever}"
    assert tag + "|raised" not in runs, runs.get(tag + "|raised")
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    model = convert.lm_params_from_numpy(cfg, _tree(runs, arch + "|init|"),
                                         mesh=mesh)
    opt = PO.adamw_init(model)
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig(),
                               PTS.TrainConfig(**LEVERS.get(lever, {})))
    batch = {"tokens": np.random.default_rng(REF_SEED).integers(
                 0, cfg.vocab, (REF_B, REF_S)),
             "targets": np.random.default_rng(REF_SEED + 1000).integers(
                 0, cfg.vocab, (REF_B, REF_S))}
    batch = to_torch(batch)
    for t in range(REF_STEPS):
        metrics = step(model, opt, batch)
        for k in ("loss", "grad_norm", "lr", "aux"):
            _close_tree(metrics[k].numpy(), runs[f"{tag}|{t}|{k}"], REL)
    opt.pop("ef", None)
    got = convert.train_state_to_numpy(model, opt)
    _close_tree(got["params"], _tree(runs, tag + "|params|"), REL)
    assert int(got["opt"]["step"]) == REF_STEPS
    for part in ("m", "v"):
        _close_tree(got["opt"][part], _tree(runs, f"{tag}|{part}|"),
                    moments_rel)


# ----------------------------------------------------------------------
# 4. checkpoint slots of a placed state, restored onto any mesh shape
# ----------------------------------------------------------------------
def _slot_files(directory):
    slot = os.path.join(directory, "slot1")
    return {name: open(os.path.join(slot, name), "rb").read()
            for name in sorted(os.listdir(slot))}


def test_checkpoint_cycle_across_mesh_shapes(tmp_path):
    cfg = lm_cfg(PR.get_config("moonshot_v1_16b_a3b", smoke=True))
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())
    batches = [to_torch(train_inputs(cfg, 20 + s, B, 16)) for s in range(4)]
    # uninterrupted: four steps on (1, 4)
    model = _seeded(cfg, _mesh("1x4"))
    opt = PO.adamw_init(model)
    for batch in batches:
        step(model, opt, batch)
    want = convert.train_state_to_numpy(model, opt)
    # two steps on (1, 4), a slot, and the one-device state's slot
    model = _seeded(cfg, _mesh("1x4"))
    opt = PO.adamw_init(model)
    for batch in batches[:2]:
        step(model, opt, batch)
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path / "mesh")))
    mgr.save(lambda: convert.train_state_to_numpy(model, opt), 2)
    one, one_opt = convert.train_state_from_numpy(
        cfg, convert.train_state_to_numpy(model, opt), "cpu")
    assert not isinstance(one.embed, S.Placed)
    NVMCheckpointManager(CheckpointConfig(str(tmp_path / "one"))).save(
        convert.train_state_to_numpy(one, one_opt), 2)
    assert _slot_files(tmp_path / "mesh") == _slot_files(tmp_path / "one")
    # restore onto (2, 2) and onto one device, two more steps each
    tree, at, _ = mgr.restore(convert.train_state_like(cfg))
    assert at == 2
    for mesh in (_mesh("2x2"), None):
        model, opt = convert.train_state_from_numpy(cfg, tree, "cpu",
                                                    mesh=mesh)
        assert int(opt["step"]) == 2
        if mesh is not None:
            assert model.mesh is mesh and all(
                isinstance(m, S.Placed) and m.spec == leaf.spec
                for (_, leaf), m in zip(PR.placed_leaves(model),
                                        opt["m"].values()))
        for batch in batches[2:]:
            step(model, opt, batch)
        got = convert.train_state_to_numpy(model, opt)["params"]
        flat_got = dict(_flat(got))
        for key, w in _flat(want["params"]):
            assert np.all(np.abs(flat_got[key] - w)
                          <= 1e-6 * (1 + np.abs(w))), (mesh, key)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


# ----------------------------------------------------------------------
# 5. the train CLI over a mesh
# ----------------------------------------------------------------------
def test_train_cli_over_a_mesh_resumes_on_another(tmp_path):
    from repro_torch.launch import train

    common = ["--arch", "llama3_8b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "32", "--mtbf", "1",
              "--ckpt-dir", str(tmp_path)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(common + ["--mesh", "4", "--steps", "6"])
    out = buf.getvalue()
    assert "params on 4 device(s) as a (1, 4) mesh" in out
    assert out.rstrip().endswith("done.")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(common + ["--mesh", "2", "--steps", "8"])
    out = buf.getvalue()
    assert "params on 2 device(s) as a (1, 2) mesh" in out
    assert "elastic restore: resuming from step 5" in out
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(common + ["--steps", "9"])
    out = buf.getvalue()
    assert "params on 1 device(s)\n" in out
    assert "elastic restore: resuming from step" in out


OTHER_FAMILIES = ["mamba2_370m", "recurrentgemma_9b", "whisper_small",
                  "qwen2_vl_72b"]


@pytest.mark.parametrize("arch", MESH_ARCHS + OTHER_FAMILIES)
def test_train_cli_default_mesh_by_family(arch, monkeypatch):
    """With four cards visible the CLI trains every family over
    ``make_mesh_for(4)`` on the cards by default, as the reference's
    ``make_mesh_for(ndev)``; ``--device cpu`` and ``--device cuda:1``
    train on one device, and ``--mesh`` is taken as given.  The model is
    never built: ``init_params`` stops the run once it is asked for."""
    import types

    from repro_torch.launch import train

    class Built(Exception):
        pass

    def mesh_for(n, device):
        return types.SimpleNamespace(device=torch.device("cpu"), n=n,
                                     on=torch.device(device))

    def init_params(cfg, generator, device, mesh):
        raise Built(None if mesh is None else (mesh.n, mesh.on))

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(train, "resolve_device", torch.device)
    monkeypatch.setattr(train, "make_mesh_for", mesh_for)
    monkeypatch.setattr(train.R, "init_params", init_params)
    # no card here: the model's generator is made on the CPU
    cpu_generator = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device: cpu_generator())
    cuda = torch.device("cuda")
    for argv, want in ((["--device", "cuda"], (4, cuda)),
                       (["--device", "cpu"], None),
                       (["--device", "cuda:1"], None),
                       (["--device", "cuda", "--mesh", "1"], None),
                       (["--device", "cuda", "--mesh", "2"], (2, cuda))):
        with pytest.raises(Built) as built:
            train.main(["--arch", arch, "--smoke"] + argv)
        assert built.value.args[0] == want, argv
    assert train.mesh_shards(torch.device("cuda"), None) == 4


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_train_cli_trains_each_family_over_a_mesh_and_resumes(arch,
                                                              tmp_path):
    """``--mesh 4`` trains the SSD, RG-LRU, encoder-decoder and vision
    families over the (1, 4) mesh on the CPU, their stub inputs placed
    by the forward, and a run over ``--mesh 2`` resumes from its slot."""
    from repro_torch.launch import train

    common = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
              "--seq", "16", "--mtbf", "1", "--ckpt-dir", str(tmp_path)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(common + ["--mesh", "4", "--steps", "6"])
    out = buf.getvalue()
    assert "params on 4 device(s) as a (1, 4) mesh" in out
    assert out.rstrip().endswith("done.")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(common + ["--mesh", "2", "--steps", "7"])
    out = buf.getvalue()
    assert "params on 2 device(s) as a (1, 2) mesh" in out
    assert "elastic restore: resuming from step 5" in out
    assert out.rstrip().endswith("done.")


# ----------------------------------------------------------------------
# 3. (the tests) against the reference's own mesh train step, last, so
# that its subprocesses run beside everything before them
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_two_mesh_train_steps_match_the_references_mesh_steps(
        arch, mesh_name, ref_mesh_train):
    _against_the_reference(ref_mesh_train, arch, mesh_name)


@pytest.mark.parametrize("lever,moments_rel", [
    ("microbatches", REL), ("compress_grads", 2 / 127)])
def test_mesh_train_step_levers_match_the_reference(lever, moments_rel,
                                                    ref_mesh_train):
    _against_the_reference(ref_mesh_train, "llama3_8b", "1x4", lever,
                           moments_rel)
