"""The residual stream's ``seq`` layout over a ``(data, model)`` device
mesh on the CPU (``repro_torch.launch.mesh.make_mesh_for(4)``, a (1, 4)
mesh, and ``make_mesh_for(4, 2)``, a (2, 2) mesh, every shard on the
CPU): the reference's sequence parallelism, its default rules'
``"seq": "model"``.

- ``sharding.reduce_scatter``: each piece element for element the
  matching rows of ``reduce_sum``'s, with values whose sum in another
  order differs, and its backward the all-gather of the output
  gradients in rank order.
- The stream between layers is placed ``(batch, "model", None)`` where
  the model extent divides the positions, and whole at a 14-token
  prompt on model = 4 and at a decode step.
- For the ten SMOKE configs in f32 (MoE at capacity factor 16), on both
  meshes: the prefill logits against the same mesh under rules with
  ``"seq": None`` (the whole layout; whether they are bitwise is the
  case's ``forward_bitwise`` property in pytest's ``--junitxml``
  report), every layer checkpointed in a train step holding ``1 /
  model`` of the whole layout's bytes of its input on each shard, and
  one train step's loss, gradient norm and parameters within ``REL`` of
  the whole layout's, every replica of every leaf bitwise.

The reference's seq-sharded mesh runs are held against the port's in
``tests/test_torch_lm_mesh.py``, ``tests/test_torch_lm_mesh_families.py``
and ``tests/test_torch_lm_mesh_train*.py``; this module runs no
reference subprocess.  It runs torch on one thread.
"""
import numpy as np
import pytest
import torch

from _torch_port import lm_cfg, to_torch, train_inputs
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import registry as PR
from repro_torch.models import transformer as PT
from repro_torch.training import optimizer as PO
from repro_torch.training import train_step as PTS

#: make_mesh_for's model_parallel: None is the (1, 4) mesh, 2 the (2, 2)
MESHES = {"1x4": None, "2x2": 2}
#: the train step's batch: 32 positions, 8 a shard on model = 4
B, SEQ = 2, 32
#: ``tests/test_torch_lm_mesh_train.py``'s tolerance: each leaf within
#: this share of its largest magnitude
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(name):
    return make_mesh_for(4, MESHES[name], device="cpu")


def _seeded(cfg, mesh, seq=True):
    """The seeded SMOKE model on ``mesh``, under its serving rules or,
    with ``seq=False``, those rules with ``"seq"`` on no axis."""
    model = PR.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", mesh=mesh)
    if not seq:
        model.rules = S.AxisRules(mesh, {**model.rules.rules, "seq": None})
    return model


# ----------------------------------------------------------------------
# the collective
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_reduce_scatter_is_reduce_sums_rows_and_its_transpose_the_gather(
        data, model, dim):
    mesh = S.make_device_mesh(data, model, device="cpu")
    rng = np.random.default_rng(11)
    shape = (4, 8, 3)
    # partial pieces whose magnitudes spread over twelve decades: a sum
    # in another order than rank order gives other bits
    pieces = [torch.as_tensor(rng.standard_normal(shape)
                              * 10.0 ** rng.integers(-6, 7, shape)).float()
              for _ in range(mesh.nshards)]
    x = S.Placed([p.clone().requires_grad_(True) for p in pieces], mesh,
                 (None, None, None))
    got = S.reduce_scatter(x, "model", dim)
    assert got.spec == tuple("model" if i == dim else None for i in range(3))
    whole = S.reduce_sum(S.Placed(pieces, mesh, x.spec), "model")
    step = shape[dim] // model
    reordered = False
    for s in range(mesh.nshards):
        m = mesh.coords(s)["model"]
        want = whole.pieces[s].narrow(dim, m * step, step)
        assert torch.equal(got.pieces[s], want), s
        group = [pieces[r].narrow(dim, m * step, step)
                 for r in mesh.group("model", s)]
        backwards = group[-1]
        for part in group[-2::-1]:
            backwards = backwards + part
        reordered |= not torch.equal(backwards, want)
    # two terms add alike in either order; three or more do not
    assert reordered == (model > 2)
    # the transpose: each input piece's gradient is its group's output
    # gradients joined along ``dim`` in rank order
    weights = [torch.as_tensor(rng.standard_normal(p.shape)).float()
               for p in got.pieces]
    sum((p * w).sum() for p, w in zip(got.pieces, weights)).backward()
    for r in range(mesh.nshards):
        want = torch.cat([weights[s] for s in mesh.group("model", r)], dim)
        assert torch.equal(x.pieces[r].grad, want), r


def test_reduce_scatter_refuses_a_dimension_it_cannot_split():
    mesh = S.make_device_mesh(1, 4, device="cpu")
    x = S.Placed([torch.zeros(2, 6)] * 4, mesh, (None, None))
    with pytest.raises(ValueError, match="cannot reduce-scatter"):
        S.reduce_scatter(x, "model", 1)


# ----------------------------------------------------------------------
# the stream's layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
def test_the_stream_between_layers_is_seq_placed_where_the_extent_divides(
        mesh_name):
    cfg = lm_cfg(PR.get_config("llama3_8b", smoke=True))
    mesh = _mesh(mesh_name)
    n, data = mesh.shape["model"], mesh.shape["data"]
    bspec = "data" if data > 1 else None
    model = _seeded(cfg, mesh)
    seen = []
    model.layers[1].register_forward_pre_hook(
        lambda module, args: seen.append(args[0]))
    rng = np.random.default_rng(2)
    for prompt in (64, 14):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, prompt + 1)))
        caches = PR.init_caches(cfg, 4, prompt + 1, mesh=mesh)
        with torch.inference_mode():
            _, caches = PR.make_prefill(cfg)(model, tokens[:, :prompt], caches)
            x = seen.pop()
            split = prompt % n == 0
            assert x.spec == (bspec, "model" if split else None, None)
            assert tuple(x.pieces[0].shape) == (
                4 // data, prompt // n if split else prompt, cfg.d_model)
            PR.make_decode(cfg)(model, tokens[:, prompt:], caches, prompt)
            assert seen.pop().spec == (bspec, None, None)
    # the rules' own switch: "seq" on no axis keeps the stream whole
    whole = _seeded(cfg, mesh, seq=False)
    whole.layers[1].register_forward_pre_hook(
        lambda module, args: seen.append(args[0]))
    with torch.inference_mode():
        PR.make_prefill(cfg)(whole, tokens[:, :8],
                             PR.init_caches(cfg, 4, 8, mesh=mesh))
    assert seen.pop().spec == (bspec, None, None)


# ----------------------------------------------------------------------
# the ten configs against the whole layout
# ----------------------------------------------------------------------
def _prefill_inputs(batch):
    return {k: v for k, v in batch.items() if k != "targets"}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_the_seq_layout_is_the_whole_layouts_run(arch, mesh_name,
                                                 monkeypatch,
                                                 record_property):
    cfg = lm_cfg(PR.get_config(arch, smoke=True))
    mesh = _mesh(mesh_name)
    n = mesh.shape["model"]
    batch = to_torch(train_inputs(cfg, 9, B, SEQ))
    frames = []

    class Recording(PT._MeshCheckpoint):
        """Records each checkpointed layer's stream input: its spec and
        each shard's bytes."""

        def __init__(self, fn, args, kwargs):
            super().__init__(fn, args, kwargs)
            x = next(a for a in args if isinstance(a, S.Placed))
            frames[-1].append((x.spec, [p.numel() * p.element_size()
                                        for p in x.pieces]))

    monkeypatch.setattr(PT, "_MeshCheckpoint", Recording)
    logits, runs = [], []
    for seq in (True, False):
        model = _seeded(cfg, mesh, seq)
        with torch.inference_mode():
            out, _ = PR.make_prefill(cfg)(model, _prefill_inputs(batch),
                                          PR.init_caches(cfg, B, SEQ,
                                                         mesh=mesh))
        logits.append(out)
        frames.append([])
        opt = PO.adamw_init(model)
        metrics = PTS.make_train_step(PR.make_train_forward(cfg),
                                      PO.AdamWConfig())(model, opt, batch)
        runs.append((model, metrics))
    seq_out, whole_out = logits
    scale = float(whole_out[..., :cfg.vocab].abs().max())
    record_property("forward_bitwise", bool(torch.equal(seq_out, whole_out)))
    record_property("forward_rel", float((seq_out - whole_out).abs().max())
                    / scale)
    assert float((seq_out - whole_out).abs().max()) <= REL * scale

    seq_frames, whole_frames = frames
    assert seq_frames and len(seq_frames) == len(whole_frames)
    for (spec, got), (wspec, want) in zip(seq_frames, whole_frames):
        assert spec[1] == "model" and wspec[1] is None
        assert [g * n for g in got] == want

    (model, metrics), (whole, want) = runs
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics[key]) - float(want[key])) <= \
            REL * abs(float(want[key])), key
    placed = dict(PR.placed_leaves(whole))
    for name, leaf in PR.placed_leaves(model):
        for group in S.replica_groups(leaf):
            for r in group[1:]:
                assert torch.equal(leaf.pieces[r], leaf.pieces[group[0]]), \
                    (name, group)
        got = S.to_whole(leaf).detach()
        ref = S.to_whole(placed[name]).detach()
        err = float((got - ref).abs().max())
        assert err <= REL * max(float(ref.abs().max()), 1e-30), (name, err)
