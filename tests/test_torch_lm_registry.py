"""The port's LM registry, configs, logical-axis rules, mesh layout,
roofline counts and the serve CLI's ``--arch`` path against the
reference, on the CPU."""
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as RS
from repro.launch import roofline as ref_roofline
from repro.models import registry as RR
from repro_torch.distributed import sharding as PS
from repro_torch.launch import mesh as PM
from repro_torch.launch import roofline as RL
from repro_torch.models import registry as PR


# ----------------------------------------------------------------------
# registry and configs
# ----------------------------------------------------------------------
def test_arch_ids_and_shapes_are_the_references():
    assert PR.ARCH_IDS == RR.ARCH_IDS
    assert sorted(PR.SHAPES) == sorted(RR.SHAPES)
    for name, shape in RR.SHAPES.items():
        assert dataclasses.asdict(PR.SHAPES[name]) == dataclasses.asdict(shape)


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_config_fields_and_counts_are_the_references(arch, smoke):
    ref = RR.get_config(arch, smoke=smoke)
    got = PR.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for prop in ("hd", "padded_vocab", "group_size", "n_groups", "n_tail"):
        assert getattr(got, prop) == getattr(ref, prop), prop
    assert got.param_count() == ref.param_count()
    assert got.pdt == getattr(torch, str(ref.pdt))
    assert got.cdt == getattr(torch, str(ref.cdt))
    assert PR.cells_for(got) == RR.cells_for(ref)
    for shape in RR.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            assert RL.model_flops(got, shape, kind) == \
                ref_roofline.model_flops(ref, shape, kind)


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_model_shapes_are_the_references(arch):
    """Every parameter of the port's full-size model (built on the meta
    device: shapes only) has the reference's shape and dtype."""
    from repro_torch.models.layers import Init

    ref_cfg = RR.get_config(arch)
    structs = jax.eval_shape(lambda k: RR.init_params(ref_cfg, k)[0],
                             jax.random.PRNGKey(0))
    cfg = PR.get_config(arch)
    model = PR.build_model(cfg, Init(torch.device("meta")))
    for name, param in model.named_parameters():
        path, row = PR.reference_path(cfg, name)
        leaf = structs
        for key in path:
            leaf = leaf[key]
        shape = leaf.shape[1:] if row is not None else leaf.shape
        assert tuple(param.shape) == tuple(shape), name
        assert str(param.dtype).replace("torch.", "") == str(leaf.dtype), name
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(structs))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_init_params_is_seeded_and_refuses_cuda_without_a_card(monkeypatch):
    cfg = PR.get_config("llama3_8b", smoke=True)
    a = PR.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = PR.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert a.embed.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.init_caches(cfg, 1, 8)


def test_init_caches_shapes_are_the_references():
    for arch in RR.ARCH_IDS:
        rcfg, pcfg = RR.get_config(arch, smoke=True), PR.get_config(arch, smoke=True)
        ref, _ = RR.init_caches(rcfg, 2, 40)
        from repro_torch.convert import lm_caches_to_numpy

        got = lm_caches_to_numpy(pcfg, PR.init_caches(pcfg, 2, 40, device="cpu"))
        flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert sorted(map(str, flat_r)) == sorted(map(str, flat_g)), arch
        for path, leaf in flat_r.items():
            assert flat_g[path].shape == leaf.shape, (arch, path)
            assert np.array_equal(flat_g[path], np.asarray(leaf, np.float32)
                                  if leaf.dtype.name == "bfloat16"
                                  else np.asarray(leaf)), (arch, path)


# ----------------------------------------------------------------------
# logical-axis rules on duck-typed meshes
# ----------------------------------------------------------------------
MESHES = {
    "1x1": (("data", "model"), {"data": 1, "model": 1}),
    "16x16": (("data", "model"), {"data": 16, "model": 16}),
    "2x16x16": (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}),
}
SHAPES = [(256, 4096), (8, 128, 1024), (1, 32768, 8, 128), (48, 6144),
          (100352, 6144), (2, 16, 30)]
LOGICAL = [("batch", "seq"), ("fsdp", "mlp"), ("batch", "kv_seq", None, None),
           ("heads", None), ("vocab", "fsdp"), ("experts", "fsdp", None),
           (None, "embed"), ("state", "layers")]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_shape_and_logical_spec_match_the_reference(mesh):
    names, shape = MESHES[mesh]
    m = PS.LogicalMesh(names, shape)
    ref_rules, got_rules = RS.AxisRules(m, dict(RS.DEFAULT_RULES)), \
        PS.AxisRules(m, dict(PS.DEFAULT_RULES))
    assert PS.DEFAULT_RULES == RS.DEFAULT_RULES
    for dims in SHAPES:
        for logical in LOGICAL:
            if len(logical) != len(dims):
                continue
            assert PS.spec_for_shape(got_rules, dims, logical) == \
                tuple(RS.spec_for_shape(ref_rules, dims, logical))
    for logical in LOGICAL:
        assert got_rules.spec(*logical) == tuple(ref_rules.spec(*logical))
        with RS.use_rules(m), PS.use_rules(m) as r:
            assert r.mesh is m
            assert PS.logical_spec(*logical) == tuple(RS.logical_spec(*logical))
    # use_rules restores what was set before
    assert PS.current_rules().mesh is None


def test_shard_is_the_identity_and_rules_nest():
    x = torch.arange(6.0).reshape(2, 3)
    assert PS.shard(x, "batch", "mlp") is x
    outer = PS.LogicalMesh(*MESHES["16x16"])
    with PS.use_rules(outer):
        with PS.use_rules(None, {"batch": "data"}) as inner:
            assert inner.mesh is None and inner.physical("batch") is None
        assert PS.current_rules().mesh is outer
        assert PS.logical_spec("batch", "heads") == ("data", "model")
    r = PS.set_rules(outer, {"batch": ("pod", "data")})
    try:
        assert PS.current_rules() is r
        assert r.physical("batch") == ("data",)
    finally:
        PS.set_rules(None)


def test_make_mesh_for_keeps_the_references_arithmetic():
    from repro.launch.mesh import make_mesh_for as ref_make_mesh_for

    ref = ref_make_mesh_for(1)              # the one CPU device
    got = PM.make_mesh_for(1)
    assert got.axis_names == tuple(ref.axis_names)
    assert dict(got.shape) == dict(ref.shape)
    for devices in range(1, 520):
        data, model = PM.mesh_shape_for(devices)
        assert data * model == devices and 1 <= model <= 16
        assert all(devices % m for m in range(model + 1, min(devices, 16) + 1))
    assert PM.mesh_shape_for(256) == (16, 16)
    assert PM.mesh_shape_for(512, model_parallel=16) == (32, 16)
    assert PM.mesh_shape_for(24, model_parallel=7) == (4, 6)
    # more devices: the device mesh, the reference's (data, model)
    mesh = PM.make_mesh_for(8, device="cpu")
    assert mesh.axis_names == tuple(ref.axis_names)
    assert dict(mesh.shape) == dict(zip(("data", "model"),
                                        PM.mesh_shape_for(8))) == \
        {"data": 1, "model": 8}
    assert len(mesh.devices) == 8
    assert dict(PM.make_mesh_for(8, 2, device="cpu").shape) == \
        {"data": 4, "model": 2}


def test_bf16_peak_is_the_data_sheets():
    assert PM.peak_ops(torch.bfloat16) == 989e12
    assert PM.peak_ops("float32") == 67e12


# ----------------------------------------------------------------------
# a decode step's compulsory bytes
# ----------------------------------------------------------------------
def test_decode_step_bytes_of_a_dense_model_by_hand():
    """llama3-8b, batch 4 at position 543: every f32 weight but the
    embedding table, 4 gathered embedding rows, the bf16 KV cache up to
    the position plus one new row, and the f32 logits."""
    cfg = PR.get_config("llama3_8b")
    b, pos = 4, 543
    d, f, v, h, k, hd, nl = (cfg.d_model, cfg.d_ff, cfg.padded_vocab,
                             cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers)
    layer = d * hd * (h + 2 * k) + h * hd * d + 3 * d * f + 2 * d
    weights = 4 * (nl * layer + d + d * v + b * d)
    kv = nl * 2 * b * k * hd * 2 * (pos + 1 + 1)
    assert RL.decode_step_bytes(cfg, b, pos) == weights + kv + b * v * 4
    # about 30.3 GB: 9.0 ms at 3.35 TB/s
    assert 30.2e9 < RL.decode_step_bytes(cfg, b, pos) < 30.4e9


def test_decode_step_bytes_of_rings_states_and_experts():
    """A ring reads at most its window; SSM/RG-LRU states are read and
    written whole; an MoE layer reads min(E, B*k) experts; whisper's
    decode reads no encoder weight but all of the cached cross K/V."""
    sc = PR.get_config("starcoder2_3b")
    assert RL.decode_step_bytes(sc, 1, 10_000) == RL.decode_step_bytes(
        sc, 1, 20_000)
    assert RL.decode_step_bytes(sc, 1, 100) < RL.decode_step_bytes(sc, 1, 200)
    mb = PR.get_config("mamba2_370m")
    assert RL.decode_step_bytes(mb, 2, 10) == RL.decode_step_bytes(mb, 2, 10_000)
    mo = PR.get_config("moonshot_v1_16b_a3b")
    one, four = RL.decode_step_bytes(mo, 1, 0), RL.decode_step_bytes(mo, 4, 0)
    per_expert = 3 * mo.d_model * mo.d_ff * 4 * mo.n_layers
    assert four - one > 18 * per_expert      # 6 experts -> 24 of 64
    wh = PR.get_config("whisper_small")
    enc_bytes = 4 * wh.enc_seq * wh.d_model
    assert RL.decode_step_bytes(wh, 1, 0) < 4 * wh.param_count() - enc_bytes


# ----------------------------------------------------------------------
# the serve CLI's --arch path
# ----------------------------------------------------------------------
_LINE = re.compile(r"^(\S+): \((\d+), (\d+)\) tokens in [\d.]+s "
                   r"\([\d.]+ tok/s incl\. compile\)$")


def _main(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("arch", ["llama3_8b", "whisper_small"])
def test_serve_cli_lm_line_is_the_references(monkeypatch, capsys, arch):
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "4"]
    want = _main(monkeypatch, capsys, ref_serve.main, argv)
    got = _main(monkeypatch, capsys, serve.main, argv + ["--device", "cpu"])
    assert len(got) == len(want) == 1
    assert _LINE.match(got[0]).groups() == _LINE.match(want[0]).groups()
