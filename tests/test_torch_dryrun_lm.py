"""The LM dry run (``repro_torch.launch.dryrun``'s LM cells and
``repro_torch.models.registry``'s dry-run half) against the reference's
``repro.launch.dryrun`` and ``repro.models.registry`` on the CPU.

- Every parameter, optimizer and cache leaf's logical spec equals the
  reference's, keyed by the reference's leaf paths.
- Every leaf's per-device shape equals ``NamedSharding(AbstractMesh,
  spec).shard_shape`` of the reference's cell, and every cell's
  per-device argument bytes the reference's, for all ten ``CONFIG`` s x
  ``cells_for`` x 16x16 and 2x16x16, with and without
  ``serve_resident``.
- ``abstract_params`` counts the reference's parameters;
  ``_depth_variant`` and ``OPT_LEVERS`` are the reference's.
- ``build_cell``'s step at SMOKE on a small shape matches the
  reference's ``cell.fn`` with the same weights: a train step's metrics,
  parameters and AdamW moments within 1e-4 of each leaf's scale, each
  leaf moved as far as the reference moves it; prefill and decode logits
  and caches within ``LM_TOL``.
- The timed steps' window and the replica step's range; ``run_cell``
  and the CLI run the SMOKE cells on the CPU, every lever among them,
  and ``report.table`` renders their rows.
- The collective kinds and bytes of two SMOKE cells on a (2, 2, 2) mesh
  against the reference's HLO counts (ROADMAP Queue 3, C2).
"""
import dataclasses
import math
import os
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from _torch_port import (LM_TOL, lm_inputs, max_abs_diff, port_lm, ref_lm,
                         to_torch, train_inputs, tree_max_abs_diff)
from repro.distributed import sharding as RS
from repro.models import registry as RR
from repro.training import optimizer as RO
from repro_torch import convert
from repro_torch.distributed import sharding as PS
from repro_torch.launch import dryrun, mesh as M, report
from repro_torch.launch import roofline as RL
from repro_torch.models import registry as PR
from repro_torch.training import optimizer as PO

H100 = 3.35e12
#: the production layouts: (mesh shape, axis names)
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the CPU's stand-in for the card's memory in the SMOKE runs
MEMORY = 2**30


def _ref_rules(layout):
    return RS.AxisRules(AbstractMesh(*LAYOUTS[layout]), dict(RS.DEFAULT_RULES))


def _port_rules(layout):
    return PS.AxisRules(M.make_production_mesh(layout == "2x16x16"),
                        dict(PS.DEFAULT_RULES))


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _ref_flat(tree, is_leaf=None):
    """A reference pytree as ``{path of keys: leaf}``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(_key(k) for k in path): leaf for path, leaf in flat}


def _ref_specs(tree):
    return _ref_flat(tree, is_leaf=lambda x: isinstance(x, tuple))


def _port_flat(tree, prefix=()):
    """A port tree (dicts keyed by names or by reference paths) as
    ``{path of keys: leaf}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (k if isinstance(k, tuple)
                                               else (k,))))
        return out
    return {prefix: tree}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _padded(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


# ----------------------------------------------------------------------
# logical specs and abstract structures
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_logical_specs_and_structs_match_the_reference(arch):
    """Parameters, optimizer state and caches: the same leaves, each
    with the reference's logical spec, shape and dtype; the same
    parameter count."""
    rcfg, pcfg = RR.get_config(arch), PR.get_config(arch)
    rstructs, rspecs = RR.abstract_params(rcfg)
    pstructs, pspecs = PR.abstract_params(pcfg)
    assert pspecs == _ref_specs(rspecs) == PR.param_specs(pcfg)
    want = _ref_flat(rstructs)
    assert sorted(pstructs) == sorted(want)
    for path, t in pstructs.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype(t.dtype)) == (
            tuple(want[path].shape), str(want[path].dtype)), path
    assert sum(t.numel() for t in pstructs.values()) == sum(
        math.prod(s.shape) for s in want.values())
    assert _port_flat(PO.adamw_init_specs(pspecs)) == _ref_specs(
        RO.adamw_init_specs(rspecs))

    rcaches, rcspecs = RR.abstract_caches(rcfg, 2, 2048)
    pcaches, pcspecs = PR.abstract_caches(pcfg, 2, 2048)
    assert pcspecs == _ref_specs(rcspecs) == PR.cache_specs(pcfg)
    want = _ref_flat(rcaches)
    assert sorted(pcaches) == sorted(want)
    for path, t in pcaches.items():
        assert (tuple(t.shape), _dtype(t.dtype)) == (
            tuple(want[path].shape), str(want[path].dtype)), path


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_per_device_shapes_and_bytes_match_the_reference(arch, layout):
    """Every argument leaf of every cell, and of every serving cell
    under ``serve_resident``: its shape, dtype, physical spec and
    per-device shape against the reference's ``NamedSharding``; the
    cell's per-device argument bytes against their sum."""
    rrules, prules = _ref_rules(layout), _port_rules(layout)
    for resident in (False, True):
        rcfg = dataclasses.replace(RR.get_config(arch), serve_resident=resident)
        pcfg = dataclasses.replace(PR.get_config(arch), serve_resident=resident)
        for shape in RR.cells_for(rcfg):
            if resident and RR.SHAPES[shape].kind == "train":
                continue
            rc = RR.build_cell(rcfg, arch, shape, rrules)
            pc = PR.build_cell(pcfg, arch, shape, prules)
            assert pc.donate == rc.donate
            total = 0
            for i, (rst, rsh) in enumerate(zip(rc.in_structs,
                                               rc.in_shardings)):
                want_st, want_sh = _ref_flat(rst), _ref_flat(rsh)
                got_st = _port_flat(pc.in_structs[i])
                got_sh = _port_flat(pc.in_shardings[i])
                assert sorted(got_st) == sorted(want_st), (shape, i)
                for path, st in want_st.items():
                    n = len(st.shape)
                    per_dev = want_sh[path].shard_shape(st.shape)
                    total += math.prod(per_dev) * np.dtype(st.dtype).itemsize
                    ph = got_sh[path]
                    assert (tuple(got_st[path].shape),
                            _dtype(got_st[path].dtype), _padded(ph.spec, n),
                            ph.shape) == (
                        tuple(st.shape), str(st.dtype),
                        _padded(want_sh[path].spec, n), tuple(per_dev)), (
                        shape, i, path)
            assert pc.argument_bytes() == total, (shape, resident)


@pytest.mark.parametrize("shape,logical", [
    ((8, 4096), ("kv_heads", "fsdp")), ((32, 7), ("batch", None)),
    ((16, 5), ("batch",)), ((6, 48), ("batch", "heads")), ((), ())])
def test_shard_shape_is_named_sharding_shard_shape(shape, logical):
    """Ragged dimensions degrade as the reference's do (the longest
    divisible prefix of a tuple mapping); dimensions past the spec stay
    whole."""
    from jax.sharding import NamedSharding

    for layout in LAYOUTS:
        rrules = _ref_rules(layout)
        want = NamedSharding(rrules.mesh, RS.spec_for_shape(
            rrules, shape, logical)).shard_shape(shape)
        assert PS.shard_shape(_port_rules(layout), shape, logical) == want


# ----------------------------------------------------------------------
# the reference's dry-run module: depth variants and levers
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with this process's
    ``XLA_FLAGS`` left as they were (the module sets a 512-device flag
    for its own process)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_depth_variant_and_levers_match_the_reference(ref_dryrun, arch,
                                                      groups):
    want = ref_dryrun._depth_variant(RR.get_config(arch), groups)
    got = dryrun._depth_variant(PR.get_config(arch), groups)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dryrun.OPT_LEVERS == ref_dryrun.OPT_LEVERS
    cfg = PR.get_config(arch)
    geff = cfg.n_layers if cfg.family == "encdec" else (
        cfg.n_groups + cfg.n_tail / cfg.group_size)
    assert dryrun.groups_eff(cfg) == geff
    # the extrapolation of the reference's two variants
    assert dryrun.extrapolate(1, (3.0, 5.0), geff) == 3.0 + 2.0 * (geff - 1)
    assert dryrun.extrapolate(0, (3.0, 5.0), geff) == 3.0 + 2.0 * geff


# ----------------------------------------------------------------------
# the cells' step functions against the reference's
# ----------------------------------------------------------------------
def _close_tree(got, want, rel=1e-4):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close_tree(got[k], want[k], rel)
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size:
        scale = max(float(np.max(np.abs(want))), 1e-30)
        assert float(np.max(np.abs(got - want))) <= rel * scale


@pytest.mark.parametrize("arch,kind", [
    ("llama3_8b", "train"), ("moonshot_v1_16b_a3b", "train"),
    ("llama3_8b", "prefill"), ("whisper_small", "prefill"),
    ("qwen2_vl_72b", "prefill"), ("llama3_8b", "decode"),
    ("gemma3_12b", "decode"), ("mamba2_370m", "decode")])
def test_cell_step_matches_the_reference(monkeypatch, arch, kind):
    """``build_cell``'s step on both packages' SMOKE cells at 2 x 16
    tokens (f32 compute), the same weights: the train step's metrics
    and parameters within 1e-4 of each leaf's scale; the logits and
    caches of prefill, and of a decode step at the last position of
    caches of seeded values (``dryrun.cell_args``), within LM_TOL."""
    b, s = 2, 16
    shape = RR.Shape("_test", kind, s, b)
    monkeypatch.setitem(RR.SHAPES, "_test", shape)
    monkeypatch.setitem(PR.SHAPES, "_test", PR.Shape("_test", kind, s, b))
    rcfg, params, _ = ref_lm(arch)
    pcfg, model = port_lm(arch)
    rc = RR.build_cell(rcfg, arch, "_test", _ref_rules("16x16"))
    pc = PR.build_cell(pcfg, arch, "_test", _port_rules("16x16"))
    rfn = jax.jit(rc.fn)
    if kind == "train":
        np_in = train_inputs(rcfg, 7, b, s)
        before = convert.lm_params_to_numpy(model)
        rp, ro, rm = rfn(params, RO.adamw_init(params),
                         {k: jnp.asarray(v) for k, v in np_in.items()})
        popt = PO.adamw_init(model)
        pm = pc.fn(model, popt, to_torch(np_in))
        for k in ("loss", "grad_norm"):
            _close_tree(pm[k].numpy(), rm[k])
        got = convert.train_state_to_numpy(model, popt)
        rp, ro = jax.tree.map(np.asarray, (rp, ro))
        _close_tree(got["params"], rp)
        # the first step moves a parameter by about lr (3e-6 in the
        # warmup), under the tolerance above: the update is held by the
        # moments (m = 0.1 g, v = 0.001 g^2 after one step) and by how
        # far each leaf moved
        for part in ("m", "v"):
            _close_tree(got["opt"][part], ro[part])
        assert int(got["opt"]["step"]) == int(ro["step"]) == 1
        moved = jax.tree.map(
            lambda new, old: float(np.max(np.abs(
                new.astype(np.float64) - old.astype(np.float64)))),
            (got["params"], rp), (before, params))
        for pmove, rmove in zip(*map(jax.tree.leaves, moved)):
            assert rmove > 0 and pmove == pytest.approx(rmove, rel=0.01)
        return
    if kind == "prefill":
        np_in = lm_inputs(rcfg, 7, b, s)
        rcaches, _ = RR.init_caches(rcfg, b, s)
        rl, rcaches = rfn(params, {k: jnp.asarray(v) for k, v in np_in.items()},
                          rcaches)
        pl, pcaches = pc.fn(model, to_torch(np_in),
                            PR.init_caches(pcfg, b, s, device="cpu"))
    else:
        _, tok, pcaches, index = dryrun.cell_args(pc, b, torch.device("cpu"))
        rcaches = jax.tree.map(jnp.asarray,
                               convert.lm_caches_to_numpy(pcfg, pcaches))
        rl, rcaches = rfn(params, jnp.asarray(tok.numpy()), rcaches,
                          jnp.asarray(index, jnp.int32))
        pl, pcaches = pc.fn(model, tok, pcaches, index)
    assert max_abs_diff(pl.numpy(), rl) < LM_TOL
    assert tree_max_abs_diff(convert.lm_caches_to_numpy(pcfg, pcaches),
                             jax.tree.map(np.asarray, rcaches)) < LM_TOL


def test_chunked_adamw_update_is_bitwise_the_whole_leaf(monkeypatch):
    """The update is elementwise: chunks of 997 values give the bits of
    one pass over each leaf, moments of another dtype included."""
    cfg, model = port_lm("llama3_8b")
    batch = to_torch(train_inputs(cfg, 3, 2, 16))
    loss = model.embed.float().square().sum() + model.unembed.sum()
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.ones_like(p))
             for n, p in model.named_parameters()}
    assert batch["tokens"].shape == (2, 16)
    runs = []
    for chunk in (PO.UPDATE_CHUNK, 997):
        monkeypatch.setattr(PO, "UPDATE_CHUNK", chunk)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = PO.adamw_init(params)
        for mdt in ("float32", "bfloat16"):
            PO.adamw_update(grads, opt, params,
                            PO.AdamWConfig(moment_dtype=mdt))
        runs.append((params, opt))
    (p1, o1), (p2, o2) = runs
    assert all(torch.equal(p1[n], p2[n]) for n in p1)
    for part in ("m", "v"):
        assert all(o2[part][n].dtype == torch.bfloat16 for n in o2[part])
        assert all(torch.equal(o1[part][n], o2[part][n]) for n in o1[part])


# ----------------------------------------------------------------------
# the reports
# ----------------------------------------------------------------------
@pytest.mark.parametrize("steps,window,more", [
    ([], 2.0, True), ([0.9, 0.9], 2.0, True), ([0.9] * 3, 2.0, False),
    ([0.4] * 3, 2.0, True), ([0.4] * 5, 2.0, False),
    ([0.001] * dryrun.MAX_TIMED_STEPS, 2.0, False), ([10.0] * 2, 0.0, True),
    ([1e-4] * 3, 0.0, False)])
def test_a_variant_times_steps_over_its_window(steps, window, more):
    """At least ``WARM_STEPS`` timed steps, then more until they add up
    to the window (the card's ``TIMED_WINDOW_S``; none on the CPU), at
    most ``MAX_TIMED_STEPS``."""
    assert dryrun.keep_timing(steps, window) is more


@pytest.mark.parametrize("lo,geff", [(1, 32.0), (0, 48.0), (1, 1.5),
                                     (1, 1.0)])
def test_the_replica_step_range_brackets_its_extrapolation(lo, geff):
    """The range over each variant's low and high step holds the
    extrapolation of any steps between them, its ends among them, and
    closes on the extrapolation when the steps do not spread."""
    lows, highs = (0.40, 0.65), (0.45, 0.70)
    least, most = dryrun.extrapolate_range(lo, lows, highs, geff)
    grid = [dryrun.extrapolate(lo, (a, b), geff)
            for a in np.linspace(lows[0], highs[0], 5)
            for b in np.linspace(lows[1], highs[1], 5)]
    assert least == pytest.approx(min(grid)) and most == pytest.approx(
        max(grid))
    assert least <= dryrun.extrapolate(lo, (0.42, 0.68), geff) <= most
    one = dryrun.extrapolate(lo, lows, geff)
    assert dryrun.extrapolate_range(lo, lows, lows, geff) == (one, one)
    # a row's replica step: the medians' extrapolation inside the range,
    # both times the batch cut
    runs = {lo + i: {"step_s": (lows[i] + highs[i]) / 2,
                     "step_q1_s": lows[i], "step_q3_s": highs[i]}
            for i in range(2)}
    step, span = dryrun.replica_steps(runs, (lo, lo + 1), geff, 4.0)
    assert step == pytest.approx(4 * dryrun.extrapolate(
        lo, (0.425, 0.675), geff))
    assert span == pytest.approx([4 * least, 4 * most])
    assert span[0] <= step <= span[1]


# ----------------------------------------------------------------------
# run_cell and the CLI on the CPU at SMOKE
# ----------------------------------------------------------------------
LM_ROW_KEYS = {"arch", "shape", "mesh", "chips", "compile_s", "memory",
               "roofline", "coll_by_kind", "model_flops_global",
               "model_flops_per_chip", "useful_flop_ratio", "calibration",
               "ok", "device", "measured", "reduced", "levers_inert"}


def _smoke_cell(arch, shape_name, layout, opt=None):
    cfg, _ = dryrun._lm_config(arch, opt, smoke=True)
    return PR.build_cell(cfg, arch, dryrun._cell_shape(shape_name, True),
                         _port_rules(layout))


def test_lm_dry_run_cli_on_the_cpu_and_its_tables(tmp_path, capsys):
    """Three SMOKE cells on both layouts: the reference's keys, the exact
    per-device arguments, the counted roofline (the two variants'
    counts extrapolated, scaled to the replica and over the chips), no
    device metric on the CPU, ``--resume``, and the report's tables."""
    out = tmp_path / "rows.jsonl"
    argv = ["--arch", "llama3_8b", "--smoke", "--device", "cpu",
            "--memory-bytes", str(MEMORY), "--hbm-rate", str(H100),
            "--out", str(out)]
    dryrun.main(argv)
    dryrun.main(argv + ["--resume"])            # every cell done: skipped
    assert len(out.read_text().splitlines()) == 6
    assert capsys.readouterr().out.count("[llama3_8b@smoke x ") == 6
    rows = report.load(str(out))
    for (arch, shape, layout), row in rows.items():
        assert arch == "llama3_8b@smoke" and row["ok"]
        assert row["chips"] == M.LAYOUTS[layout]
        cell = _smoke_cell("llama3_8b", shape, layout)
        assert row["memory"]["argument_bytes"] == cell.argument_bytes()
        assert row["memory"]["peak_bytes"] is None
        assert set(row["device"].values()) == {"cpu", None}
        assert row["measured"]["replica_step_s"] is None
        for var in row["measured"]["variants"].values():
            assert var["finite"] and var["step_s"] is None
            assert var["step_mode"] == "eager"      # graphs: the card only
        if layout == "2x16x16":                  # the multi-pod pass
            assert "roofline" not in row
            assert list(row["measured"]["variants"]) == ["g1"]
            continue
        assert LM_ROW_KEYS <= set(row)
        cal = row["calibration"]
        assert cal["variants"] == ["g1", "g2"] and cal["batch_cut"] == 1
        rep, replicas = dryrun.replica_batch(cell.shape, cell.rules)
        assert cal["batch"] == rep == min(PR.SHAPES[shape].batch, 64) // 16
        assert replicas == 16
        flops = dryrun.extrapolate(1, (cal["flops_g1"], cal["flops_g2"]),
                                   cal["groups_eff"]) * replicas / 256
        assert row["roofline"]["flops_per_chip"] == pytest.approx(flops)
        assert row["coll_by_kind"] == RL.lm_collectives(cell)
        assert row["model_flops_per_chip"] == pytest.approx(
            row["model_flops_global"] / 256)
        assert row["useful_flop_ratio"] == pytest.approx(
            row["model_flops_per_chip"] / flops)
    lines = report.table(rows).splitlines()
    assert len(lines) == 7 and lines[0].startswith("| arch | shape |")
    assert all(ln.startswith("| llama3_8b@smoke | ") and "| - | - | " in ln
               for ln in lines[2:5])
    assert lines[5:] == ["", report.LM_COUNTS_NOTE]
    lm = report.lm_table(rows).splitlines()
    assert len(lm) == 5 and all(
        re.search(r" \| g1 - \(\d+\), g2 - \(\d+\) \| - \| - \| ", ln)
        for ln in lm[2:])
    multi = report.multipod_table(rows).splitlines()
    assert len(multi) == 5 and multi[0].endswith("| args GiB/dev |")


def _run(arch, shape, opt=None, memory=MEMORY, multi_pod=False):
    return dryrun.run_cell(arch, shape, multi_pod, None, verbose=False,
                           opt=opt, device="cpu", smoke=True,
                           memory_bytes=memory, hbm_rate=H100)


@pytest.fixture(scope="module")
def base_row():
    """``base_row(shape)``: llama3_8b's unlevered SMOKE row of ``shape``,
    run once for the module (the levers and the sizing test all hold
    their rows against the same base rows)."""
    rows = {}

    def get(shape):
        if shape not in rows:
            rows[shape] = _run("llama3_8b", shape)
        return rows[shape]
    return get


@pytest.mark.parametrize("lever", sorted(dryrun.OPT_LEVERS))
def test_every_lever_runs_and_moves_what_it_should(base_row, lever):
    """Each ``OPT_LEVERS`` key on a SMOKE cell it acts on, against the
    same cell without it: ``logit_bf16`` writes bf16 prefill logits (fewer bytes),
    ``remat_dots`` saves products (fewer operations), ``micro2`` and
    ``micro4`` run that many microbatches, ``serve_resident`` keeps the
    decode weights whole over ``data``, ``bf16_gather`` halves the
    gathered bytes, ``explicit_sp`` changes nothing and says so.  The
    weights' gathers are held apart from the residual stream's
    (``seq``), which neither lever moves: the gathers of the same cell
    less those of its rules with ``"seq"`` on no axis."""
    shape = {"serve_resident": "decode_32k",
             "logit_bf16": "prefill_32k"}.get(lever, "train_4k")
    base, row = base_row(shape), _run("llama3_8b", shape, lever)
    cell = _smoke_cell("llama3_8b", shape, "16x16")
    whole = PR.build_cell(cell.cfg, "llama3_8b", cell.shape, PS.AxisRules(
        cell.rules.mesh, {**cell.rules.rules, "seq": None}))
    seq = RL.lm_collectives(cell).get("all-gather", 0) - \
        RL.lm_collectives(whole).get("all-gather", 0)
    assert row["arch"] == f"llama3_8b+{lever}@smoke" and row["ok"]
    assert row["levers"] == [lever]
    assert row["levers_inert"] == ([lever] if lever == "explicit_sp" else [])
    cb, cr = base["coll_by_kind"], row["coll_by_kind"]
    fb, fr = (r["roofline"]["flops_per_chip"] for r in (base, row))
    if lever == "bf16_gather":
        assert (cr["all-gather"] - seq) * 2 == cb["all-gather"] - seq
    elif lever == "serve_resident":
        assert "all-gather" not in cr and "all-gather" in cb
        assert row["memory"]["argument_bytes"] > \
            base["memory"]["argument_bytes"]
    elif lever in ("micro2", "micro4"):
        assert cr["all-gather"] - seq == \
            (cb["all-gather"] - seq) * int(lever[-1])
        assert fr == pytest.approx(fb, rel=0.05)
    elif lever == "remat_dots":
        assert fr < fb and cr == cb
    elif lever == "logit_bf16":
        assert row["roofline"]["hbm_bytes_per_chip"] < \
            base["roofline"]["hbm_bytes_per_chip"]
    else:
        assert cr == cb and fr == fb


def test_variants_that_do_not_fit_are_cut_refused_or_replaced(base_row):
    """Sized before allocation: a batch cut scales the counts by the cut;
    g2 refused calibrates from g0 and g1; a cell whose g1 does not fit
    is refused whole."""
    cfg = PR.get_config("llama3_8b", smoke=True)
    shape = dryrun._cell_shape("train_4k", True)
    room = 1 - dryrun.HEADROOM

    def need(groups, b):
        return dryrun.variant_bytes(dryrun._depth_variant(cfg, groups),
                                    shape, b)["need"]

    full = base_row("train_4k")
    cut = _run("llama3_8b", "train_4k", memory=int(need(2, 1) / room) + 1)
    assert cut["calibration"]["batch"] == 1 and cut["calibration"][
        "batch_cut"] == 4
    assert cut["reduced"][0].startswith("batch 4 -> 1 ")
    assert cut["roofline"]["flops_per_chip"] == pytest.approx(
        full["roofline"]["flops_per_chip"], rel=0.02)

    g0 = _run("llama3_8b", "train_4k", memory=int(need(1, 1) / room) + 1)
    assert g0["calibration"]["variants"] == ["g0", "g1"]
    assert g0["reduced"][0].startswith("g2 refused")
    assert g0["calibration"]["flops_g0"] < g0["calibration"]["flops_g1"]
    assert g0["roofline"]["flops_per_chip"] == pytest.approx(
        full["roofline"]["flops_per_chip"], rel=0.02)

    with pytest.raises(MemoryError, match="does not fit"):
        _run("llama3_8b", "train_4k", memory=int(need(1, 1) / room) - 1,
             multi_pod=True)


#: an NVIDIA H100 80GB HBM3's memory as the card reports it
#: (``torch.cuda.get_device_properties(0).total_memory``): 76.5 GB of
#: room less ``HEADROOM``
H100_MEMORY = 85017493504
#: each full config's train_4k plan on 16x16 on that card (replica
#: batch 16): the variants and their batch.  With each attention and SSD
#: chunk checkpointed the train step holds one chunk's scores, not the
#: layer's S x S: granite_20b's g2 takes 8 rows (4 when its scores were
#: counted whole) and qwen2_vl_72b's g2 fits at 1 row (it calibrated on
#: g0/g1 at 2); dbrx_132b's g1 needs 80.4 GB at 1 row, and is refused
TRAIN_4K_PLANS = {
    "moonshot_v1_16b_a3b": ((1, 2), 2), "dbrx_132b": None,
    "granite_20b": ((1, 2), 8), "starcoder2_3b": ((1, 2), 8),
    "llama3_8b": ((1, 2), 4), "gemma3_12b": ((0, 1), 1),
    "whisper_small": ((1, 2), 8), "mamba2_370m": ((1, 2), 16),
    "recurrentgemma_9b": ((1, 2), 1), "qwen2_vl_72b": ((1, 2), 1)}


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_train_4k_plans_on_an_h100(arch):
    """The full configs' train_4k variants sized for one H100 on 16x16:
    the variants, their batch and the refusal of dbrx_132b."""
    cfg = PR.get_config(arch)
    shape = dryrun._cell_shape("train_4k", False)
    rep_batch, _ = dryrun.replica_batch(shape, _port_rules("16x16"))
    want = TRAIN_4K_PLANS[arch]
    if want is None:
        with pytest.raises(MemoryError, match="g1 needs .* does not fit"):
            dryrun.plan_variants(cfg, shape, rep_batch, H100_MEMORY, True)
        return
    pair, batch, reduced = dryrun.plan_variants(cfg, shape, rep_batch,
                                                H100_MEMORY, True)
    assert (pair, batch) == want
    assert any(r.startswith("g2 refused") for r in reduced) == (
        pair == (0, 1))
    assert any(r.startswith(f"batch {rep_batch} -> {batch} ")
               for r in reduced) == (batch < rep_batch)


def test_train_sizing_holds_one_chunk_not_the_whole_scores():
    """In training the layer term holds one query chunk's recompute, so
    it grows linearly in the tokens: granite_20b at one group and one
    row of 32768 tokens needs 48.8 GB (its S x S scores, saved whole,
    would need about 388 GB); its layer term at 2S is about twice that
    at S.  mamba2's layer term counts its SSD chunk: more than its
    weights in training, and not 0 in a prefill."""
    room = (1 - dryrun.HEADROOM) * H100_MEMORY
    train = dryrun._cell_shape("train_4k", False)
    granite = dryrun._depth_variant(PR.get_config("granite_20b"), 1)
    sized = {s: dryrun.variant_bytes(
        granite, dataclasses.replace(train, seq=s, batch=1), 1)
        for s in (16384, 32768)}
    assert sized[32768]["need"] == pytest.approx(48.8e9, rel=2e-3)
    assert sized[32768]["need"] < room
    assert sized[32768]["layer"] < 2.1 * sized[16384]["layer"]
    mamba = dryrun._depth_variant(PR.get_config("mamba2_370m"), 1)
    weights = sum(t[0].numel() for path, t in
                  PR.abstract_params(mamba)[0].items()
                  if path[0] == "groups") * 2
    assert dryrun.variant_bytes(mamba, train, 16)["layer"] > 10 * weights
    prefill = dryrun._cell_shape("prefill_32k", False)
    assert dryrun.variant_bytes(mamba, prefill, 1)["layer"] > 0


class _HighWater(TorchDispatchMode):
    """The bytes of storage that ops made inside the mode hold, the most
    at once since :meth:`reset`: the CPU's stand-in for the card's
    ``max_memory_allocated`` and ``reset_peak_memory_stats``."""

    def __init__(self):
        super().__init__()
        self.live, self.now, self.top = {}, 0, 0

    def _free(self, key):
        self.now -= self.live.pop(key)

    def peak(self):
        return self.top

    def reset(self):
        self.top = self.now

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st.data_ptr()
                if key and key not in self.live:
                    self.live[key] = st.nbytes()
                    self.now += st.nbytes()
                    self.top = max(self.top, self.now)
                    weakref.finalize(st, self._free, key)
        return out


def _smoke_train_peak(batch, split):
    """SMOKE llama3_8b's train step at ``batch`` rows of 128 tokens after
    one warm step: its high-water mark and, with ``split``, the step's
    :class:`PeakSplit` points."""
    cfg = PR.get_config("llama3_8b", smoke=True)
    shape = dataclasses.replace(PR.SHAPES["train_4k"], seq=128, batch=4)
    cell = PR.build_cell(cfg, "llama3_8b", shape, _port_rules("16x16"))
    args = dryrun.cell_args(cell, batch, torch.device("cpu"))
    cell.fn(*args)                       # the AdamW moments are made once
    with _HighWater() as hw:
        if not split:
            cell.fn(*args)
            return hw.top, None
        with dryrun.PeakSplit(args[0].parameters(), hw.peak,
                              hw.reset) as ps:
            cell.fn(*args)
    grads = sum(p.numel() * p.element_size() for p in args[0].parameters())
    assert ps.made == grads
    return hw.top, ps.points()


@pytest.mark.parametrize("cut", [2, 4])
def test_a_train_peak_scales_only_its_batch_part(cut):
    """A train step's peak at ``cut`` times its rows: :class:`PeakSplit`
    at 1 row, scaled by :func:`scaled_peak`, bounds the peak measured at
    ``cut`` rows within 10 %, where the whole peak times ``cut`` (the
    update's temporaries and the gradients with it) overshoots by half
    again."""
    one, points = _smoke_train_peak(1, split=True)
    more, _ = _smoke_train_peak(cut, split=False)
    est = dryrun.scaled_peak(points, cut)
    assert more <= est <= 1.1 * more, (points, est, more)
    assert cut * one >= 1.5 * more
    assert dryrun.scaled_peak(points, 1) == one


#: qwen2_vl_72b's train_4k variants on 16x16 as ``run_variant`` measured
#: them on an NVIDIA H100 80GB HBM3 (700 W; ``python -m
#: repro_torch.launch.dryrun --shape train_4k --mesh single``): one row
#: each (the replica's 16 cut 16x), the non-argument peak and its
#: ``peak_split``.  At one row both peak in the update, on the
#: gradients, which do not grow with the batch
QWEN2_TRAIN_4K = {
    "argument_bytes": 5442338820, "groups_eff": 80.0, "cut": 16.0,
    "variants": {
        1: {"nonarg_peak_bytes": 18526356992, "peak_split": [
            [18526356992, 0], [8560640000, 406882816],
            [8292204544, 671090688], [8225095680, 3143665664],
            [6018859008, 3600893952], [5049974784, 4569778176],
            [67108864, 15284160512]]},
        2: {"nonarg_peak_bytes": 21969947136, "peak_split": [
            [21969947136, 0], [12004229120, 406882816],
            [11735793664, 671090688], [11668684800, 3143665664],
            [9462448128, 3600893952], [8493563904, 4569778176],
            [4982865920, 4771186688], [0, 15351302144]]}}}


def test_qwen2_train_4k_peak_estimate_scales_only_the_batch_part():
    """qwen2_vl_72b's train_4k estimate from its measured variants: the
    per-device arguments plus the replica's non-argument peak over the
    model extent is about the 28.02 GiB the dry run read for this cell
    when it calibrated on g0/g1 at 2 rows, where the forward set the
    peak, and fits the card; the whole 1-row peak times the batch
    cut, gradients included, would read over 250 GiB."""
    m = QWEN2_TRAIN_4K
    runs, pair = m["variants"], (1, 2)
    nonarg = dryrun.peak_estimate(runs, pair, m["groups_eff"], m["cut"])
    est = (m["argument_bytes"] + nonarg / 16) / 2**30
    assert 28.02 * 0.8 <= est <= 28.02 * 1.2, est
    assert est * 2**30 <= H100_MEMORY
    whole = {g: {"peak_split": [[0, v["nonarg_peak_bytes"]]]}
             for g, v in runs.items()}
    scaled_whole = dryrun.peak_estimate(whole, pair, m["groups_eff"],
                                        m["cut"])
    assert (m["argument_bytes"] + scaled_whole / 16) / 2**30 > 250
    for g, v in runs.items():
        assert dryrun.scaled_peak(v["peak_split"], 1) == \
            v["nonarg_peak_bytes"]


# ----------------------------------------------------------------------
# collectives against the reference's HLO (C2)
# ----------------------------------------------------------------------
_REF_HLO = r"""
import json, re, jax
import dataclasses as dc
from repro.distributed.sharding import set_rules
from repro.models import registry as R
from repro.launch.mesh import compat_make_mesh
from repro.launch.roofline import _parse_shape_bytes, collective_bytes

mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
rules = set_rules(mesh)
out = {}
for arch, shape in (("llama3_8b", "train_4k"), ("llama3_8b", "decode_32k")):
    cfg = dc.replace(R.get_config(arch, smoke=True), name=f"{arch}-dry",
                     unroll_groups=True)
    R.SHAPES["_test"] = dc.replace(R.SHAPES[shape], seq=128, batch=8)
    cell = R.build_cell(cfg, arch, "_test", rules)
    with mesh:
        text = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       donate_argnums=cell.donate).lower(
                           *cell.in_structs).compile().as_text()
    ops = []
    for line in text.splitlines():
        m = re.search(r"=\s*(.*?)\s*(all-gather|all-reduce|reduce-scatter|"
                      r"all-to-all|collective-permute)(?:-start)?\(", line)
        if m and f"{m.group(2)}-done" not in line.split("=")[1][:80]:
            ops.append([m.group(2), m.group(1).split("{")[0],
                        _parse_shape_bytes(m.group(1))])
    out[shape] = {"kinds": collective_bytes(text), "ops": ops}
print(json.dumps(out))
"""


@pytest.mark.multi_device
def test_lm_collectives_against_the_reference_hlo(multi_device):
    """C2: the reference's HLO on a (2, 2, 2) mesh (the SMOKE llama
    cells of ``tests/test_dryrun_small.py``, their groups unrolled as the
    calibration compiles them) against :func:`lm_collectives`.  The HLO
    counts each op's output (a gather's whole result, an all-reduce's
    operand) in f32 (the CPU backend promotes bf16), gathers only the
    embedding rows a lookup needs, gathers every attention weight three
    times a layer in training (forward, recompute, backward; the port
    counts the forward and the backward), has no reduce-scatter (no
    rewrite on the CPU), and reshards activations (``all-to-all``) the
    port does not count.  The port counts the residual stream's seq
    layout where the 128 training positions split over ``model``: each
    row-parallel output, and the vocabulary-sharded lookup's sum,
    reduce-scattered and the next input gathered, where a whole stream
    all-reduces.  On n = 2 a ring moves ``(n-1)/n``, half, of a gather's
    output and ``2 (n-1)/n``, all, of an all-reduce's operand, so the
    decode cell, whose one position leaves the stream whole, agrees term
    by term."""
    ref = multi_device.run(_REF_HLO, ndevices=8, timeout=480)
    mesh = PS.LogicalMesh(("pod", "data", "model"),
                          {"pod": 2, "data": 2, "model": 2})
    rules = PS.AxisRules(mesh, dict(PS.DEFAULT_RULES))
    cfg = PR.get_config("llama3_8b", smoke=True)
    got = {}
    for shape in ("train_4k", "decode_32k"):
        cell = PR.build_cell(cfg, "llama3_8b", dataclasses.replace(
            PR.SHAPES[shape], seq=128, batch=8), rules)
        got[shape] = RL.lm_collectives(cell)
    params, phys = cell.in_structs[0], cell.in_shardings[0]
    per_dev = {p: math.prod(phys[p].shape) * 4 for p in params}

    dec, dec_ref = got["decode_32k"], ref["decode_32k"]
    assert set(dec) == {"all-gather", "all-reduce"}
    assert set(dec_ref["kinds"]) == {"all-gather", "all-reduce", "all-to-all"}
    # the weights' gathers: the HLO's outputs are twice the port's ring
    # bytes; the embedding table is gathered by the port only (the HLO
    # gathers the 8 rows looked up); the rest of the HLO's gathers are
    # the token ids (16 bytes), those rows and the decode's q, k and v
    weight_gathers = 2 * (dec["all-gather"] - per_dev[("embed",)])
    assert dec_ref["kinds"]["all-gather"] - weight_gathers == \
        16 + 8 * 32 * 4 + 2 * (2 * 256 + 512)
    # all-reduces: each row-parallel output and the vocabulary-sharded
    # lookup's partial sum (five of (2, 1, 64): bf16 in the port, f32 in
    # the HLO; a decode step's one position leaves the stream whole) and
    # the softmax's partial outputs with their maximum and sum (f32 in
    # both)
    rowpar = 5 * 2 * 64 * 2
    combine = dec["all-reduce"] - rowpar
    assert combine == 2 * 2 * 4 * (16 + 2) * 4
    assert dec_ref["kinds"]["all-reduce"] == 2 * rowpar + combine

    tr, tr_ref = got["train_4k"], ref["train_4k"]
    assert set(tr) == {"all-gather", "reduce-scatter", "all-reduce"}
    assert set(tr_ref["kinds"]) == {"all-gather", "all-reduce", "all-to-all"}
    # the 128 positions split over model = 2: each row-parallel output
    # and the lookup's sum reduce-scattered onto the stream's halves, and
    # each block's input and the final norm's output gathered (five of
    # (2, 128, 64) bf16, in the forward and the backward), in place of
    # the all-reduces; beside them the weights' gathers and gradients
    seq_parallel = 2 * 5 * (2 * 128 * 64 * 2) // 2
    assert tr["all-gather"] == 2 * dec["all-gather"] + seq_parallel
    assert tr["reduce-scatter"] == dec["all-gather"] + seq_parallel
    attn = [p for p in params if p[:3] == ("groups", "0", "attn")]
    whole = {tuple(2 * n if "data" in RL._axes(a) else n
                   for n, a in zip(phys[p].shape[1:], phys[p].spec[1:]))
             for p in attn}
    hlo_attn = sum(n for kind, shp, n in tr_ref["ops"]
                   if kind == "all-gather" and shp.startswith("f32[")
                   and tuple(int(x) for x in shp[4:-1].split(",")) in whole)
    port_attn = sum(2 * per_dev[p] for p in attn)
    assert hlo_attn == 2 * 3 * port_attn // 2
