"""The port's launch layer against the reference's (``repro_torch.launch``,
``repro_torch.configs`` vs ``repro.launch``, ``repro.configs``).

- The report tables render byte for byte what the reference renders for
  reports with equal fields: seeded campaigns through both packages'
  ``api.solve`` (the reference's wall-clock timing fields copied onto the
  port's report), the capability matrix of every registered spec, the
  advice table of an unprobed ``advise``, and a registry's counter and
  gauge rows.
- The analytic roofline: the terms and bottleneck of
  ``tests/test_esrp_and_roofline.py`` on the card's constants, each
  kernel's bound against the byte formulas ``chip_smoke.py`` used to
  inline, the grid steps' halo bytes against ``ShardedOperator.
  halo_bytes``, and one ``multi_device`` subprocess holding the
  ``shardmap`` step's collective bytes against the reference's HLO
  count.
- ``GRIDS``, ``SMOKE`` and ``solve_config()`` equal the reference's.
- The serve CLI prints what the reference's prints, wall fields masked.
- The dry run writes the reference's row keys on the CPU and ``table()``
  renders its rows.
"""
import dataclasses
import json
import re
import sys

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro_torch import api
from repro_torch.configs import poisson_pcg as cfg
from repro_torch.convert import problem_from_numpy
from repro_torch.core import spmv
from repro_torch.core.poisson import StencilOperator
from repro_torch.distributed.sharding import (ShardedOperator, ShardLayout,
                                              make_data_mesh)
from repro_torch.kernels.fused_cg import fused_pass_traffic
from repro_torch.launch import dryrun, mesh as M, report, roofline as RL
from repro_torch.launch import serve

H100 = 3.35e12


# ----------------------------------------------------------------------
# report tables, byte for byte
# ----------------------------------------------------------------------
#: the float fields that hold wall-clock seconds (not modelled counts)
TIMING_FIELDS = ("persist_cost_s", "persist_stage_s", "persist_hidden_s",
                 "persist_exposed_s", "persist_drain_s")
GRID, NBLOCKS = (8, 8, 8), 4


def _campaign(pkg, solver):
    if solver == "pcg":
        return [pkg.FailureEvent(blocks=(1,), at_iteration=5),
                pkg.FailureEvent(blocks=(2,), at_iteration=11)]
    return pkg.FailureCampaign((
        pkg.FailureEvent(at_iteration=3, prd=True),
        pkg.FailureEvent(blocks=(1, 2), at_iteration=6)))


@pytest.fixture(scope="module")
def problems():
    ref_problem = ref_api.Problem.poisson(*GRID, nblocks=NBLOCKS)
    port_problem = problem_from_numpy(GRID, NBLOCKS, np.asarray(ref_problem.b),
                                      device="cpu")
    return ref_problem, port_problem


@pytest.fixture(scope="module")
def campaign_reports(problems):
    """Two seeded campaigns through both packages: PCG on ``nvm-prd``
    (two block kills, sync), BiCGStab on the fused ``erasure(nvm-prd
    x4+p)`` stripe (a PRD kill, then blocks (1, 2), overlap); each
    (reference report, port report)."""
    ref_problem, port_problem = problems
    runs = []
    for solver, spec, opts in (
            ("pcg", "nvm-prd", {}),
            ("bicgstab", "erasure(nvm-prd x4+p)",
             {"persist_mode": "overlap", "fused_persist": True})):
        ref = ref_api.solve(ref_problem, ref_api.SolverSpec(solver, tol=1e-10),
                            ref_api.ResilienceSpec(spec, **opts),
                            failures=_campaign(ref_api, solver))
        got = api.solve(port_problem, api.SolverSpec(solver, tol=1e-10),
                        api.ResilienceSpec(spec, **opts),
                        failures=_campaign(api, solver))
        assert got.report.failures_recovered >= 1
        runs.append((ref.report, got.report))
    return runs


def _with_reference_timings(port_report, ref_report):
    return dataclasses.replace(port_report, **{
        f: getattr(ref_report, f) for f in TIMING_FIELDS})


@pytest.mark.parametrize("which", [0, 1, "both"],
                         ids=["pcg nvm-prd", "bicgstab erasure", "both"])
def test_solve_report_table_is_byte_identical(campaign_reports, which):
    from repro.launch.report import solve_report_table as ref_table

    runs = campaign_reports if which == "both" else [campaign_reports[which]]
    refs = [r for r, _ in runs]
    ports = [_with_reference_timings(p, r) for r, p in runs]
    assert report.solve_report_table(ports) == ref_table(refs)
    assert report.solve_report_table([]) == ref_table([])


#: the port's own counters (the kernel route of a persist event and the
#: device-to-host bytes it copied), which the reference does not keep
PORT_ONLY_METRICS = ("persist.d2h_bytes", "persist.route")


@pytest.mark.parametrize("which", [0, 1],
                         ids=["pcg nvm-prd", "bicgstab erasure"])
def test_metrics_table_counter_and_gauge_rows_match(campaign_reports, which):
    from repro.launch.report import metrics_rows as ref_rows

    ref_rep, port_rep = campaign_reports[which]
    want = [r for r in ref_rows(ref_rep.metrics) if r["kind"] != "histogram"]
    got = [r for r in report.metrics_rows(port_rep.metrics)
           if r["kind"] != "histogram" and r["metric"] not in PORT_ONLY_METRICS]
    assert want and got == want
    assert (report._markdown_table(got, "-")
            == report._markdown_table(want, "-"))
    # the histograms hold the same instruments and counts
    hist = [(r["metric"], r["labels"], r["count"])
            for r in ref_rows(ref_rep.metrics) if r["kind"] == "histogram"]
    assert [(r["metric"], r["labels"], r["count"])
            for r in report.metrics_rows(port_rep.metrics)
            if r["kind"] == "histogram"] == hist


def test_metrics_table_renders_like_the_reference():
    from repro.launch.report import metrics_table as ref_table
    from repro.obs import MetricsRegistry as RefRegistry
    from repro_torch.obs import MetricsRegistry

    assert report.metrics_table(None) == ref_table(None) == "(no metrics)"
    tables = []
    for reg in (RefRegistry(solver="pcg", mode="sync"),
                MetricsRegistry(solver="pcg", mode="sync")):
        reg.counter("persist.commit").inc(3)
        reg.gauge("service.queue_depth").set(2.5)
        reg.histogram("persist.commit_s", phase="persist").observe(1e-3)
        reg.histogram("persist.commit_s", phase="persist").observe(3e-3)
        tables.append(reg)
    assert report.metrics_table(tables[1]) == ref_table(tables[0])


@pytest.mark.parametrize("baseline", [False, True],
                         ids=["values", "overhead factor"])
def test_capability_matrix_is_byte_identical(problems, baseline):
    from repro.launch.report import capability_matrix_table as ref_table
    from repro.launch.report import storage_values as ref_storage
    from repro.nvm.backend import backend_names as ref_names
    from repro.solvers.registry import make_backend as ref_make
    from repro_torch.nvm.backend import backend_names
    from repro_torch.solvers.registry import make_backend

    ref_problem, port_problem = problems
    assert backend_names() == ref_names()
    ref_base = (ref_storage(ref_make("nvm-prd", ref_problem.op))
                if baseline else None)
    base = (report.storage_values(make_backend("nvm-prd", port_problem.op))
            if baseline else None)
    assert base == ref_base
    want = ref_table(((n, ref_make(n, ref_problem.op)) for n in ref_names()),
                     baseline_values=ref_base)
    got = report.capability_matrix_table(
        ((n, make_backend(n, port_problem.op)) for n in backend_names()),
        baseline_values=base)
    assert got == want and got.count("\n") == len(ref_names()) + 1
    assert report.capability_matrix_table([]) == ref_table([])


@pytest.mark.parametrize("campaign", ["single block", "double PRD loss"])
@pytest.mark.parametrize("baseline", [False, True],
                         ids=["values", "overhead factor"])
def test_unprobed_advice_table_is_byte_identical(problems, campaign, baseline):
    from repro.launch.report import spec_advice_table as ref_table
    from repro.solvers.driver import advise_spec as ref_advise
    from repro.solvers.registry import make_backend as ref_make
    from repro_torch.solvers.driver import advise_spec
    from repro_torch.solvers.registry import make_backend

    ref_problem, port_problem = problems

    def events(pkg):
        if campaign == "single block":
            return [pkg.FailureEvent(blocks=(1,), at_iteration=6)]
        return pkg.FailureCampaign((
            pkg.FailureEvent(blocks=(1,), at_iteration=6, prd=True),
            pkg.FailureEvent(blocks=(2,), at_iteration=10, prd=True)))

    specs = api.default_candidate_specs()
    assert specs == ref_api.default_candidate_specs()
    want_advice = ref_advise(events(ref_api), [
        (s, ref_make(s, ref_problem.op)) for s in specs])
    advice = advise_spec(events(api), [
        (s, make_backend(s, port_problem.op)) for s in specs])
    base = 2 * port_problem.op.n if baseline else None
    assert report.spec_advice_table(advice, base) == ref_table(want_advice,
                                                               base)
    assert advice.chosen == want_advice.chosen


# ----------------------------------------------------------------------
# roofline
# ----------------------------------------------------------------------
def test_roofline_terms_and_bottleneck():
    r = RL.Roofline(flops=67e12, hbm_bytes=H100 / 2, coll_bytes=H100,
                    coll_by_kind={}, chips=256, hbm_rate=H100)
    assert abs(r.t_compute - 1.0) < 1e-9          # float32 peak
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9       # a read and a write
    assert r.bottleneck == "collective"
    # the copies share HBM with the kernels: memory and collective add
    assert r.step_time_lb == r.t_memory + r.t_collective
    f64 = dataclasses.replace(r, flops=34e12 * 4, dtype="float64")
    assert f64.bottleneck == "compute" and f64.step_time_lb == 4.0
    row = r.as_row()
    assert set(row) == {
        "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
        "flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip"}
    # the counts per shard, as the reference's per device; times the card's
    assert (row["flops_per_chip"], row["hbm_bytes_per_chip"],
            row["coll_bytes_per_chip"]) == (67e12 / 256, H100 / 2 / 256,
                                            H100 / 256)
    assert row["t_memory_s"] == r.t_memory


N256 = 256 ** 3
PLANE = 256 * 256
SLAB = 64 * PLANE
#: (work, the byte count chip_smoke.py inlined, its printed bound ms)
KERNEL_BOUNDS = {
    "stencil7": (RL.stencil7_work(N256, "float64"), 2 * N256 * 8, 0.0801),
    "fused_cg_update": (RL.fused_cg_update_work(N256, "float64"),
                        8 * N256 * 8, 0.3205),
    "det_dot": (RL.det_dot_work(N256, "float64"), 2 * N256 * 8, 0.0801),
    "det_dot local CG": (RL.det_dot_work(2 * N256 // 8, "float64"),
                         2 * (2 * N256 // 8) * 8, 0.0200),
    "gf256_rs_encode": (RL.gf256_rs_encode_work(4, N256 * 8 // 4, 2),
                        (4 + 2) * (N256 * 8 // 4), 0.0601),
    "gf256_rs_encode P=1": (RL.gf256_rs_encode_work(4, N256 * 8 // 4, 1),
                            (4 + 1) * (N256 * 8 // 4), 0.0501),
    "fused_cg_update_persist": (
        RL.fused_cg_update_persist_work(N256, "float64", 4, 2),
        fused_pass_traffic(N256, 8, 4, 2)["total_bytes"], 0.3806),
    "stencil7 lanes": (RL.stencil7_work(4 * N256, "float64"),
                       2 * 4 * N256 * 8, 0.3205),
    "fused_cg_update_lanes": (RL.fused_cg_update_work(4 * N256, "float64"),
                              8 * 4 * N256 * 8, 1.2821),
    "det_dot_lanes": (RL.det_dot_work(4 * N256, "float64"),
                      2 * 4 * N256 * 8, 0.3205),
    "stencil7_halo": (RL.stencil7_halo_work(SLAB, PLANE, 2, "float64"),
                      (2 * SLAB + 2 * PLANE) * 8, 0.0203),
    "det_dot_lanes one shard": (RL.det_dot_work(2 * N256 // 8, "float64"),
                                2 * (2 * N256 // 8) * 8, 0.0200),
    "fused_cg_update_lanes one shard": (
        RL.fused_cg_update_work(2 * N256 // 8, "float64"),
        8 * (2 * N256 // 8) * 8, 0.0801),
}


@pytest.mark.parametrize("name", sorted(KERNEL_BOUNDS))
def test_kernel_bounds_equal_the_smoke_scripts_former_formulas(name):
    work, nbytes, printed_ms = KERNEL_BOUNDS[name]
    assert work.nbytes == nbytes
    ms, by = RL.bound_ms(work, "float64", H100)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / H100)
    assert round(ms, 4) == printed_ms


def test_bound_ms_takes_the_larger_term():
    ms, by = RL.bound_ms(RL.Work(nbytes=1.0, ops=34e12), "float64", H100)
    assert by == "operations" and ms == pytest.approx(1e3)
    assert RL.bound_ms(RL.Work(0, 0), "float32", H100) == (0.0, "bytes")


def test_main_path_step_is_its_kernels():
    n = N256
    roof = RL.pcg_step_roofline((256, 256, 256), "float64", hbm_rate=H100)
    parts = (RL.stencil7_work(n, "float64") + RL.det_dot_work(n, "float64")
             + RL.fused_cg_update_work(n, "float64")
             + RL.p_update_work(n, "float64"))
    assert (roof.hbm_bytes, roof.flops) == (parts.nbytes, parts.ops)
    assert roof.hbm_bytes == 15 * n * 8 and roof.coll_by_kind == {}
    assert roof.chips == 1 and roof.bottleneck == "memory"
    # a 4-lane bucket counts every lane
    bucket = RL.pcg_step_roofline((4, 256, 256, 256), "float64",
                                  hbm_rate=H100)
    assert bucket.hbm_bytes == 4 * roof.hbm_bytes


@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_sharded_step_adds_halo_planes_and_block_sums(nshards):
    grid, n = (16, 8, 8), 16 * 8 * 8
    plain = RL.pcg_step_roofline(grid, "float64", hbm_rate=H100)
    roof = RL.pcg_step_roofline(grid, "float64", nshards=nshards, nblocks=8,
                                hbm_rate=H100)
    # each interior slab boundary: both slabs' K1 launches read a plane
    assert roof.hbm_bytes == plain.hbm_bytes + 2 * (nshards - 1) * 64 * 8
    assert roof.flops == plain.flops
    assert roof.coll_by_kind == {"collective-permute": 2 * (nshards - 1) * 64 * 8,
                                 "all-reduce": 2 * 8 * 8}
    assert roof.coll_bytes == sum(roof.coll_by_kind.values())
    assert RL.pcg_step_roofline(grid, "float64", esr_mode="inmemory",
                                hbm_rate=H100
                                ).coll_by_kind == {"all-gather": n * 8}


@pytest.mark.parametrize("esr_mode", ["nvm", "inmemory"])
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
@pytest.mark.parametrize("nshards", [4, 8])
def test_grid_step_halo_bytes_equal_the_sharded_operator(nshards, variant,
                                                         esr_mode):
    grid = (16, 8, 8)
    roof = RL.grid_step_roofline(variant, grid, "float32", nshards, esr_mode,
                                 hbm_rate=H100)
    base = StencilOperator(*grid, nblocks=nshards, device="cpu")
    op = ShardedOperator(base, ShardLayout(nshards, nshards),
                         make_data_mesh(nshards, "cpu"))
    op.apply(torch.ones(base.n, dtype=torch.float32))
    assert roof.coll_by_kind["collective-permute"] == op.halo_bytes
    assert op.halo_bytes == spmv.halo_nbytes(grid, nshards, torch.float32)
    assert roof.coll_by_kind["all-reduce"] == 2 * nshards * 4
    assert ("all-gather" in roof.coll_by_kind) == (esr_mode == "inmemory")
    assert roof.chips == nshards and roof.dtype == "float32"


_REF_COLLECTIVES = r"""
import json
from repro.launch.mesh import compat_make_mesh
from repro.launch.roofline import analyze
from repro.core.spmv import lower_pcg_step

mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for esr in ("nvm", "inmemory"):
    c = lower_pcg_step(mesh, 64, 32, 32, esr_mode=esr,
                       variant="shardmap").compile()
    out[esr] = analyze(c, 8).coll_by_kind
print(json.dumps(out))
"""


@pytest.mark.multi_device
def test_shardmap_collectives_against_the_reference_hlo(multi_device):
    """The reference's HLO counts one device's program: both ``ppermute``
    outputs (one plane each, the boundary devices' zero fill included),
    one float32 ``psum`` scalar per reduction and a full gathered grid.
    The port counts the one card's: the planes that exist (the two
    zero-filled boundary planes are never moved), every shard's sum and
    one replica."""
    want = multi_device.run(_REF_COLLECTIVES, ndevices=8, timeout=480)
    plane = 32 * 32 * 4
    for esr, ref in want.items():
        got = RL.grid_step_roofline("shardmap", (64, 32, 32), "float32", 8,
                                    esr, hbm_rate=H100).coll_by_kind
        assert ref["collective-permute"] == 2 * plane
        assert got["collective-permute"] == ref["collective-permute"] * (8 - 1)
        assert got["all-reduce"] == ref["all-reduce"] * 8
        assert got.get("all-gather") == ref.get("all-gather")


# ----------------------------------------------------------------------
# the card's constants and the production layouts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,rate", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA H200", 4.8e12)])
def test_hbm_rate_by_card_name(name, rate):
    assert M.hbm_rate(name) == rate


def test_unknown_card_and_cpu_memory_are_never_guessed():
    with pytest.raises(ValueError, match="no memory rate"):
        M.hbm_rate("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="must be given"):
        M.device_memory_bytes("cpu")
    assert M.device_memory_bytes("cpu", 2**30) == 2**30
    with pytest.raises(ValueError, match="must be given"):
        M.device_hbm_rate("cpu")
    assert M.device_hbm_rate("cpu", H100) == H100
    with pytest.raises(TypeError, match="hbm_rate"):
        RL.pcg_step_roofline((8, 8, 8), "float64")
    assert M.peak_ops(torch.float64) == 34e12 and M.peak_ops("float32") == 67e12
    with pytest.raises(ValueError):
        M.peak_ops("int8")
    assert M.card_identity("cpu") == {"name": "cpu", "power_limit": None}


@pytest.mark.parametrize("layout,shards", [("16x16", 256), ("2x16x16", 512)])
def test_production_layouts_on_one_device(layout, shards):
    mesh = M.make_data_mesh(M.LAYOUTS[layout], "cpu")
    assert mesh.shape == {"data": shards} and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="production layout"):
        M.make_data_mesh(shards + 1, "cpu")


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
def test_configs_equal_the_reference():
    from repro.configs import poisson_pcg as ref

    assert list(cfg.GRIDS) == list(ref.GRIDS)
    for name, sc in cfg.GRIDS.items():
        assert dataclasses.asdict(sc) == dataclasses.asdict(ref.GRIDS[name])
    assert dataclasses.asdict(cfg.SMOKE) == dataclasses.asdict(ref.SMOKE)
    assert ([f.name for f in dataclasses.fields(cfg.SolverConfig)]
            == [f.name for f in dataclasses.fields(ref.SolverConfig)])


@pytest.mark.parametrize("name", sorted(cfg.GRIDS) + ["SMOKE"])
def test_solve_config_equals_the_reference(name):
    from repro.configs import poisson_pcg as ref

    got = (cfg.SMOKE if name == "SMOKE" else cfg.GRIDS[name]).solve_config()
    want = (ref.SMOKE if name == "SMOKE" else ref.GRIDS[name]).solve_config()
    assert type(got).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ----------------------------------------------------------------------
# the serve CLI
# ----------------------------------------------------------------------
_WALL = re.compile(r"\(\d+\.\d+s, \d+\.\d+ solves/s\)")


def _run_main(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("failures", [False, True],
                         ids=["failure-free", "failures"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serve_cli_prints_what_the_reference_prints(monkeypatch, capsys,
                                                    seed, failures):
    from repro.launch import serve as ref_serve

    argv = ["--seed", str(seed), "--requests", "6", "--lanes", "4"]
    argv += ["--failures"] if failures else []
    want = _run_main(monkeypatch, capsys, ref_serve.main, argv)
    got = _run_main(monkeypatch, capsys, serve.main,
                    argv + ["--device", "cpu"])
    assert got.count("\n") == 7 and "service: " in got
    assert _WALL.sub("(WALL)", got) == _WALL.sub("(WALL)", want)


def test_serve_cli_refuses_the_lm_path(monkeypatch, capsys):
    """The LM path refuses a vision arch (it takes patch embeddings, not
    token prompts) and an unknown arch, exiting non-zero as the
    reference does."""
    for arch, why in (("qwen2_vl_72b", "patch embeddings"),
                      ("no_such_arch", "unknown arch")):
        with pytest.raises(SystemExit) as exc:
            _run_main(monkeypatch, capsys, serve.main,
                      ["--arch", arch, "--smoke", "--device", "cpu"])
        assert exc.value.code not in (0, None)
        assert why in str(exc.value.code)


# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------
ROW_KEYS = {"arch", "shape", "mesh", "chips", "esr_mode", "compile_s",
            "memory", "roofline", "coll_by_kind", "model_flops_per_chip",
            "useful_flop_ratio", "device", "ok"}


@pytest.mark.parametrize("esr_mode", ["nvm", "inmemory"])
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
@pytest.mark.parametrize("nshards", [4, 8])
def test_run_solver_cell_writes_the_reference_row(tmp_path, nshards, variant,
                                                  esr_mode):
    sc = cfg.SolverConfig(f"pcg_16_{variant}_{esr_mode}", (16, 16, 16), 16,
                          esr_mode=esr_mode, variant=variant)
    out = tmp_path / "rows.jsonl"
    row = dryrun.run_solver_cell(sc, results_path=str(out), verbose=False,
                                 device="cpu", nshards=nshards,
                                 memory_bytes=2**30, hbm_rate=H100)
    assert ROW_KEYS <= set(row) and row["ok"] and row["x_r_finite"]
    assert json.loads(out.read_text()) == row
    assert (row["arch"], row["shape"], row["mesh"], row["chips"]) == (
        "poisson_pcg", sc.name, str(nshards), nshards)
    assert row["esr_mode"] == esr_mode and row["variant"] == variant
    roof = RL.grid_step_roofline(variant, (16, 16, 16), "float32", nshards,
                                 esr_mode, hbm_rate=H100)
    assert row["roofline"] == roof.as_row()
    assert row["coll_by_kind"] == roof.coll_by_kind
    assert row["model_flops_per_chip"] == 18 * 16 ** 3 / nshards
    assert row["useful_flop_ratio"] == pytest.approx(
        18 * 16 ** 3 / roof.flops) == 1.0
    assert len(row["warm_steps_s"]) == dryrun.WARM_STEPS
    assert row["step_s"] == sorted(row["warm_steps_s"])[dryrun.WARM_STEPS // 2]
    grids = 5 if esr_mode == "inmemory" else 4
    assert row["memory"] == {"state_bytes": grids * 16 ** 3 * 4 + 4,
                             "peak_bytes": None}
    # CPU times are not the card's: no share of its bound
    assert row["roofline_share"] is None and row["compile_s"] > 0
    assert row["device"] == {"type": "cpu", "name": "cpu", "power_limit": None,
                             "memory_bytes": 2**30,
                             "hbm_bytes_per_s": H100}


@pytest.mark.parametrize("layout", sorted(M.LAYOUTS))
@pytest.mark.parametrize("cell", sorted(cfg.GRIDS))
def test_useful_ops_never_exceed_the_counted_ops(cell, layout):
    """The model's operations and the roofline's are counted alike (the
    stencil a multiply and six subtracts a point), so a shard's useful
    share of its counted operations is at most 1."""
    sc, shards = cfg.GRIDS[cell], M.LAYOUTS[layout]
    roof = RL.grid_step_roofline(sc.variant, sc.grid, "float32", shards,
                                 sc.esr_mode, hbm_rate=H100)
    counted = roof.as_row()["flops_per_chip"]
    assert counted * shards == roof.flops
    assert 0 < dryrun.model_ops_per_chip(sc.grid, shards) / counted <= 1


def test_report_reads_rows_without_the_dry_run():
    """The table renderer does not pull in the module that produces its
    rows (nor the kernels and configs behind it)."""
    import os
    import pathlib
    import subprocess

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = ("import json, sys; import repro_torch.launch.report; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    loaded = json.loads(out.stdout)
    assert "repro_torch.launch.report" in loaded
    assert not any(m.startswith(("repro_torch.launch.dryrun",
                                 "repro_torch.kernels", "repro_torch.core",
                                 "repro_torch.configs")) for m in loaded)


def test_dry_run_step_matches_the_grid_step():
    """The row's first step is the grid step on the seeded state: one
    step by hand from the same state gives the same ``x``."""
    sc = cfg.SMOKE
    mesh = make_data_mesh(sc.nblocks, "cpu")
    step, spec = spmv.make_sharded_pcg_step(mesh)
    _, structs = spec(*sc.grid)
    state = dryrun.cell_state(structs, mesh, torch.device("cpu"))
    assert set(state) == set(structs)
    assert all(state[k].shape == structs[k].shape
               and state[k].dtype == structs[k].dtype for k in structs)
    out = step(state)
    z = state["r"] * (1.0 / 6.0)
    ap = spmv.sharded_stencil7(z, sc.nblocks)
    alpha = state["rz"] / (z * ap).sum(dtype=torch.float64).float()
    np.testing.assert_allclose(out["x"].numpy(), (alpha * z).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_dry_run_refuses_a_cell_that_does_not_fit():
    with pytest.raises(MemoryError, match="does not fit"):
        dryrun.run_solver_cell("pcg_1g", results_path=None, device="cpu",
                               memory_bytes=2**30, hbm_rate=H100)


def test_dry_run_cli_on_the_cpu_and_its_table(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    argv = ["--solver", "--smoke", "--device", "cpu", "--memory-bytes",
            str(2**30), "--hbm-rate", str(H100), "--out", str(out)]
    dryrun.main(argv)
    dryrun.main(argv + ["--resume"])            # the cell is done: skipped
    assert len(out.read_text().splitlines()) == 1
    printed = capsys.readouterr().out
    assert printed.count("[pcg pcg_smoke") == 1
    for variant in ("auto", "shardmap"):
        dryrun.run_solver_cell(
            dataclasses.replace(cfg.SMOKE, name=f"smoke_{variant}",
                                variant=variant),
            results_path=str(out), verbose=False, device="cpu",
            nshards=4, memory_bytes=2**30, hbm_rate=H100)
    rows = report.load(str(out))
    assert sorted(rows) == [("poisson_pcg", "pcg_smoke", "8"),
                            ("poisson_pcg", "smoke_auto", "4"),
                            ("poisson_pcg", "smoke_shardmap", "4")]
    text = report.table(rows, mesh="4")
    lines = text.splitlines()
    assert len(lines) == 4 and lines[0].startswith("| arch | shape |")
    assert all("| - | - | " in ln for ln in lines[2:])   # peak not measured
    assert "pcg_smoke" not in text and "smoke_auto" in text
    # a row measured on a card: peak against the card's memory
    row = dict(rows[("poisson_pcg", "smoke_auto", "4")], mesh="2x16x16")
    row["memory"] = {"peak_bytes": 3 * 2**30}
    row["device"] = dict(row["device"], memory_bytes=2 * 2**30)
    table = report.multipod_table({("poisson_pcg", "smoke_auto", "2x16x16"):
                                   row})
    assert table.splitlines()[2].startswith(
        "| poisson_pcg | smoke_auto | 2x16x16 | 3.00 | ")
    assert "| 3.00 | n |" in report.table(
        {("poisson_pcg", "smoke_auto", "2x16x16"): row}, mesh="2x16x16")


@pytest.mark.parametrize("argv,code,says", [
    (["--arch", "llama3_8b", "--shape", "train_4k", "--mesh", "single",
      "--smoke", "--device", "cpu", "--memory-bytes", "4096", "--hbm-rate",
      str(H100)], 1, "does not fit"),
    (["--solver", "--opt", "remat_dot"], 2, "unknown --opt lever")],
    ids=["LM cells", "--opt"])
def test_dry_run_refuses_the_lm_cells(tmp_path, capsys, argv, code, says):
    """An LM cell whose variants do not fit the device is refused before
    anything is allocated (the run exits 1 naming it); an unknown lever
    is refused before any cell runs."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(argv + ["--out", str(tmp_path / "rows.jsonl")])
    assert exc.value.code == code
    captured = capsys.readouterr()
    assert says in captured.out + captured.err
    assert not (tmp_path / "rows.jsonl").exists()

