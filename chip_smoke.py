#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

Phases (each prints its results on lines of its own; any failure exits
non-zero and prints no result line):

1. device — ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build — the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card,
   at the main path's shapes (256^3 float64) plus small float32/bfloat16
   cases, with CUDA-event times (median of 25 launches) beside the
   least time the card could take (``bound_ms``);
4. main path — ``api.solve`` of the 256^3 float64 Poisson problem
   (``nblocks=8``, PCG, ``nvm-prd``): unprotected, persisted without
   failure, and with blocks (1, 2) failing at iteration 20 in sync and in
   overlap mode; the recovered runs must match the failure-free run at
   rtol = atol = 1e-8 and every kernel must have launched;
5. convergence — a 64^3 ``nvm-homogeneous`` solve with a block kill must
   converge to 1e-10.

The line before the last is the kernel summary ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  The script imports
neither JAX nor the reference package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

GRID = 256
NBLOCKS = 8
FAIL_AT = 20
MAXITER = 40
REPS = 25
DEVICE = "cuda"

#: HBM rate (bytes/s) by card model, from NVIDIA's data sheets; the
#: SXM part is the default for an H100 whose name says neither.
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
#: peak non-tensor-core rates (op/s) by dtype, H100 SXM data sheet
PEAK_OPS = {"float64": 34e12, "float32": 67e12}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise SmokeFailure(f"no memory rate known for card {name!r}")


def bound_ms(nbytes: float, ops: float, dtype: str, rate: float):
    t_bytes = nbytes / rate
    t_ops = ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=line, torch_name=name,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return name, line


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    for name, (path, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        say("build", source=f"{name}.cu", library=os.path.basename(path),
            ptxas=regs)
    say("build", seconds=seconds)


def phase_kernels(torch, rate: float):
    """Each kernel against its plain version on the card; returns the
    per-kernel records of the summary line (launches filled later)."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import stencil7 as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = GRID ** 3
    records = {}

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    # ---- K1 at the main path's shape, float64 -------------------------
    u = randn(GRID, GRID, GRID)
    got, want = k1.stencil7_cuda(u), k1.stencil7_plain(u)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    tol = 1e-12 * max(1.0, float(want.abs().max()))
    say("kernels", kernel="stencil7", dtype="float64", shape=[GRID] * 3,
        max_abs_err=err, tol=tol)
    check(err <= tol, f"stencil7 f64 error {err} > {tol}")
    ms = time_ms(torch, lambda: k1.stencil7_cuda(u))
    plain_ms = time_ms(torch, lambda: k1.stencil7_plain(u))
    # yardstick: one cuDNN convolution with the 7-point weights, float32
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros(1, 1, 3, 3, 3, device=dev, dtype=torch.float32)
    w[0, 0, 1, 1, 1] = 6.0
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[(0, 0) + idx] = -1.0
    u32 = u.float()
    conv = lambda: F.conv3d(u32[None, None], w, padding=1)  # noqa: E731
    k32 = k1.stencil7_cuda(u32)
    conv_err = max_abs(conv()[0, 0], k32)
    library_ms = time_ms(torch, conv)
    k32_ms = time_ms(torch, lambda: k1.stencil7_cuda(u32))
    b_ms, b_by = bound_ms(2 * n * 8, 7 * n, "float64", rate)
    b32_ms, _ = bound_ms(2 * n * 4, 7 * n, "float32", rate)
    say("kernels", kernel="stencil7", kernel_ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, library="conv3d float32 (tf32 off)",
        bound_ms=b_ms, bound_by=b_by, f32_kernel_ms=k32_ms,
        f32_bound_ms=b32_ms, conv_vs_kernel_f32_max_abs_err=conv_err)
    records["stencil7"] = dict(
        name="stencil7", route="cuda",
        source="src/repro_torch/kernels/csrc/stencil7.cu",
        replaces="src/repro/kernels/stencil7.py:53", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms)
    del u, got, want, u32, k32

    # ---- K1 small float32 / bfloat16 (reference tolerances) -----------
    for shape, dtype, tol in (((24, 10, 130), torch.float32, 1e-5),
                              ((16, 8, 64), torch.bfloat16, 1e-1)):
        v = randn(*shape, dtype=torch.float32).to(dtype)
        e = max_abs(k1.stencil7_cuda(v).float(), k1.stencil7_plain(v).float())
        say("kernels", kernel="stencil7", dtype=str(dtype), shape=shape,
            max_abs_err=e, tol=tol)
        check(e <= tol, f"stencil7 {dtype} error {e} > {tol}")
    # batched input (recovery's dense local solve): one launch, 3 grids
    vb = randn(3, 9, 7, 33)
    e = max_abs(k1.stencil7_cuda(vb), k1.stencil7_plain(vb))
    say("kernels", kernel="stencil7", dtype="float64", shape=[3, 9, 7, 33],
        max_abs_err=e, tol=1e-12)
    check(e <= 1e-12, f"stencil7 batched error {e}")

    # ---- K2 at the main path's shape, float64 --------------------------
    x, r, p, ap = (randn(n) for _ in range(4))
    inv = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) + 0.5
    alpha = torch.tensor(0.37, dtype=torch.float64, device=dev)
    got = k2.fused_cg_update_cuda(x, r, p, ap, alpha, inv, NBLOCKS)
    want = k2.fused_cg_update_plain(x, r, p, ap, alpha, inv, NBLOCKS)
    torch.cuda.synchronize()
    vec_err = max(max_abs(g, w_) for g, w_ in zip(got[:3], want[:3]))
    rz_err = max_abs(got[3], want[3])
    rz_tol = 1e-12 * abs(float(want[3]))
    vec_tol = 1e-12 * max(1.0, max(float(t.abs().max()) for t in want[:3]))
    say("kernels", kernel="fused_cg_update", dtype="float64", n=n,
        nblocks=NBLOCKS, vec_max_abs_err=vec_err, vec_tol=vec_tol,
        rz_abs_err=rz_err, rz_tol=rz_tol)
    check(vec_err <= vec_tol and rz_err <= rz_tol,
          f"fused_cg_update f64 error vec {vec_err} rz {rz_err}")
    # N2: the fused rz' and det_dot(r', z') share one rounding order
    same = k2.det_dot_cuda(got[1], got[2], NBLOCKS)
    check(bool(same == got[3]), "det_dot(r', z') != fused rz' bitwise")
    ms = time_ms(torch, lambda: k2.fused_cg_update_cuda(x, r, p, ap, alpha, inv, NBLOCKS))
    plain_ms = time_ms(torch, lambda: k2.fused_cg_update_plain(x, r, p, ap, alpha, inv, NBLOCKS))
    b_ms, b_by = bound_ms(8 * n * 8, 7 * n, "float64", rate)
    say("kernels", kernel="fused_cg_update", kernel_ms=ms, plain_ms=plain_ms,
        library_ms=None, library="no single PyTorch call computes it",
        bound_ms=b_ms, bound_by=b_by)
    records["fused_cg_update"] = dict(
        name="fused_cg_update", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:61",
        max_abs_err=max(vec_err, rz_err), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- det_dot (K2's reduction) at the main path's shape -------------
    got_d = k2.det_dot_cuda(p, ap, NBLOCKS)
    want_d = k2.block_dot_plain(p, ap, NBLOCKS)
    d_err = max_abs(got_d, want_d)
    d_tol = 1e-12 * float((p * ap).abs().sum())
    say("kernels", kernel="det_dot", dtype="float64", n=n, nblocks=NBLOCKS,
        max_abs_err=d_err, tol=d_tol)
    check(d_err <= d_tol, f"det_dot error {d_err} > {d_tol}")
    ms = time_ms(torch, lambda: k2.det_dot_cuda(p, ap, NBLOCKS))
    plain_ms = time_ms(torch, lambda: k2.block_dot_plain(p, ap, NBLOCKS))
    library_ms = time_ms(torch, lambda: torch.dot(p, ap))
    b_ms, b_by = bound_ms(2 * n * 8, 2 * n, "float64", rate)
    say("kernels", kernel="det_dot", kernel_ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, library="torch.dot", bound_ms=b_ms,
        bound_by=b_by)
    records["det_dot"] = dict(
        name="det_dot", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:58", max_abs_err=d_err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms)
    del x, r, p, ap, inv, got, want

    # ---- K2 float32, ragged n (reference tolerances) -------------------
    m = 128 * 64 + 37
    vs = [randn(m, dtype=torch.float32) for _ in range(5)]
    a32 = torch.tensor(0.37, dtype=torch.float32, device=dev)
    got = k2.fused_cg_update_cuda(*vs[:4], a32, vs[4], 1)
    want = k2.fused_cg_update_plain(*vs[:4], a32, vs[4], 1)
    e = max(max_abs(g, w_) for g, w_ in zip(got[:3], want[:3]))
    rz_rel = abs(float(got[3]) - float(want[3])) / (abs(float(want[3])) + 1e-9)
    say("kernels", kernel="fused_cg_update", dtype="float32", n=m,
        max_abs_err=e, tol=2e-5, rz_rel_err=rz_rel, rz_tol=1e-4)
    check(e <= 2e-5 and rz_rel < 1e-4, f"fused_cg_update f32 error {e} {rz_rel}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def _recovery_seconds(tracer) -> float:
    return sum(rec["dur"] for rec in tracer.records
               if rec["type"] == "span"
               and rec["name"] in ("recovery.fetch", "recovery.reconstruct"))


def iteration_breakdown(torch, problem, p, first_run_s: float,
                        reps: int = 3):
    """Where a persisted iteration's wall time goes: the device step,
    timed with CUDA events once the allocator is warm, and the residual
    norm's scalar pull, against the two halves of the host persistence
    path — the device-to-host copy of ``p`` (``host_shard``) and the
    backend's persist event (slot encode, CRC, simulated store writes,
    drain).  ``first_run_s`` is the unprotected solve's wall seconds per
    iteration, allocator warm-up included."""
    from repro_torch.solvers.pcg import PCGSolver
    from repro_torch.solvers.registry import make_backend

    solver = PCGSolver()
    state = solver.init_state(problem.op, problem.precond, problem.b)
    step = solver.make_step(problem.op, problem.precond)
    step_ms = time_ms(torch, lambda: step(state))
    t0 = time.perf_counter()
    for _ in range(REPS):
        solver.residual_norm(state)
    norm_s = (time.perf_counter() - t0) / REPS
    t0 = time.perf_counter()
    for _ in range(reps):
        host = solver.host_shard(p)
    d2h_s = (time.perf_counter() - t0) / reps
    backend = make_backend("nvm-prd", problem.op, solver=solver)
    t0 = time.perf_counter()
    for k in range(reps):
        backend.persist_set(k, {"beta": 0.5}, {"p": host})
        backend.drain()
    persist_s = (time.perf_counter() - t0) / reps
    say("main", breakdown="seconds per iteration",
        unprotected_run_s=first_run_s, device_step_s=step_ms / 1e3,
        residual_norm_pull_s=norm_s, d2h_copy_s=d2h_s,
        d2h_bytes_per_s=host.nbytes / d2h_s, backend_persist_s=persist_s)


def phase_main_path(torch):
    """The port's main path at full width; returns the launch counts."""
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer

    problem = api.Problem.poisson(GRID, nblocks=NBLOCKS, device=DEVICE)
    check(problem.b.device.type == DEVICE, "problem not on the card")
    spec = api.SolverSpec("pcg", tol=1e-10, maxiter=MAXITER)
    failure = [api.FailureEvent(blocks=(1, 2), at_iteration=FAIL_AT)]

    def run(label, resilience, failures=(), tracer=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(problem, spec, resilience, failures=failures,
                        capture_states_at=[FAIL_AT], tracer=tracer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = res.report
        say("main", run=label, iterations=rep.iterations, wall_s=wall,
            s_per_iteration=wall / max(rep.iterations, 1),
            relres=rep.final_relres, failures_recovered=rep.failures_recovered,
            persist_events=rep.persist_events, persist_bytes=rep.persist_bytes,
            recovery_fetch_bytes=rep.recovery_fetch_bytes,
            wasted_iterations=rep.wasted_iterations,
            recovery_s=None if tracer is None else _recovery_seconds(tracer))
        return res, wall

    ops.reset_launch_counts()
    plain, plain_wall = run("unprotected", None)
    base, _ = run("nvm-prd sync, no failure", api.ResilienceSpec("nvm-prd"))
    check(base.iterations == MAXITER == plain.iterations,
          f"expected {MAXITER} iterations, got {base.iterations}")
    check(bool(torch.equal(plain.state.x, base.state.x)),
          "persistence changed the trajectory")
    for mode in ("sync", "overlap"):
        tracer = Tracer()
        res, _ = run(f"nvm-prd {mode}, blocks (1, 2) fail at {FAIL_AT}",
                     api.ResilienceSpec("nvm-prd", persist_mode=mode),
                     failure, tracer)
        rep = res.report
        check(rep.failures_recovered == 1, f"{mode}: failures_recovered="
              f"{rep.failures_recovered}")
        check(res.iterations == base.iterations,
              f"{mode}: k={res.iterations} vs {base.iterations}")
        pairs = [("captured x", res.captured[FAIL_AT].x, base.captured[FAIL_AT].x),
                 ("captured r", res.captured[FAIL_AT].r, base.captured[FAIL_AT].r),
                 ("final x", res.state.x, base.state.x),
                 ("final r", res.state.r, base.state.r)]
        for what, got, want in pairs:
            ok = torch.allclose(got, want, rtol=1e-8, atol=1e-8)
            say("main", mode=mode, check=what, max_abs_err=max_abs(got, want),
                rtol=1e-8, atol=1e-8, ok=bool(ok))
            check(bool(ok), f"{mode}: {what} differs from the failure-free run")
        del res
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    say("main", launches=counts)
    for name, count in counts.items():
        check(count > 0, f"kernel {name} never launched on the main path")
    iteration_breakdown(torch, problem, base.state.p, plain_wall / MAXITER)
    del plain, base, problem
    torch.cuda.empty_cache()
    return counts


def phase_convergence(torch):
    from repro_torch import api

    problem = api.Problem.poisson(64, nblocks=8, device=DEVICE)
    resilience = api.ResilienceSpec("nvm-homogeneous")
    free = api.solve(problem, "pcg", resilience)
    t0 = time.perf_counter()
    res = api.solve(problem, "pcg", resilience,
                    failures=[api.FailureEvent(blocks=(3,), at_iteration=30)])
    torch.cuda.synchronize()
    err = float((res.state.x - free.state.x).abs().max())
    say("convergence", grid=[64] * 3, nblocks=8, backend="nvm-homogeneous",
        converged=res.converged, iterations=res.iterations,
        failure_free_iterations=free.iterations, relres=res.relres,
        failures_recovered=res.report.failures_recovered,
        wall_s=time.perf_counter() - t0, x_vs_failure_free_max_abs_err=err)
    check(res.converged and res.relres < 1e-10, "64^3 solve did not converge")
    check(res.report.failures_recovered == 1, "64^3 failure not recovered")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script drives "
              "the port on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        name, _ = phase_device(torch)
        rate = hbm_rate(name)
        say("device", hbm_bytes_per_s=rate)
        phase_build()
        records = phase_kernels(torch, rate)
        counts = phase_main_path(torch)
        phase_convergence(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for key in ("stencil7", "fused_cg_update", "det_dot"):
        rec = records[key]
        kernels.append({**rec, "launches": counts[key]})
    say("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
