#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

Phases (each prints its results on lines of its own; any failure exits
non-zero and prints no result line):

1. device — ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build — the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel);
3. kernels — each kernel against its plain version on the card, at the
   main path's shapes (256^3 float64) plus small float32/bfloat16,
   ragged and unaligned cases, each timed two ways: the median of 25
   single launches, each between its own CUDA events (``ms``: host work
   per call included), and 25 launches back to back between two events
   (``device_ms``, the median of three such windows), beside the least
   time the card could take (``bound_ms``) and, where one PyTorch call
   computes the same function, that call's two times: K1 (stencil7; conv3d in float64 and float32),
   K2 (fused_cg_update, its ``rz'`` bitwise ``det_dot(r', z')`` and
   ``det_dot_order_plain``), det_dot (bitwise ``det_dot_order_plain``,
   at 256^3/8 and at recovery's local-CG shape, 2 blocks with
   ``nblocks=1``, beside ``torch.dot``), K3 (gf256_rs_encode at P = 2
   and P = 1, bitwise its plain version on the 256^3 chunks, 24 ragged
   and 192 unaligned cases) and K4 (fused_cg_update_persist, bitwise K2
   on its update outputs); then the lane modes of the service's bucket
   step at 4 x 256^3 (fused_cg_update_lanes and det_dot_lanes, each lane
   bitwise a solo ``nblocks=1`` launch on it, beside
   ``torch.linalg.vecdot`` for the lane dots) and K1 on the bucket's
   ``(4, 256, 256, 256)`` grids, beside a batched conv3d;
4. main path — ``api.solve`` of the 256^3 float64 Poisson problem
   (``nblocks=8``, PCG, ``nvm-prd``): unprotected, persisted without
   failure, and with blocks (1, 2) failing at iteration 20 in sync and in
   overlap mode; the recovered runs must match the failure-free run at
   rtol = atol = 1e-8 and K1, K2 and det_dot must have launched;
5. erasure path — the same problem on ``erasure(nvm-prd x4+2p)`` with
   ``fused_persist=True`` in sync (K3 every event) and overlap (K4 every
   step) mode, under a storage-only PRD kill at iteration 10 and blocks
   (1, 2) failing with a second PRD kill at 20: both must recover onto
   the failure-free run at rtol = atol = 1e-8 (and are checked bitwise
   against phase 4's ``nvm-prd`` run of the same mode); at 64^3 the numpy
   and fused routes of x4+p, x4+2p and x6+2p must be bitwise equal; K3
   and K4 must have launched;
6. convergence — a 64^3 ``nvm-homogeneous`` solve with a block kill must
   converge to 1e-10;
7. zoo — at 256^3 (``nblocks=8``, Jacobi preconditioning) each zoo
   solver runs a failure-free solve and one with blocks (1, 2) failing
   mid-way, at the same iteration cap, each on its own backend:
   ``jacobi`` on ``replicated(nvm-prd x2)`` (one mirror's storage node
   killed first), ``chebyshev`` on ``tiered(nvm-prd)``, ``bicgstab`` on
   ``esr`` with three copies, ``gmres`` (m = 20, 3 cycles) on the fused
   ``erasure(nvm-prd x4+p)`` stripe; each recovered run must equal its
   failure-free run at rtol = atol = 1e-8 with equal iteration counts,
   and K1, det_dot (and K3 for GMRES) must have launched;
8. ``solve_jit`` — the PCG loop as a CUDA graph to tol 1e-10 at 256^3:
   its ``x`` must be bitwise the driver's unprotected loop's at the same
   ``k``; graph ms / iteration beside the driver's and the kernels'
   device times;
9. advisor and block Jacobi — ``api.advise`` at 256^3 for a single-block
   and a double-PRD-loss campaign (the second must choose
   ``erasure(nvm-prd x6+2p)``), and block-Jacobi PCG at 16^3/8 (test
   scale: dense per-block factors) on the card against the same solve on
   the CPU at rtol 1e-10;
10. the multi-tenant service — one 4-lane PCG bucket of 256^3 float64
   (tenants of 256^3, 240x256^2, 200^3 and 192x256^2 on ``nvm-prd``,
   ``replicated(nvm-prd x2)`` in overlap, ``erasure(nvm-prd x4+p)``
   with 4 declared shards and ``nvm-homogeneous``), 30 iterations, run
   (A) failure-free, (B) with a block kill, a PRD kill and a
   ``shard=`` kill of three tenants and (C) with the fourth alone: the
   fourth must be bitwise the same in all three, each victim within
   rtol = atol = 1e-8 of its run (A), and each bucket step one launch of
   K1, K2's lane mode and det_dot's; then a 2-lane BiCGStab bucket of
   128^3 with a block kill (a lane step without K2).  Every bucket step
   prints its device ms (CUDA events), the host ms of the loop-top
   passes and each tenant's persist seconds;
11. mesh — the sharded main path at 256^3 float64 (``nblocks=8``):
   K1's halo mode at 2, 4 and 8 shards bitwise one full K1 launch (one
   sharded apply's device ms, every slab launch and halo copy, beside
   the full launch's) and one slab against its plain version and a
   conv3d; ``det_dot``, ``det_rowdots`` and the PCG step on a 4-shard
   mesh bitwise unsharded (per-shard lane launches of det_dot and K2);
   ``api.solve`` of ``Problem.poisson(256, nblocks=8, nshards=4)`` on
   ``nvm-prd`` with ``FailureEvent(shard=1)`` at 10, 20 iterations,
   bitwise the unsharded solve with blocks (2, 3) killed and fetching
   one shard's slot bytes; fetch bytes halving from 2 to 4 to 8 shards
   (6-iteration runs on ``nvm-homogeneous``); the 4-shard float32
   ``make_shardmap_pcg_step`` for 10 steps within rtol 1e-4 of the
   unsharded fused step.

Kernel launches are counted from a reset just before each path (phases
4, 5, 7, 8, 9, each run of 10 and the sharded solve of 11) to a reading
just after it, graph replays included, and summed into the kernel
summary.  The line before the last is the
kernel summary ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  The script imports
neither JAX nor the reference package.

``python3 chip_smoke.py --times-only [--src DIR]`` runs phases 1-2 and
prints both timing columns of every kernel at the main path's shapes,
from the ``repro_torch`` under ``DIR`` (default ``src``): two checkouts
timed in one call compare on one card.
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
STORAGE_KILL_AT = 10
MAXITER = 30
REPS = 25
DEVICE = "cuda"
#: the erasure path's stripe: K data + P parity children
STRIPE = "erasure(nvm-prd x4+2p)"
K_DATA, NPARITY = 4, 2
#: recovery's local CG: two failed blocks of the 256^3 grid, nblocks=1
LOCAL_CG_N = 2 * GRID ** 3 // NBLOCKS
#: the stripes the small erasure check runs through every route
SMALL_STRIPES = ("erasure(nvm-prd x4+p)", "erasure(nvm-prd x4+2p)",
                 "erasure(nvm-prd x6+2p)")
#: phase 7: (solver, options, backend spec, resilience options,
#: iteration cap, failure iteration); the first event kills one
#: mirror's storage node where the spec is a mirror
ZOO_ITERS, ZOO_FAIL_AT = 20, 10
ZOO_CASES = (
    ("jacobi", {}, "replicated(nvm-prd x2)", {}, ZOO_ITERS, ZOO_FAIL_AT),
    ("chebyshev", {}, "tiered(nvm-prd)", {}, ZOO_ITERS, ZOO_FAIL_AT),
    ("bicgstab", {}, "esr", {"options": {"copies": 3}}, ZOO_ITERS,
     ZOO_FAIL_AT),
    ("gmres", {"m": 20}, "erasure(nvm-prd x4+p)", {"fused_persist": True},
     3, 2),
)
#: phase 8: the graph's chunk of PCG iterations
JIT_CHUNK = 32
#: phase 9: block-Jacobi PCG at test scale
BJ_GRID, BJ_NBLOCKS = 16, 8
#: phase 10: the multi-tenant service's PCG bucket (256^3, 4 lanes):
#: (tenant, grid, spec, persist mode, period, declared nshards); each
#: tenant has nblocks=8 and Jacobi preconditioning
SVC_LANES, SVC_MAXITER, SVC_NBLOCKS = 4, 30, 8
SVC_TENANTS = (
    ("t0", (256, 256, 256), "nvm-prd", "sync", 1, 1),
    ("t1", (240, 256, 256), "replicated(nvm-prd x2)", "overlap", 3, 1),
    ("t2", (200, 200, 200), "erasure(nvm-prd x4+p)", "sync", 3, 4),
    ("t3", (192, 256, 256), "nvm-homogeneous", "sync", 1, 1),
)
#: the cohabitant run (B) leaves alone, and the states it captures
SVC_COHABITANT, SVC_CAPTURE = "t3", (10, 25)
#: phase 10's BiCGStab bucket (128^3, 2 lanes): a lane step without K2
SVC_BICG_GRIDS = ((128, 128, 128), (96, 128, 128))
SVC_BICG_STEPS, SVC_BICG_FAIL_AT = 30, 15

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


def device_ms(torch, fn, reps: int = REPS, warmup: int = 3,
              windows: int = 3) -> float:
    """Device time of ``fn``: ``reps`` launches back to back between two
    CUDA events, over ``reps`` (the host enqueues ahead of the card, so
    its per-call work stays out of the window unless it is the longer);
    the median of ``windows`` such windows, so one stall of the shared
    host does not stand for the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def in_graph_ms(torch, fn, prepare=None, reps: int = REPS,
                windows: int = 3) -> float:
    """Device time of one call of ``fn`` inside a CUDA graph of ``reps``
    calls, so no call pays its host work (the median of ``windows``
    replays, over ``reps``).  ``prepare`` runs on the graph's stream
    after a warm-up call and before the capture; the graph keeps what
    it returns alive."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    times = []
    with torch.cuda.stream(stream):
        fn()
        keep = prepare() if prepare is not None else None  # noqa: F841
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
        graph.replay()
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
    torch.cuda.current_stream().wait_stream(stream)
    return statistics.median(times)


def both_ms(torch, fn):
    """(per-call median, device time) of ``fn``."""
    return time_ms(torch, fn), device_ms(torch, fn)


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
    ms, dev_ms = both_ms(torch, lambda: k1.stencil7_cuda(u))
    plain_ms = time_ms(torch, lambda: k1.stencil7_plain(u))
    # yardsticks: one cuDNN convolution with the 7-point weights, in
    # float64 (K1's own type) and in float32 (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros(1, 1, 3, 3, 3, device=dev, dtype=torch.float64)
    w[0, 0, 1, 1, 1] = 6.0
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[(0, 0) + idx] = -1.0
    conv64 = lambda: F.conv3d(u[None, None], w, padding=1)  # noqa: E731
    conv64_err = max_abs(conv64()[0, 0], got)
    library_ms, library_dev_ms = both_ms(torch, conv64)
    u32, w32 = u.float(), w.float()
    conv = lambda: F.conv3d(u32[None, None], w32, padding=1)  # noqa: E731
    k32 = k1.stencil7_cuda(u32)
    conv_err = max_abs(conv()[0, 0], k32)
    lib32_ms, lib32_dev_ms = both_ms(torch, conv)
    k32_ms, k32_dev_ms = both_ms(torch, lambda: k1.stencil7_cuda(u32))
    b_ms, b_by = bound_ms(2 * n * 8, 7 * n, "float64", rate)
    b32_ms, _ = bound_ms(2 * n * 4, 7 * n, "float32", rate)
    say("kernels", kernel="stencil7", kernel_ms=ms, kernel_device_ms=dev_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=library_dev_ms, library="conv3d float64",
        conv_vs_kernel_f64_max_abs_err=conv64_err, bound_ms=b_ms,
        bound_by=b_by, f32_kernel_ms=k32_ms, f32_kernel_device_ms=k32_dev_ms,
        f32_bound_ms=b32_ms, f32_library_ms=lib32_ms,
        f32_library_device_ms=lib32_dev_ms,
        f32_library="conv3d float32 (tf32 off)",
        conv_vs_kernel_f32_max_abs_err=conv_err)
    records["stencil7"] = dict(
        name="stencil7", route="cuda",
        source="src/repro_torch/kernels/csrc/stencil7.cu",
        replaces="src/repro/kernels/stencil7.py:53", max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        library_device_ms=library_dev_ms)
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
    # N2: the fused rz' and det_dot(r', z') share one rounding order, the
    # one det_dot_order_plain writes down
    same = k2.det_dot_cuda(got[1], got[2], NBLOCKS)
    check(bool(torch.equal(same, got[3])), "det_dot(r', z') != fused rz' bitwise")
    check(bool(torch.equal(k2.det_dot_order_plain(got[1], got[2], NBLOCKS),
                           got[3])), "fused rz' != det_dot_order_plain bitwise")
    say("kernels", kernel="fused_cg_update", rz_bitwise_det_dot=True,
        rz_bitwise_order_plain=True)
    ms, dev_ms = both_ms(torch, lambda: k2.fused_cg_update_cuda(
        x, r, p, ap, alpha, inv, NBLOCKS))
    plain_ms = time_ms(torch, lambda: k2.fused_cg_update_plain(x, r, p, ap, alpha, inv, NBLOCKS))
    b_ms, b_by = bound_ms(8 * n * 8, 7 * n, "float64", rate)
    say("kernels", kernel="fused_cg_update", kernel_ms=ms,
        kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
        library="no single PyTorch call computes it", bound_ms=b_ms,
        bound_by=b_by)
    records["fused_cg_update"] = dict(
        name="fused_cg_update", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:61",
        max_abs_err=max(vec_err, rz_err), ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_device_ms=None)

    # ---- det_dot (K2's reduction) at the main path's shape, and at the
    # ---- shape of recovery's local CG (two failed blocks, nblocks=1) ----
    dots = []
    for label, a, b, nb in (("256^3/8", p, ap, NBLOCKS),
                            ("local CG", p[:LOCAL_CG_N], ap[:LOCAL_CG_N], 1)):
        got_d = k2.det_dot_cuda(a, b, nb)
        order = k2.det_dot_order_plain(a, b, nb)
        want_d = k2.block_dot_plain(a, b, nb)
        torch.cuda.synchronize()
        check(bool(torch.equal(got_d, order)),
              f"det_dot != det_dot_order_plain bitwise at {label}")
        d_err = max_abs(got_d, want_d)
        d_tol = 1e-12 * float((a * b).abs().sum())
        check(d_err <= d_tol, f"det_dot error {d_err} > {d_tol} at {label}")
        ms, dev_ms = both_ms(torch, lambda: k2.det_dot_cuda(a, b, nb))
        plain_ms = time_ms(torch, lambda: k2.block_dot_plain(a, b, nb))
        lib_ms, lib_dev_ms = both_ms(torch, lambda: torch.dot(a, b))
        m = a.numel()
        b_ms, b_by = bound_ms(2 * m * 8, 2 * m, "float64", rate)
        dots.append(dict(shape=label, n=m, nblocks=nb, max_abs_err=d_err,
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_device_ms=lib_dev_ms,
                         bound_ms=b_ms, bound_by=b_by))
        say("kernels", kernel="det_dot", dtype="float64", shape=label, n=m,
            nblocks=nb, bitwise_order_plain=True, max_abs_err_vs_block_sum=d_err,
            tol=d_tol, kernel_ms=ms, kernel_device_ms=dev_ms,
            plain_ms=plain_ms, library_ms=lib_ms,
            library_device_ms=lib_dev_ms, library="torch.dot",
            bound_ms=b_ms, bound_by=b_by)
    main_dot = {k: v for k, v in dots[0].items()
                if k not in ("shape", "n", "nblocks")}
    records["det_dot"] = dict(
        name="det_dot", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:58", **main_dot,
        local_cg=dots[1])
    del x, r, p, ap, inv, got, want

    # ---- K3 on the 256^3 p's four stripe chunks ------------------------
    from repro_torch.kernels import gf256_encode as k3

    pvec = randn(n)
    data = k2.stripe_bytes(pvec.reshape(NBLOCKS, K_DATA, -1))
    k3_times = {}
    for nparity in (NPARITY, 1):
        got = k3.gf256_rs_encode_cuda(data, nparity)
        want = k3.gf256_rs_encode_plain(data, nparity)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)),
              f"gf256_rs_encode P={nparity} != plain at 256^3")
        ms, dev_ms = both_ms(torch, lambda: k3.gf256_rs_encode_cuda(data, nparity))
        k3_bytes = (K_DATA + nparity) * data.shape[1]
        b_ms, b_by = bound_ms(k3_bytes, 0, "float64", rate)
        k3_times[nparity] = dict(ms=ms, device_ms=dev_ms, bound_ms=b_ms,
                                 bound_by=b_by)
        say("kernels", kernel="gf256_rs_encode", shards=list(data.shape),
            nparity=nparity, bitwise_equal=True, kernel_ms=ms,
            kernel_device_ms=dev_ms, bytes=k3_bytes, bound_ms=b_ms,
            bound_by=b_by)
    plain_ms = time_ms(torch, lambda: k3.gf256_rs_encode_plain(data, NPARITY))
    say("kernels", kernel="gf256_rs_encode", nparity=NPARITY,
        plain_ms=plain_ms, library_ms=None,
        library="no single PyTorch call computes it")
    records["gf256_rs_encode"] = dict(
        name="gf256_rs_encode", route="cuda",
        source="src/repro_torch/kernels/csrc/gf256_encode.cu",
        replaces="src/repro/kernels/gf256_encode.py:93", max_abs_err=0.0,
        **k3_times[NPARITY], plain_ms=plain_ms, library_ms=None,
        library_device_ms=None, p1=k3_times[1])
    # small ragged cases, all-zero and all-0xFF shards
    cpu_gen = torch.Generator().manual_seed(1)
    for k_data in (2, 3, 6):
        for nparity in (1, 2):
            for length in (1, 7, 1023, 8205):
                shards = torch.randint(0, 256, (k_data, length),
                                       generator=cpu_gen,
                                       dtype=torch.uint8).to(dev)
                shards[0].zero_()
                shards[-1].fill_(0xFF)
                check(bool(torch.equal(
                    k3.gf256_rs_encode_cuda(shards, nparity),
                    k3.gf256_rs_encode_plain(shards, nparity))),
                    f"gf256_rs_encode K={k_data} P={nparity} L={length}")
    say("kernels", kernel="gf256_rs_encode", ragged_cases=24,
        bitwise_equal=True)
    # unaligned shards: the tensor starts 0-15 bytes off a 16-byte
    # boundary and rows are not multiples of 16 long
    cases = 0
    for k_data in (1, 16, 255):
        for length in (1000, 4099):
            buf = torch.randint(0, 256, (k_data * length + 16,),
                                generator=cpu_gen, dtype=torch.uint8).to(dev)
            for offset in range(16):
                shards = buf[offset:offset + k_data * length].view(k_data, length)
                for nparity in (1, 2):
                    check(bool(torch.equal(
                        k3.gf256_rs_encode_cuda(shards, nparity),
                        k3.gf256_rs_encode_plain(shards, nparity))),
                        f"gf256_rs_encode K={k_data} P={nparity} L={length} "
                        f"offset={offset}")
                    cases += 1
    say("kernels", kernel="gf256_rs_encode", unaligned_cases=cases,
        bitwise_equal=True)

    # ---- K4 at the main path's shape, float64, K=4, P=2 ----------------
    x, r, ap = (randn(n) for _ in range(3))
    inv = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) + 0.5
    args = (x, r, pvec, ap, alpha, inv, NBLOCKS, K_DATA, NPARITY)
    got = k2.fused_cg_update_persist_cuda(*args)
    k2_out = k2.fused_cg_update_cuda(x, r, pvec, ap, alpha, inv, NBLOCKS)
    want = k2.fused_cg_update_persist_plain(*args)
    k3_cut = k3.gf256_rs_encode_cuda(data, NPARITY)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(g, w)) for g, w in zip(got[:4], k2_out)),
          "fused_cg_update_persist update != fused_cg_update bitwise")
    check(bool(torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])),
          "fused_cg_update_persist chunks/parity != plain")
    check(bool(torch.equal(got[5].transpose(0, 1).reshape(NPARITY, -1),
                           k3_cut)),
          "fused_cg_update_persist parity != gf256_rs_encode of the cut")
    vec_err = max(max_abs(g, w_) for g, w_ in zip(got[:3], want[:3]))
    say("kernels", kernel="fused_cg_update_persist", dtype="float64", n=n,
        nblocks=NBLOCKS, k_data=K_DATA, nparity=NPARITY,
        update_bitwise_k2=True, stripe_bitwise_plain=True,
        parity_bitwise_k3=True, vec_max_abs_err_vs_plain=vec_err)
    ms, dev_ms = both_ms(torch, lambda: k2.fused_cg_update_persist_cuda(*args))
    plain_ms = time_ms(torch, lambda: k2.fused_cg_update_persist_plain(*args))
    k2_ms, k2_dev_ms = both_ms(torch, lambda: k2.fused_cg_update_cuda(
        x, r, pvec, ap, alpha, inv, NBLOCKS))
    traffic = k2.fused_pass_traffic(n, 8, K_DATA, NPARITY)
    b_ms, b_by = bound_ms(traffic["total_bytes"], 7 * n, "float64", rate)
    say("kernels", kernel="fused_cg_update_persist", kernel_ms=ms,
        kernel_device_ms=dev_ms, plain_ms=plain_ms,
        k2_kernel_ms_same_call=k2_ms, k2_kernel_device_ms_same_call=k2_dev_ms,
        library_ms=None, library="no single PyTorch call computes it",
        bytes=traffic["total_bytes"], bound_ms=b_ms, bound_by=b_by)
    records["fused_cg_update_persist"] = dict(
        name="fused_cg_update_persist", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:171", max_abs_err=vec_err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, library_device_ms=None)
    del x, r, ap, inv, pvec, data, got, want, k2_out, args

    # ---- K4 small float32 (K2's float32 tolerances vs plain) -----------
    m4 = 4 * 6 * 1000
    vs = [randn(m4, dtype=torch.float32) for _ in range(5)]
    a32 = torch.tensor(0.37, dtype=torch.float32, device=dev)
    got = k2.fused_cg_update_persist_cuda(*vs[:4], a32, vs[4], 4, 6, 2)
    want = k2.fused_cg_update_persist_plain(*vs[:4], a32, vs[4], 4, 6, 2)
    same_k2 = k2.fused_cg_update_cuda(*vs[:4], a32, vs[4], 4)
    e = max(max_abs(g, w_) for g, w_ in zip(got[:3], want[:3]))
    check(e <= 2e-5 and all(bool(torch.equal(g, w_))
                            for g, w_ in zip(got[:4], same_k2))
          and bool(torch.equal(got[4], want[4]))
          and bool(torch.equal(got[5], want[5])),
          f"fused_cg_update_persist f32 error {e}")
    say("kernels", kernel="fused_cg_update_persist", dtype="float32", n=m4,
        k_data=6, nparity=2, max_abs_err=e, tol=2e-5,
        update_bitwise_k2=True, stripe_bitwise_plain=True)

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
    records.update(lane_kernels(torch, rate, records))
    return records


def lane_kernels(torch, rate: float, records: dict) -> dict:
    """The lane modes of K2 and det_dot (the service's bucket step) at
    SVC_LANES x 256^3 float64: each lane bitwise a solo nblocks=1 launch
    on it, the bucket against the plain lane version, both timing
    columns beside the bound; K1 on the bucket's (lanes, 256, 256, 256)
    grids beside its bound (added to K1's record).  Returns the two lane
    kernels' records."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import stencil7 as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    lanes, n = SVC_LANES, GRID ** 3
    total = lanes * n

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64)

    # ---- K1 on the bucket's stacked grids ------------------------------
    u = randn(lanes, GRID, GRID, GRID)
    got = k1.stencil7_cuda(u)
    want = k1.stencil7_plain(u)
    err = max_abs(got, want)
    tol = 1e-12 * max(1.0, float(want.abs().max()))
    check(err <= tol, f"stencil7 on {lanes} lanes: error {err} > {tol}")
    ms, dev_ms = both_ms(torch, lambda: k1.stencil7_cuda(u))
    b_ms, b_by = bound_ms(2 * total * 8, 7 * total, "float64", rate)
    # the yardstick: one cuDNN convolution over the lanes as a batch
    w = torch.zeros(1, 1, 3, 3, 3, device=dev, dtype=torch.float64)
    w[0, 0, 1, 1, 1] = 6.0
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[(0, 0) + idx] = -1.0
    conv = lambda: F.conv3d(u[:, None], w, padding=1)  # noqa: E731
    conv_err = max_abs(conv()[:, 0], got)
    lib_ms, lib_dev_ms = both_ms(torch, conv)
    say("kernels", kernel="stencil7", shape=[lanes] + [GRID] * 3,
        max_abs_err=err, tol=tol, kernel_ms=ms, kernel_device_ms=dev_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library_device_ms=lib_dev_ms, library="conv3d float64, batch of "
        "lanes", conv_vs_kernel_max_abs_err=conv_err)
    records["stencil7"]["lanes"] = dict(shape=[lanes] + [GRID] * 3, ms=ms,
                                        device_ms=dev_ms, bound_ms=b_ms,
                                        max_abs_err=err, library_ms=lib_ms,
                                        library_device_ms=lib_dev_ms)
    del u, got, want, w

    # ---- K2 lane mode ---------------------------------------------------
    x, r, p, ap = (randn(lanes, n) for _ in range(4))
    inv = torch.rand(lanes, n, generator=gen, device=dev,
                     dtype=torch.float64) + 0.5
    alpha = torch.rand(lanes, generator=gen, device=dev,
                       dtype=torch.float64) + 0.1
    got = k2.fused_cg_update_lanes_cuda(x, r, p, ap, alpha, inv)
    for i in range(lanes):
        solo = k2.fused_cg_update_cuda(x[i], r[i], p[i], ap[i], alpha[i],
                                       inv[i], 1)
        check(all(bool(torch.equal(g[i], s_)) for g, s_ in zip(got, solo)),
              f"fused_cg_update_lanes lane {i} != a solo nblocks=1 launch")
    check(bool(torch.equal(k2.det_dot_order_plain(got[1][0], got[2][0]),
                           got[3][0])),
          "fused_cg_update_lanes rz'[0] != det_dot_order_plain bitwise")
    want = k2.fused_cg_update_lanes_plain(x, r, p, ap, alpha, inv)
    torch.cuda.synchronize()
    vec_err = max(max_abs(g, w_) for g, w_ in zip(got[:3], want[:3]))
    vec_tol = 1e-12 * max(1.0, max(float(t.abs().max()) for t in want[:3]))
    rz_err = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    check(vec_err <= vec_tol and rz_err <= 1e-12,
          f"fused_cg_update_lanes vs plain: vec {vec_err} rz {rz_err}")
    ms, dev_ms = both_ms(torch, lambda: k2.fused_cg_update_lanes_cuda(
        x, r, p, ap, alpha, inv))
    plain_ms = time_ms(torch, lambda: k2.fused_cg_update_lanes_plain(
        x, r, p, ap, alpha, inv))
    b_ms, b_by = bound_ms(8 * total * 8, 7 * total, "float64", rate)
    say("kernels", kernel="fused_cg_update_lanes", lanes=lanes, n=n,
        lanes_bitwise_solo_nblocks1=True, rz0_bitwise_order_plain=True,
        vec_max_abs_err=vec_err, vec_tol=vec_tol, rz_max_rel_err=rz_err,
        rz_tol=1e-12, kernel_ms=ms, kernel_device_ms=dev_ms,
        plain_ms=plain_ms, library_ms=None,
        library="no single PyTorch call computes it", bound_ms=b_ms,
        bound_by=b_by)
    out = {"fused_cg_update_lanes": dict(
        name="fused_cg_update_lanes", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:61",
        max_abs_err=max(vec_err, float((got[3] - want[3]).abs().max())),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, library_device_ms=None)}
    del got, want, solo, x, r, inv

    # ---- det_dot lane mode ----------------------------------------------
    dots = k2.det_dot_lanes_cuda(p, ap)
    for i in range(lanes):
        check(bool(torch.equal(dots[i], k2.det_dot_cuda(p[i], ap[i], 1))),
              f"det_dot_lanes lane {i} != a solo nblocks=1 launch")
    want = k2.det_dot_lanes_plain(p, ap)
    torch.cuda.synchronize()
    d_err = max_abs(dots, want)
    d_tol = 1e-12 * float((p * ap).abs().sum(dim=1).max())
    check(d_err <= d_tol, f"det_dot_lanes error {d_err} > {d_tol}")
    ms, dev_ms = both_ms(torch, lambda: k2.det_dot_lanes_cuda(p, ap))
    plain_ms = time_ms(torch, lambda: k2.det_dot_lanes_plain(p, ap))
    vecdot = lambda: torch.linalg.vecdot(p, ap)  # noqa: E731
    lib_err = max_abs(vecdot(), dots)
    lib_ms, lib_dev_ms = both_ms(torch, vecdot)
    b_ms, b_by = bound_ms(2 * total * 8, 2 * total, "float64", rate)
    say("kernels", kernel="det_dot_lanes", lanes=lanes, n=n,
        lanes_bitwise_solo_nblocks1=True, max_abs_err=d_err, tol=d_tol,
        kernel_ms=ms, kernel_device_ms=dev_ms, plain_ms=plain_ms,
        library_ms=lib_ms, library_device_ms=lib_dev_ms,
        library="torch.linalg.vecdot", vecdot_vs_kernel_max_abs_err=lib_err,
        bound_ms=b_ms, bound_by=b_by)
    out["det_dot_lanes"] = dict(
        name="det_dot_lanes", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_cg.cu",
        replaces="src/repro/kernels/fused_cg.py:58", max_abs_err=d_err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms)
    del p, ap, dots, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


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
    recovered = {"free": (plain.state.x, plain.state.r)}
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
        recovered[mode] = (res.state.x, res.state.r)
        del res
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    say("main", launches=counts)
    for name in ("stencil7", "fused_cg_update", "det_dot"):
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    iteration_breakdown(torch, problem, base.state.p, plain_wall / MAXITER)
    del plain, base
    return counts, problem, recovered


def _campaign(api, nparity: int):
    """A storage-only PRD kill at 10, then blocks (1, 2) failing at
    FAIL_AT with a second PRD kill when the stripe has two parities."""
    return api.FailureCampaign((
        api.FailureEvent(at_iteration=STORAGE_KILL_AT, prd=True),
        api.FailureEvent(blocks=(1, 2), at_iteration=FAIL_AT,
                         prd=nparity == 2),
    ))


def erasure_breakdown(torch, problem, p):
    """Where a fused erasure event's host time goes: K3's device encode
    plus the one device-to-host copy of the K+P shards, against the six
    children's persist writes (slot encode, CRC, simulated PRD stores)."""
    from repro_torch.solvers.registry import make_backend

    session = make_backend(STRIPE, problem.op).open_session()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        host = session._device_bytes(p).cpu()
    encode_d2h_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for k in range(reps):
        session.persist(k, {"beta": 0.5}, {"p": p})
        session.drain()
    event_s = (time.perf_counter() - t0) / reps
    say("erasure", breakdown="seconds per fused sync event", event_s=event_s,
        k3_encode_and_d2h_s=encode_d2h_s, d2h_bytes=host.numel(),
        children_persist_s=event_s - encode_d2h_s)


def phase_erasure(torch, problem, recovered):
    """The erasure-coded stripe with the fused persist path at full width,
    and its routes against each other at 64^3; returns the launch counts
    of the two 256^3 solves."""
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, check_trace_report

    spec = api.SolverSpec("pcg", tol=1e-10, maxiter=MAXITER)
    free_x, free_r = recovered["free"]
    n = problem.b.numel()
    ops.reset_launch_counts()
    for mode in ("overlap", "sync"):
        tracer = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(problem, spec,
                        api.ResilienceSpec(STRIPE, persist_mode=mode,
                                           fused_persist=True),
                        failures=_campaign(api, NPARITY), tracer=tracer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = res.report
        check_trace_report(tracer, rep)
        routes = rep.metrics.counter_by_label("persist.route", "route")
        d2h = rep.metrics.counter_total("persist.d2h_bytes")
        writes = sum(routes.values())
        say("erasure", run=f"{STRIPE} fused {mode}", iterations=rep.iterations,
            wall_s=wall, s_per_iteration=wall / max(rep.iterations, 1),
            relres=rep.final_relres, failures_recovered=rep.failures_recovered,
            storage_failures=rep.storage_failures,
            persist_events=rep.persist_events,
            persist_aborts=rep.persist_aborts, persist_routes=routes,
            d2h_bytes_per_event=d2h / max(writes, 1),
            nvm_prd_d2h_bytes_per_event=n * 8,
            persist_bytes=rep.persist_bytes,
            recovery_fetch_bytes=rep.recovery_fetch_bytes,
            wasted_iterations=rep.wasted_iterations,
            recovery_s=_recovery_seconds(tracer))
        check(rep.failures_recovered == 1 and rep.storage_failures == 2,
              f"erasure {mode}: recovered {rep.failures_recovered}, storage "
              f"kills {rep.storage_failures}")
        check(res.iterations == MAXITER, f"erasure {mode}: k={res.iterations}")
        check("K4" in routes if mode == "overlap" else set(routes) == {"K3"},
              f"erasure {mode}: persist routes {routes}")
        for what, got, want in (("final x", res.state.x, free_x),
                                ("final r", res.state.r, free_r)):
            ok = bool(torch.allclose(got, want, rtol=1e-8, atol=1e-8))
            say("erasure", mode=mode, check=what, vs="failure-free run",
                max_abs_err=max_abs(got, want), rtol=1e-8, atol=1e-8, ok=ok)
            check(ok, f"erasure {mode}: {what} differs from the failure-free run")
        prd_x, prd_r = recovered[mode]
        say("erasure", mode=mode, vs=f"nvm-prd {mode} recovered run",
            x_bitwise_equal=bool(torch.equal(res.state.x, prd_x)),
            r_bitwise_equal=bool(torch.equal(res.state.r, prd_r)),
            x_max_abs_diff=max_abs(res.state.x, prd_x))
        del res
    torch.cuda.synchronize()
    counts = ops.launch_counts()  # the two 256^3 solves' launches only
    say("erasure", launches=counts)
    for name in ("gf256_rs_encode", "fused_cg_update_persist"):
        check(counts[name] > 0, f"kernel {name} never launched on the "
              f"erasure path")
    erasure_breakdown(torch, problem, problem.b)

    # ---- 64^3: the numpy and fused routes, bitwise equal ----------------
    small = api.Problem.poisson(64, nblocks=8, device=DEVICE)
    for stripe in SMALL_STRIPES:
        nparity = 2 if "+2p" in stripe else 1
        for mode in ("sync", "overlap"):
            runs = {}
            for fused in (False, True):
                res = api.solve(small, spec,
                                api.ResilienceSpec(stripe, persist_mode=mode,
                                                   fused_persist=fused),
                                failures=_campaign(api, nparity))
                check(res.report.failures_recovered == 1,
                      f"64^3 {stripe} {mode} fused={fused} not recovered")
                runs[fused] = res
            same = all(bool(torch.equal(getattr(runs[True].state, f),
                                        getattr(runs[False].state, f)))
                       for f in ("x", "r", "p"))
            say("erasure", grid=[64] * 3, stripe=stripe, mode=mode,
                numpy_vs_fused_bitwise=same,
                fused_routes=runs[True].report.metrics.counter_by_label(
                    "persist.route", "route"))
            check(same, f"64^3 {stripe} {mode}: fused != numpy route")
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


def phase_zoo(torch, problem):
    """Each zoo solver at full width on its own backend, failure-free and
    with blocks (1, 2) failing; returns the launch counts."""
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer

    totals = {}
    for solver, opts, backend, res_opts, maxiter, fail_at in ZOO_CASES:
        spec = api.SolverSpec(solver, tol=1e-10, maxiter=maxiter,
                              options=opts)
        resilience = api.ResilienceSpec(backend, **res_opts)
        events = [api.FailureEvent(blocks=(1, 2), at_iteration=fail_at)]
        if backend.startswith("replicated"):
            events.insert(0, api.FailureEvent(at_iteration=fail_at // 2,
                                              prd=True))
        runs = {}
        ops.reset_launch_counts()
        for label, failures, tracer in (("failure-free", (), None),
                                        ("blocks (1, 2) fail", events,
                                         Tracer())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api.solve(problem, spec, resilience, failures=failures,
                            tracer=tracer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rep = res.report
            say("zoo", solver=solver, backend=backend, run=label,
                iterations=rep.iterations, wall_s=wall,
                s_per_iteration=wall / max(rep.iterations, 1),
                relres=rep.final_relres,
                failures_recovered=rep.failures_recovered,
                storage_failures=rep.storage_failures,
                persist_events=rep.persist_events,
                wasted_iterations=rep.wasted_iterations,
                recovery_s=None if tracer is None else _recovery_seconds(tracer))
            runs[label] = res
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        free, hit = runs["failure-free"], runs["blocks (1, 2) fail"]
        err = max_abs(hit.state.x, free.state.x)
        ok = bool(torch.allclose(hit.state.x, free.state.x, rtol=1e-8,
                                 atol=1e-8))
        say("zoo", solver=solver, backend=backend, launches=counts,
            x_vs_failure_free_max_abs_err=err, rtol=1e-8, atol=1e-8, ok=ok)
        check(hit.report.failures_recovered == 1,
              f"zoo {solver}: failures_recovered="
              f"{hit.report.failures_recovered}")
        check(hit.iterations == free.iterations == maxiter,
              f"zoo {solver}: k={hit.iterations} vs {free.iterations}")
        check(ok, f"zoo {solver}: recovered x differs from the failure-free "
              f"run by {err}")
        needed = ("stencil7", "det_dot") + (
            ("gf256_rs_encode",) if "fused_persist" in res_opts else ())
        for name in needed:
            check(counts[name] > 0, f"zoo {solver}: kernel {name} never "
                  f"launched")
        for name, count in counts.items():
            totals[name] = totals.get(name, 0) + count
        del runs, free, hit, res
        torch.cuda.empty_cache()
    return totals


def phase_jit(torch, problem, records):
    """solve_jit's CUDA graph against the driver's unprotected loop at
    the same k; returns the launch counts."""
    from repro_torch import api
    from repro_torch.core import solve_jit
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, k = solve_jit(problem.op, problem.precond, problem.b, tol=1e-10,
                     chunk=JIT_CHUNK, info=info)
    torch.cuda.synchronize()
    jit_wall = time.perf_counter() - t0
    check(info["graph"], "solve_jit did not capture a CUDA graph")
    t0 = time.perf_counter()
    driver = api.solve(problem, api.SolverSpec("pcg", tol=0.0, maxiter=k))
    torch.cuda.synchronize()
    driver_wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    same = bool(torch.equal(x, driver.state.x))
    replayed = info["chunks"] * info["chunk"]
    graph_ms = 1e3 * info["chunk_s"] / replayed
    kernels_ms = (records["stencil7"]["device_ms"]
                  + records["fused_cg_update"]["device_ms"]
                  + 2 * records["det_dot"]["device_ms"])
    relres = float(torch.linalg.vector_norm(
        problem.b - problem.op.apply(x)) / torch.linalg.vector_norm(problem.b))
    say("jit", k=k, chunk=info["chunk"], chunks_replayed=info["chunks"],
        launches_per_chunk=info["launches_per_chunk"],
        eager_iterations=info["eager_iterations"],
        capture_s=info["capture_s"], wall_s=jit_wall,
        graph_ms_per_iteration=graph_ms,
        driver_iterations=driver.iterations,
        driver_ms_per_iteration=1e3 * driver_wall / k,
        kernels_device_ms_per_iteration=kernels_ms,
        kernels="K1 + K2 + 2 det_dot device_ms (phase 3)", relres=relres,
        x_bitwise_driver=same, launches=counts)
    check(driver.iterations == k, f"driver ran {driver.iterations} != {k}")
    check(same, "solve_jit's x is not bitwise the driver's at the same k")
    check(relres < 1e-9, f"solve_jit relres {relres}")
    for name in ("stencil7", "fused_cg_update", "det_dot"):
        check(info["launches_per_chunk"][name] > 0,
              f"the graph holds no {name} launch")
    del x, driver

    # det_dot's per-call time with the host work gone: inside a graph
    from repro_torch.kernels import fused_cg as k2

    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = (torch.randn(GRID ** 3, generator=gen, device="cuda",
                        dtype=torch.float64) for _ in range(2))
    graph_dots = {}
    for label, u, v, nb in (("256^3/8", a, b, NBLOCKS),
                            ("local CG", a[:LOCAL_CG_N], b[:LOCAL_CG_N], 1)):
        graph_dots[label] = dict(
            det_dot_in_graph_ms=in_graph_ms(
                torch, lambda: k2.det_dot_cuda(u, v, nb),
                prepare=lambda: k2.workspace(u, nb).reserve_scalars(
                    torch.float64, REPS)),
            torch_dot_in_graph_ms=in_graph_ms(torch, lambda: torch.dot(u, v)))
    say("jit", in_graph=graph_dots)
    records["det_dot"].update(in_graph_ms=graph_dots["256^3/8"][
        "det_dot_in_graph_ms"], local_cg_in_graph=graph_dots["local CG"])
    del a, b
    torch.cuda.empty_cache()
    return counts


def phase_advise(torch, problem):
    """The spec advisor at full width and block-Jacobi PCG at test scale
    against the CPU; returns the launch counts."""
    from repro_torch import api
    from repro_torch.convert import problem_from_numpy
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    campaigns = {
        "single block": [api.FailureEvent(blocks=(1,), at_iteration=6)],
        "double PRD loss": api.FailureCampaign((
            api.FailureEvent(blocks=(1,), at_iteration=6, prd=True),
            api.FailureEvent(blocks=(2,), at_iteration=10, prd=True))),
    }
    chosen = {}
    for label, campaign in campaigns.items():
        t0 = time.perf_counter()
        advice = api.advise(problem, campaign)
        say("advise", grid=[GRID] * 3, campaign=label, chosen=advice.chosen,
            seconds=time.perf_counter() - t0,
            ranked=[[r.spec, r.storage_values, r.persist_cost_s]
                    for r in advice.ranked],
            rejected=[r.spec for r in advice.rejected])
        chosen[label] = advice.chosen
    check(chosen["double PRD loss"] == "erasure(nvm-prd x6+2p)",
          f"double-PRD-loss advice {chosen['double PRD loss']}")
    check(chosen["single block"] is not None, "no spec survives one block")

    card = api.Problem.poisson(BJ_GRID, nblocks=BJ_NBLOCKS,
                               preconditioner="block_jacobi", device=DEVICE)
    # the same problem on the CPU, from the card's right-hand side
    host = problem_from_numpy(card.op.grid, BJ_NBLOCKS, card.b.cpu().numpy(),
                              "block_jacobi", device="cpu")
    spec = api.SolverSpec("pcg", tol=1e-10)
    failure = [api.FailureEvent(blocks=(1, 2), at_iteration=5)]
    runs = [api.solve(p, spec, "nvm-prd", failures=failure)
            for p in (card, host)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    got, want = runs[0].state.x.cpu(), runs[1].state.x
    ok = bool(torch.allclose(got, want, rtol=1e-10, atol=1e-10))
    say("block_jacobi", scale="test scale: dense per-block Cholesky factors",
        grid=[BJ_GRID] * 3, nblocks=BJ_NBLOCKS,
        iterations=runs[0].iterations, cpu_iterations=runs[1].iterations,
        converged=runs[0].converged,
        failures_recovered=runs[0].report.failures_recovered,
        vs_cpu_max_abs_err=max_abs(got, want), rtol=1e-10, atol=1e-10,
        ok=ok, launches=counts)
    check(ok and runs[0].iterations == runs[1].iterations
          and runs[0].converged, "block-Jacobi PCG on the card != the CPU")
    return counts


def _timed_service(torch, lanes: int):
    """A ``SolveService`` that records, per bucket step, the device time
    of the batched step between two CUDA events, the host seconds of the
    loop-top passes before it (recoveries included) and each tenant's
    host seconds after it (its overlap commit and persist point)."""
    from repro_torch.serving.solve_service import ServiceConfig, SolveService

    class TimedService(SolveService):
        def __init__(self):
            super().__init__(ServiceConfig(lanes=lanes, device=DEVICE))
            self.steps = []
            self._pre_s = 0.0

        def _admit(self):
            super()._admit()
            for bucket in self._buckets.values():
                if not hasattr(bucket, "untimed_step"):
                    bucket.untimed_step = bucket.step
                    bucket.step = self._timed(bucket.untimed_step)

        def _timed(self, step):
            def run(states, lane_data):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(states, lane_data)
                end.record()
                self.steps.append(dict(events=(start, end),
                                       pre_s=self._pre_s, post_s={}))
                self._pre_s = 0.0
                return out
            return run

        def _pre_step(self, bucket, i, t):
            t0 = time.perf_counter()
            super()._pre_step(bucket, i, t)
            self._pre_s += time.perf_counter() - t0

        def _post_step(self, bucket, i, t, window):
            t0 = time.perf_counter()
            super()._post_step(bucket, i, t, window)
            self.steps[-1]["post_s"][t.name] = time.perf_counter() - t0

    return TimedService()


def _serve_bucket(torch, label, tenants, failures, lanes, capture=None):
    """Submit ``tenants`` ((name, problem, solver spec, resilience spec,
    nshards) each) to a timed service, with ``failures`` and the states
    to capture (``capture``) by tenant name, drain it, print every
    bucket step and a summary; returns (tickets, launch counts, bucket
    steps, wall seconds).  The counts run from a reset just before the first
    submission (the lane inits' K1 included) to a reading after the
    drain."""
    from repro_torch.kernels import ops

    svc = _timed_service(torch, lanes)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = {name: svc.submit(problem, spec, resilience,
                                failures=failures.get(name, ()),
                                tenant=name, nshards=nshards,
                                capture_states_at=(capture or {}).get(
                                    name, ()))
               for name, problem, spec, resilience, nshards in tenants}
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    device_ms, pre_s, post_s = [], 0.0, {}
    for i, rec in enumerate(svc.steps):
        start, end = rec["events"]
        ms = start.elapsed_time(end)
        device_ms.append(ms)
        pre_s += rec["pre_s"]
        for name, sec in rec["post_s"].items():
            post_s[name] = post_s.get(name, 0.0) + sec
        say("service", run=label, bucket_step=i, device_ms=ms,
            host_pre_ms=1e3 * rec["pre_s"],
            host_post_ms=1e3 * sum(rec["post_s"].values()),
            persist_s=rec["post_s"])
    steps = len(svc.steps)
    say("service", run=label, summary=True, wall_s=wall, bucket_steps=steps,
        device_ms_total=sum(device_ms),
        device_ms_median=statistics.median(device_ms),
        device_busy_share_of_wall=sum(device_ms) / 1e3 / wall,
        host_pre_s_total=pre_s, persist_s_total=post_s,
        tenants={name: dict(iterations=t.result.iterations,
                            relres=t.result.relres,
                            failures_recovered=t.result.report
                            .failures_recovered,
                            storage_failures=t.result.report.storage_failures,
                            wasted_iterations=t.result.report
                            .wasted_iterations,
                            persist_events=t.result.report.persist_events,
                            persist_bytes_by_shard=t.result.report
                            .persist_bytes_by_shard,
                            recovery_fetch_bytes_by_shard=t.result.report
                            .recovery_fetch_bytes_by_shard,
                            lane_steps=t.result.report.service_lane_steps,
                            occupancy=t.result.report.service_batch_occupancy)
                 for name, t in tickets.items()},
        launches=counts)
    for name, t in tickets.items():
        check(t.accepted and t.result is not None,
              f"{label}: tenant {name} was not served")
        check(bool(torch.isfinite(t.result.state.x).all()),
              f"{label}: tenant {name} has non-finite x")
    check(steps > 0 and counts["fused_cg_update_lanes"] in (0, steps)
          and counts["stencil7"] >= steps,
          f"{label}: launches {counts} against {steps} bucket steps")
    return tickets, counts, steps, wall


def phase_service(torch):
    """The multi-tenant service on the card at full width: one 4-lane
    PCG bucket of 256^3 (runs A: no failures, B: block, PRD and shard
    kills of three tenants, C: the untouched cohabitant alone) and a
    2-lane BiCGStab bucket of 128^3 with a block kill; returns the
    launch counts of all five runs."""
    from repro_torch import api

    t_phase = time.perf_counter()
    spec = api.SolverSpec("pcg", tol=1e-10, maxiter=SVC_MAXITER)
    tenants = []
    for name, grid, backend, mode, period, nshards in SVC_TENANTS:
        problem = api.Problem.poisson(*grid, nblocks=SVC_NBLOCKS,
                                      device=DEVICE)
        tenants.append((name, problem, spec,
                        api.ResilienceSpec(backend, persist_mode=mode,
                                           period=period), nshards))
    kills = {
        "t0": (api.FailureEvent(blocks=(1, 2), at_iteration=20),),
        "t1": (api.FailureEvent(blocks=(5,), at_iteration=10, prd=True),),
        "t2": (api.FailureEvent(shard=2, at_iteration=15),),
    }
    runs, totals = {}, {}
    for label, members, failures in (
            ("A: four tenants, no failure", tenants, {}),
            ("B: t0 blocks (1, 2) at 20, t1 PRD + block 5 at 10, "
             "t2 shard 2 of 4 at 15", tenants, kills),
            ("C: t3 alone", [t for t in tenants
                             if t[0] == SVC_COHABITANT], {})):
        tickets, counts, steps, _ = _serve_bucket(
            torch, label, members, failures, SVC_LANES,
            {SVC_COHABITANT: SVC_CAPTURE})
        check(counts["fused_cg_update_lanes"] == counts["det_dot_lanes"]
              == steps, f"{label}: K2 lanes {counts['fused_cg_update_lanes']}"
              f", det_dot lanes {counts['det_dot_lanes']}, bucket steps "
              f"{steps}: not one launch each a bucket step")
        runs[label[0]] = (tickets, counts, steps)
        for name, count in counts.items():
            totals[name] = totals.get(name, 0) + count
    (a, a_counts, a_steps), (b, b_counts, b_steps), (c, _, _) = (
        runs["A"], runs["B"], runs["C"])
    check(a_counts["stencil7"] == a_steps + len(SVC_TENANTS),
          f"run A: {a_counts['stencil7']} K1 launches, {a_steps} bucket "
          f"steps + {len(SVC_TENANTS)} lane inits")

    # the cohabitant: bitwise its failure-free run and its run alone
    cohab = {k: v[SVC_COHABITANT].result for k, v in
             (("A", a), ("B", b), ("C", c))}
    for other in ("B", "C"):
        got, want = cohab[other], cohab["A"]
        same_x = bool(torch.equal(got.state.x, want.state.x))
        same_captured = all(
            all(bool(torch.equal(g, w)) if isinstance(g, torch.Tensor)
                else g == w for g, w in zip(got.captured[k],
                                            want.captured[k]))
            for k in SVC_CAPTURE)
        same_history = (got.report.residual_history
                        == want.report.residual_history)
        say("service", check=f"{SVC_COHABITANT} in run {other} vs run A",
            x_bitwise=same_x, captured_bitwise=same_captured,
            captured_at=list(SVC_CAPTURE), residual_history_equal=same_history,
            iterations=[got.iterations, want.iterations])
        check(same_x and same_captured and same_history,
              f"cohabitant {SVC_COHABITANT} in run {other} differs from run A")
    # the victims: onto their failure-free runs
    for name, kill in kills.items():
        got, want = b[name].result, a[name].result
        err = max_abs(got.state.x, want.state.x)
        ok = bool(torch.allclose(got.state.x, want.state.x, rtol=1e-8,
                                 atol=1e-8))
        say("service", check=f"victim {name} in run B vs run A",
            kill=str(kill[0]), failures_recovered=got.report
            .failures_recovered, storage_failures=got.report.storage_failures,
            iterations=[got.iterations, want.iterations], max_abs_err=err,
            rtol=1e-8, atol=1e-8, ok=ok)
        check(ok and got.iterations == want.iterations == SVC_MAXITER,
              f"victim {name}: k {got.iterations} vs {want.iterations}, "
              f"x off by {err}")
        check(got.report.failures_recovered == 1,
              f"victim {name}: failures_recovered "
              f"{got.report.failures_recovered}")
    check(b["t1"].result.report.storage_failures == 1,
          "t1: the PRD kill was not counted")
    t2 = b["t2"].result.report
    check(t2.nshards == 4 and set(t2.persist_bytes_by_shard) == {0, 1, 2, 3}
          and set(t2.recovery_fetch_bytes_by_shard) == {2},
          f"t2: shards {t2.persist_bytes_by_shard} / "
          f"{t2.recovery_fetch_bytes_by_shard}")
    # the service's answer against the port's own solo engine
    solo_problem = next(t[1] for t in tenants if t[0] == SVC_COHABITANT)
    solo = api.solve(solo_problem, spec)
    err = max_abs(cohab["A"].state.x, solo.state.x)
    ok = bool(torch.allclose(cohab["A"].state.x, solo.state.x, rtol=1e-8,
                             atol=1e-12))
    say("service", check=f"{SVC_COHABITANT} in run A vs solo api.solve",
        iterations=[cohab["A"].iterations, solo.iterations],
        max_abs_err=err, rtol=1e-8, atol=1e-12, ok=ok)
    check(ok and solo.iterations == cohab["A"].iterations,
          f"{SVC_COHABITANT}: service != solo solve ({err})")
    del runs, a, b, c, cohab, solo, tenants
    torch.cuda.empty_cache()

    # ---- BiCGStab bucket: a lane step without K2 ------------------------
    bspec = api.SolverSpec("bicgstab", tol=1e-10, maxiter=SVC_BICG_STEPS)
    members = [("u0", api.Problem.poisson(*SVC_BICG_GRIDS[0], nblocks=8,
                                          device=DEVICE), bspec,
                api.ResilienceSpec("nvm-prd"), 1),
               ("u1", api.Problem.poisson(*SVC_BICG_GRIDS[1], nblocks=8,
                                          device=DEVICE), bspec,
                api.ResilienceSpec("esr"), 1)]
    bicg = {}
    for label, failures in (("bicgstab: no failure", {}),
                            (f"bicgstab: u0 blocks (1, 2) at "
                             f"{SVC_BICG_FAIL_AT}",
                             {"u0": (api.FailureEvent(
                                 blocks=(1, 2),
                                 at_iteration=SVC_BICG_FAIL_AT),)})):
        tickets, counts, steps, _ = _serve_bucket(torch, label, members,
                                                  failures, 2)
        check(counts["fused_cg_update_lanes"] == 0
              and counts["det_dot_lanes"] == 4 * steps
              and counts["stencil7"] >= 2 * steps,
              f"{label}: launches {counts} against {steps} bucket steps")
        bicg[label] = tickets
        for name, count in counts.items():
            totals[name] = totals.get(name, 0) + count
    free, hit = bicg.values()
    err = max_abs(hit["u0"].result.state.x, free["u0"].result.state.x)
    ok = bool(torch.allclose(hit["u0"].result.state.x,
                             free["u0"].result.state.x, rtol=1e-8, atol=1e-8))
    same = bool(torch.equal(hit["u1"].result.state.x,
                            free["u1"].result.state.x))
    say("service", check="bicgstab victim u0 vs its failure-free run",
        failures_recovered=hit["u0"].result.report.failures_recovered,
        iterations=[hit["u0"].result.iterations,
                    free["u0"].result.iterations],
        max_abs_err=err, rtol=1e-8, atol=1e-8, ok=ok,
        cohabitant_u1_x_bitwise=same)
    check(ok and same and hit["u0"].result.report.failures_recovered == 1
          and hit["u0"].result.iterations == SVC_BICG_STEPS,
          f"bicgstab bucket: victim off by {err}, cohabitant bitwise {same}")
    del bicg, free, hit, members
    torch.cuda.empty_cache()
    say("service", phase_seconds=time.perf_counter() - t_phase,
        launches=totals)
    return totals


#: phase 11: the sharded main path (256^3 float64, nblocks=8): the
#: solve's shard count, its iteration cap and failure, the shard counts
#: of K1's halo check and of the fetch-scaling runs, whose cap and kill
#: keep them short, and the float32 grid steps of the shardmap check
MESH_NSHARDS, MESH_MAXITER, MESH_FAIL_AT = 4, 20, 10
MESH_HALO_SHARDS = (2, 4, 8)
MESH_SCALING_MAXITER, MESH_SCALING_FAIL_AT = 6, 4
MESH_GRID_STEPS = 10


def mesh_kernels(torch, rate: float, records: dict) -> None:
    """K1's halo mode at 2, 4 and 8 shards of the 256^3 float64 grid
    (the slabs side by side bitwise one full K1 launch; one sharded
    apply's device ms beside the full launch's), one slab launch against
    its plain version with its timings and bound (the record of
    ``stencil7_halo``), and the per-shard lane launches of det_dot and K2
    at the 4-shard solve's shape, their chained sums bitwise the
    unsharded launches'."""
    import torch.nn.functional as F

    from repro_torch.core import pcg, spmv
    from repro_torch.core.state import PCGState
    from repro_torch.distributed import make_data_mesh
    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import stencil7 as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    n, plane = GRID ** 3, GRID * GRID
    u = torch.randn(GRID, GRID, GRID, generator=gen, device=dev,
                    dtype=torch.float64)
    full = k1.stencil7_cuda(u)
    full_ms = device_ms(torch, lambda: k1.stencil7_cuda(u))
    b_full, by_full = bound_ms(2 * n * 8, 7 * n, "float64", rate)
    sharded_ms = {}
    for nshards in MESH_HALO_SHARDS:
        got = spmv.sharded_stencil7(u, nshards)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, full)),
              f"stencil7_halo at {nshards} shards != one full K1 launch")
        ms = sharded_ms[nshards] = device_ms(
            torch, lambda: spmv.sharded_stencil7(u, nshards))
        say("mesh", kernel="stencil7_halo", nshards=nshards,
            bitwise_full_launch=True, sharded_apply_device_ms=ms,
            full_launch_device_ms=full_ms, bound_ms=b_full, bound_by=by_full,
            halo_bytes=2 * (nshards - 1) * plane * 8)

    # one slab of the 4-shard solve: its launch, plain version, conv3d
    slab = GRID // MESH_NSHARDS
    z = slice(slab, 2 * slab)
    us, lo, hi = u[z].contiguous(), u[slab - 1].clone(), u[2 * slab].clone()
    got = k1.stencil7_halo_cuda(us, lo, hi)
    want = k1.stencil7_halo_plain(us, lo, hi)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    tol = 1e-12 * max(1.0, float(want.abs().max()))
    check(err <= tol, f"stencil7_halo slab error {err} > {tol}")
    check(bool(torch.equal(got, full[z])), "stencil7_halo slab != full[z]")
    ms, dev_ms = both_ms(torch, lambda: k1.stencil7_halo_cuda(us, lo, hi))
    plain_ms = time_ms(torch, lambda: k1.stencil7_halo_plain(us, lo, hi))
    ext = torch.cat([lo[None], us, hi[None]])[None, None]
    w = torch.zeros(1, 1, 3, 3, 3, device=dev, dtype=torch.float64)
    w[0, 0, 1, 1, 1] = 6.0
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[(0, 0) + idx] = -1.0
    conv = lambda: F.conv3d(ext, w, padding=(0, 1, 1))  # noqa: E731
    conv_err = max_abs(conv()[0, 0], got)
    lib_ms, lib_dev_ms = both_ms(torch, conv)
    m = us.numel()
    b_ms, b_by = bound_ms((2 * m + 2 * plane) * 8, 7 * m, "float64", rate)
    say("mesh", kernel="stencil7_halo", slab=list(us.shape), max_abs_err=err,
        tol=tol, bitwise_full_launch_slab=True, kernel_ms=ms,
        kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        library="conv3d float64 on the slab with its halo planes",
        conv_vs_kernel_max_abs_err=conv_err, bound_ms=b_ms, bound_by=b_by)
    records["stencil7_halo"] = dict(
        name="stencil7_halo", route="cuda",
        source="src/repro_torch/kernels/csrc/stencil7.cu",
        replaces="src/repro/kernels/stencil7.py:53", max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms,
        sharded_apply_device_ms=sharded_ms, full_launch_device_ms=full_ms)
    del u, full, got, want, ext

    # per-shard block sums: det_dot's and K2's lane modes, 2 blocks a shard
    x, r, p, ap = (torch.randn(n, generator=gen, device=dev,
                               dtype=torch.float64) for _ in range(4))
    inv = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) + 0.5
    alpha = torch.tensor(0.37, dtype=torch.float64, device=dev)
    mesh = make_data_mesh(MESH_NSHARDS, dev)
    bps = NBLOCKS // MESH_NSHARDS
    mesh_dot = spmv.make_det_dot(NBLOCKS, mesh)
    want_dot = k2.det_dot_cuda(p, ap, NBLOCKS)
    check(bool(torch.equal(mesh_dot(p, ap), want_dot)),
          "det_dot under a 4-shard mesh != the unsharded det_dot")
    rows = torch.randn(3, n, generator=gen, device=dev, dtype=torch.float64)
    got_rows = spmv.make_det_rowdots(NBLOCKS, mesh)(rows, ap)
    want_rows = spmv.make_det_rowdots(NBLOCKS)(rows, ap)
    check(bool(torch.equal(got_rows, want_rows)),
          "det_rowdots under a 4-shard mesh != unsharded")
    check(all(bool(torch.equal(got_rows[i], k2.det_dot_cuda(rows[i], ap,
                                                           NBLOCKS)))
              for i in range(3)), "det_rowdots row != det_dot of the row")
    del rows, got_rows, want_rows
    shard = slice(bps * (n // NBLOCKS), 2 * bps * (n // NBLOCKS))
    ps, aps = p[shard].view(bps, -1), ap[shard].view(bps, -1)
    lane_ms, lane_dev_ms = both_ms(torch, lambda: k2.det_dot_lanes_cuda(
        ps, aps))
    lane_b, lane_by = bound_ms(2 * ps.numel() * 8, 2 * ps.numel(), "float64",
                               rate)
    mesh_dot_ms = device_ms(torch, lambda: mesh_dot(p, ap))
    dot_ms = device_ms(torch, lambda: k2.det_dot_cuda(p, ap, NBLOCKS))
    b_dot, _ = bound_ms(2 * n * 8, 2 * n, "float64", rate)
    say("mesh", kernel="det_dot_lanes", shard_blocks=bps,
        n=ps.numel(), kernel_ms=lane_ms, kernel_device_ms=lane_dev_ms,
        bound_ms=lane_b, bound_by=lane_by, mesh_dot_device_ms=mesh_dot_ms,
        det_dot_device_ms=dot_ms, dot_bound_ms=b_dot,
        mesh_dot_bitwise_det_dot=True, rowdots_bitwise=True)

    # the PCG step's dots and update shard by shard (one full K1 for
    # both, so the two steps differ in those alone)
    def apply(v):
        return k1.stencil7_cuda(v.view(GRID, GRID, GRID)).view(-1)

    state = PCGState(x=x, r=r, z=r * inv, p=p, rz=k2.det_dot_cuda(r, r * inv,
                                                                  NBLOCKS),
                     beta_prev=alpha * 0, k=0)
    mesh_step = pcg.make_step(apply, inv, NBLOCKS, mesh)
    plain_step = pcg.make_step(apply, inv, NBLOCKS)
    got, want = mesh_step(state), plain_step(state)
    check(all(bool(torch.equal(getattr(got, f), getattr(want, f)))
              for f in ("x", "r", "z", "p", "rz", "beta_prev")),
          "the PCG step on a 4-shard mesh != the unsharded step bitwise")
    alphas = alpha.reshape(1).repeat(bps)
    xs, rs, invs = (t[shard].view(bps, -1) for t in (x, r, inv))
    k2_ms, k2_dev_ms = both_ms(torch, lambda: k2.fused_cg_update_lanes_cuda(
        xs, rs, ps, aps, alphas, invs))
    k2_b, k2_by = bound_ms(8 * xs.numel() * 8, 7 * xs.numel(), "float64",
                           rate)
    mesh_step_ms = device_ms(torch, lambda: mesh_step(state))
    plain_step_ms = device_ms(torch, lambda: plain_step(state))
    say("mesh", kernel="fused_cg_update_lanes", shard_blocks=bps,
        n=xs.numel(), kernel_ms=k2_ms, kernel_device_ms=k2_dev_ms,
        bound_ms=k2_b, bound_by=k2_by, sharded_step_device_ms=mesh_step_ms,
        unsharded_step_device_ms=plain_step_ms, step_bitwise=True)
    del x, r, p, ap, inv, got, want, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_mesh(torch, rate: float, records: dict) -> dict:
    """The sharded main path at full width: the mesh kernels, then
    ``api.solve`` of the 4-shard 256^3 problem with a ``shard=1`` kill,
    bitwise the unsharded solve with blocks (2, 3) killed and fetching
    one shard's slot bytes; fetch bytes halving from 2 to 4 to 8 shards
    (short runs); the 4-shard float32 shardmap grid step against the
    unsharded fused step.  Returns the sharded solve's launch counts."""
    from repro_torch import api
    from repro_torch.core import pcg, spmv
    from repro_torch.core.state import PCG_SCHEMA, PCGState
    from repro_torch.distributed import make_data_mesh
    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil7 as k1

    t_phase = time.perf_counter()
    mesh_kernels(torch, rate, records)
    spec = api.SolverSpec("pcg", tol=1e-10, maxiter=MESH_MAXITER)

    def run(label, nshards, event, spec_=spec, backend="nvm-prd"):
        problem = api.Problem.poisson(GRID, nblocks=NBLOCKS, device=DEVICE,
                                      nshards=nshards)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(problem, spec_,
                        api.ResilienceSpec(backend, nshards=nshards),
                        failures=[api.FailureEvent(**event)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = res.report
        say("mesh", run=label, nshards=rep.nshards,
            iterations=rep.iterations, wall_s=wall,
            s_per_iteration=wall / max(rep.iterations, 1),
            relres=rep.final_relres, failures_recovered=rep.failures_recovered,
            recovery_fetch_bytes=rep.recovery_fetch_bytes,
            recovery_fetch_bytes_by_shard=rep.recovery_fetch_bytes_by_shard,
            persist_bytes_by_shard=rep.persist_bytes_by_shard,
            halo_bytes=getattr(problem.op, "halo_bytes", 0))
        check(rep.failures_recovered == 1, f"{label}: no recovery")
        check(bool(torch.isfinite(res.state.x).all()), f"{label}: x not finite")
        return res, problem

    ops.reset_launch_counts()
    sharded, problem = run(f"{MESH_NSHARDS} shards, shard 1 killed",
                           MESH_NSHARDS,
                           dict(shard=1, at_iteration=MESH_FAIL_AT))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    say("mesh", launches=counts)
    for name in ("stencil7_halo", "fused_cg_update_lanes", "det_dot_lanes"):
        check(counts[name] > 0, f"kernel {name} never launched on the "
              f"sharded path")
    check(counts["stencil7_halo"] >= MESH_NSHARDS * MESH_MAXITER,
          f"stencil7_halo launched {counts['stencil7_halo']} times")
    blocks = problem.op.layout.blocks_of(1)
    plain, _ = run(f"unsharded, blocks {blocks} killed", 1,
                   dict(blocks=blocks, at_iteration=MESH_FAIL_AT))
    rep = sharded.report
    slot = PCG_SCHEMA.history * len(blocks) * PCG_SCHEMA.slot_nbytes(
        problem.op.partition.block_size, "float64")
    check(sharded.iterations == plain.iterations == MESH_MAXITER,
          f"iterations {sharded.iterations} vs {plain.iterations}")
    check(bool(torch.equal(sharded.state.x, plain.state.x))
          and bool(torch.equal(sharded.state.r, plain.state.r)),
          "the sharded solve's x, r != the unsharded solve's bitwise")
    check(rep.recovery_fetch_bytes == slot
          and rep.recovery_fetch_bytes_by_shard == {1: slot},
          f"fetch bytes {rep.recovery_fetch_bytes_by_shard} != one shard's "
          f"{slot}")
    say("mesh", check="sharded == unsharded", x_bitwise=True, r_bitwise=True,
        fetch_bytes=slot, relres=rep.final_relres)
    del sharded, plain, problem

    # fetch bytes halve as the shard count doubles (short runs)
    short = api.SolverSpec("pcg", tol=1e-10, maxiter=MESH_SCALING_MAXITER)
    fetch = {}
    for nshards in MESH_HALO_SHARDS:
        res, _ = run(f"scaling, {nshards} shards", nshards,
                     dict(shard=0, at_iteration=MESH_SCALING_FAIL_AT), short,
                     "nvm-homogeneous")
        fetch[nshards] = res.report.recovery_fetch_bytes
        del res
    check(fetch[2] == 2 * fetch[4] == 4 * fetch[8],
          f"fetch bytes do not halve with the shard count: {fetch}")
    say("mesh", fetch_bytes_by_nshards=fetch, halves=True)

    # the shardmap grid step on 4 float32 shards against the unsharded
    # fused step (K1 + det_dot + K2 on the whole grid)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    b = torch.randn(GRID, GRID, GRID, generator=gen, device=DEVICE,
                    dtype=torch.float32)
    z = b * (1.0 / 6.0)
    rz = k2.det_dot_cuda(b.view(-1), z.view(-1), 1)
    step, _ = spmv.make_shardmap_pcg_step(make_data_mesh(MESH_NSHARDS,
                                                         DEVICE))
    st = dict(x=torch.zeros_like(b), r=b, z=z, p=z, rz=rz)
    inv = torch.full((b.numel(),), 1.0 / 6.0, device=DEVICE,
                     dtype=torch.float32)
    ref_step = pcg.make_step(lambda v: k1.stencil7_cuda(
        v.view(GRID, GRID, GRID)).view(-1), inv, 1)
    ref = PCGState(x=st["x"].reshape(-1), r=b.reshape(-1), z=z.reshape(-1),
                   p=z.reshape(-1), rz=rz, beta_prev=rz * 0, k=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_GRID_STEPS):
        st = {f: v for f, v in step(st).items() if f in ("x", "r", "z", "p",
                                                         "rz")}
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    for _ in range(MESH_GRID_STEPS):
        ref = ref_step(ref)
    torch.cuda.synchronize()
    errs = {}
    for f in ("x", "r", "p"):
        got, want = st[f].reshape(-1).double(), getattr(ref, f).double()
        errs[f] = float((got - want).abs().max() / want.abs().max())
        check(errs[f] <= 1e-4, f"shardmap step {f}: relative error {errs[f]}")
    say("mesh", check="shardmap float32 grid step vs unsharded fused step",
        steps=MESH_GRID_STEPS, nshards=MESH_NSHARDS, max_rel_err=errs,
        rtol=1e-4, ms_per_step=1e3 * grid_s / MESH_GRID_STEPS)
    del b, z, st, ref, inv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("mesh", phase_seconds=time.perf_counter() - t_phase)
    return counts


def kernel_times(torch, rate: float) -> dict:
    """Both timing columns of every kernel at the main path's shapes,
    through the wrappers every slice of the port has had, so the same
    call can time the kernels of another checkout (``--src``)."""
    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import gf256_encode as k3
    from repro_torch.kernels import stencil7 as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = GRID ** 3
    x, r, p, ap = (torch.randn(n, generator=gen, device=dev,
                               dtype=torch.float64) for _ in range(4))
    inv = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) + 0.5
    alpha = torch.tensor(0.37, dtype=torch.float64, device=dev)
    data = k2.stripe_bytes(p.reshape(NBLOCKS, K_DATA, -1))
    m = LOCAL_CG_N
    calls = {
        "stencil7": lambda: k1.stencil7_cuda(p.view(GRID, GRID, GRID)),
        "fused_cg_update": lambda: k2.fused_cg_update_cuda(
            x, r, p, ap, alpha, inv, NBLOCKS),
        "det_dot": lambda: k2.det_dot_cuda(p, ap, NBLOCKS),
        "torch.dot": lambda: torch.dot(p, ap),
        "det_dot local CG": lambda: k2.det_dot_cuda(p[:m], ap[:m], 1),
        "torch.dot local CG": lambda: torch.dot(p[:m], ap[:m]),
        "gf256_rs_encode P=2": lambda: k3.gf256_rs_encode_cuda(data, 2),
        "gf256_rs_encode P=1": lambda: k3.gf256_rs_encode_cuda(data, 1),
        "fused_cg_update_persist": lambda: k2.fused_cg_update_persist_cuda(
            x, r, p, ap, alpha, inv, NBLOCKS, K_DATA, NPARITY),
    }
    times = {}
    for name, fn in calls.items():
        ms, dev_ms = both_ms(torch, fn)
        times[name] = {"ms": ms, "device_ms": dev_ms}
    say("times", src=SRC, hbm_bytes_per_s=rate, **times)
    return times


def main() -> int:
    global SRC
    import torch

    args = sys.argv[1:]
    times_only = "--times-only" in args
    if "--src" in args:
        SRC = os.path.abspath(args[args.index("--src") + 1])
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
        if times_only:
            kernel_times(torch, rate)
            return 0
        records = phase_kernels(torch, rate)
        counts, problem, recovered = phase_main_path(torch)
        paths = [counts, phase_erasure(torch, problem, recovered)]
        del recovered
        phase_convergence(torch)
        paths.append(phase_zoo(torch, problem))
        paths.append(phase_jit(torch, problem, records))
        paths.append(phase_advise(torch, problem))
        del problem
        paths.append(phase_service(torch))
        paths.append(phase_mesh(torch, rate, records))
        counts = {name: sum(path[name] for path in paths) for name in records}
        say("launches", by_path=paths, total=counts)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for key in ("stencil7", "fused_cg_update", "det_dot", "gf256_rs_encode",
                "fused_cg_update_persist", "fused_cg_update_lanes",
                "det_dot_lanes", "stencil7_halo"):
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
