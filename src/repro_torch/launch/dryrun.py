"""The solver dry run at the paper's pod-scale grids, on one card (port of
the solver path of ``repro/launch/dryrun.py``).

The reference lowers and compiles one sharded PCG iteration on the
production meshes (16x16 = 256 devices, 2x16x16 = 512) and reads XLA's
memory and cost analyses.  PyTorch has no ahead-of-time compile with a
memory analysis, and one H100 holds the paper's grids whole, so each
``GRIDS`` cell here really runs:

1. the layout's one-card data mesh (256 or 512 shards,
   :func:`repro_torch.launch.mesh.make_data_mesh`);
2. the cell's step, :func:`~repro_torch.core.spmv.make_sharded_pcg_step`
   (``variant="auto"``) or :func:`~repro_torch.core.spmv.
   make_shardmap_pcg_step` (``"shardmap"``), on float32 grids;
3. the spec's state materialised at the full grid (a seeded right-hand
   side ``b``: ``x = 0``, ``r = b``, ``z = p = b / 6``, the in-memory ESR
   replica a copy of ``p``);
4. one step, then a synchronize: ``compile_s`` is that first step's wall
   seconds (the kernels are built before the first cell, so it holds no
   ``nvcc``; it does hold the step's first-call work: workspaces and the
   Jacobi vector); then ``WARM_STEPS`` more steps, each from the last
   one's output: ``step_s`` is their median wall (the step the roofline
   share is taken against) and ``enqueue_s`` the median of the seconds
   until a step's call returned (the host's part, which is most of
   ``step_s`` when the host cannot enqueue ahead of the card).

Each cell appends one JSON row with the reference's keys (``arch,
shape, mesh, chips`` (the shard count), ``esr_mode, compile_s,
memory.peak_bytes`` (``torch.cuda.max_memory_allocated`` of the cell
after ``reset_peak_memory_stats``; not measured on the CPU),
``roofline`` (the counts per shard), ``coll_by_kind,
model_flops_per_chip = 18 n / chips, useful_flop_ratio``), plus the card's name, power limit and memory, the
step's bound and its share of the warm step (on the card only).  A cell
whose state alone exceeds the device's memory is refused before anything
is allocated.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver --smoke \
        --device cpu --memory-bytes 1073741824 --hbm-rate 3.35e12

``--smoke`` runs the CPU test problem (``SMOKE``, 16x12x10 on its 8
blocks as shards) in place of ``GRIDS``.  The LM cells (no ``--solver``)
and the ``--opt`` levers need the NN stack (ROADMAP Queue 1 item 3) and
exit non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time
import traceback
from typing import Dict, Optional, Sequence, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.poisson_pcg import GRIDS, SMOKE, SolverConfig
from repro_torch.core import spmv
from repro_torch.distributed.sharding import make_data_mesh
from repro_torch.launch import DRYRUN_OUT
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RL

#: what the LM cells answer until the NN stack is ported
LM_CELLS_MISSING = ("the LM dry-run cells (and their --opt levers) need the "
                    "NN stack, which the port does not have yet: ROADMAP "
                    "Queue 1 item 3")
#: a PCG iteration's useful operations a grid point, counted as
#: :mod:`repro_torch.launch.roofline` counts the step's (one per rounded
#: multiply, add or subtract): the Poisson stencil 7 (a multiply and six
#: subtracts), two dots 4, three vector updates 6, Jacobi 1.  The
#: reference's 25 counts the stencil as a general SpMV's 2 per nonzero
#: (14); held against the roofline's 7 it would claim more useful
#: operations than the step does.
USEFUL_OPS_PER_POINT = 18.0
#: the warm steps after the first whose median wall is ``step_s``
WARM_STEPS = 3
#: the grids' dtype (``lower_pcg_step``'s default)
DTYPE = torch.float32
#: the seed of every cell's right-hand side
SEED = 0


def model_ops_per_chip(grid: Sequence[int], chips: int) -> float:
    """The iteration's useful operations a shard:
    ``USEFUL_OPS_PER_POINT`` a point of ``grid``, over ``chips``."""
    return USEFUL_OPS_PER_POINT * math.prod(grid) / chips


def cell_step(sc: SolverConfig, mesh):
    """``(step, spec)`` of the cell's variant on ``mesh``, on float32
    grids."""
    make = (spmv.make_shardmap_pcg_step if sc.variant == "shardmap"
            else spmv.make_sharded_pcg_step)
    return make(mesh, esr_mode=sc.esr_mode, dtype=DTYPE)


def cell_state(structs: Dict[str, torch.Tensor], mesh, device: torch.device,
               seed: int = SEED) -> Dict[str, torch.Tensor]:
    """The spec's state on ``device``: every field of ``structs`` its own
    tensor, from a seeded right-hand side."""
    grid = structs["x"]
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randn(grid.shape, generator=gen, device=device,
                    dtype=grid.dtype)
    z = b * (1.0 / 6.0)
    dot = spmv.make_det_dot(int(mesh.shape["data"]), mesh)
    state = dict(x=torch.zeros_like(b), r=b, z=z, p=z.clone(),
                 rz=dot(b.reshape(-1), z.reshape(-1)).to(structs["rz"].dtype))
    if "esr_red_cur" in structs:
        state["esr_red_cur"] = state["p"].clone()
    return state


def _timed_step(step, state, device: torch.device):
    """(the step's output, seconds until the call returned with every
    launch enqueued, seconds until the device finished)."""
    t0 = time.perf_counter()
    out = step(state)
    enqueued = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, enqueued, time.perf_counter() - t0


def run_solver_cell(cell: Union[str, SolverConfig], multi_pod: bool = False,
                    results_path: Optional[str] = DRYRUN_OUT,
                    verbose: bool = True, device: str = "cuda",
                    nshards: Optional[int] = None,
                    memory_bytes: Optional[int] = None,
                    hbm_rate: Optional[float] = None) -> dict:
    """Run one solver cell (a ``GRIDS`` name or a :class:`SolverConfig`)
    for ``1 + WARM_STEPS`` steps on the layout's one-card mesh (16x16, or
    2x16x16 with ``multi_pod``; ``nshards`` replaces the layout's shard
    count, and the row's mesh is then that count) and return, and append
    to ``results_path``, its row.  ``memory_bytes`` and ``hbm_rate`` are
    the device's memory and memory rate on the CPU
    (:func:`repro_torch.launch.mesh.device_memory_bytes`,
    :func:`~repro_torch.launch.mesh.device_hbm_rate`)."""
    sc = GRIDS[cell] if isinstance(cell, str) else cell
    dev = resolve_device(device)
    layout = "2x16x16" if multi_pod else "16x16"
    if nshards is None:
        mesh = M.make_data_mesh(M.LAYOUTS[layout], dev)
    else:
        mesh, layout = make_data_mesh(nshards, dev), str(nshards)
    chips = int(mesh.shape["data"])
    step, spec = cell_step(sc, mesh)
    nz, ny, nx = sc.grid
    _, structs = spec(nz, ny, nx)
    capacity = M.device_memory_bytes(dev, memory_bytes)
    state_bytes = sum(t.numel() * t.element_size() for t in structs.values())
    if state_bytes > capacity:
        raise MemoryError(
            f"{sc.name} on {layout}: the state alone is {state_bytes} bytes, "
            f"more than the device's {capacity}: it does not fit")
    card = M.card_identity(dev)
    rate = M.device_hbm_rate(dev, hbm_rate)

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    state = cell_state(structs, mesh, dev)
    out, _, first_s = _timed_step(step, state, dev)
    enqueues, steps = [], []
    for _ in range(WARM_STEPS):
        del state
        state = {k: out[k] for k in structs}
        del out
        out, enqueued, stepped = _timed_step(step, state, dev)
        enqueues.append(enqueued)
        steps.append(stepped)
    del state
    enqueue_s, step_s = statistics.median(enqueues), statistics.median(steps)
    finite = bool(torch.isfinite(out["x"]).all() and
                  torch.isfinite(out["r"]).all())
    del out
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not finite:
        raise FloatingPointError(f"{sc.name} on {layout}: x or r is not "
                                 f"finite after the step")

    roof = RL.grid_step_roofline(sc.variant, sc.grid, DTYPE, chips,
                                 sc.esr_mode, hbm_rate=rate)
    useful = model_ops_per_chip(sc.grid, chips)
    row_counts = roof.as_row()
    row = {
        "arch": "poisson_pcg", "shape": sc.name, "mesh": layout,
        "chips": chips, "esr_mode": sc.esr_mode, "variant": sc.variant,
        "grid": list(sc.grid), "dtype": str(DTYPE).replace("torch.", ""),
        "compile_s": first_s, "step_s": step_s, "enqueue_s": enqueue_s,
        "warm_steps_s": steps,
        "memory": {"state_bytes": state_bytes, "peak_bytes": peak},
        "roofline": row_counts,
        "coll_by_kind": roof.coll_by_kind,
        "step_bound_s": roof.step_time_lb,
        # a share of the card's bound only for a step the card ran
        "roofline_share": (roof.step_time_lb / step_s if dev.type == "cuda"
                           else None),
        "model_flops_per_chip": useful,
        "useful_flop_ratio": useful / row_counts["flops_per_chip"],
        "device": {"type": dev.type, "name": card["name"],
                   "power_limit": card["power_limit"],
                   "memory_bytes": capacity, "hbm_bytes_per_s": rate},
        "x_r_finite": finite,
        "ok": True,
    }
    if verbose:
        peak_s = "not measured" if peak is None else f"{peak / 2**30:.3f} GiB"
        share = row["roofline_share"]
        share_s = "not measured" if share is None else f"{share:.3f}"
        print(f"[pcg {sc.name} ({sc.esr_mode}, {sc.variant}) x {layout} on "
              f"{card['name']}] first step {first_s:.3f}s, step "
              f"{step_s:.4f}s (median of {WARM_STEPS}, enqueued in "
              f"{enqueue_s:.4f}s) | peak "
              f"{peak_s} | bound "
              f"{roof.step_time_lb * 1e3:.3f} ms (share of the step: "
              f"{share_s}) | bottleneck {roof.bottleneck} colls "
              f"{roof.coll_by_kind}", flush=True)
    if results_path:
        os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
        with open(results_path, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--solver", action="store_true",
                    help="run the PCG solver cells (the LM cells are not "
                         "ported)")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=DRYRUN_OUT)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--opt", default=None,
                    help="LM levers: not ported, exits non-zero")
    ap.add_argument("--smoke", action="store_true",
                    help="run SMOKE (16x12x10, 8 shards) in place of GRIDS")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--memory-bytes", type=int, default=None,
                    help="the device's memory; required on the CPU")
    ap.add_argument("--hbm-rate", type=float, default=None,
                    help="the device's memory rate (bytes/s); required on "
                         "the CPU")
    args = ap.parse_args(argv)
    if args.opt is not None or not args.solver:
        raise SystemExit(LM_CELLS_MISSING)
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build()

    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    if args.smoke:
        cells = [(SMOKE, False, SMOKE.nblocks)]
    else:
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
        cells = [(g, mp, None) for g in GRIDS for mp in meshes]
    failures = []
    for cell, mp, nshards in cells:
        name = cell.name if isinstance(cell, SolverConfig) else cell
        label = str(nshards) if nshards else ("2x16x16" if mp else "16x16")
        if ("poisson_pcg", name, label) in done:
            continue
        try:
            run_solver_cell(cell, mp, args.out, device=args.device,
                            nshards=nshards, memory_bytes=args.memory_bytes,
                            hbm_rate=args.hbm_rate)
        # one cell's failure is reported, and the next cell runs
        except Exception as e:  # noqa: BLE001
            failures.append((f"pcg/{name}", label, repr(e)))
            traceback.print_exc()
    if failures:
        print(f"\nDRY-RUN FAILURES ({len(failures)}):")
        for name, label, err in failures:
            print(f"  {name} mesh={label}: {err}")
        raise SystemExit(1)
    print("\nDRY-RUN: every requested cell ran its steps on the device.")


if __name__ == "__main__":
    main()
