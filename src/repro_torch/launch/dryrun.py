"""The dry run on one card (port of ``repro/launch/dryrun.py``): the
LM cells of the ten configs and the solver cells at the paper's
pod-scale grids.

The reference lowers and compiles every (architecture x shape) cell on
the production meshes (16x16 = 256 devices, 2x16x16 = 512) of faked
host devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and
the partitioned HLO's collectives.  PyTorch has none of those, so the
port answers the same three questions as its solver dry run does: from
shapes, and from real steps on the card.

**LM cells** (:func:`run_cell`).  For one (arch, shape, layout) cell:

1. the cell is built on the layout's
   :class:`~repro_torch.distributed.sharding.LogicalMesh`
   (:func:`repro_torch.models.registry.build_cell`):
   ``memory.argument_bytes`` is the exact per-device bytes of its
   parameters, optimizer state, batch and caches under the axis rules
   (``shard_shape``, leaf by leaf);
2. the cell's step (AdamW train step, prefill or decode) runs for real
   at full width, at one data replica's batch (the shape's batch over
   the extent of the batch axes ``spec_for_shape`` keeps), on depth
   variants (:func:`_depth_variant`): g1 and g2 on the single-pod
   layout, g1 alone as the multi-pod pass; each variant's state comes
   from seeded generators and takes one step, then timed steps (CUDA
   events) until there are at least ``WARM_STEPS`` and, on the card,
   they add up to ``TIMED_WINDOW_S`` (:func:`keep_timing`), then one
   untimed step under
   :class:`~repro_torch.launch.roofline.OpCounter` (calibrating passes
   only); the peak is ``max_memory_allocated`` after
   ``reset_peak_memory_stats``;
3. before anything is allocated each variant is sized exactly from
   ``meta`` (:func:`variant_bytes`): the batch is halved until the
   state and the largest transient fit the card less ``HEADROOM``;
   every cut is listed in the row's ``reduced``; a variant that does
   not fit at the smallest batch is refused, and where g2 is refused
   and g1 fits the cell calibrates from g0 (no layer group) and g1.  An
   out-of-memory error that still happens fails the cell;
4. the counts, the step seconds and the non-argument peak are
   extrapolated to full depth as the reference extrapolates its counts
   (``groups_eff``; every microbatch really runs and is counted, so the
   reference's microbatch factor, which makes up for a scan counted
   once, is 1 here), and scaled by the batch cut (exact in batch for
   the counts; of a train step's peak only the part that grows with
   the batch, :class:`PeakSplit`): the full-depth step of one data
   replica on one card,
   which on the production mesh is the work of ``model`` = 16 chips;
   the extrapolation multiplies the variants' step difference by about
   ``groups_eff - 1``, so the row also gives the replica step's range
   over the quartiles of the variants' timed steps
   (:func:`replica_steps`); the counts over the chips give the
   roofline's perfectly partitioned share (the operations of the
   products only; the bytes the eager program's ATen traffic, which is
   not a compulsory bound: :class:`~repro_torch.launch.roofline.
   OpCounter`), and :func:`~repro_torch.launch.roofline.lm_collectives`
   the bytes a chip exchanges over the network;
5. one JSON row with the reference's keys (``arch, shape, mesh, chips,
   compile_s`` (the first step's wall), ``memory, roofline,
   coll_by_kind, model_flops_global, model_flops_per_chip,
   useful_flop_ratio, calibration, ok``) plus ``device``, ``measured``,
   ``reduced`` and ``levers_inert``; ``memory.peak_bytes`` is an
   estimate, named as one: the per-device arguments plus the replica's
   non-argument peak over the ``model`` extent.  On the CPU every
   device field is ``None``.

**Solver cells** (:func:`run_solver_cell`).  The reference lowers and
compiles one sharded PCG iteration; one H100 holds the paper's grids
whole, so each ``GRIDS`` cell really runs:

1. the layout's data mesh (256 or 512 shards,
   :func:`repro_torch.launch.mesh.make_data_mesh`), spread over every
   visible card (one card holds every shard);
2. the cell's step, :func:`~repro_torch.core.spmv.make_sharded_pcg_step`
   (``variant="auto"``) or :func:`~repro_torch.core.spmv.
   make_shardmap_pcg_step` (``"shardmap"``), on float32 grids;
3. the spec's state materialised at the full grid (a seeded right-hand
   side ``b``: ``x = 0``, ``r = b``, ``z = p = b / 6``, the in-memory ESR
   replica a copy of ``p``), placed slab by slab on the cards when they
   are several (:func:`cell_state`);
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
memory.peak_bytes`` (the largest card's ``torch.cuda.max_memory_allocated``
of the cell after ``reset_peak_memory_stats``; not measured on the
CPU), ``roofline`` (the counts per shard), ``coll_by_kind,
model_flops_per_chip = 18 n / chips, useful_flop_ratio``), plus
``cards``, the card's name, power limit and memory, the step's bound
and its share of the warm step (on the card only).  A cell whose state
alone exceeds a card's memory (its slabs and its replicas) is refused
before anything is allocated.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \
        --shape train_4k --mesh single --resume
    PYTHONPATH=src python -m repro_torch.launch.dryrun --opt remat_dots
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke \
        --device cpu --memory-bytes 1073741824 --hbm-rate 3.35e12

``--smoke`` runs the SMOKE configs at ``SMOKE_SEQ`` tokens and at most
``SMOKE_BATCH`` rows (with ``--solver``, the CPU test problem, 16x12x10
on its 8 blocks as shards, in place of ``GRIDS``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.poisson_pcg import GRIDS, SMOKE, SolverConfig
from repro_torch.core import spmv
from repro_torch.distributed.sharding import (DEFAULT_RULES, AxisRules,
                                              make_data_mesh, spec_for_shape)
from repro_torch.launch import DRYRUN_OUT
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RL
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serving.engine import DecodeGraph
from repro_torch.training.optimizer import UPDATE_CHUNK, adamw_init
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
#: an LM variant's timed steps on the card add up to at least this many
#: seconds (beyond ``WARM_STEPS``, at most ``MAX_TIMED_STEPS``): a
#: short step's noise grows about ``groups_eff - 1`` times in the
#: extrapolated replica step
TIMED_WINDOW_S = 2.0
MAX_TIMED_STEPS = 500
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
    """The spec's state: every field of ``structs`` its own tensor, from
    a seeded right-hand side drawn on ``device``.  On a mesh whose
    shards span distinct cards (``mesh.distinct``) the right-hand side
    is placed (``DataMesh.place``) and every grid is a sharded grid, its
    slabs on their shards, ``rz`` on shard 0's device and the in-memory
    ESR replica a whole copy on each card; otherwise the grids are whole
    on ``device`` and the step runs on views of them.  Both states hold
    the same values bit for bit."""
    grid = structs["x"]
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randn(grid.shape, generator=gen, device=device,
                    dtype=grid.dtype)
    if getattr(mesh, "distinct", False):
        b = mesh.place(b)
    z = b * (1.0 / 6.0)
    dot = spmv.make_det_dot(int(mesh.shape["data"]), mesh)
    state = dict(x=torch.zeros_like(b), r=b, z=z, p=z.clone(),
                 rz=dot(b.reshape(-1), z.reshape(-1)).to(structs["rz"].dtype))
    if "esr_red_cur" in structs:
        state["esr_red_cur"] = spmv.esr_replica(state["p"])
    return state


def card_state_bytes(shardings: Dict[str, object],
                     structs: Dict[str, torch.Tensor], mesh
                     ) -> Dict[torch.device, int]:
    """The state's bytes on each distinct device of ``mesh``: its slabs
    of the z-sharded grids (``shardings`` not ``None``) and a whole copy
    of each replicated field."""
    out = {}
    for dev in dict.fromkeys(mesh.devices):
        share = mesh.devices.count(dev) / mesh.nshards
        out[dev] = int(sum(
            t.numel() * t.element_size() * (share if shardings[f] else 1)
            for f, t in structs.items()))
    return out


def _grid_finite(t: torch.Tensor) -> bool:
    """Whether every value of a grid (a sharded one slab by slab) is
    finite."""
    return all(bool(torch.isfinite(slab).all())
               for slab in getattr(t, "slabs", (t,)))


def _timed_step(step, state, mesh):
    """(the step's output, seconds until the call returned with every
    launch enqueued, seconds until every card of ``mesh`` finished)."""
    t0 = time.perf_counter()
    out = step(state)
    enqueued = time.perf_counter() - t0
    mesh.synchronize()
    return out, enqueued, time.perf_counter() - t0


def run_solver_cell(cell: Union[str, SolverConfig], multi_pod: bool = False,
                    results_path: Optional[str] = DRYRUN_OUT,
                    verbose: bool = True, device: str = "cuda",
                    nshards: Optional[int] = None,
                    memory_bytes: Optional[int] = None,
                    hbm_rate: Optional[float] = None) -> dict:
    """Run one solver cell (a ``GRIDS`` name or a :class:`SolverConfig`)
    for ``1 + WARM_STEPS`` steps on the layout's data mesh (16x16, or
    2x16x16 with ``multi_pod``; ``nshards`` replaces the layout's shard
    count, and the row's mesh is then that count) and return, and append
    to ``results_path``, its row.  With ``device="cuda"`` (no index) the
    shards span the visible cards (:func:`~repro_torch.distributed.
    sharding.make_data_mesh`: 256 shards on four cards are 64 slabs a
    card), and the state is placed card by card (:func:`cell_state`);
    an indexed card or the CPU holds every shard.  The state must fit
    each card (:func:`card_state_bytes`); ``memory.state_bytes`` and
    ``memory.peak_bytes`` are the largest card's.  ``memory_bytes`` and
    ``hbm_rate`` are the device's memory and memory rate on the CPU
    (:func:`repro_torch.launch.mesh.device_memory_bytes`,
    :func:`~repro_torch.launch.mesh.device_hbm_rate`)."""
    sc = GRIDS[cell] if isinstance(cell, str) else cell
    layout = "2x16x16" if multi_pod else "16x16"
    if nshards is None:
        mesh = M.make_data_mesh(M.LAYOUTS[layout], device)
    else:
        mesh, layout = make_data_mesh(nshards, device), str(nshards)
    dev = mesh.device
    cards = tuple(dict.fromkeys(mesh.devices))
    chips = int(mesh.shape["data"])
    step, spec = cell_step(sc, mesh)
    nz, ny, nx = sc.grid
    shardings, structs = spec(nz, ny, nx)
    capacity = M.device_memory_bytes(dev, memory_bytes)
    by_card = card_state_bytes(shardings, structs, mesh)
    for c, nbytes in by_card.items():
        room = M.device_memory_bytes(c, memory_bytes)
        if nbytes > room:
            raise MemoryError(
                f"{sc.name} on {layout}: the state alone is {nbytes} bytes "
                f"on {c}, more than the device's {room}: it does not fit")
    state_bytes = max(by_card.values())
    card = M.card_identity(dev)
    rate = M.device_hbm_rate(dev, hbm_rate)

    if dev.type == "cuda":
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(c)
    state = cell_state(structs, mesh, dev)
    out, _, first_s = _timed_step(step, state, mesh)
    enqueues, steps = [], []
    for _ in range(WARM_STEPS):
        del state
        state = {k: out[k] for k in structs}
        del out
        out, enqueued, stepped = _timed_step(step, state, mesh)
        enqueues.append(enqueued)
        steps.append(stepped)
    del state
    enqueue_s, step_s = statistics.median(enqueues), statistics.median(steps)
    finite = _grid_finite(out["x"]) and _grid_finite(out["r"])
    del out
    peak = (max(int(torch.cuda.max_memory_allocated(c)) for c in cards)
            if dev.type == "cuda" else None)
    if dev.type == "cuda":
        for c in cards:
            with torch.cuda.device(c):
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
        "chips": chips, "cards": len(cards), "esr_mode": sc.esr_mode,
        "variant": sc.variant,
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
              f"{len(cards)} x {card['name']}] first step {first_s:.3f}s, "
              f"step "
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




# ======================================================================
# The LM cells
# ======================================================================
#: the share of the device's memory the sizing leaves free for what it
#: does not count (the MoE dispatch, SSM chunk states, the allocator's
#: rounding)
HEADROOM = 0.10
#: the smoke's cut of every shape: the SMOKE configs at this many tokens
#: and at most this many rows (a replica batch of 4 on 16x16, 2 on
#: 2x16x16)
SMOKE_SEQ, SMOKE_BATCH = 64, 64
#: the f32 copies of a logit entry a train step holds at its peak,
#: beside the compute-dtype product: the loss's f32 logits and
#: ``logsumexp`` temporary, and in its backward the gradient, the
#: ``exp`` of its softmax and the gold gather's scatter (llama3_8b's
#: step at 4 x 4096 tokens peaked at 20.9 bytes an entry on an H100:
#: PERF.md).  Serving holds the product and its cast to the logit
#: dtype.
TRAIN_LOGIT_COPIES = 5

#: the reference's roofline levers (``repro/launch/dryrun.py:72-81``)
OPT_LEVERS = {
    "logit_bf16": {"logit_dtype": "bfloat16"},
    "explicit_sp": {"explicit_sp": True},
    "bf16_gather": {"bf16_gather": True},
    "remat_dots": {"remat_policy": "dots"},
    "serve_resident": {"serve_resident": True},
    "micro2": {"microbatches": 2},
    "micro4": {"microbatches": 4},
}
#: levers that change nothing in the port: ``explicit_sp`` pins the
#: reference's sequence-parallel gather to the normed block input in the
#: compute dtype, which is what the port's seq-placed residual stream
#: always gathers (``layers.to_stream``), so the lever changes neither
#: values nor bytes; a row lists them under ``levers_inert``
INERT_LEVERS = ("explicit_sp",)


#: a variant's fields that hold device metrics (``None`` on the CPU)
DEVICE_FIELDS = ("first_step_s", "step_s", "step_q1_s", "step_q3_s",
                 "timed_steps", "enqueue_s", "allocated_bytes",
                 "peak_bytes", "nonarg_peak_bytes", "peak_split")


def _depth_variant(cfg, groups: int):
    """The same architecture at ``groups`` pattern groups (no tail);
    the encoder-decoder takes ``groups`` encoder and decoder layers.
    The reference also unrolls the variant's scan (``unroll_groups``);
    the port's layers are unrolled already."""
    kw = {"n_layers": cfg.group_size * groups,
          "name": f"{cfg.name}@g{groups}", "unroll_groups": True}
    if cfg.family == "encdec":
        kw["enc_layers"] = groups
    return dataclasses.replace(cfg, **kw)


def groups_eff(cfg) -> float:
    """Full depth in pattern groups: the groups plus the tail's share
    of one (the encoder-decoder: its decoder layers, the encoder's
    scaling with them)."""
    if cfg.family == "encdec":
        return float(cfg.n_layers)
    return cfg.n_groups + cfg.n_tail / cfg.group_size


def extrapolate(lo: int, values: Tuple[float, float], geff: float) -> float:
    """Full depth from two depth variants ``lo`` and ``lo + 1`` groups:
    the per-group delta carried from ``lo`` groups to ``geff`` (the
    reference's ``a + (b - a) (groups_eff - 1)`` from g1 and g2)."""
    a, b = values
    return a + (b - a) * (geff - lo)


def extrapolate_range(lo: int, lows: Tuple[float, float],
                      highs: Tuple[float, float],
                      geff: float) -> Tuple[float, float]:
    """The least and the most :func:`extrapolate` gives over each
    variant's low (``lows``) and high (``highs``) step: past one group
    the shallower variant's weight is negative, so its high step with
    the deeper one's low gives the least."""
    ends = [extrapolate(lo, (a, b), geff)
            for a in (lows[0], highs[0]) for b in (lows[1], highs[1])]
    return min(ends), max(ends)


def replica_steps(runs: Dict[int, Dict], pair: Tuple[int, int],
                  geff: float, cut: float) -> Tuple[float, List[float]]:
    """The replica's full-depth step from the variants ``pair`` (their
    median steps extrapolated, times the batch cut) and its range over
    their steps' first and third quartiles (:func:`extrapolate_range`):
    the spread of half the timed steps, which the extremes of hundreds
    of short steps would overstate."""
    def ends(key):
        return tuple(runs[g][key] for g in pair)

    least, most = extrapolate_range(pair[0], ends("step_q1_s"),
                                    ends("step_q3_s"), geff)
    return (extrapolate(pair[0], ends("step_s"), geff) * cut,
            [least * cut, most * cut])


class PeakSplit:
    """A train step's non-argument peak split at each gradient
    accumulation (a ``register_post_accumulate_grad_hook`` on every
    parameter): between two accumulations the gradients made before the
    first do not grow with the batch, and the rest of the interval's
    peak is taken to grow with it (the activations, the loss, and a
    gradient made within the interval, which makes the split a bound);
    after the last accumulation the step holds gradients and the
    update's temporaries only, which do not.  ``peak()`` reads the bytes
    held above the step's arguments at the most since ``reset()``.  Use
    as a context around one step; :meth:`points` then gives ``[fixed,
    batch]`` pairs, and :func:`scaled_peak` the step's peak at a
    multiple of its rows."""

    def __init__(self, params, peak: Callable[[], int],
                 reset: Callable[[], None]):
        self.params, self.peak, self.reset = list(params), peak, reset
        self.made, self.seen, self.intervals = 0, set(), []

    def _accumulated(self, p: torch.Tensor) -> None:
        self.intervals.append([self.made, self.peak() - self.made])
        if id(p) not in self.seen:
            self.seen.add(id(p))
            self.made += p.grad.numel() * p.grad.element_size()
        self.reset()

    def __enter__(self) -> "PeakSplit":
        self.reset()
        self.handles = [p.register_post_accumulate_grad_hook(
            self._accumulated) for p in self.params]
        return self

    def __exit__(self, *exc) -> None:
        for h in self.handles:
            h.remove()
        self.intervals.append([max(self.peak(), self.made), 0])

    def points(self) -> List[List[int]]:
        """The intervals' ``[fixed, batch]`` pairs that some multiple of
        the rows makes the peak: those no other pair matches in both."""
        keep, most = [], -1
        for fixed, batch in sorted(self.intervals, reverse=True):
            if batch > most:
                keep.append([fixed, batch])
                most = batch
        return keep


def scaled_peak(points: Sequence[Sequence[int]], cut: float) -> float:
    """The non-argument peak at ``cut`` times a variant's rows from its
    :class:`PeakSplit` points: only the part that grows with the batch
    is multiplied."""
    return max(fixed + cut * batch for fixed, batch in points)


def peak_estimate(runs: Dict[int, Dict], pair: Tuple[int, int],
                  geff: float, cut: float) -> float:
    """The replica's non-argument peak at full depth and at its batch:
    each variant's ``peak_split`` scaled to the batch cut
    (:func:`scaled_peak`), extrapolated over depth, and at least the
    deeper variant's (allocator noise in a small step cannot make it
    shrink below that)."""
    scaled = tuple(scaled_peak(runs[g]["peak_split"], cut) for g in pair)
    return max(extrapolate(pair[0], scaled, geff), scaled[1])


def keep_timing(steps: Sequence[float], window: float) -> bool:
    """Whether a variant times another step after ``steps``: until
    there are ``WARM_STEPS``, then while they add up to less than
    ``window`` seconds, up to ``MAX_TIMED_STEPS``."""
    if len(steps) < WARM_STEPS:
        return True
    return sum(steps) < window and len(steps) < MAX_TIMED_STEPS


def _nbytes(structs) -> int:
    return sum(t.numel() * t.element_size() for t in R.tree_leaves(structs))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def replica_batch(shape, rules: AxisRules) -> Tuple[int, int]:
    """``(the replica's batch, the replica count)``: the shape's batch
    over the extent of the batch axes ``spec_for_shape`` keeps."""
    phys = spec_for_shape(rules, (shape.batch, shape.seq), ("batch", None))[0]
    axes = () if phys is None else phys if isinstance(phys, tuple) else (phys,)
    n = math.prod(int(rules.mesh.shape[a]) for a in axes)
    return shape.batch // n, n


def variant_bytes(cfg, shape, batch: int) -> Dict[str, int]:
    """The bytes a depth variant's step needs on one card at ``batch``
    rows, counted from ``meta`` before anything is allocated:

    - ``state``: the parameters, and in training their gradients and
      two f32 moments, with the batch and the saved inputs of the
      checkpoints: every layer's, or where the stack nests its remat
      (:func:`~repro_torch.models.transformer.nests_groups`) every
      group's, one group's other layers' and the tail's; serving: the
      parameters, the inputs and the caches at ``shape.seq``;
    - ``logits``: ``batch x tokens x padded_vocab`` entries (``tokens``
      1 for decode) of one compute-dtype product plus its cast to the
      logit dtype (none when the two agree), or in training
      ``TRAIN_LOGIT_COPIES`` f32 copies;
    - ``layer``: the largest layer's transient.  Attention: a query
      chunk's f32 scores, three copies, and the f32 keys it reads; in
      training also what the chunk's recompute holds for its backward
      (each chunk is checkpointed, so one at a time): its f32 softmax
      and its probabilities in the compute dtype, and a banded chunk's
      gathered K/V band.  SSD: one chunk's ``(b, Q, Q, nh)`` f32
      segment sums, decays and scores, four copies, six in training.
      In training also the layer's weights in the compute dtype;
      decode reads its cache in f32;
    - ``update``: AdamW's f32 temporaries, about eight of
      ``UPDATE_CHUNK`` values (or of the largest leaf) in training.

    ``need`` is the largest of ``state + layer``, ``state + update``
    and, for the loss, ``state + logits`` less the gradients not yet
    made then (every one but the unembedding's): the loss, the layers
    and the update do not run at once."""
    kind, s = shape.kind, shape.seq
    b = batch
    params, _ = R.abstract_params(cfg)
    p_bytes = _nbytes(params)
    numel = sum(t.numel() for t in params.values())
    cdt, ldt = _itemsize(cfg.cdt), _itemsize(getattr(torch, cfg.logit_dtype))
    tokens = 1 if kind == "decode" else s
    cut = dataclasses.replace(shape, batch=b)
    if kind == "train":
        inputs, _ = R.batch_structs(cfg, cut)
        saved = cfg.n_layers
        if T.nests_groups(cfg):
            saved = cfg.n_groups + len(cfg.attn_pattern) - 1 + cfg.n_tail
        state = (2 * p_bytes + 8 * numel + _nbytes(inputs)
                 + saved * b * s * cfg.d_model * cdt)
        vocab = params[("embed",) if cfg.tie_embeddings else ("unembed",)]
        pending = p_bytes - vocab.numel() * vocab.element_size()
    else:
        caches, _ = R.abstract_caches(cfg, b, s)
        inputs, _ = R.batch_structs(cfg, cut)
        inputs.pop("targets")
        state = p_bytes + _nbytes(caches) + (
            b * 4 if kind == "decode" else _nbytes(inputs))
        pending = 0
    entry = cdt + (TRAIN_LOGIT_COPIES * 4 if kind == "train"
                   else ldt if ldt != cdt else 0)
    logits = b * tokens * cfg.padded_vocab * entry

    layer = 0
    kinds = ["global"] if cfg.family == "encdec" else list(cfg.attn_pattern)
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for lk in set(kinds) & {"global", "local"}:
        if kind == "decode":
            kv = min(cfg.window, s) if lk == "local" else s
            layer = max(layer, b * kv * kh * hd * 4)
            continue
        spans = [s] if cfg.family != "encdec" else [s, cfg.enc_seq]
        for span in spans:
            c = min(cfg.attn_chunk, span)
            kv = span
            banded = lk == "local" and cfg.window > 0
            if banded:
                kv = min(span, (cfg.window // c + 2) * c)
            t = 3 * b * h * c * kv * 4 + b * kv * h * hd * 4
            if kind == "train":
                t += b * h * c * kv * (4 + cdt)
                if banded:
                    t += 2 * b * kv * h * hd * cdt
            layer = max(layer, t)
    if "ssm" in kinds and kind != "decode":
        q = min(cfg.ssm_chunk, s)
        nh = cfg.expand * cfg.d_model // cfg.ssm_head_dim
        layer = max(layer, (6 if kind == "train" else 4) * b * q * q * nh * 4)
    if kind == "train":
        per_layer: Dict[Tuple[str, ...], int] = {}
        for path, t in params.items():
            if path[0] in ("groups", "enc", "dec"):      # stacked rows
                key, n = path[:2 if path[0] == "groups" else 1], t[0].numel()
            elif path[0] == "tail":
                key, n = path[:2], t.numel()
            else:
                continue
            per_layer[key] = per_layer.get(key, 0) + n
        layer += max(per_layer.values(), default=0) * cdt
    largest = max((t.numel() for t in params.values()), default=0)
    update = 8 * min(UPDATE_CHUNK, largest) * 4 if kind == "train" else 0
    need = state + max(logits - pending, layer, update)
    return {"state": state, "logits": logits, "layer": layer,
            "update": update, "need": need}


def plan_batch(cfg, shape, batch: int, capacity: int
               ) -> Tuple[Optional[int], Dict[str, int]]:
    """The largest batch, ``batch`` halved, whose step fits the card
    (``variant_bytes(...)["need"] <= (1 - HEADROOM) capacity``) and
    its bytes; ``(None, the smallest batch's bytes)`` when even
    ``cfg.microbatches`` rows (one a microbatch) do not fit."""
    room = (1 - HEADROOM) * capacity
    b = batch
    while True:
        sized = variant_bytes(cfg, shape, b)
        if sized["need"] <= room:
            return b, sized
        if b // 2 < max(cfg.microbatches, 1):
            return None, sized
        b //= 2


def plan_variants(cfg, shape, rep_batch: int, capacity: int,
                  calibrate: bool) -> Tuple[Tuple[int, ...], int, List[str]]:
    """The depth variants a cell runs, the batch they share and the cuts
    made (the row's ``reduced``), sized before anything is allocated
    (:func:`plan_batch`): g1 and g2 (g1 alone without ``calibrate``);
    g0 and g1 where g2 does not fit; the batch the smaller of the
    variants' batches.  Raises :class:`MemoryError` when a variant does
    not fit at its smallest batch."""
    reduced: List[str] = []
    pair = (1, 2) if calibrate else (1,)
    plans = {g: plan_batch(_depth_variant(cfg, g), shape, rep_batch, capacity)
             for g in pair}
    room = f"the device's {capacity / 1e9:.1f} GB less {HEADROOM:.0%}"
    if calibrate and plans[2][0] is None:
        reduced.append(f"g2 refused: it needs {plans[2][1]['need'] / 1e9:.1f}"
                       f" GB at {max(cfg.microbatches, 1)} row(s), over "
                       f"{room}; calibrated from g0 and g1")
        pair = (0, 1)
        plans[0] = plan_batch(_depth_variant(cfg, 0), shape, rep_batch,
                              capacity)
    for g in pair:
        if plans[g][0] is None:
            raise MemoryError(
                f"variant g{g} needs {plans[g][1]['need']} bytes at its "
                f"smallest batch, more than {room}: it does not fit")
    batch = min(plans[g][0] for g in pair)
    if batch < rep_batch:
        deep = _depth_variant(cfg, pair[-1])
        over = variant_bytes(deep, shape, 2 * batch)["need"]
        reduced.append(f"batch {rep_batch} -> {batch} (g{pair[-1]} at "
                       f"{2 * batch} rows needs {over / 1e9:.1f} GB, over "
                       f"{room})")
    return pair, batch, reduced


def _fill_caches(caches, index: int, gen: torch.Generator) -> None:
    """Seeded values in every floating cache tensor; a ring's positions
    the last ``window`` positions before ``index``, in their slots."""
    for c in caches:
        for t in R.tree_leaves(c):
            if t.is_floating_point():
                t.normal_(generator=gen)
        for part in ([c] if "k" in c else c.values()):
            if isinstance(part, dict) and "pos" in part:
                w = part["pos"].shape[0]
                p = torch.arange(index - w, index, device=part["pos"].device)
                part["pos"][p % w] = p.to(part["pos"].dtype)


def _inputs(cfg, b: int, s: int, dev, gen, targets: bool) -> Dict:
    """Seeded inputs of ``b`` rows of ``s`` tokens, in
    :func:`~repro_torch.models.registry.batch_structs`' layout."""
    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=cfg.cdt)

    out = {}
    if cfg.frontend == "vision":
        out["tokens"] = normal(b, s, cfg.d_model)
        out["positions"] = ints(4 * s, 3, b, s)
    else:
        out["tokens"] = ints(cfg.vocab, b, s)
    if cfg.family == "encdec":
        out["frames"] = normal(b, cfg.enc_seq, cfg.d_model)
    if targets:
        out["targets"] = ints(cfg.vocab, b, s)
    return out


def cell_args(cell, batch: int, device: torch.device, seed: int = SEED):
    """The real arguments of ``cell``'s step at ``batch`` rows on
    ``device``, from generators seeded with ``seed``: the model, and
    its AdamW state and a batch (training), the inputs and zeroed caches
    (prefill), or one token a row, caches of seeded values and the last
    position (decode)."""
    cfg, shape = cell.cfg, cell.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    model = R.init_params(cfg, gen, device)
    if shape.kind == "train":
        return (model, adamw_init(model),
                _inputs(cfg, batch, shape.seq, device, gen, targets=True))
    caches = R.init_caches(cfg, batch, shape.seq, device)
    if shape.kind == "prefill":
        return (model, _inputs(cfg, batch, shape.seq, device, gen,
                               targets=False), caches)
    index = shape.seq - 1
    _fill_caches(caches, index, gen)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=device,
                        dtype=torch.int32)
    return model, tok, caches, index


def _finite(kind: str, out) -> bool:
    """Whether a step's loss and gradient norm (training) or logits are
    finite; the logits are checked a few rows at a time, so the check
    holds no copy of them."""
    if kind == "train":
        return bool(torch.isfinite(out["loss"]) and
                    torch.isfinite(out["grad_norm"]))
    logits = out[0].reshape(-1, out[0].shape[-1])
    return all(bool(torch.isfinite(rows).all()) for rows in logits.split(1024))


def _decode_graph(cell, args, device: torch.device):
    """``cell.fn``'s decode step captured once as a CUDA graph
    (:class:`~repro_torch.serving.engine.DecodeGraph`) on a stream of
    its own, after one eager step there, at the cell's position as a
    0-d tensor: ``(stream, step)``, ``step()`` a replay returning
    ``(logits, caches)``."""
    model, tok, caches, index = args
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        pos = torch.full((), index, dtype=torch.int32, device=device)
        _, caches = cell.fn(model, tok, caches, pos)
        graph = DecodeGraph(cell.fn, model, tok, caches, stream)
    return stream, lambda: (graph(tok, index), graph.caches)


def run_variant(cell, batch: int, device: torch.device, count: bool) -> Dict:
    """One step of ``cell`` at ``batch`` rows on ``device``, then timed
    steps while :func:`keep_timing` says so (CUDA events over a window
    of ``TIMED_WINDOW_S`` on the card; ``WARM_STEPS`` by the host's
    clock on the CPU, which names no device time), then with ``count``
    one step under
    :class:`~repro_torch.launch.roofline.OpCounter`.  On the card a
    decode cell's timed steps are replays of one capture of its step
    (``"step_mode": "graph"``, the step the reference jits); train and
    prefill steps, the first step and the counted one run eagerly
    (``"eager"``).  On the card a train variant takes one more untimed
    step under :class:`PeakSplit` (``"peak_split"``; any other step's
    peak grows with the batch whole: ``[[0, nonarg_peak_bytes]]``).
    Returns the variant's measurements; raises when a step's loss,
    gradient norm or logits are not finite."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    args = cell_args(cell, batch, device)
    if cuda:
        torch.cuda.synchronize(device)
        allocated = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = cell.fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    mode = "graph" if cuda and cell.shape.kind == "decode" else "eager"
    stream, step = None, lambda: cell.fn(*args)
    if mode == "graph":
        del out
        stream, step = _decode_graph(cell, args, device)
        out = step()
    steps, enqueues = [], []
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        while keep_timing(steps, TIMED_WINDOW_S if cuda else 0.0):
            del out
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            out = step()
            enqueues.append(time.perf_counter() - t0)
            if cuda:
                end.record()
                end.synchronize()
                steps.append(start.elapsed_time(end) / 1e3)
            else:
                steps.append(time.perf_counter() - t0)
    if stream is not None:
        torch.cuda.current_stream(device).wait_stream(stream)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else None
    finite = _finite(cell.shape.kind, out)
    del out
    split = None
    if cuda and cell.shape.kind == "train":
        # what earlier steps left (the libraries' workspaces) is fixed
        start = torch.cuda.memory_allocated(device)
        with PeakSplit(
                args[0].parameters(),
                lambda: torch.cuda.max_memory_allocated(device) - start,
                lambda: torch.cuda.reset_peak_memory_stats(device)) as ps:
            out = cell.fn(*args)
        finite = finite and _finite(cell.shape.kind, out)
        del out
        split = [[fixed + start - allocated, batch]
                 for fixed, batch in ps.points()]
    elif cuda:
        split = [[0, peak - allocated]]
    q1, _, q3 = statistics.quantiles(steps, n=4, method="inclusive")
    rec = {"batch": batch, "first_step_s": first_s,
           "step_s": statistics.median(steps), "step_q1_s": q1,
           "step_q3_s": q3, "timed_steps": len(steps),
           "enqueue_s": statistics.median(enqueues),
           "allocated_bytes": allocated if cuda else None,
           "peak_bytes": peak,
           "nonarg_peak_bytes": peak - allocated if cuda else None,
           "peak_split": split, "step_mode": mode, "finite": finite}
    if count:
        counter = RL.OpCounter()
        with counter:
            out = cell.fn(*args)
        finite = finite and _finite(cell.shape.kind, out)
        del out
        rec.update(flops=counter.flops, hbm_bytes=counter.nbytes,
                   aten_ops=counter.ops)
    del args
    if cuda:
        torch.cuda.empty_cache()
    if not finite:
        raise FloatingPointError(f"{cell.cfg.name} {cell.shape.name}: a "
                                 f"step's loss, grad norm or logits are "
                                 f"not finite")
    return rec


def _lm_config(arch: str, opt: Optional[str], smoke: bool):
    cfg = R.get_config(arch, smoke=smoke)
    levers = [lv for lv in opt.split(",") if lv] if opt else []
    unknown = [lv for lv in levers if lv not in OPT_LEVERS]
    if unknown:
        raise ValueError(f"unknown --opt lever(s) {unknown}: the levers are "
                         f"{sorted(OPT_LEVERS)}")
    kw = {}
    for lever in levers:
        kw.update(OPT_LEVERS[lever])
    return dataclasses.replace(cfg, **kw), levers


def _cell_shape(shape_name: str, smoke: bool):
    shape = R.SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(shape, seq=min(shape.seq, SMOKE_SEQ),
                                    batch=min(shape.batch, SMOKE_BATCH))
    return shape


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             results_path: Optional[str] = DRYRUN_OUT,
             verbose: bool = True, calibrate: Optional[bool] = None,
             opt: Optional[str] = None, device: str = "cuda",
             smoke: bool = False, memory_bytes: Optional[int] = None,
             hbm_rate: Optional[float] = None) -> dict:
    """Run one (arch x shape x layout) LM cell on the device (the card
    unless ``device="cpu"``; on the CPU ``memory_bytes`` and
    ``hbm_rate`` stand for the card's) and return, and append to
    ``results_path``, its row.  ``calibrate`` (default: single-pod
    only) runs two depth variants and counts their work; otherwise g1
    alone runs (the multi-pod pass).  ``opt`` is a comma-separated list
    of ``OPT_LEVERS``; ``smoke`` takes the SMOKE config at the smoke's
    cut of the shape."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    layout = "2x16x16" if multi_pod else "16x16"
    chips = math.prod(mesh.shape.values())
    rules = AxisRules(mesh, dict(DEFAULT_RULES))
    cfg, levers = _lm_config(arch, opt, smoke)
    label = arch + (f"+{opt}" if opt else "") + ("@smoke" if smoke else "")
    if calibrate is None:
        calibrate = not multi_pod
    shape = _cell_shape(shape_name, smoke)
    capacity = M.device_memory_bytes(dev, memory_bytes)
    rate = M.device_hbm_rate(dev, hbm_rate)
    card = M.card_identity(dev)

    cell = R.build_cell(cfg, arch, shape, rules)
    arg_bytes = cell.argument_bytes()
    rep_batch, replicas = replica_batch(shape, rules)
    if shape.kind == "train" and rep_batch < cfg.microbatches:
        raise ValueError(f"{label} {shape_name} on {layout}: the replica's "
                         f"{rep_batch} rows do not split into "
                         f"{cfg.microbatches} microbatches")
    geff = groups_eff(cfg)

    # ---- size every variant before anything is allocated ---------------
    try:
        pair, batch, reduced = plan_variants(cfg, shape, rep_batch, capacity,
                                             calibrate)
    except MemoryError as e:
        raise MemoryError(f"{label} {shape_name} on {layout}: {e} (its "
                          f"arguments: {arg_bytes} bytes a device)") from None
    cut = rep_batch / batch

    # ---- run the variants ------------------------------------------------
    runs = {}
    for g in pair:
        vcell = R.build_cell(_depth_variant(cfg, g), arch, shape, rules)
        runs[g] = run_variant(vcell, batch, dev, count=calibrate)
        runs[g]["state_bytes"] = variant_bytes(vcell.cfg, shape,
                                               batch)["state"]
    first = runs[pair[0]]
    mflops = RL.model_flops(cfg, shape, shape.kind)
    # a CPU run names no device metric
    measured = {f"g{g}": {k: None if k in DEVICE_FIELDS and not cuda else v
                          for k, v in runs[g].items()}
                for g in pair}
    row = {
        "arch": label, "shape": shape_name, "mesh": layout, "chips": chips,
        "compile_s": first["first_step_s"],
        "memory": {"argument_bytes": arg_bytes, "peak_bytes": None,
                   "peak_bytes_is": "an estimate: the per-device arguments "
                                    "plus the replica's non-argument peak, "
                                    "extrapolated to full depth and the "
                                    "replica's batch (a train step's "
                                    "gradients and update unscaled), over "
                                    "the model extent"},
        "ok": True,
        "device": {"type": dev.type, "name": card["name"] if cuda else None,
                   "power_limit": card["power_limit"] if cuda else None,
                   "memory_bytes": capacity if cuda else None,
                   "hbm_bytes_per_s": rate if cuda else None,
                   "network_bytes_per_s": M.NETWORK_RATE if cuda else None,
                   "bf16_ops_per_s": M.peak_ops("bfloat16") if cuda
                   else None},
        "measured": {"variants": measured, "replica_batch": rep_batch,
                     "replicas": replicas, "batch_cut": cut,
                     "replica_step_s": None,
                     "replica_step_range_s": None, "bf16_share": None},
        "reduced": reduced,
        "levers": levers,
        "levers_inert": [lv for lv in levers if lv in INERT_LEVERS],
    }

    if calibrate:
        lo = pair[0]

        def ext(key):
            return extrapolate(lo, (runs[pair[0]][key], runs[pair[1]][key]),
                               geff)

        per_chip = cut * replicas / chips
        colls = RL.lm_collectives(cell)
        roof = RL.Roofline(flops=ext("flops") * per_chip,
                           hbm_bytes=ext("hbm_bytes") * per_chip,
                           coll_bytes=float(sum(colls.values())),
                           coll_by_kind=colls, chips=1, hbm_rate=rate,
                           dtype="bfloat16", coll_rate=M.NETWORK_RATE)
        model_n = int(mesh.shape["model"])
        row.update({
            "roofline": {
                **roof.as_row(),
                "flops_are": "the products' operations only "
                             "(torch.utils.flop_counter's registry)",
                "hbm_bytes_are": "the eager program's ATen traffic (every "
                                 "op's inputs and outputs), not compulsory "
                                 "bytes: t_memory_s bounds nothing"},
            "step_bound_s": roof.step_time_lb,
            "coll_by_kind": roof.coll_by_kind,
            "model_flops_global": mflops,
            "model_flops_per_chip": mflops / chips,
            "useful_flop_ratio": (mflops / chips) / roof.flops
            if roof.flops else None,
            "calibration": {
                "variants": [f"g{g}" for g in pair], "groups_eff": geff,
                "batch": batch, "batch_cut": cut,
                **{f"flops_g{g}": runs[g]["flops"] for g in pair},
                **{f"hbm_bytes_g{g}": runs[g]["hbm_bytes"] for g in pair}},
        })
        if cuda:
            step, span = replica_steps(runs, pair, geff, cut)
            nonarg = peak_estimate(runs, pair, geff, cut)
            row["memory"]["peak_bytes"] = int(arg_bytes + nonarg / model_n)
            row["measured"].update(
                replica_step_s=step, replica_step_range_s=span,
                bf16_share=mflops / replicas / step / M.peak_ops("bfloat16"))
    if verbose:
        msr = row["measured"]
        step_s = ("not measured" if msr["replica_step_s"] is None
                  else f"{msr['replica_step_s']:.4f}s (%.4f-%.4f)"
                  % tuple(msr["replica_step_range_s"]))
        peak = row["memory"]["peak_bytes"]
        peak_s = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
        head = (f"[{label} x {shape_name} x {layout} on {card['name']}] "
                f"args {arg_bytes / 2**30:.3f} GiB/dev | peak est {peak_s} | "
                f"batch {batch} of {rep_batch} | first step "
                f"{first['first_step_s']:.3f}s")
        if calibrate:
            rf = row["roofline"]
            print(f"{head} | replica step {step_s} | flops/chip "
                  f"{rf['flops_per_chip']:.3e} (useful "
                  f"{row['useful_flop_ratio']:.2f}) | bottleneck "
                  f"{rf['bottleneck']} (c={rf['t_compute_s'] * 1e3:.1f} "
                  f"m={rf['t_memory_s'] * 1e3:.1f} "
                  f"x={rf['t_collective_s'] * 1e3:.1f} ms)"
                  + (f" | reduced: {reduced}" if reduced else ""), flush=True)
        else:
            print(f"{head} | multi-pod pass OK"
                  + (f" | reduced: {reduced}" if reduced else ""), flush=True)
    if results_path:
        os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
        with open(results_path, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="one shape (default: all applicable)")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--solver", action="store_true",
                    help="run the PCG solver cells only")
    ap.add_argument("--with-solver", action="store_true",
                    help="include the PCG solver cells")
    ap.add_argument("--out", default=DRYRUN_OUT)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--opt", default=None,
                    help="comma-separated levers (see OPT_LEVERS)")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE configs at the smoke's cut of each "
                         "shape (with --solver: SMOKE, 16x12x10 on 8 "
                         "shards, in place of GRIDS)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--memory-bytes", type=int, default=None,
                    help="the device's memory; required on the CPU")
    ap.add_argument("--hbm-rate", type=float, default=None,
                    help="the device's memory rate (bytes/s); required on "
                         "the CPU")
    args = ap.parse_args(argv)
    if args.opt is not None:
        try:
            _lm_config(R.ARCH_IDS[0], args.opt, smoke=True)
        except ValueError as e:
            ap.error(str(e))
    cuda = resolve_device(args.device).type == "cuda"
    if cuda:
        # the variants fill the card: segments that grow in place keep
        # the allocator's free blocks usable (set before the first
        # allocation; a caller's setting stands)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        if args.solver or args.with_solver:
            from repro_torch.kernels import _build

            _build.build()
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

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

    failures = []
    if args.solver or args.with_solver:
        if args.smoke:
            cells = [(SMOKE, False, SMOKE.nblocks)]
        else:
            cells = [(g, mp, None) for g in GRIDS for mp in meshes]
        for cell, mp, nshards in cells:
            name = cell.name if isinstance(cell, SolverConfig) else cell
            label = str(nshards) if nshards else ("2x16x16" if mp else "16x16")
            if ("poisson_pcg", name, label) in done:
                continue
            try:
                run_solver_cell(cell, mp, args.out, device=args.device,
                                nshards=nshards,
                                memory_bytes=args.memory_bytes,
                                hbm_rate=args.hbm_rate)
            # one cell's failure is reported, and the next cell runs
            except Exception as e:  # noqa: BLE001
                failures.append((f"pcg/{name}", label, repr(e)))
                traceback.print_exc()
        if args.solver:
            _finish(failures)
            return

    archs = [args.arch] if args.arch else R.ARCH_IDS
    for arch in archs:
        cfg = R.get_config(arch)
        label = arch + (f"+{args.opt}" if args.opt else "") + (
            "@smoke" if args.smoke else "")
        shapes = [args.shape] if args.shape else R.cells_for(cfg)
        for shape in shapes:
            for mp in meshes:
                layout = "2x16x16" if mp else "16x16"
                if (label, shape, layout) in done:
                    continue
                try:
                    run_cell(arch, shape, mp, args.out, opt=args.opt,
                             device=args.device, smoke=args.smoke,
                             memory_bytes=args.memory_bytes,
                             hbm_rate=args.hbm_rate)
                # one cell's failure is reported, and the next cell runs
                except Exception as e:  # noqa: BLE001
                    failures.append((f"{label}/{shape}", layout, repr(e)))
                    traceback.print_exc()
    _finish(failures)


def _finish(failures) -> None:
    """Print the failures and exit non-zero if there were any."""
    if failures:
        print(f"\nDRY-RUN FAILURES ({len(failures)}):")
        for name, layout, err in failures:
            print(f"  {name} mesh={layout}: {err}")
        raise SystemExit(1)
    print("\nDRY-RUN: every requested cell ran its steps on the device.")


if __name__ == "__main__":
    main()
