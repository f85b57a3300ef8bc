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
   computes the same function, that call's two times: K1 (stencil7; conv3d in float64 and float32;
   both also timed as 25 launches inside one CUDA graph),
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
   rtol = atol = 1e-8 and K1, K2 and det_dot must have launched.
   Recovery's local CG runs as a CUDA graph replayed chunk by chunk on
   the failed slabs alone (K1's halo mode with zero halo planes over the
   64 planes of blocks (1, 2), never K1 over the whole grid); its halo
   and det_dot launches (replays included) are counted apart.  It runs
   again on the same right-hand side with ``A[F,F]`` applied by
   embedding into the whole grid (the embed version): the same iteration
   count, ``x_F`` bitwise, both seconds printed.  The
   sync recovery runs again, up to iteration
   21, with the plain loop (a host read an iteration): the recovered
   state and the local CG's ``x_F`` must be bitwise the graph's, at the
   same iteration; both recoveries' seconds and local-CG seconds are
   printed side by side;
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
   the full launch's, on views of one buffer and on a sharded vector's
   slabs with a stream a shard) and one slab against its plain version
   and a conv3d; the halo mode at recovery's local-CG shape (64 planes,
   zero halo planes) against its plain version and a zero-padded
   conv3d; ``det_dot``, ``det_rowdots`` and the PCG step on a 4-shard
   mesh bitwise unsharded (per-shard lane launches of det_dot and K2);
   ``api.solve`` of ``Problem.poisson(256, nblocks=8, nshards=4)`` on
   ``nvm-prd`` with ``FailureEvent(shard=1)`` at 10, 20 iterations,
   every vector a sharded vector (a slab a shard on the card, a stream a
   shard), bitwise the unsharded solve with blocks (2, 3) killed and
   fetching one shard's slot bytes, its step's device ms beside the
   same step on views of one buffer (the one-buffer layout) and phase 4's
   breakdown of its iteration (step, norm pull, slab-by-slab pull of
   ``p``, backend persist); with two or more
   cards visible the same solve with the shards on distinct cards,
   bitwise the one-card solve (else a line ``"distinct_cards": "not
   run: 1 card visible"``); fetch bytes halving from 2 to 4 to 8 shards
   (6-iteration runs on ``nvm-homogeneous``); the 4-shard float32
   ``make_shardmap_pcg_step`` for 10 steps within rtol 1e-4 of the
   unsharded fused step; both grid steps on sharded 256^3 float32 grids
   (``DataMesh.place``'s z-slabs, the in-memory ESR replica a whole copy
   a card) on the 4-shard mesh of the one card for 3 steps, every field
   bitwise the same steps on views of one buffer, and with two or more
   cards the same over distinct cards and ``pcg_128m``'s first step on
   256 shards spread over every card, x and r finite (else a line
   ``"distinct_cards": "not run: 1 card visible"``);
12. launch — the roofline share (``repro_torch.launch.roofline``) of
   the 256^3 float64 steps phases 4, 8, 10 and 11 timed; the report
   tables of phases 4, 5 and 9 and the capability matrix; the serve CLI
   (``python -m repro_torch.launch.serve``, seed 0, 6 requests, 4
   lanes, ``--failures``) in its own process, its tenants' solver,
   convergence, iterations and recoveries equal to an in-process CPU
   replay of the same trace; the dry run's kernels at its shapes
   against their plain versions in float32 (K1's halo mode on the
   1-, 2- and 4-plane slabs of 512^2 and 1024^2 planes, interior and
   boundary shards; det_dot's and K2's lane modes at a shard's length)
   and the first step of ``pcg_128m`` on 512 shards, both variants,
   within rtol 1e-5 of the unsharded fused step on the same state; the
   solver dry run (``python -m repro_torch.launch.dryrun --solver``) in
   its own process at the paper's pod-scale grids (1024^3 and 512^3
   float32) on the 16x16 layout's 256 shards and, when the script's
   elapsed time allows (under 700 s with it), the 2x16x16 layout's 512:
   every cell's ``x`` and ``r`` finite after its steps and its peak
   device memory within the card's;
13. lm — LM serving (``repro_torch.models``, ``repro_torch.serving.
   ServeEngine``): ``llama3_8b`` at its full ``CONFIG`` (32 layers,
   d_model 4096, 8.03 B parameters in float32, bf16 compute),
   initialised on the card from a seeded ``torch.Generator``, answers 4
   requests of a 512-token prompt and 32 greedy tokens through
   ``ServeEngine.generate``, whose decode runs one eager step and then
   replays of one CUDA-graph capture (30 replays, checked): logits
   finite, the first token the argmax of a teacher-forced
   ``decoder_forward`` over the prompt; the prefill seconds, the eager
   step's ms, the capture's seconds, decode ms a token (CUDA events
   between steps, median over the replays after the first), the host's
   enqueue ms a token, tokens/s (with and without the capture), peak
   memory, beside the card's name and power limit, and the prefill's
   ``model_flops`` as a share of the bf16 peak and the decode step's
   compulsory bytes (``roofline.decode_step_bytes``) as a share of the
   HBM rate; a second run's tokens and every step's logits bitwise an
   eager ``make_decode`` loop's from the same prefill.  Then
   the nine other configs at full width in f32 (MoE capacity factor
   16), cut in depth only to one pattern period (gemma3 6 layers,
   recurrentgemma 4 so its tail layer runs, the rest 1; whisper, mamba2
   and starcoder2 whole): prefill 2 x 64 and 4 decode steps, each
   position's logits within ``LM_REL_TOL`` of the largest |logit| of
   the teacher-forced forward; qwen2-vl runs on patch embeddings with
   three M-RoPE streams (no decode against the forward: the CLI refuses
   vision).  Each of the nine then decodes 3 steps through a captured
   graph, every step's logits bitwise its eager steps' (qwen2-vl: token
   ids after its embeddings).  The path has no hand-written kernel: its
   launch counts must read 0;
14. train — LM training (``repro_torch.training``, ``repro_torch.ft``):
   ``starcoder2_3b`` at its full ``CONFIG`` (30 layers, d_model 3072,
   3.18 B f32 parameters, bf16 compute) takes four AdamW steps of batch
   4 x seq 2048 from the seeded synthetic corpus through
   ``make_train_step(make_train_forward(cfg))`` (every layer
   checkpointed): each step's seconds (CUDA events), host enqueue ms,
   loss, grad norm and lr, then tokens/s, ``train_mfu`` (``model_flops``
   over the median step after the first, as a share of the bf16 peak)
   and peak memory; losses and grad norms finite, the parameters moved,
   the first loss bitwise a plain ``remat=False`` forward's (each
   attention chunk checkpointed inside each layer's checkpoint).  Then
   the long context: ``granite_20b`` at full width (d_model 6144, 48
   heads, one KV head) cut to one pattern group takes two AdamW steps of
   one row of 32768 tokens: step seconds and enqueue ms, loss, grad norm
   and the peak (``max_memory_allocated``) against the dry run's sizing
   (``variant_bytes(...)["need"]``, the peak must not exceed it), the
   loss bitwise a plain forward's.  At the full
   width cut to 2 layers: the gradients with remat off, full and
   ``"dots"`` bitwise equal (and whether two runs are); the reference
   test's fault-tolerance cycle (8 steps, ``save_async`` every 4 into a
   fresh temporary directory, a host failure at 5, ``TrainingRecovery``,
   the resume within rtol = atol = 1e-6 of the uninterrupted run, with
   the snapshot, drain and modeled seconds, the slot's bytes, the step
   time while a drain runs and the Young/Daly period).  Then every
   SMOKE config's two f32 train steps on the card against the CPU, and
   the train CLI (``python -m repro_torch.launch.train --arch
   starcoder2_3b --smoke``) for 12 steps and again for 16 in the same
   checkpoint directory, which must resume.  No hand-written kernel
   runs: the launch counts must read 0;
15. dryrun-lm — the LM dry run (``python -m repro_torch.launch.dryrun``)
   in two processes of its own: llama3_8b's train_4k, prefill_32k and
   decode_32k and mamba2_370m's long_500k on the 16x16 layout (the
   depth variants g1 and g2 really run at full width, at one data
   replica's batch, cut where the card needs it), llama3_8b's decode_32k
   on 2x16x16 (the multi-pod pass, g1); every row ``ok`` with finite
   losses or logits, its per-device argument bytes equal to the
   reference's (``DRYRUN_LM_ARG_BYTES``), a calibrated row's
   extrapolated replica step at least its g1 step and within its range
   over the quartiles of the variants' timed steps, decode and
   long_500k steps timed as graph replays and the others eagerly (each
   variant's ``step_mode``); no hand-written
   kernel runs: the launch counts must read 0 (79-135 s on an H100 80GB
   HBM3 at 700 W with three timed steps a variant; each variant now
   times at least 2 s of steps, a few seconds more);
16. lm-mesh — LM serving over a ``(data, model)`` device mesh
   (``launch.mesh.make_mesh_for``: the shards span the visible cards,
   the one card repeated, a stream a shard): (a) llama3_8b at full
   width and depth, bf16 compute, on ``make_mesh_for(4)`` (1, 4) answers
   4 requests of 512 tokens with 16 generated tokens through
   ``ServeEngine.generate`` (an eager prefill, one eager decode step,
   then replays of one CUDA-graph capture of the mesh's decode step),
   with its prefill s, decode ms a token and the host's enqueue ms over
   the replays, capture s, replays, tokens/s, every shard's parameter
   and cache bytes against ``shard_shape``'s count and the peak bytes;
   beside it an eager leg of 4 decode steps from the same prompt whose
   tokens and logits must be the engine's bit for bit, with its ms and
   host ms a step; (b) llama3_8b at full width cut to 2 layers, f32, on
   (1, 4) and (2, 2): prefill and decode logits against the same model's
   one-device run within ``LM_REL_TOL``, and its decode steps replayed
   from a capture bitwise its eager steps; on (1, 4) its prefill with
   the residual stream seq-placed (the default rules) against the same
   model with ``"seq"`` on no axis: the logits' largest difference,
   bitwise or not, and each shard's stream bytes between layers, the
   seq layout's 1/4 of the whole's; (c) moonshot_v1_16b_a3b and
   dbrx_132b at full width cut to one layer, f32, capacity factor 16:
   the same, and whether the expert-parallel block at ``data = 1`` is
   bitwise the one-device block; (d) with two or more cards, (b)'s
   meshes over distinct cards bitwise the same meshes with every shard
   on the first card, eager and replayed steps (else a line
   ``"distinct_cards": "not run: 1 card visible"``); (e) mamba2_370m at
   its full config (48 layers), bf16, served as (a) is on
   ``make_mesh_for(4)``; (f) recurrentgemma_9b cut
   to 4 layers, whisper_small to 4 encoder and 4 decoder layers and
   qwen2_vl_72b to one layer,
   full width, f32, as (b) is on both meshes (whisper with its frames,
   qwen2_vl prefilled on patch embeddings with three M-RoPE position
   streams), with (d)'s distinct-card leg.  No hand-written kernel
   runs: the launch counts must read 0;
17. lm-train-mesh — LM training over a ``(data, model)`` device mesh of
   the one card (``make_mesh_for(4)`` (1, 4) and ``make_mesh_for(4, 2)``
   (2, 2), a stream a shard): (a) starcoder2_3b at its full ``CONFIG``
   (30 layers, bf16 compute) takes two AdamW steps of batch 2 x 1024
   on (1, 4) through ``make_train_step(make_train_forward(cfg))``:
   each step's seconds (CUDA events) and host enqueue ms, loss and grad
   norm, tokens/s, ``train_mfu``, the peak bytes, every shard's
   parameter and moment bytes against ``shard_shape``'s count, every
   replica bitwise; (b) moonshot_v1_16b_a3b at full width cut to 2
   layers (64 experts, 16 a model shard), two steps on (1, 4), the
   same lines; (a') mamba2_370m at its full ``CONFIG`` (48 layers, 32
   SSD heads), one step of 2 x 1024 on (1, 4) after an untimed step of
   its first 2 layers there, the same lines; (a) and (a')'s peaks
   beside those measured with the residual stream whole, with the
   saving the seq-placed stream is reckoned to bring; (c) the
   ten configs at full width, f32 (MoE at capacity factor 16), cut in
   depth (2 layers, dbrx_132b and qwen2_vl_72b 1, recurrentgemma_9b
   3, one (rec, rec, local) group, whisper_small whole), two steps of
   2 x 64 (with the train CLI's stub frames, patch embeddings and
   M-RoPE positions) on one device and on each mesh of
   ``MESH_TRAIN_CUT_MESHES``: loss, grad norm and every
   moment within 1e-4 of each leaf's scale of the one-device run, every
   parameter within 1e-4 of itself plus twice the summed ``lr`` (an MoE's one-device aux on the (2, 2) mesh the mean
   of the two data shards' rows' aux, as the mesh computes it), every
   replica bitwise, the (1, 4) steps run twice bitwise for
   moonshot; (d) a checkpoint slot of starcoder2_3b cut to 1 layer
   written on (1, 4), restored onto (2, 2) and onto one device, two
   more steps each within rtol = atol = 1e-5 of the uninterrupted run;
   (e) with two or more cards, (c)'s meshes over distinct cards bitwise
   the one-card meshes (else ``"distinct_cards": "not run: 1 card
   visible"``).  No hand-written kernel runs: the launch counts must
   read 0.

Every bound comes from ``repro_torch.launch.roofline`` (each function's
compulsory bytes and operations) over the card's rates in
``repro_torch.launch.mesh``.  Kernel launches are counted from a reset
just before each path (phases 4, 5, 7, 8, 9, each run of 10, the
sharded solve of 11, in their own processes the two CLIs of 12, 13,
14 and the dry-run processes of 15; 16 and 17 read their own) to
a reading just after it, graph replays included, and summed into the
kernel summary; the halo mode's and det_dot's entries also give the
launches of recovery's local CG on the main path, phase 4, with its
timings at that shape (``local_cg``).  The line before the last is the
kernel summary ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  The script imports
neither JAX nor the reference package.

``python3 chip_smoke.py --mesh-only`` runs phases 1, 2 and 11 (the
mesh, with its distinct-card leg where two or more cards are visible:
on a machine with four cards); like ``--times-only`` it is a measurement, and
its output ends without the ``ok`` line.

``python3 chip_smoke.py --lm-mesh-only`` runs phases 1, 2 and 16 (LM
serving over the mesh; on a machine with several cards its
distinct-card leg runs); its output also ends without the ``ok`` line.

``python3 chip_smoke.py --lm-train-mesh-only`` runs phases 1, 2 and 17
(LM training over the mesh); its output also ends without the ``ok``
line.

``python3 chip_smoke.py --times-only [--src DIR]`` runs phases 1-2,
prints both timing columns of every kernel at the main path's shapes and
runs phase 14's starcoder2_3b steps (step seconds, peak, ``train_mfu``),
from the ``repro_torch`` under ``DIR`` (default ``src``): two checkouts
timed in one call compare on one card.  It is a measurement, not the
smoke: its output ends without the ``ok`` line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
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
#: the card's ``nvidia-smi`` name and power limit, printed beside the LM
#: timings (set by phase 1)
CARD = None
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


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


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
    from repro_torch.launch import roofline as RL

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
    graph_ms = in_graph_ms(torch, lambda: k1.stencil7_cuda(u))
    library_graph_ms = in_graph_ms(torch, conv64)
    u32, w32 = u.float(), w.float()
    conv = lambda: F.conv3d(u32[None, None], w32, padding=1)  # noqa: E731
    k32 = k1.stencil7_cuda(u32)
    conv_err = max_abs(conv()[0, 0], k32)
    lib32_ms, lib32_dev_ms = both_ms(torch, conv)
    k32_ms, k32_dev_ms = both_ms(torch, lambda: k1.stencil7_cuda(u32))
    b_ms, b_by = RL.bound_ms(RL.stencil7_work(n, "float64"), "float64", rate)
    b32_ms, _ = RL.bound_ms(RL.stencil7_work(n, "float32"), "float32", rate)
    say("kernels", kernel="stencil7", kernel_ms=ms, kernel_device_ms=dev_ms,
        kernel_in_graph_ms=graph_ms, plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=library_dev_ms,
        library_in_graph_ms=library_graph_ms, library="conv3d float64",
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
        ms=ms, device_ms=dev_ms, in_graph_ms=graph_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        library_device_ms=library_dev_ms,
        library_in_graph_ms=library_graph_ms)
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
    b_ms, b_by = RL.bound_ms(RL.fused_cg_update_work(n, "float64"), "float64",
                             rate)
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
        b_ms, b_by = RL.bound_ms(RL.det_dot_work(m, "float64"), "float64",
                                 rate)
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
        k3_work = RL.gf256_rs_encode_work(K_DATA, data.shape[1], nparity)
        b_ms, b_by = RL.bound_ms(k3_work, "float64", rate)
        k3_times[nparity] = dict(ms=ms, device_ms=dev_ms, bound_ms=b_ms,
                                 bound_by=b_by)
        say("kernels", kernel="gf256_rs_encode", shards=list(data.shape),
            nparity=nparity, bitwise_equal=True, kernel_ms=ms,
            kernel_device_ms=dev_ms, bytes=k3_work.nbytes, bound_ms=b_ms,
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
    k4_work = RL.fused_cg_update_persist_work(n, "float64", K_DATA, NPARITY)
    b_ms, b_by = RL.bound_ms(k4_work, "float64", rate)
    say("kernels", kernel="fused_cg_update_persist", kernel_ms=ms,
        kernel_device_ms=dev_ms, plain_ms=plain_ms,
        k2_kernel_ms_same_call=k2_ms, k2_kernel_device_ms_same_call=k2_dev_ms,
        library_ms=None, library="no single PyTorch call computes it",
        bytes=k4_work.nbytes, bound_ms=b_ms, bound_by=b_by)
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
    from repro_torch.launch import roofline as RL

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
    b_ms, b_by = RL.bound_ms(RL.stencil7_work(total, "float64"), "float64",
                             rate)
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
    b_ms, b_by = RL.bound_ms(RL.fused_cg_update_work(total, "float64"),
                             "float64", rate)
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
    b_ms, b_by = RL.bound_ms(RL.det_dot_work(total, "float64"), "float64",
                             rate)
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
                        reps: int = 3, phase: str = "main"):
    """Where a persisted iteration's wall time goes: the device step,
    timed with CUDA events once the allocator is warm, and the residual
    norm's scalar pull, against the two halves of the host persistence
    path — the device-to-host copy of ``p`` (``host_shard``) and the
    backend's persist event (slot encode, CRC, simulated store writes,
    drain).  ``first_run_s`` is the unprotected solve's wall seconds per
    iteration, allocator warm-up included.  A sharded problem's step and
    norm run shard by shard, its pull slab by slab."""
    from repro_torch.solvers.base import solver_dot
    from repro_torch.solvers.registry import make_backend

    solver, state, step = pcg_step(problem)
    mesh = getattr(problem.op, "mesh", None)

    def joined_step():
        step(state)
        if mesh is not None:
            mesh.join()

    step_ms, step_dev_ms = both_ms(torch, joined_step)
    dot = solver_dot(problem.op)
    t0 = time.perf_counter()
    for _ in range(REPS):
        solver.residual_norm(state, dot)
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
    say(phase, breakdown="seconds per iteration",
        unprotected_run_s=first_run_s, device_step_s=step_ms / 1e3,
        device_step_back_to_back_s=step_dev_ms / 1e3,
        residual_norm_pull_s=norm_s, d2h_copy_s=d2h_s,
        d2h_bytes_per_s=host.nbytes / d2h_s, backend_persist_s=persist_s)
    return step_dev_ms


def local_cg_plain_vs_graph(torch, problem, spec, failure, graph_run,
                            graph_call) -> None:
    """Phase 4's sync recovery once more, up to the iteration after it,
    with the plain local CG (a host read an iteration) in place of the
    graph: the recovered state (``captured`` at the failure) and the
    local CG's ``x_F`` bitwise the graph run's (``graph_run``: its
    result and tracer), at the same iteration, and the recovery seconds
    of both side by side."""
    from repro_torch import api
    from repro_torch.obs import Tracer

    graph_run, graph_tracer = graph_run
    tracer = Tracer()
    with LocalCGWatch(torch, "_local_cg_plain") as watch:
        torch.cuda.synchronize()
        res = api.solve(problem, dataclasses.replace(spec,
                                                     maxiter=FAIL_AT + 1),
                        api.ResilienceSpec("nvm-prd", persist_mode="sync"),
                        failures=failure, capture_states_at=[FAIL_AT],
                        tracer=tracer)
        torch.cuda.synchronize()
    plain_call = watch.calls[0]
    same_x = bool(torch.equal(plain_call["x"], graph_call["x"]))
    same_state = all(bool(torch.equal(getattr(res.captured[FAIL_AT], f),
                                      getattr(graph_run.captured[FAIL_AT], f)))
                     for f in ("x", "r", "z", "p", "rz"))
    graph_recovery = _recovery_seconds(graph_tracer)
    plain_recovery = _recovery_seconds(tracer)
    say("main", recovery="blocks (1, 2) at 20, sync: plain loop vs graph",
        iterations=graph_call["iterations"],
        plain_iterations=plain_call["iterations"],
        plain_recovery_s=plain_recovery, graph_recovery_s=graph_recovery,
        plain_local_cg_s=plain_call["seconds"],
        graph_local_cg_s=graph_call["seconds"],
        graph_capture_s=graph_call["capture_s"],
        graph_chunk=graph_call["chunk"], graph_chunks=graph_call["chunks"],
        graph_eager_iterations=graph_call["eager_iterations"],
        graph_launches_per_chunk=graph_call["launches_per_chunk"],
        plain_ms_per_iteration=1e3 * plain_call["seconds"]
        / plain_call["iterations"],
        graph_ms_per_iteration=1e3 * graph_call["seconds"]
        / graph_call["iterations"],
        x_f_bitwise=same_x, recovered_state_bitwise=same_state)
    check(plain_call["iterations"] == graph_call["iterations"],
          "the plain local CG stopped at another iteration than the graph")
    check(same_x and same_state,
          "the graph's recovered state is not the plain loop's bitwise")


def local_cg_embed_vs_slabs(torch, problem, failure, call) -> None:
    """Phase 4's local CG once more on the same right-hand side with
    ``A[F,F]`` applied by the embed version (the union embedded into a zero
    grid, K1 over all of it, restrict), as a graph too: the same
    iteration count, ``x_F`` bitwise the failed-slab run's (so the
    recovered state is the one the embed version made), and both runs'
    seconds and ms an iteration side by side."""
    from repro_torch.core import reconstruction as rec

    op, part = problem.op, problem.op.partition
    failed = list(failure[0].blocks)
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = rec._local_cg(lambda u: part.restrict(op.apply(part.embed(
        u, failed)), failed), call["rhs"], info=info)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    same = bool(torch.equal(x, call["x"]))
    say("main", local_cg="failed slabs (K1 halo mode, zero planes) vs "
        "embed into the whole grid, both as graphs",
        blocks=failed, slab_shape=[len(failed) * GRID // NBLOCKS, GRID, GRID],
        iterations=call["iterations"], embed_iterations=info["iterations"],
        slabs_local_cg_s=call["seconds"], embed_local_cg_s=embed_s,
        slabs_ms_per_iteration=1e3 * call["seconds"] / call["iterations"],
        embed_ms_per_iteration=1e3 * embed_s / info["iterations"],
        slabs_capture_s=call["capture_s"], embed_capture_s=info["capture_s"],
        slabs_chunk_s=call["chunk_s"], embed_chunk_s=info["chunk_s"],
        slabs_launches_per_chunk=call["launches_per_chunk"],
        embed_launches_per_chunk=info["launches_per_chunk"],
        x_f_bitwise_embed=same)
    check(info["iterations"] == call["iterations"],
          "the embed local CG stopped at another iteration")
    check(same, "the failed-slab local CG's x_F is not the embed version's")


def pcg_step(problem):
    """(solver, initial state, step) of PCG on ``problem`` (a sharded
    problem's step runs shard by shard)."""
    from repro_torch.solvers.pcg import PCGSolver

    solver = PCGSolver()
    state = solver.init_state(problem.op, problem.precond, problem.b)
    return solver, state, solver.make_step(problem.op, problem.precond)


class LocalCGWatch:
    """Recovery's local CG (``core.reconstruction._local_cg``) wrapped
    while a path runs: each call's seconds (host clock between
    synchronisations), iterations, statistics, result and the launches
    it made, graph replays included, so that they are counted apart from
    the path's other launches.  ``loop`` picks the loop the wrapper
    calls: the dispatching ``_local_cg`` (the graph on the card) or
    ``_local_cg_plain``."""

    def __init__(self, torch, loop: str = "_local_cg"):
        from repro_torch.core import reconstruction as rec

        self.torch, self.rec = torch, rec
        self.loop = getattr(rec, loop)
        self.calls = []
        self.launches = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        def watched(apply_fn, rhs, tol=1e-14, maxiter=10000, info=None):
            info = {} if info is None else info
            before = ops.launch_counts()
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = self.loop(apply_fn, rhs, tol, maxiter, info=info)
            self.torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = ops.launch_counts()
            for name, n in after.items():
                self.launches[name] = (self.launches.get(name, 0)
                                       + n - before[name])
            self.calls.append(dict(info, seconds=seconds, x=x, rhs=rhs))
            return x

        self.saved = self.rec._local_cg
        self.rec._local_cg = watched
        return self

    def __exit__(self, *exc):
        self.rec._local_cg = self.saved

    def summary(self) -> list:
        return [{k: v for k, v in call.items() if k not in ("x", "rhs")}
                for call in self.calls]


def phase_main_path(torch, found, records):
    """The port's main path at full width; returns the launch counts.
    Its reports and its step's device time go into ``found`` (phase
    12), and the launches of recovery's local CG, counted apart, into
    K1's and det_dot's ``records``."""
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
        found["reports"].append(rep)
        return res, wall

    ops.reset_launch_counts()
    watch = LocalCGWatch(torch).__enter__()
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
        if mode == "sync":
            graph_run = (res, tracer)
        else:
            del res
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    watch.__exit__()
    say("main", launches=counts, local_cg_launches=watch.launches,
        local_cg_calls=watch.summary())
    for name in ("stencil7", "fused_cg_update", "det_dot"):
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    for name in ("stencil7_halo", "det_dot"):
        check(watch.launches.get(name, 0) > 0,
              f"recovery's local CG never launched {name}")
    check(watch.launches.get("stencil7", 0) == 0,
          "recovery's local CG launched K1 over the whole grid")
    check(all(c["graph"] for c in watch.calls),
          "a local CG on the card did not run as a graph")
    found["local_cg_halo_launches"] = watch.launches["stencil7_halo"]
    records["det_dot"]["local_cg"]["launches"] = watch.launches["det_dot"]
    local_cg_embed_vs_slabs(torch, problem, failure, watch.calls[0])
    local_cg_plain_vs_graph(torch, problem, spec, failure, graph_run,
                            watch.calls[0])
    del graph_run
    found["steps"]["phase 4: PCG step (main path)"] = dict(
        device_ms=iteration_breakdown(torch, problem, base.state.p,
                                      plain_wall / MAXITER),
        grid=(GRID,) * 3,
        timed_as="CUDA events around 25 back-to-back steps, median of 3 "
                 "windows")
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


def phase_erasure(torch, problem, recovered, found):
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
        found["reports"].append(rep)
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


def phase_jit(torch, problem, records, found):
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
    found["steps"]["phase 8: solve_jit graph iteration"] = dict(
        device_ms=graph_ms, grid=(GRID,) * 3,
        timed_as="host clock over the graph's chunk replays, an iteration")
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


def phase_advise(torch, problem, found):
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
        found["advice"].append((label, advice))
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
    steps, median device ms of a bucket step).  The counts run from a
    reset just before the first submission (the lane inits' K1
    included) to a reading after the drain."""
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
    return tickets, counts, steps, statistics.median(device_ms)


def phase_service(torch, found):
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
        tickets, counts, steps, step_ms = _serve_bucket(
            torch, label, members, failures, SVC_LANES,
            {SVC_COHABITANT: SVC_CAPTURE})
        if label.startswith("A"):
            found["steps"]["phase 10: service bucket step (run A)"] = dict(
                device_ms=step_ms, grid=(SVC_LANES, GRID, GRID, GRID),
                timed_as="CUDA events around each batched step, median")
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
#: the grid steps on sharded grids: steps of each variant against the
#: same steps on views of one buffer, and the dry-run cell whose first
#: step runs over every card where there are two or more
MESH_SHARDED_STEPS, MESH_SHARDED_CELL = 3, "pcg_128m"


def mesh_kernels(torch, rate: float, records: dict, found) -> None:
    """K1's halo mode at 2, 4 and 8 shards of the 256^3 float64 grid
    (the slabs side by side bitwise one full K1 launch; one sharded
    apply's device ms beside the full launch's, on views of one buffer
    and on a sharded vector's slabs with a stream a shard), one slab
    launch against its plain version with its timings and bound (the
    record of ``stencil7_halo``), the halo mode at recovery's local-CG
    shape (64 planes, zero halo planes), and the per-shard lane launches
    of det_dot and K2 at the 4-shard solve's shape, their chained sums
    bitwise the unsharded launches', on plain vectors and on sharded
    ones."""
    import torch.nn.functional as F

    from repro_torch.core import pcg, spmv
    from repro_torch.core.poisson import StencilOperator
    from repro_torch.core.state import PCGState
    from repro_torch.distributed import make_data_mesh, sharding
    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import stencil7 as k1
    from repro_torch.launch import roofline as RL

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    n, plane = GRID ** 3, GRID * GRID
    u = torch.randn(GRID, GRID, GRID, generator=gen, device=dev,
                    dtype=torch.float64)
    full = k1.stencil7_cuda(u)
    full_ms = device_ms(torch, lambda: k1.stencil7_cuda(u))
    b_full, by_full = RL.bound_ms(RL.stencil7_work(n, "float64"), "float64",
                                  rate)
    sharded_ms = {}
    for nshards in MESH_HALO_SHARDS:
        got = spmv.sharded_stencil7(u, nshards)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, full)),
              f"stencil7_halo at {nshards} shards != one full K1 launch")
        ms = sharded_ms[nshards] = device_ms(
            torch, lambda: spmv.sharded_stencil7(u, nshards))
        # the same apply on a sharded vector: a slab a shard, a stream a
        # shard, the halo planes moved between the streams
        sop = sharding.ShardedOperator(
            StencilOperator(GRID, GRID, GRID, nblocks=NBLOCKS, device=dev),
            sharding.ShardLayout(NBLOCKS, nshards),
            make_data_mesh(nshards, "cuda:0"))
        us = sop.device_put(u.view(-1))
        check(bool(torch.equal(sharding.gather(sop.apply(us)),
                               full.view(-1))),
              f"the {nshards}-slab sharded apply != one full K1 launch")

        def slab_apply():
            sop.apply(us)
            sop.mesh.join()

        slab_ms = sharded_ms[f"{nshards} slabs"] = device_ms(torch, slab_apply)
        say("mesh", kernel="stencil7_halo", nshards=nshards,
            bitwise_full_launch=True, sharded_apply_device_ms=ms,
            slabs_apply_device_ms=slab_ms, streams=nshards,
            full_launch_device_ms=full_ms, bound_ms=b_full, bound_by=by_full,
            halo_bytes=2 * (nshards - 1) * plane * 8)
        del sop, us

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
    b_ms, b_by = RL.bound_ms(RL.stencil7_halo_work(m, plane, 2, "float64"),
                             "float64", rate)
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
    del got, want, ext

    # recovery's local CG: K1's halo mode over the failed run of two
    # blocks (64 planes) with zero halo planes, in place of K1 over the
    # whole grid
    us = u[:2 * GRID // NBLOCKS].contiguous()
    got = k1.stencil7_halo_cuda(us, None, None)
    want = k1.stencil7_halo_plain(us, None, None)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    tol = 1e-12 * max(1.0, float(want.abs().max()))
    check(err <= tol, f"stencil7_halo local-CG slab error {err} > {tol}")
    check(bool(torch.equal(got, k1.stencil7_cuda(us))),
          "the zero-plane halo launch != K1 on the sub-grid")
    ms, dev_ms = both_ms(torch, lambda: k1.stencil7_halo_cuda(us, None, None))
    graph_ms = in_graph_ms(torch, lambda: k1.stencil7_halo_cuda(us, None,
                                                                None))
    plain_ms = time_ms(torch, lambda: k1.stencil7_halo_plain(us, None, None))
    conv = lambda: F.conv3d(us[None, None], w, padding=1)  # noqa: E731
    conv_err = max_abs(conv()[0, 0], got)
    lib_ms, lib_dev_ms = both_ms(torch, conv)
    b_ms, b_by = RL.bound_ms(RL.stencil7_halo_work(us.numel(), plane, 0,
                                                   "float64"), "float64", rate)
    local = dict(shape=list(us.shape), halo_planes=0,
                 launches=found.get("local_cg_halo_launches"),
                 max_abs_err=err, ms=ms, device_ms=dev_ms,
                 in_graph_ms=graph_ms, plain_ms=plain_ms, library_ms=lib_ms,
                 library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    say("mesh", kernel="stencil7_halo", at="recovery's local CG, blocks "
        "(1, 2)", library="conv3d float64, zero padding",
        conv_vs_kernel_max_abs_err=conv_err, bitwise_k1_subgrid=True, **local)
    records["stencil7_halo"]["local_cg"] = local
    del u, full, us, got, want

    # per-shard block sums: det_dot's and K2's lane modes, 2 blocks a shard
    x, r, p, ap = (torch.randn(n, generator=gen, device=dev,
                               dtype=torch.float64) for _ in range(4))
    inv = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) + 0.5
    alpha = torch.tensor(0.37, dtype=torch.float64, device=dev)
    mesh = make_data_mesh(MESH_NSHARDS, "cuda:0")
    bps = NBLOCKS // MESH_NSHARDS
    mesh_dot = spmv.make_det_dot(NBLOCKS, mesh)
    want_dot = k2.det_dot_cuda(p, ap, NBLOCKS)
    check(bool(torch.equal(mesh_dot(p, ap), want_dot)),
          "det_dot under a 4-shard mesh != the unsharded det_dot")
    ps_v, aps_v = mesh.place(p), mesh.place(ap)
    check(bool(torch.equal(mesh_dot(ps_v, aps_v), want_dot)),
          "det_dot of sharded vectors != the unsharded det_dot")
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
    lane_b, lane_by = RL.bound_ms(RL.det_dot_work(ps.numel(), "float64"),
                                  "float64", rate)
    # the yardstick: one PyTorch call for the shard's block sums
    vecdot = lambda: torch.linalg.vecdot(ps, aps)  # noqa: E731
    vecdot_err = max_abs(vecdot(), k2.det_dot_lanes_cuda(ps, aps))
    lib_ms, lib_dev_ms = both_ms(torch, vecdot)
    mesh_dot_ms = device_ms(torch, lambda: mesh_dot(p, ap))
    slabs_dot_ms = device_ms(torch, lambda: mesh_dot(ps_v, aps_v))
    del ps_v, aps_v
    dot_ms = device_ms(torch, lambda: k2.det_dot_cuda(p, ap, NBLOCKS))
    b_dot, _ = RL.bound_ms(RL.det_dot_work(n, "float64"), "float64", rate)
    say("mesh", kernel="det_dot_lanes", shard_blocks=bps,
        n=ps.numel(), kernel_ms=lane_ms, kernel_device_ms=lane_dev_ms,
        library_ms=lib_ms, library_device_ms=lib_dev_ms,
        library="torch.linalg.vecdot", vecdot_vs_kernel_max_abs_err=vecdot_err,
        bound_ms=lane_b, bound_by=lane_by, mesh_dot_device_ms=mesh_dot_ms,
        slabs_mesh_dot_device_ms=slabs_dot_ms,
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
    k2_b, k2_by = RL.bound_ms(RL.fused_cg_update_work(xs.numel(), "float64"),
                              "float64", rate)
    mesh_step_ms = device_ms(torch, lambda: mesh_step(state))
    plain_step_ms = device_ms(torch, lambda: plain_step(state))
    say("mesh", kernel="fused_cg_update_lanes", shard_blocks=bps,
        n=xs.numel(), kernel_ms=k2_ms, kernel_device_ms=k2_dev_ms,
        bound_ms=k2_b, bound_by=k2_by, sharded_step_device_ms=mesh_step_ms,
        unsharded_step_device_ms=plain_step_ms, step_bitwise=True)
    del x, r, p, ap, inv, got, want, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_mesh(torch, rate: float, records: dict, found) -> dict:
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
    from repro_torch.distributed.sharding import gather
    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil7 as k1
    from repro_torch.obs import Tracer

    t_phase = time.perf_counter()
    mesh_kernels(torch, rate, records, found)
    spec = api.SolverSpec("pcg", tol=1e-10, maxiter=MESH_MAXITER)

    walls = {}

    def run(label, nshards, event, spec_=spec, backend="nvm-prd",
            mesh=None):
        problem = api.Problem.poisson(GRID, nblocks=NBLOCKS, device=DEVICE)
        if nshards > 1:
            problem = problem.with_shards(nshards, mesh=mesh)
        tracer = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(problem, spec_,
                        api.ResilienceSpec(backend, nshards=nshards),
                        failures=[api.FailureEvent(**event)], tracer=tracer)
        torch.cuda.synchronize()
        wall = walls[label] = time.perf_counter() - t0
        rep = res.report
        # where the wall went: the set-up before the first step, each
        # iteration's seconds (step start to step start) and the recovery
        starts = [r["ts"] for r in tracer.records if r["type"] == "span"
                  and r["name"] == "iteration.step"]
        say("mesh", run=label, setup_s=starts[0] if starts else None,
            iteration_s=[round(b - a, 4) for a, b in zip(starts, starts[1:])],
            recovery_s=_recovery_seconds(tracer))
        say("mesh", run=label, nshards=rep.nshards,
            iterations=rep.iterations, wall_s=wall,
            s_per_iteration=wall / max(rep.iterations, 1),
            relres=rep.final_relres, failures_recovered=rep.failures_recovered,
            recovery_fetch_bytes=rep.recovery_fetch_bytes,
            recovery_fetch_bytes_by_shard=rep.recovery_fetch_bytes_by_shard,
            persist_bytes_by_shard=rep.persist_bytes_by_shard,
            halo_bytes=getattr(problem.op, "halo_bytes", 0))
        check(rep.failures_recovered == 1, f"{label}: no recovery")
        check(bool(torch.isfinite(gather(res.state.x)).all()),
              f"{label}: x not finite")
        return res, problem

    ops.reset_launch_counts()
    label = f"{MESH_NSHARDS} shards, shard 1 killed"
    sharded, problem = run(label, MESH_NSHARDS,
                           dict(shard=1, at_iteration=MESH_FAIL_AT))
    sharded_wall = walls[label]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    say("mesh", launches=counts)
    for name in ("stencil7_halo", "fused_cg_update_lanes", "det_dot_lanes"):
        check(counts[name] > 0, f"kernel {name} never launched on the "
              f"sharded path")
    check(counts["stencil7_halo"] >= MESH_NSHARDS * MESH_MAXITER,
          f"stencil7_halo launched {counts['stencil7_halo']} times")
    check(all(slab.device == dev for slab, dev in zip(
        sharded.state.x.slabs, problem.op.mesh.devices)),
        "a slab of the sharded solve is not on its shard's device")
    _, state, step = pcg_step(problem)

    def slab_step():
        step(state)
        problem.op.mesh.join()

    slab_ms = device_ms(torch, slab_step)
    # the one-buffer layout of the same step: full-length vectors on the card,
    # the shards views of them, every launch on the current stream
    views = PCGState(**{f: gather(getattr(state, f)) for f in
                        ("x", "r", "z", "p", "rz", "beta_prev")}, k=0)
    views_step = pcg.make_step(problem.op.apply,
                               gather(problem.precond.inv_diag), NBLOCKS,
                               problem.op.mesh)
    a, b_ = step(state), views_step(views)
    check(all(bool(torch.equal(gather(getattr(a, f)), getattr(b_, f)))
              for f in ("x", "r", "z", "p", "rz", "beta_prev")),
          "the slab step != the step on views of one buffer")
    views_ms = device_ms(torch, lambda: views_step(views))
    say("mesh", step=f"{MESH_NSHARDS}-shard PCG step, 256^3 float64",
        slabs_streams_device_ms=slab_ms, views_one_buffer_device_ms=views_ms,
        views_layout="one buffer, views a shard, one stream",
        bitwise=True)
    found["steps"][f"phase 11: {MESH_NSHARDS}-shard PCG step"] = dict(
        device_ms=slab_ms, grid=(GRID,) * 3,
        nshards=MESH_NSHARDS, nblocks=NBLOCKS,
        timed_as="CUDA events around 25 back-to-back steps, median of 3 "
                 "windows, the current stream joined to every shard's: the "
                 "host's launch gaps included, as the sharded step's host "
                 "work outlasts its kernels")
    iteration_breakdown(torch, problem, sharded.state.p,
                        sharded_wall / sharded.iterations, phase="mesh")
    del state, step, views, views_step, a, b_
    blocks = problem.op.layout.blocks_of(1)
    plain, _ = run(f"unsharded, blocks {blocks} killed", 1,
                   dict(blocks=blocks, at_iteration=MESH_FAIL_AT))
    rep = sharded.report
    slot = PCG_SCHEMA.history * len(blocks) * PCG_SCHEMA.slot_nbytes(
        problem.op.partition.block_size, "float64")
    check(sharded.iterations == plain.iterations == MESH_MAXITER,
          f"iterations {sharded.iterations} vs {plain.iterations}")
    check(bool(torch.equal(gather(sharded.state.x), plain.state.x))
          and bool(torch.equal(gather(sharded.state.r), plain.state.r)),
          "the sharded solve's x, r != the unsharded solve's bitwise")
    check(rep.recovery_fetch_bytes == slot
          and rep.recovery_fetch_bytes_by_shard == {1: slot},
          f"fetch bytes {rep.recovery_fetch_bytes_by_shard} != one shard's "
          f"{slot}")
    say("mesh", check="sharded == unsharded", x_bitwise=True, r_bitwise=True,
        fetch_bytes=slot, relres=rep.final_relres)
    del plain, problem

    # the same solve with the shards on distinct cards, where there are
    # two or more
    cards = torch.cuda.device_count()
    if cards >= 2:
        far, problem = run(f"{MESH_NSHARDS} shards on {min(cards, MESH_NSHARDS)}"
                           f" cards, shard 1 killed", MESH_NSHARDS,
                           dict(shard=1, at_iteration=MESH_FAIL_AT),
                           mesh=make_data_mesh(MESH_NSHARDS))
        devices = [str(d) for d in problem.op.mesh.devices]
        same = (bool(torch.equal(gather(far.state.x), gather(sharded.state.x)))
                and bool(torch.equal(gather(far.state.r),
                                     gather(sharded.state.r))))
        _, state, step = pcg_step(problem)

        def far_step():
            step(state)
            problem.op.mesh.join()

        say("mesh", distinct_cards=devices, x_r_bitwise_one_card=same,
            iterations=far.iterations,
            step_device_ms=device_ms(torch, far_step),
            one_card_step_device_ms=slab_ms)
        check(same, "the solve on distinct cards != the one-card solve")
        del far, problem, state, step
    else:
        say("mesh", distinct_cards=f"not run: {cards} card visible")
    del sharded

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
                                                         "cuda:0"))
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
    grid_steps_sharded(torch, cards)
    say("mesh", phase_seconds=time.perf_counter() - t_phase)
    return counts


def grid_steps_sharded(torch, cards: int) -> None:
    """The PCG grid steps on sharded grids (``DataMesh.place``'s
    ``(nz / n, ny, nx)`` slabs, each its own tensor on its shard): on
    the 4-shard mesh of the one card, a stream a shard, 256^3 float32,
    ``MESH_SHARDED_STEPS`` steps of both variants with the in-memory ESR
    replica, every field bitwise the same steps on views of one buffer;
    with two or more cards the same over ``make_data_mesh(4)``, and
    ``MESH_SHARDED_CELL``'s first step on the 16x16 layout's 256 shards
    spread over every card, its x and r finite.  These launches are
    checks: they count toward no path."""
    from repro_torch.configs.poisson_pcg import GRIDS
    from repro_torch.core import spmv
    from repro_torch.distributed import make_data_mesh, sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    b = torch.randn(GRID, GRID, GRID, generator=gen, device="cuda:0",
                    dtype=torch.float32)
    meshes = {"one card": make_data_mesh(MESH_NSHARDS, "cuda:0")}
    if cards >= 2:
        meshes["distinct cards"] = make_data_mesh(MESH_NSHARDS)
    views_dot = spmv.make_det_dot(MESH_NSHARDS, meshes["one card"])
    for label, mesh in meshes.items():
        rec = dict(check="grid steps on sharded grids vs views of one "
                         "buffer", mesh=label,
                   devices=[str(d) for d in mesh.devices],
                   grid=[GRID] * 3, steps=MESH_SHARDED_STEPS)
        for variant, make in (("auto", spmv.make_sharded_pcg_step),
                              ("shardmap", spmv.make_shardmap_pcg_step)):
            step, _ = make(mesh, esr_mode="inmemory")
            z = b * (1.0 / 6.0)
            views = dict(x=torch.zeros_like(b), r=b, z=z, p=z.clone(),
                         rz=views_dot(b.reshape(-1), z.reshape(-1)))
            placed = {f: mesh.place(v) if v.dim() == 3 else v
                      for f, v in views.items()}
            views["esr_red_cur"] = z.clone()
            placed["esr_red_cur"] = sharding.replicate(placed["p"])
            same, walls = True, {"views": 0.0, "sharded": 0.0}
            for _ in range(MESH_SHARDED_STEPS):
                for name in walls:
                    mesh.synchronize()
                    t0 = time.perf_counter()
                    if name == "views":
                        views = step(views)
                    else:
                        placed = step(placed)
                    mesh.synchronize()
                    walls[name] += time.perf_counter() - t0
                for f, v in views.items():
                    got = placed[f]
                    if isinstance(got, tuple):
                        same &= all(bool(torch.equal(t.to("cuda:0"), v))
                                    for t in got)
                    else:
                        same &= bool(torch.equal(sharding.gather(got), v))
                same &= [s.device for s in placed["x"].slabs] == list(
                    mesh.devices)
                views = {f: v for f, v in views.items()
                         if f not in ("beta", "esr_red_prev")}
                placed = {f: v for f, v in placed.items() if f in views}
            rec[f"{variant}_bitwise"] = same
            rec[f"{variant}_ms_per_step"] = {
                k: 1e3 * v / MESH_SHARDED_STEPS for k, v in walls.items()}
            check(same, f"the {variant} grid step on sharded grids ({label})"
                        f" != the step on views of one buffer")
            del views, placed, z
        say("mesh", **rec)
    if cards < 2:
        say("mesh", check="grid steps over distinct cards",
            distinct_cards=f"not run: {cards} card visible")
        del b
        return
    sc = GRIDS[MESH_SHARDED_CELL]
    mesh = M.make_data_mesh(M.LAYOUTS["16x16"])
    step, spec = dryrun.cell_step(sc, mesh)
    _, structs = spec(*sc.grid)
    state = dryrun.cell_state(structs, mesh, mesh.device)
    mesh.synchronize()
    t0 = time.perf_counter()
    out = step(state)
    mesh.synchronize()
    first_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(slab).all())
                 for slab in out["x"].slabs + out["r"].slabs)
    say("mesh", check="dry-run cell over distinct cards",
        cell=sc.name, shards=mesh.nshards,
        cards=len(set(mesh.devices)), sharded=isinstance(
            out["x"], sharding.ShardedVector),
        first_step_s=first_s, x_r_finite=finite)
    check(finite, f"{sc.name} over {cards} cards: x or r not finite")
    del b, state, out
    torch.cuda.empty_cache()


#: phase 12: the serve CLI's trace (seed, requests, lanes, failures, and
#: the CLI's defaults the in-process replay repeats), and the elapsed
#: seconds under which the dry run also takes the 2x16x16 layout
LAUNCH_SERVE_ARGS = ("--seed", "0", "--requests", "6", "--lanes", "4",
                     "--failures")
LAUNCH_TRACE = dict(seed=0, nrequests=6, failure_rate=0.6,
                    survivable_only=True)
LAUNCH_LANES, LAUNCH_MAX_QUEUE = 4, 8
LAUNCH_BOTH_LAYOUTS_S = 700
#: the dry run's kernels at its shapes against their plain versions
#: (float32): an output's error over its largest value, and a sum's over
#: the sum of its terms' magnitudes; one dry-run cell's first step
#: against the unsharded fused step on the same state (the error over
#: each field's largest value), on the 2x16x16 layout's one-plane slabs
LAUNCH_F32_TOL, LAUNCH_SUM_TOL, LAUNCH_STEP_RTOL = 1e-6, 1e-5, 1e-5
LAUNCH_STEP_CELL, LAUNCH_STEP_LAYOUT = "pcg_128m", "2x16x16"
#: a tenant line of the serve CLI: name, solver, conv, iters, recovered
_TENANT_LINE = re.compile(
    r"^  (\S+): (\S+)\s+conv=(\S+)\s+iters=\s*(\d+) recovered=(\d+) ")


def run_cli(torch, module: str, args, timeout: float, then=()):
    """``python -m module *args`` in a fresh process on the card, then in
    the same process the module again with each argument list of
    ``then``, with the kernels' launch counts reset to 0 there before
    the module runs and read after the last run; returns (its stdout
    lines, the counts, seconds).  The process is killed if it outlives
    ``timeout``."""
    argvs = [[module, *a] for a in (args, *then)]
    code = ("import json, runpy, sys\n"
            "from repro_torch.kernels import ops\n"
            "ops.reset_launch_counts()\n"
            "try:\n"
            f"    for argv in {argvs!r}:\n"
            "        sys.argv = argv\n"
            f"        runpy.run_module({module!r}, run_name='__main__', "
            "alter_sys=True)\n"
            "finally:\n"
            "    print('LAUNCHES ' + json.dumps(ops.launch_counts()), "
            "flush=True)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env, cwd=ROOT, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"{module} ran past {timeout} s") from e
    seconds = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    counts = [json.loads(ln[len("LAUNCHES "):]) for ln in lines
              if ln.startswith("LAUNCHES ")]
    lines = [ln for ln in lines if not ln.startswith("LAUNCHES ")]
    say("launch", cli=module, args=[list(a) for a in (args, *then)],
        exit_code=res.returncode,
        seconds=seconds, launches=counts[0] if counts else None)
    check(res.returncode == 0 and len(counts) == 1,
          f"{module} {' '.join(args)} exited {res.returncode}:\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return lines, counts[0], seconds


def _tenant_fields(line: str):
    m = _TENANT_LINE.match(line)
    return m.groups() if m else line


def dryrun_kernels(torch) -> None:
    """The dry run's kernels at the shapes its cells give them, against
    their plain versions in float32: K1's halo mode on the slab of every
    (grid, layout), an interior shard's (both halo planes from the
    buffers) and each boundary shard's; one lane of det_dot's and K2's
    lane modes at a shard's length; then the first step of one cell,
    both grid-step variants, against the unsharded fused step (K1, K2 and
    det_dot on the whole grid) on the same state.  These launches are
    checks: they count toward no path."""
    from repro_torch.configs.poisson_pcg import GRIDS
    from repro_torch.core import pcg
    from repro_torch.core.state import PCGState
    from repro_torch.kernels import fused_cg as k2
    from repro_torch.kernels import stencil7 as k1
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M

    dev = torch.device("cuda")
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(17)

    def rel(got, want):
        return float((got.double() - want.double()).abs().max()
                     / max(1.0, float(want.double().abs().max())))

    shapes = sorted({(sc.grid, shards) for sc in GRIDS.values()
                     for shards in M.LAYOUTS.values()})
    for grid, nshards in shapes:
        nz, ny, nx = grid
        slab = nz // nshards
        u = torch.randn(slab + 2, ny, nx, generator=gen, device=dev,
                        dtype=f32)
        us, lo, hi = u[1:-1], u[0], u[-1]
        halo = {}
        for label, planes in (("interior", (lo, hi)), ("first", (None, hi)),
                              ("last", (lo, None))):
            got = k1.stencil7_halo_cuda(us, *planes)
            want = k1.stencil7_halo_plain(us, *planes)
            torch.cuda.synchronize()
            halo[label] = err = rel(got, want)
            check(err <= LAUNCH_F32_TOL, f"stencil7_halo on a {list(us.shape)}"
                  f" float32 slab ({label} shard): error {err}")
        m = nz * ny * nx // nshards
        x, r, p, ap = (torch.randn(1, m, generator=gen, device=dev, dtype=f32)
                       for _ in range(4))
        inv = torch.rand(1, m, generator=gen, device=dev, dtype=f32) + 0.5
        alpha = torch.full((1,), 0.37, device=dev, dtype=f32)
        scale = float((p.double() * ap.double()).abs().sum())
        dot_err = float((k2.det_dot_lanes_cuda(p, ap).double()
                         - k2.det_dot_lanes_plain(p, ap).double()).abs().max()
                        ) / scale
        check(dot_err <= LAUNCH_SUM_TOL, f"det_dot_lanes on (1, {m}) float32: "
              f"error {dot_err} of the terms' magnitude")
        got = k2.fused_cg_update_lanes_cuda(x, r, p, ap, alpha, inv)
        want = k2.fused_cg_update_lanes_plain(x, r, p, ap, alpha, inv)
        upd_err = max(rel(g, w) for g, w in zip(got[:3], want[:3]))
        rz_scale = float((want[1].double() * want[2].double()).abs().sum())
        rz_err = float((got[3].double() - want[3].double()).abs().max()
                       ) / rz_scale
        check(upd_err <= LAUNCH_F32_TOL and rz_err <= LAUNCH_SUM_TOL,
              f"fused_cg_update_lanes on (1, {m}) float32: x', r', z' error "
              f"{upd_err}, rz' error {rz_err}")
        say("launch", check="dry-run kernels vs plain, float32",
            grid=list(grid), shards=nshards, slab=list(us.shape),
            stencil7_halo_err=halo, lane_length=m, det_dot_lanes_err=dot_err,
            fused_cg_update_lanes_err=upd_err, rz_err=rz_err,
            tol=LAUNCH_F32_TOL, sum_tol=LAUNCH_SUM_TOL)
        del u, us, lo, hi, x, r, p, ap, inv, got, want

    # one cell's first step, both variants, against the unsharded step
    base = GRIDS[LAUNCH_STEP_CELL]
    nshards = M.LAYOUTS[LAUNCH_STEP_LAYOUT]
    mesh = M.make_data_mesh(nshards, "cuda:0")
    inv = torch.full((math.prod(base.grid),), 1.0 / 6.0, device=dev,
                     dtype=f32)
    ref_step = pcg.make_step(lambda v: k1.stencil7_cuda(
        v.view(base.grid)).view(-1), inv, 1)
    for variant in ("auto", "shardmap"):
        sc = dataclasses.replace(base, variant=variant)
        step, spec = dryrun.cell_step(sc, mesh)
        _, structs = spec(*sc.grid)
        state = dryrun.cell_state(structs, mesh, dev)
        out = step(state)
        ref = ref_step(PCGState(
            x=state["x"].reshape(-1), r=state["r"].reshape(-1),
            z=state["z"].reshape(-1), p=state["p"].reshape(-1),
            rz=state["rz"], beta_prev=state["rz"] * 0, k=0))
        torch.cuda.synchronize()
        errs = {f: rel(out[f].reshape(-1), getattr(ref, f))
                for f in ("x", "r", "z", "p")}
        say("launch", check="dry-run first step vs unsharded fused step",
            cell=sc.name, variant=variant, layout=LAUNCH_STEP_LAYOUT,
            shards=nshards, grid=list(sc.grid), max_rel_err=errs,
            rtol=LAUNCH_STEP_RTOL)
        check(max(errs.values()) <= LAUNCH_STEP_RTOL,
              f"{sc.name} ({variant}) on {nshards} shards: first step off "
              f"the unsharded step by {errs}")
        del state, out, ref, step, spec, structs
    del inv, ref_step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_launch(torch, rate: float, found, t_start: float) -> dict:
    """The launch layer on the card: the roofline shares of the 256^3
    float64 steps the earlier phases timed, the report tables of their
    runs, the serve CLI (tenants against an in-process CPU replay of the
    same trace), the dry run's kernels and one cell's first step against
    their plain versions, and the solver dry run at the pod-scale grids,
    each CLI in its own process.  Returns the two CLIs' launch counts."""
    from repro_torch import api
    from repro_torch.configs.poisson_pcg import GRIDS
    from repro_torch.launch import mesh, report, serve
    from repro_torch.launch import roofline as RL
    from repro_torch.nvm.backend import backend_names
    from repro_torch.solvers.registry import make_backend

    t_phase = time.perf_counter()
    # ---- the roofline share of each step path ---------------------------
    check(len(found["steps"]) == 4, f"steps timed: {sorted(found['steps'])}")
    for label, st in found["steps"].items():
        roof = RL.pcg_step_roofline(st["grid"], "float64",
                                    nshards=st.get("nshards", 1),
                                    nblocks=st.get("nblocks", 1),
                                    hbm_rate=rate)
        bound = 1e3 * roof.step_time_lb
        say("launch", step=label, ms=st["device_ms"], timed_as=st["timed_as"],
            bound_ms=bound, share_of_bound=bound / st["device_ms"],
            bottleneck=roof.bottleneck, hbm_bytes=roof.hbm_bytes,
            ops=roof.flops, coll_by_kind=roof.coll_by_kind)

    # ---- the report tables of phases 4, 5 and 9 -------------------------
    print("[launch] solve_report_table, phases 4 and 5:\n"
          + report.solve_report_table(found["reports"]), flush=True)
    op = api.Problem.poisson(64, nblocks=NBLOCKS, device=DEVICE).op
    print("[launch] capability_matrix_table (storage against nvm-prd):\n"
          + report.capability_matrix_table(
              ((name, make_backend(name, op)) for name in backend_names()),
              baseline_values=report.storage_values(
                  make_backend("nvm-prd", op))), flush=True)
    for label, advice in found["advice"]:
        print(f"[launch] spec_advice_table, phase 9, {label}:\n"
              + report.spec_advice_table(advice), flush=True)
    del op

    # ---- the serve CLI against the same trace replayed on the CPU ------
    lines, serve_counts, _ = run_cli(torch, "repro_torch.launch.serve",
                                     LAUNCH_SERVE_ARGS, 600)
    for line in lines:
        print(f"[launch] serve: {line}", flush=True)
    cpu = api.serve(api.generate_request_trace(**LAUNCH_TRACE),
                    lanes=LAUNCH_LANES, max_queue=LAUNCH_MAX_QUEUE,
                    device="cpu")
    want = [_tenant_fields(ln) for ln in serve.tenant_lines(cpu)]
    got = [_tenant_fields(ln) for ln in lines if ln.startswith("  ")]
    say("launch", check="serve CLI on the card vs the CPU replay",
        fields="tenant, solver, conv, iters, recovered", card=got, cpu=want,
        equal=got == want)
    check(got == want and len(got) == LAUNCH_TRACE["nrequests"],
          "the serve CLI's tenants differ from the CPU replay")
    for name in ("stencil7", "det_dot_lanes", "fused_cg_update_lanes"):
        check(serve_counts[name] > 0, f"the serve CLI never launched {name}")

    # ---- the solver dry run ---------------------------------------------
    dryrun_kernels(torch)
    out = os.path.join(ROOT, "results", "chip_smoke_dryrun.jsonl")
    if os.path.exists(out):
        os.remove(out)
    args = ["--solver", "--out", out, "--mesh"]
    _, dry_counts, single_s = run_cli(torch, "repro_torch.launch.dryrun",
                                      args + ["single"], 900)
    layouts = ["16x16"]
    elapsed = time.perf_counter() - t_start
    if elapsed + single_s < LAUNCH_BOTH_LAYOUTS_S:
        _, multi_counts, _ = run_cli(torch, "repro_torch.launch.dryrun",
                                     args + ["multi"], 900)
        dry_counts = {k: v + multi_counts[k] for k, v in dry_counts.items()}
        layouts.append("2x16x16")
    say("launch", dryrun_layouts=layouts, elapsed_before_multi_s=elapsed,
        single_layout_s=single_s, limit_s=LAUNCH_BOTH_LAYOUTS_S,
        note="both layouts when the script's elapsed seconds plus one "
             "layout's stay under the limit, else 16x16 only")
    rows = report.load(out)
    memory = mesh.device_memory_bytes(DEVICE)
    for layout in layouts:
        for cell in GRIDS:
            row = rows.get(("poisson_pcg", cell, layout))
            check(row is not None, f"no dry-run row for {cell} on {layout}")
            say("launch", dryrun_row=row)
            peak = row["memory"]["peak_bytes"]
            check(row["x_r_finite"], f"{cell} on {layout}: x or r not finite")
            check(peak is not None and peak <= memory,
                  f"{cell} on {layout}: peak {peak} bytes > {memory}")
            check(row["chips"] == mesh.LAYOUTS[layout],
                  f"{cell} on {layout}: {row['chips']} shards")
        print(f"[launch] dry-run table, {layout}:\n"
              + report.table(rows, mesh=layout), flush=True)
    if "2x16x16" in layouts:
        print("[launch] dry-run multipod table:\n"
              + report.multipod_table(rows), flush=True)
    for name in ("stencil7_halo", "det_dot_lanes", "fused_cg_update_lanes"):
        check(dry_counts[name] > 0, f"the dry run never launched {name}")
    counts = {k: v + dry_counts[k] for k, v in serve_counts.items()}
    say("launch", launches=counts, phase_seconds=time.perf_counter() - t_phase)
    return counts


#: phase 13: LM serving.  llama3_8b at its full CONFIG (32 layers, bf16
#: compute) answers four requests: a 512-token prompt and 32 generated
#: tokens each, through ``ServeEngine.generate``
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3_8b", 4, 512, 32
#: the other nine configs at full width and f32 compute (MoE capacity
#: factor 16, as tests/test_decode_consistency.py runs them), cut in depth
#: only, to one pattern period (whisper, mamba2 and starcoder2 whole):
#: prefill 2 x 64, then 4 decode steps
LM_CUT_DEPTH = {"moonshot_v1_16b_a3b": 1, "dbrx_132b": 1, "granite_20b": 1,
                "starcoder2_3b": None, "gemma3_12b": 6, "whisper_small": None,
                "mamba2_370m": None, "recurrentgemma_9b": 4,
                "qwen2_vl_72b": 1}
LM_CUT_BATCH, LM_CUT_PROMPT, LM_CUT_STEPS = 2, 64, 4
#: prefill and decode logits against the teacher-forced forward (f32 on
#: the card, TF32 off): the largest difference over the largest |logit|.
#: Decode and prefill sum in other orders (and SSD's recurrence against
#: its chunked scan): f32 round-off (6e-8) times sqrt(d_model) times the
#: depth is 1.3e-4 for mamba2's 48 layers of d_inner 2048 and 1e-4 for
#: starcoder2's 30 of 3072
LM_REL_TOL = 5e-4


def _aten_ops(fn) -> int:
    """The ATen operations ``fn`` dispatches (a count, not a time: the
    dispatch mode slows every op it sees)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def _step_marks(torch, marks: list):
    """An ``on_step`` for ``ServeEngine.generate`` that appends, at each
    step, a CUDA event recorded on the engine's stream (no
    synchronisation), the host clock, and whether the logits were finite
    (a device tensor)."""
    def mark(i, logits):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((i, event, time.perf_counter(),
                      torch.isfinite(logits).all()))
    return mark


def lm_serve(torch, cfg, batch: int, prompt_len: int, gen: int,
             rate: float, device=DEVICE) -> dict:
    """``cfg`` initialised on the card from a seeded ``torch.Generator``
    serves ``batch`` requests through ``ServeEngine.generate`` (a warm-up
    of 3 tokens, then the timed run of ``gen``): the decode runs one
    eager step, then replays of one CUDA-graph capture.  Measured: the
    prefill seconds, the eager first decode step's ms, the capture's
    seconds, the decode ms a token (CUDA events between consecutive
    steps, median over the replays after the first), the host's enqueue
    ms a token over the same steps, tokens/s, peak memory, and the
    shares of the bf16 peak (prefill) and of the HBM rate (decode); the
    first token checked against the argmax of a teacher-forced forward
    over the prompt.  Then a second graph run's tokens and every step's
    logits against an eager loop over ``make_decode`` from its own
    prefill, bit for bit, and the ATen ops one decode step dispatches,
    counted apart from the timed run."""
    from repro_torch.launch import mesh
    from repro_torch.launch import roofline as RL
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    dev = torch.device(device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    eng = ServeEngine(R.make_prefill(cfg), R.make_decode(cfg),
                      lambda b, s: R.init_caches(cfg, b, s, device=dev))
    t0 = time.perf_counter()
    eng.generate(model, prompt, 3)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    marks: list = []
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = eng.generate(model, prompt, gen, on_step=_step_marks(torch, marks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(eng.stats)
    check(all(bool(m[3]) for m in marks), f"{cfg.name}: non-finite logits")
    check(tuple(out.shape) == (batch, gen), f"{cfg.name}: out {out.shape}")
    check([m[0] for m in marks] == list(range(gen)),
          f"{cfg.name}: on_step saw {[m[0] for m in marks]}")
    check(stats["graph"] and stats["eager_steps"] == 1
          and stats["replays"] == gen - 2,
          f"{cfg.name}: the engine ran {stats}, want one eager decode step "
          f"and {gen - 2} replays")
    prefill_ms = start.elapsed_time(marks[0][1])
    eager_ms = marks[0][1].elapsed_time(marks[1][1])
    # step i >= 3: one replay, the argmax and the static inputs' writes
    replay_ms = [marks[i - 1][1].elapsed_time(marks[i][1])
                 for i in range(3, gen)]
    enqueue_ms = [1e3 * (marks[i][2] - marks[i - 1][2]) for i in range(3, gen)]
    step_ms = statistics.median(replay_ms)
    bitwise = lm_graph_vs_eager(torch, cfg, model, prompt, gen, eng)
    with torch.inference_mode():
        forced = T.decoder_forward(model, prompt, cfg)[0][:, -1]
        caches = R.init_caches(cfg, batch, prompt_len + 1, device=dev)
        _, caches = R.make_prefill(cfg)(model, prompt, caches)
        position = torch.tensor(prompt_len, dtype=torch.int32, device=dev)
        decode_ops = _aten_ops(lambda: R.make_decode(cfg)(
            model, out[:, :1], caches, position))
    first_ok = torch.equal(forced.argmax(-1), out[:, 0])
    check(first_ok, f"{cfg.name}: the first token is not the argmax of the "
          f"teacher-forced forward over the prompt")
    peak = torch.cuda.max_memory_allocated()
    flops = RL.model_flops(cfg, R.Shape("prefill", "prefill", prompt_len,
                                        batch), "prefill")
    position = prompt_len + (gen - 1) // 2   # the median step's cache index
    step_bytes = RL.decode_step_bytes(cfg, batch, position)
    rec = dict(arch=cfg.name, params=nparams, layers=cfg.n_layers,
               d_model=cfg.d_model, compute=cfg.compute_dtype, batch=batch,
               prompt=prompt_len, gen=gen, init_s=init_s,
               first_generate_s=first_s, prefill_s=prefill_ms / 1e3,
               eager_step_ms=eager_ms, capture_s=stats["capture_s"],
               replays=stats["replays"], first_replay_ms=marks[1][1]
               .elapsed_time(marks[2][1]),
               decode_ms_per_token=step_ms, decode_ms_min=min(replay_ms),
               decode_ms_max=max(replay_ms),
               decode_enqueue_ms=statistics.median(enqueue_ms),
               decode_aten_ops=decode_ops,
               generate_s=wall, tokens_per_s=batch * gen / wall,
               tokens_per_s_without_capture=batch * gen
               / (wall - stats["capture_s"]),
               peak_gib=peak / 2 ** 30, prefill_tflop=flops / 1e12,
               prefill_share_of_bf16_peak=flops / (prefill_ms / 1e3)
               / mesh.PEAK_OPS["bfloat16"],
               decode_step_gb=step_bytes / 1e9,
               decode_bound_ms=1e3 * step_bytes / rate,
               decode_share_of_hbm=1e3 * step_bytes / rate / step_ms,
               first_token_is_forced_argmax=first_ok,
               graph_tokens_and_logits_bitwise_eager=bitwise,
               tokens_row0=out[0, :8].tolist(), card=CARD)
    say("lm", **rec)
    del model, forced, eng, out, caches
    return rec


def lm_graph_vs_eager(torch, cfg, model, prompt, gen: int, eng) -> bool:
    """``eng.generate`` (graph) against an eager loop over ``make_decode``
    with the position as a 0-d tensor, each from its own prefill: the
    tokens and every step's logits bit for bit (checked)."""
    from repro_torch.models import registry as R

    seen = []
    out = eng.generate(model, prompt, gen,
                       on_step=lambda i, logits: seen.append(logits.clone()))
    dev = prompt.device
    b, s = prompt.shape
    with torch.inference_mode():
        caches = R.init_caches(cfg, b, s + gen, device=dev)
        logits, caches = R.make_prefill(cfg)(model, prompt, caches)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
        want, same = [tok], [bool(torch.equal(logits, seen[0]))]
        decode = R.make_decode(cfg)
        for i in range(1, gen):
            pos = torch.tensor(s + i - 1, dtype=torch.int32, device=dev)
            logits, caches = decode(model, tok, caches, pos)
            same.append(bool(torch.equal(logits, seen[i])))
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            want.append(tok)
    tokens_same = bool(torch.equal(out, torch.cat(want, dim=1)))
    say("lm", arch=cfg.name, graph_vs_eager="tokens and each step's logits",
        steps_bitwise=sum(same), steps=len(same), tokens_bitwise=tokens_same,
        first_differing_step=None if all(same) else same.index(False))
    check(all(same) and tokens_same,
          f"{cfg.name}: the graph's logits or tokens are not the eager "
          f"decode's bit for bit")
    return True


def _lm_inputs(torch, cfg, batch: int, length: int, dev):
    """Seeded inputs of ``length`` positions: token ids, plus frames for
    the encoder-decoder, or patch embeddings and three M-RoPE position
    streams for the vision frontend."""
    gen = torch.Generator(device=dev).manual_seed(2)
    if cfg.frontend == "vision":
        emb = torch.randn((batch, length, cfg.d_model), generator=gen,
                          device=dev)
        pos = torch.randint(0, 4 * length, (3, batch, length), generator=gen,
                            device=dev)
        return {"tokens": emb, "positions": pos}
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, length),
                                   generator=gen, device=dev)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                    generator=gen, device=dev)
    return out


def lm_consistency(torch, cfg, batch: int, prompt: int, steps: int,
                   device=DEVICE) -> dict:
    """``cfg`` (full width, f32 compute) on the card: prefill ``batch`` x
    ``prompt`` tokens, then ``steps`` decode steps fed the true tokens,
    each position's logits against the teacher-forced forward over all
    of them (relative to its largest |logit|).  The vision config runs
    its forward on patch embeddings with three M-RoPE streams against
    its prefill-with-cache, and M-RoPE with identical streams against
    RoPE."""
    from repro_torch.models import encdec as E
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T

    dev = torch.device(device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    nparams = sum(p.numel() for p in model.parameters())
    total = prompt + (0 if cfg.frontend == "vision" else steps)
    inputs = _lm_inputs(torch, cfg, batch, total, dev)
    errs = []
    with torch.inference_mode():
        if cfg.family == "encdec":
            enc = E.encode(model, inputs["frames"], cfg)
            forced = E.decode(model, inputs["tokens"], enc, cfg)[0]
        else:
            forced = T.decoder_forward(model, inputs["tokens"], cfg,
                                       positions=inputs.get("positions"))[0]
        scale = float(forced[..., :cfg.vocab].abs().max())
        caches = R.init_caches(cfg, batch, total, device=dev)
        if cfg.frontend == "vision":
            logits, _ = R.make_prefill(cfg)(model, inputs, caches)
            errs.append(max_abs(logits, forced))
            # three identical streams: M-RoPE is RoPE over the positions
            same = torch.arange(total, device=dev).expand(3, batch, total)
            errs.append(max_abs(
                T.decoder_forward(model, inputs["tokens"], cfg,
                                  positions=same)[0],
                T.decoder_forward(model, inputs["tokens"], cfg)[0]))
        else:
            pre = {k: (v[:, :prompt] if k == "tokens" else v)
                   for k, v in inputs.items()}
            logits, caches = R.make_prefill(cfg)(model, pre, caches)
            errs.append(max_abs(logits[:, -1], forced[:, prompt - 1]))
            decode = R.make_decode(cfg)
            for t in range(steps - 1):
                tok = inputs["tokens"][:, prompt + t:prompt + t + 1]
                logits, caches = decode(model, tok, caches, prompt + t)
                errs.append(max_abs(logits[:, 0], forced[:, prompt + t]))
    graph_steps = graph_vs_eager_decode(torch, cfg, model, inputs, prompt,
                                        steps)
    torch.cuda.synchronize()
    rel = max(errs) / scale
    rec = dict(arch=cfg.name, params=nparams, layers=cfg.n_layers,
               d_model=cfg.d_model, compute=cfg.compute_dtype, batch=batch,
               prompt=prompt, steps=0 if cfg.frontend == "vision" else steps,
               seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               max_abs_err=max(errs), max_abs_logit=scale, rel_err=rel,
               rel_tol=LM_REL_TOL, finite=bool(torch.isfinite(forced).all()),
               graph_decode_steps_bitwise=graph_steps)
    say("lm", **rec)
    check(rec["finite"], f"{cfg.name}: non-finite logits")
    check(rel <= LM_REL_TOL, f"{cfg.name}: prefill/decode logits off the "
          f"teacher-forced forward by {rel:.3g} of the largest logit")
    del model, forced, caches, logits
    return rec


def graph_vs_eager_decode(torch, cfg, model, inputs, prompt: int,
                          steps: int, mesh=None, seen=None) -> int:
    """``steps - 1`` decode steps after a prefill of ``prompt``
    positions, twice from the same prefill: eagerly with the position a
    0-d tensor, and as the engine runs them on the card (one eager step
    on a stream of its own, then replays of one ``DecodeGraph``
    capture).  Every step's logits must be bitwise the same (checked);
    returns the count, and appends the graph's logits to ``seen`` when
    given.  The text configs decode their true next tokens, the vision
    config seeded token ids after its embeddings.  ``model`` may be
    placed on ``mesh`` (its caches are then placed too)."""
    from repro_torch.models import registry as R
    from repro_torch.serving.engine import DecodeGraph

    dev = torch.device(DEVICE)
    batch = inputs["tokens"].shape[0]
    if cfg.frontend == "vision":
        pre = inputs
        toks = torch.randint(0, cfg.vocab, (batch, steps - 1), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(3))
    else:
        pre = {k: (v[:, :prompt] if k == "tokens" else v)
               for k, v in inputs.items()}
        toks = inputs["tokens"][:, prompt:prompt + steps - 1]
    toks = [toks[:, t:t + 1] for t in range(steps - 1)]
    decode = R.make_decode(cfg)
    runs = []
    for graph in (False, True):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        logits_seen = []
        with torch.cuda.stream(stream), torch.inference_mode():
            caches = R.init_caches(cfg, batch, prompt + steps, device=dev,
                                   mesh=mesh)
            _, caches = R.make_prefill(cfg)(model, pre, caches)
            pos = torch.full((), prompt, dtype=torch.int32, device=dev)
            for t, tok in enumerate(toks):
                if t == 0 or not graph:
                    logits, caches = decode(model, tok, caches, pos + t)
                else:
                    if t == 1:
                        step = DecodeGraph(decode, model, tok, caches, stream)
                    logits = step(tok, prompt + t)
                logits_seen.append(logits.clone())
            if mesh is not None:
                mesh.fork()
        torch.cuda.current_stream(dev).wait_stream(stream)
        runs.append(logits_seen)
    if seen is not None:
        seen.extend(runs[1])
    same = [bool(torch.equal(g, e)) for g, e in zip(runs[1], runs[0])]
    check(all(same), f"{cfg.name}: decode steps through the graph are not "
          f"the eager steps bit for bit: {same}")
    return sum(same)


def phase_lm(torch, rate: float) -> dict:
    """LM serving on the card: llama3_8b at full width and depth through
    ``ServeEngine.generate``, then the nine other configs at full width
    (f32, cut in depth) held against their own teacher-forced forward.
    The path has no hand-written kernel: its launch counts are read and
    shown, and must be 0."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry as R

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    say("lm", allocated_gib_before=torch.cuda.memory_allocated() / 2 ** 30)
    ops.reset_launch_counts()
    lm_serve(torch, R.get_config(LM_ARCH), LM_BATCH, LM_PROMPT, LM_GEN, rate)
    torch.cuda.empty_cache()
    for arch, depth in LM_CUT_DEPTH.items():
        cfg = R.get_config(arch)
        kw = {"compute_dtype": "float32"}
        if depth is not None:
            kw["n_layers"] = depth
        if cfg.n_experts > 0:
            kw["capacity_factor"] = 16.0
        lm_consistency(torch, dataclasses.replace(cfg, **kw), LM_CUT_BATCH,
                       LM_CUT_PROMPT, LM_CUT_STEPS)
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    say("lm", launches=counts, phase_seconds=time.perf_counter() - t_phase,
        note="the LM path runs no hand-written kernel")
    check(not any(counts.values()), f"the LM path launched {counts}")
    return counts


#: phase 14: LM training.  starcoder2_3b at its full CONFIG (30 layers,
#: d_model 3072, 3.18 B f32 parameters, bf16 compute) takes four steps
#: of batch 4 x seq 2048 through ``make_train_step`` (every layer
#: checkpointed)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "starcoder2_3b", 4, 2048, 4
#: the long-context step: granite_20b at full width cut to one pattern
#: group (``_depth_variant(cfg, 1)``) takes two steps of one row of
#: 32768 tokens; each attention chunk's backward holds 48 x 512 x 32768
#: f32 scores, where the layer's whole scores would be 48 x 32768^2
LONG_ARCH, LONG_SEQ, LONG_STEPS = "granite_20b", 32768, 2
#: the remat, determinism and fault-tolerance parts run the full width
#: cut to 2 layers; the cycle is the reference test's
#: (tests/test_training_ft.py): 8 steps, a slot every 4, a host failure
#: at step 5, the final parameters within rtol = atol = 1e-6 of the
#: uninterrupted run
TRAIN_CUT_LAYERS = 2
TRAIN_FT_STEPS, TRAIN_FT_PERIOD, TRAIN_FT_FAIL_AT = 8, 4, 5
TRAIN_FT_TOL = 1e-6
#: the Young/Daly period printed for the cycle's measured snapshot and
#: step seconds takes the train CLI's default MTBF
TRAIN_MTBF_S = 3600.0
#: every SMOKE config's two f32 train steps on the card against the CPU
#: (MoE capacity factor 16): loss and grad norm within 1e-4 relative,
#: every parameter element within 1e-4 relative plus twice the summed lr
#: of the two steps (3e-6 + 6e-6 in the warmup): the gradients sum in
#: other orders on the card, and where an element's gradient is near
#: zero, Adam's normalised update ``m / sqrt(v)`` can take either sign,
#: moving the element by up to ``lr`` a step either way
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, TRAIN_SMOKE_REL = 2, 16, 1e-4
TRAIN_SMOKE_ATOL = 2 * (3e-6 + 6e-6)
TRAIN_CLI = ("--arch", "starcoder2_3b", "--smoke", "--batch", "4",
             "--seq", "64")


def _kernel_class(name: str) -> str:
    """A kernel's class by its name: the f32 products (cuBLAS SIMT and
    f32 xmma kernels: the attention einsums with TF32 off), the other
    products (the bf16 weight GEMMs), softmax, copies and casts,
    reductions, indexing, and the other elementwise kernels."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low:
        f32 = "sgemm" in low or "f32f32_f32f32" in low
        return "f32 matmul" if f32 else "bf16 matmul"
    for word, cls in (("softmax", "softmax"), ("copy", "copy / cast"),
                      ("reduce", "reduction"), ("index", "index / scatter"),
                      ("scatter", "index / scatter"),
                      ("gather", "index / scatter"), ("sort", "index / scatter"),
                      ("elementwise", "elementwise")):
        if word in low:
            return cls
    return "other"


def profile_step(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activities): its wall seconds, the card's busy seconds (the union of
    its kernels' intervals) and idle share, the ATen ops the host
    dispatched (those not inside another ATen op) and the kernels the
    card ran, the kernels that took the most device time, and the CUDA
    runtime calls that can hold the host (synchronisations, allocations,
    frees, copies).  The profiler's own overhead is in the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name, runtime = {}, {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda") \
                and any(w in e.name for w in ("Synchronize", "Malloc",
                                              "Free", "Memcpy")):
            ms, n = runtime.get(e.name, (0.0, 0))
            runtime[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
    aten = sum(1 for e in events if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    classes = {}
    for name, (ms, n) in by_name.items():
        cls = _kernel_class(name)
        total, count = classes.get(cls, (0.0, 0))
        classes[cls] = (total + ms, count + n)
    return dict(wall_s=wall, device_busy_s=busy / 1e6,
                idle_share=1.0 - busy / 1e6 / wall, kernels=len(kernels),
                aten_ops=aten,
                device_ms_by_class={c: {"ms": ms, "count": n} for c, (ms, n)
                                    in sorted(classes.items(),
                                              key=lambda kv: -kv[1][0])},
                top_kernels=[{"name": name[:100], "ms": ms, "count": n}
                             for name, (ms, n) in top],
                runtime={name: {"ms": ms, "count": n}
                         for name, (ms, n) in sorted(runtime.items())})


def train_full_width(torch, cfg) -> dict:
    """``cfg`` initialised on the card takes ``TRAIN_STEPS`` steps of the
    seeded synthetic corpus: each step's device seconds (CUDA events)
    and host enqueue ms, its loss, grad norm and lr; tokens/s and
    ``train_mfu`` over the median step after the first, peak memory.
    The first step's loss must be bitwise the loss of a plain forward
    (``remat=False``, under ``no_grad``) over the same batch."""
    from repro_torch.launch import mesh
    from repro_torch.launch import roofline as RL
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticCorpus, to_tensors
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (TrainConfig, make_train_step,
                                                 token_xent)

    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(p.numel() for p in model.parameters())
    data = SyntheticCorpus(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           seed=0)
    tcfg = TrainConfig()
    first = to_tensors(data.batch_at(0), dev)
    with torch.no_grad():
        logits, _, _ = T.decoder_forward(model, first["tokens"], cfg)
        plain_ce = token_xent(logits, first["targets"], tcfg.z_weight)[1]
        del logits
    probe = {n: p.detach()[:2].clone() for n, p in model.named_parameters()}
    opt = adamw_init(model)
    step = make_train_step(R.make_train_forward(cfg), AdamWConfig(), tcfg)
    marks = []
    for s in range(TRAIN_STEPS):
        batch = to_tensors(data.batch_at(s), dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(model, opt, batch)
        end.record()
        marks.append((start, end, 1e3 * (time.perf_counter() - t0), metrics))
    torch.cuda.synchronize()
    profiled = profile_step(torch, lambda: step(
        model, opt, to_tensors(data.batch_at(TRAIN_STEPS), dev)))
    say("train", arch=cfg.name, profiled_step=profiled)
    steps = [dict(step=i, seconds=st.elapsed_time(en) / 1e3, enqueue_ms=host,
                  **{k: float(v) for k, v in m.items()})
             for i, (st, en, host, m) in enumerate(marks)]
    for rec in steps:
        say("train", arch=cfg.name, **rec)
    moved = all(not torch.equal(p.detach()[:2], probe[n])
                for n, p in model.named_parameters())
    remat_bitwise = bool(torch.equal(marks[0][3]["loss"], plain_ce))
    step_s = statistics.median(r["seconds"] for r in steps[1:])
    flops = RL.model_flops(cfg, R.Shape("train", "train", TRAIN_SEQ,
                                        TRAIN_BATCH), "train")
    rec = dict(arch=cfg.name, params=nparams, layers=cfg.n_layers,
               d_model=cfg.d_model, compute=cfg.compute_dtype,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s,
               first_step_s=steps[0]["seconds"], step_s=step_s,
               step_s_min=min(r["seconds"] for r in steps[1:]),
               step_s_max=max(r["seconds"] for r in steps[1:]),
               enqueue_ms=statistics.median(r["enqueue_ms"] for r in steps[1:]),
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               train_tflop=flops / 1e12,
               train_mfu=flops / step_s / mesh.PEAK_OPS["bfloat16"],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               params_moved=moved, step0_loss=steps[0]["loss"],
               plain_forward_loss=float(plain_ce),
               step0_loss_bitwise_remat_off=remat_bitwise,
               profiled_device_busy_s=profiled["device_busy_s"],
               profiled_idle_share=profiled["idle_share"])
    say("train", **rec)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in steps), f"{cfg.name}: a non-finite loss or grad norm")
    check(moved, f"{cfg.name}: a parameter did not move")
    check(remat_bitwise, f"{cfg.name}: the step's loss {steps[0]['loss']!r} "
          f"is not the plain forward's {float(plain_ce)!r}")
    del model, opt, probe, marks, first, plain_ce
    return rec


def train_long_context(torch, cfg) -> dict:
    """``cfg`` cut to one pattern group takes ``LONG_STEPS`` steps of one
    row of ``LONG_SEQ`` tokens of the seeded corpus: each step's seconds
    (CUDA events), enqueue ms, loss and grad norm; the peak (above what
    earlier phases left allocated) against the dry run's sizing of the
    same step.  The peak must not exceed the sizing, the losses
    and grad norms must be finite and the first loss bitwise a plain
    forward's under ``no_grad``."""
    from repro_torch.launch import dryrun
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticCorpus, to_tensors
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (TrainConfig, make_train_step,
                                                 token_xent)

    dev = torch.device(DEVICE)
    cut = dryrun._depth_variant(cfg, 1)
    shape = R.Shape("train", "train", LONG_SEQ, 1)
    sized = dryrun.variant_bytes(cut, shape, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = R.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    data = SyntheticCorpus(vocab=cut.vocab, batch=1, seq=LONG_SEQ, seed=0)
    tcfg = TrainConfig()
    first = to_tensors(data.batch_at(0), dev)
    with torch.no_grad():
        logits, _, _ = T.decoder_forward(model, first["tokens"], cut)
        plain_ce = token_xent(logits, first["targets"], tcfg.z_weight)[1]
        del logits
    opt = adamw_init(model)
    step = make_train_step(R.make_train_forward(cut), AdamWConfig(), tcfg)
    steps = []
    for i in range(LONG_STEPS):
        batch = to_tensors(data.batch_at(i), dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        metrics = step(model, opt, batch)
        end.record()
        enqueue = 1e3 * (time.perf_counter() - t1)
        end.synchronize()
        steps.append(dict(step=i, seconds=start.elapsed_time(end) / 1e3,
                          enqueue_ms=enqueue,
                          **{k: float(v) for k, v in metrics.items()}))
        if i == 0:
            bitwise = bool(torch.equal(metrics["loss"], plain_ce))
    peak = torch.cuda.max_memory_allocated() - before
    rec = dict(arch=cut.name, layers=cut.n_layers, d_model=cut.d_model,
               heads=cut.n_heads, kv_heads=cut.n_kv_heads, batch=1,
               seq=LONG_SEQ, steps=steps, allocated_before_bytes=before,
               peak_bytes=peak,
               sized_need_bytes=sized["need"], sized_layer_bytes=sized["layer"],
               peak_over_need=peak / sized["need"],
               step0_loss_bitwise_plain=bitwise,
               plain_forward_loss=float(plain_ce),
               seconds=time.perf_counter() - t0, card=CARD)
    say("train", long_context=rec)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in steps), f"{cut.name}: a non-finite loss or grad norm")
    check(peak <= sized["need"], f"{cut.name} at {LONG_SEQ} tokens peaked at "
          f"{peak} bytes, over its sizing's {sized['need']}")
    check(bitwise, f"{cut.name}: the step's loss {steps[0]['loss']!r} is not "
          f"the plain forward's {float(plain_ce)!r}")
    del model, opt, first, plain_ce, metrics
    return rec


def _cut_batch(torch, cfg, seed: int, step: int, dev):
    from repro_torch.training.data import SyntheticCorpus, to_tensors

    data = SyntheticCorpus(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           seed=seed)
    return to_tensors(data.batch_at(step), dev)


def _grads(torch, model, cfg, batch, remat: bool):
    """The loss and every parameter's gradient of one forward and
    backward (the train step's loss), the gradients taken off the
    model."""
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import TrainConfig, token_xent

    tcfg = TrainConfig()
    logits, _, aux = T.decoder_forward(model, batch["tokens"], cfg,
                                       remat=remat)
    loss, _ = token_xent(logits, batch["targets"], tcfg.z_weight)
    (loss + tcfg.aux_weight * aux).backward()
    grads = {}
    for n, p in model.named_parameters():
        grads[n], p.grad = p.grad, None
    return loss.detach(), grads


def train_remat(torch, cfg) -> dict:
    """At ``cfg``'s width cut to ``TRAIN_CUT_LAYERS`` layers: the loss and
    every gradient with remat off, full and ``"dots"`` must be bitwise
    equal; whether two runs of the same step are bitwise equal is
    printed."""
    from repro_torch.models import registry as R

    dev = torch.device(DEVICE)
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    model = R.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    batch = _cut_batch(torch, cut, 0, 0, dev)
    t0 = time.perf_counter()
    runs = {"off": _grads(torch, model, cut, batch, False),
            "full": _grads(torch, model, cut, batch, True),
            "dots": _grads(torch, model,
                           dataclasses.replace(cut, remat_policy="dots"),
                           batch, True),
            "full again": _grads(torch, model, cut, batch, True)}
    torch.cuda.synchronize()

    def diff(a, b):
        la, ga = runs[a]
        lb, gb = runs[b]
        return max([max_abs(la, lb)] + [max_abs(ga[n], gb[n]) for n in ga])

    rec = dict(arch=cut.name, layers=cut.n_layers, d_model=cut.d_model,
               seconds=time.perf_counter() - t0,
               max_diff_full_vs_off=diff("full", "off"),
               max_diff_dots_vs_off=diff("dots", "off"),
               two_runs_bitwise=diff("full", "full again") == 0.0,
               max_diff_two_runs=diff("full", "full again"))
    say("train", remat=rec)
    check(rec["max_diff_full_vs_off"] == 0.0 and
          rec["max_diff_dots_vs_off"] == 0.0,
          f"remat changed the numbers: {rec}")
    del model, runs
    return rec


def train_ft_cycle(torch, cfg) -> dict:
    """The fault-tolerance cycle at ``cfg``'s width cut to
    ``TRAIN_CUT_LAYERS`` layers: an uninterrupted run of
    ``TRAIN_FT_STEPS`` steps, then the same run persisting every
    ``TRAIN_FT_PERIOD`` steps through ``TrainingRecovery`` (``save_async``:
    the snapshot on the host, the drain in a thread), a host failure at
    step ``TRAIN_FT_FAIL_AT``, the restore and the resume.  Slots go to a
    fresh temporary directory, removed afterwards."""
    import shutil
    import tempfile

    from repro_torch import convert
    from repro_torch.ft import (CheckpointConfig, NVMCheckpointManager,
                                PersistencePeriodTuner, TrainingRecovery,
                                inject_host_failure, optimal_period)
    from repro_torch.models import registry as R
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    dev = torch.device(DEVICE)
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    step_fn = make_train_step(R.make_train_forward(cut), AdamWConfig(lr=3e-4))

    def fresh():
        model = R.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        return model, adamw_init(model)

    def run_step(model, opt, s):
        batch = _cut_batch(torch, cut, 3, s, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(model, opt, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    model, opt = fresh()
    plain_s = [run_step(model, opt, s) for s in range(TRAIN_FT_STEPS)]
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    nparams = sum(p.numel() for p in model.parameters())
    del model, opt

    slot_bytes = 3 * 4 * nparams               # params, m and v in f32
    directory = tempfile.mkdtemp(prefix="train_ft_")
    try:
        free = shutil.disk_usage(directory).free
        say("train", ft_directory_free_bytes=free, needed_bytes=2 * slot_bytes)
        if free < 2 * slot_bytes:
            raise SmokeFailure(
                f"the fault-tolerance cycle needs {2 * slot_bytes} bytes for "
                f"two slots in {directory}; {free} are free")
        mgr = NVMCheckpointManager(CheckpointConfig(directory))
        tuner = PersistencePeriodTuner(mtbf_s=1e9, min_period=TRAIN_FT_PERIOD,
                                       max_period=TRAIN_FT_PERIOD)
        rec = TrainingRecovery(mgr, tuner)
        model, opt = fresh()
        s, injected, saves, overlap_s, recover_s = 0, False, [], [], 0.0
        drain_pending = False
        while s < TRAIN_FT_STEPS:
            if s == TRAIN_FT_FAIL_AT and not injected:
                injected = True
                inject_host_failure({"params": model, "opt": opt})
                t0 = time.perf_counter()
                tree, ck_step, _ = rec.recover(convert.train_state_like(cut), s)
                if drain_pending:
                    saves[-1].update(zip(("drain_wall_s", "drain_modeled_s"),
                                         mgr.last_persist_seconds))
                    drain_pending = False
                model, opt = convert.train_state_from_numpy(cut, tree, dev)
                torch.cuda.synchronize()
                recover_s = time.perf_counter() - t0
                del tree
                s = ck_step
                continue
            dt = run_step(model, opt, s)
            if drain_pending and mgr._drainer is not None \
                    and mgr._drainer.is_alive():
                overlap_s.append(dt)        # the drain outlasted the step
            s += 1
            t0 = time.perf_counter()
            if rec.maybe_persist(
                    lambda: convert.train_state_to_numpy(model, opt), s):
                saves.append({"step": s,
                              "snapshot_s": time.perf_counter() - t0})
                drain_pending = True
        t0 = time.perf_counter()
        mgr.join()
        saves[-1].update(zip(("drain_wall_s", "drain_modeled_s"),
                             mgr.last_persist_seconds),
                         join_wait_s=time.perf_counter() - t0)
        slot = mgr.last_persist_bytes
        got = {n: p.detach() for n, p in model.named_parameters()}
        errs = {n: float(((got[n] - w).abs()
                          - TRAIN_FT_TOL * (1 + w.abs())).max())
                for n, w in want.items()}
        bitwise = all(torch.equal(got[n], w) for n, w in want.items())
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    step_s = statistics.median(plain_s)
    snapshot_s = statistics.median(sv["snapshot_s"] for sv in saves)
    out = dict(arch=cut.name, layers=cut.n_layers, params=nparams,
               slot_bytes=slot, saves=saves, recover_s=recover_s,
               step_s=step_s, mtbf_s=TRAIN_MTBF_S,
               young_daly_period_steps=optimal_period(snapshot_s,
                                                      TRAIN_MTBF_S, step_s),
               step_s_while_draining=overlap_s,
               failures_recovered=rec.failures_recovered,
               steps_wasted=rec.steps_wasted, final_params_bitwise=bitwise,
               worst_excess_over_tol=max(errs.values()), tol=TRAIN_FT_TOL)
    say("train", ft=out)
    check(rec.failures_recovered == 1 and rec.steps_wasted == 1,
          f"recovered {rec.failures_recovered}, wasted {rec.steps_wasted}")
    check(max(errs.values()) <= 0.0, "the resumed run's parameters are off "
          f"the uninterrupted run's beyond rtol = atol = {TRAIN_FT_TOL}")
    del model, opt, want, got
    return out


def _smoke_steps(torch, cfg, model, batch, dev):
    """Two train steps of ``model`` on ``batch`` moved to ``dev``: each
    step's metrics and the final parameters, on the host."""
    from repro_torch.models import registry as R
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    step = make_train_step(R.make_train_forward(cfg), AdamWConfig())
    opt = adamw_init(model)
    moved = {k: v.to(dev) for k, v in batch.items()}
    metrics = [{k: v.detach().cpu() for k, v in step(model, opt, moved).items()}
               for _ in range(2)]
    return metrics, {n: p.detach().cpu()
                     for n, p in model.named_parameters()}


def train_families(torch) -> list:
    """Every SMOKE config in f32 takes two train steps on the card and on
    the CPU from the same parameters (carried by ``convert``) and batch;
    a second card run shows whether two runs are bitwise equal."""
    from repro_torch import convert
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import registry as R
    from repro_torch.training.data import SyntheticCorpus, to_tensors

    dev = torch.device(DEVICE)
    recs = []
    for arch in R.ARCH_IDS:
        base = R.get_config(arch, smoke=True)
        kw = {"compute_dtype": "float32"}
        if base.n_experts > 0:
            kw["capacity_factor"] = 16.0
        cfg = dataclasses.replace(base, **kw)
        cpu = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        tree = convert.lm_params_to_numpy(cpu)
        data = SyntheticCorpus(vocab=cfg.vocab, batch=TRAIN_SMOKE_BATCH,
                               seq=TRAIN_SMOKE_SEQ, seed=1)
        cpu_dev = torch.device("cpu")
        batch = stub_inputs(cfg, to_tensors(data.batch_at(0), cpu_dev), 0,
                            cpu_dev)
        want_m, want_p = _smoke_steps(torch, cfg, cpu, batch, cpu_dev)
        runs = [_smoke_steps(torch, cfg, convert.lm_params_from_numpy(
            cfg, tree, dev), batch, dev) for _ in range(2)]
        (got_m, got_p), (again_m, again_p) = runs
        metric_rel = max(abs(float(g[k]) - float(w[k])) / abs(float(w[k]))
                         for g, w in zip(got_m, want_m)
                         for k in ("loss", "grad_norm"))
        excess = {n: float(((got_p[n] - w).abs() - TRAIN_SMOKE_ATOL
                            - TRAIN_SMOKE_REL * w.abs()).max())
                  for n, w in want_p.items()}
        worst = max(excess, key=excess.get)
        bitwise = (all(torch.equal(a[k], b[k]) for a, b in zip(got_m, again_m)
                       for k in a)
                   and all(torch.equal(got_p[n], again_p[n]) for n in got_p))
        rec = dict(arch=cfg.name, loss=[float(m["loss"]) for m in got_m],
                   metric_rel_err=metric_rel,
                   max_param_diff=max(max_abs(got_p[n], w)
                                      for n, w in want_p.items()),
                   worst_param=worst, worst_param_excess=excess[worst],
                   rel_tol=TRAIN_SMOKE_REL, abs_tol=TRAIN_SMOKE_ATOL,
                   two_card_runs_bitwise=bitwise,
                   finite=all(bool(torch.isfinite(p).all())
                              for p in got_p.values()))
        say("train", family=rec)
        check(rec["finite"] and metric_rel <= TRAIN_SMOKE_REL
              and excess[worst] <= 0.0,
              f"{cfg.name}: the card's train steps are off the CPU's: {rec}")
        recs.append(rec)
    return recs


def train_cli(torch) -> dict:
    """The train CLI in its own processes on the card: 12 steps, then 16
    in the same checkpoint directory, which must resume."""
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="train_cli_")
    try:
        first, c1, s1 = run_cli(torch, "repro_torch.launch.train",
                                [*TRAIN_CLI, "--steps", "12", "--ckpt-dir",
                                 directory], timeout=300)
        second, c2, s2 = run_cli(torch, "repro_torch.launch.train",
                                 [*TRAIN_CLI, "--steps", "16", "--ckpt-dir",
                                  directory], timeout=300)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    resume = [ln for ln in second
              if ln.startswith("elastic restore: resuming from step ")]
    rec = dict(first=first, second=second, seconds=[s1, s2])
    say("train", cli=rec)
    check(first[-1:] == ["done."] and second[-1:] == ["done."],
          f"the train CLI did not finish: {rec}")
    check(len(resume) == 1, f"the second train CLI run did not resume: {rec}")
    return {k: c1.get(k, 0) + c2.get(k, 0) for k in set(c1) | set(c2)}


def phase_train(torch) -> dict:
    """LM training on the card: starcoder2_3b at full width and depth,
    granite_20b's long-context step at full width, then remat,
    determinism and the fault-tolerance cycle at full width cut to 2
    layers, every family's SMOKE steps against the CPU and the
    train CLI's resume.  The path has no hand-written kernel: its launch
    counts (the CLI's counted in its processes) must be 0."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry as R

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    say("train", allocated_gib_before=torch.cuda.memory_allocated() / 2 ** 30)
    ops.reset_launch_counts()
    cfg = R.get_config(TRAIN_ARCH)
    train_full_width(torch, cfg)
    torch.cuda.empty_cache()
    train_long_context(torch, R.get_config(LONG_ARCH))
    torch.cuda.empty_cache()
    train_remat(torch, cfg)
    torch.cuda.empty_cache()
    train_ft_cycle(torch, cfg)
    torch.cuda.empty_cache()
    train_families(torch)
    counts = ops.launch_counts()
    cli = train_cli(torch)
    counts = {k: counts[k] + cli.get(k, 0) for k in counts}
    say("train", launches=counts, phase_seconds=time.perf_counter() - t_phase,
        note="the training path runs no hand-written kernel")
    check(not any(counts.values()), f"the training path launched {counts}")
    return counts


#: phase 15: the LM dry run in two processes, each a tuple of CLI calls
#: run one after the other: llama3_8b's three cells and mamba2_370m's
#: long_500k on 16x16; llama3_8b's decode_32k on 2x16x16 (the multi-pod
#: pass)
DRYRUN_LM_CALLS = (
    (("--arch", "llama3_8b", "--mesh", "single"),
     ("--arch", "mamba2_370m", "--shape", "long_500k", "--mesh", "single")),
    (("--arch", "llama3_8b", "--shape", "decode_32k", "--mesh", "multi"),),
)
#: the reference's per-device argument bytes of those cells: its
#: ``build_cell`` on ``jax.sharding.AbstractMesh`` with every leaf's
#: ``NamedSharding.shard_shape`` summed (written here as numbers: the
#: smoke imports no JAX; ``tests/test_torch_dryrun_lm.py`` holds the port
#: to the reference on every cell)
DRYRUN_LM_ARG_BYTES = {
    ("llama3_8b", "train_4k", "16x16"): 568_868_868,
    ("llama3_8b", "prefill_32k", "16x16"): 726_581_248,
    ("llama3_8b", "decode_32k", "16x16"): 2_336_931_876,
    ("mamba2_370m", "long_500k", "16x16"): 12_089_352,
    ("llama3_8b", "decode_32k", "2x16x16"): 1_263_190_036,
}


def phase_dryrun_lm(torch) -> dict:
    """The LM dry run on the card (``python -m repro_torch.launch.dryrun``
    in its own processes): every row ``ok`` with finite losses or
    logits in every variant, its per-device argument bytes the
    reference's, a calibrated row's extrapolated replica step at least
    its g1 step and within its range, and its roofline terms finite.  The path has no
    hand-written kernel: its launch counts must read 0."""
    from repro_torch.launch import report

    t_phase = time.perf_counter()
    out = os.path.join(ROOT, "results", "chip_smoke_dryrun_lm.jsonl")
    if os.path.exists(out):
        os.remove(out)
    counts = {}
    for first, *then in DRYRUN_LM_CALLS:
        lines, got, _ = run_cli(torch, "repro_torch.launch.dryrun",
                                [*first, "--out", out], 600,
                                then=[[*a, "--out", out] for a in then])
        for line in lines:
            if line.startswith("["):
                print(f"[dryrun-lm] {line}", flush=True)
        counts = {k: counts.get(k, 0) + v for k, v in got.items()}
    rows = report.load(out)
    check(sorted(rows) == sorted(DRYRUN_LM_ARG_BYTES),
          f"dry-run rows {sorted(rows)}, want {sorted(DRYRUN_LM_ARG_BYTES)}")
    for key, want in DRYRUN_LM_ARG_BYTES.items():
        row = rows[key]
        variants = row["measured"]["variants"]
        got = row["memory"]["argument_bytes"]
        say("dryrun-lm", cell=key, argument_bytes=got, reference=want,
            peak_bytes_estimate=row["memory"]["peak_bytes"],
            variants={g: {k: v[k] for k in (
                "batch", "step_s", "step_q1_s", "step_q3_s", "timed_steps",
                "step_mode", "enqueue_s", "peak_bytes", "peak_split",
                "finite")}
                for g, v in variants.items()},
            replica_step_s=row["measured"]["replica_step_s"],
            replica_step_range_s=row["measured"]["replica_step_range_s"],
            bf16_share=row["measured"]["bf16_share"],
            roofline=row.get("roofline"), reduced=row["reduced"])
        check(row["ok"] and all(v["finite"] for v in variants.values()),
              f"{key}: a variant's outputs are not finite")
        check(got == want, f"{key}: {got} argument bytes a device, the "
                           f"reference's {want}")
        mode = "graph" if key[1] in ("decode_32k", "long_500k") else "eager"
        check(all(v["step_mode"] == mode for v in variants.values()),
              f"{key}: timed steps not run as {mode}")
        if "roofline" in row:
            rf = row["roofline"]
            check(all(math.isfinite(rf[k]) for k in
                      ("t_compute_s", "t_memory_s", "t_collective_s")),
                  f"{key}: roofline terms not finite: {rf}")
            step = row["measured"]["replica_step_s"]
            least, most = row["measured"]["replica_step_range_s"]
            check(step >= variants["g1"]["step_s"],
                  f"{key}: the extrapolated step is under the g1 step")
            check(least <= step <= most,
                  f"{key}: the replica step {step} is outside its range "
                  f"{least}-{most}")
    print("[dryrun-lm] table, 16x16:\n" + report.table(rows), flush=True)
    print("[dryrun-lm] multipod table:\n" + report.multipod_table(rows),
          flush=True)
    say("dryrun-lm", launches=counts,
        phase_seconds=time.perf_counter() - t_phase,
        note="the LM dry run runs no hand-written kernel")
    check(not any(counts.values()), f"the LM dry run launched {counts}")
    return counts


#: phase 16: LM serving over a (data, model) mesh.  (a) llama3_8b at its
#: full CONFIG (bf16 compute) on make_mesh_for(4): 4 requests of 512
#: tokens, 16 generated tokens each
MESH_LM_BATCH, MESH_LM_PROMPT, MESH_LM_GEN = 4, 512, 16
#: (e): mamba2_370m's full CONFIG (bf16 compute), served as (a)
MESH_LM_SSM_ARCH = "mamba2_370m"
#: (a) and (e): the decode steps of the engine's warm-up (one eager, then
#: replays), repeated eagerly from the same prompt for the eager ms a step
MESH_LM_EAGER_STEPS = 4
#: (b), (c) and (f): full width, f32, cut in depth (None: whole; the
#: encoder-decoder's encoder cut as its decoder: whisper_small at 4 + 4
#: of its 12 + 12 layers, cut from whole for the smoke's budget when the
#: seq layout came); batch 4 (split over data=2), a 64-token prompt and
#: 4 decode steps
MESH_LM_CUT = {"llama3_8b": 2, "moonshot_v1_16b_a3b": 1, "dbrx_132b": 1,
               "recurrentgemma_9b": 4, "whisper_small": 4,
               "qwen2_vl_72b": 1}
MESH_LM_CUT_BATCH, MESH_LM_CUT_PROMPT, MESH_LM_CUT_STEPS = 4, 64, 4
#: make_mesh_for's model_parallel for the two meshes of (b)-(d)
MESH_LM_MESHES = {"1x4": None, "2x2": 2}
#: (b)'s seq-layout leg: the config and mesh whose prefill also runs with
#: the residual stream whole (rules with "seq" on no axis)
MESH_LM_SEQ_CHECK = ("llama3_8b", "1x4")


def _shard_bytes(leaves, nshards: int) -> list:
    """Every shard's bytes over placed leaves."""
    out = [0] * nshards
    for _, leaf in leaves:
        for s, piece in enumerate(leaf.pieces):
            out[s] += piece.numel() * piece.element_size()
    return out


def _counted_bytes(R, structs, specs, rules) -> int:
    """One device's bytes of ``structs`` under ``rules``: each leaf's
    ``shard_shape`` (through ``specs_to_physical``) times its item
    size."""
    phys = R.specs_to_physical(specs, rules, structs)
    return sum(math.prod(ph.shape) * st.element_size()
               for st, ph in zip(R.tree_leaves(structs), R.tree_leaves(phys)))


def mesh_lm_serve(torch, cfg) -> dict:
    """(a) and (e): ``cfg`` on ``make_mesh_for(4)`` serves through
    ``ServeEngine.generate``, whose decode runs one eager step and then
    replays one CUDA-graph capture.  The warm-up generates
    ``MESH_LM_EAGER_STEPS + 1`` tokens (its capture included) and keeps
    each step's logits; the eager leg (:func:`mesh_eager_leg`) runs as
    many decode steps from its own prefill and must give the same tokens
    and logits bit for bit.  Then the timed run: the prefill seconds
    (CUDA events on the caller's stream, which waits for every shard),
    the decode ms a token (events between consecutive replays after the
    first, median), the host's enqueue ms over the same steps, the
    capture seconds, the replays, tokens/s; the ATen ops one eager
    decode step dispatches (counted apart from the timed run), each
    shard's parameter and cache bytes against ``shard_shape``'s count
    (checked equal), the peak bytes; the logits finite."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.serving import ServeEngine

    mesh = make_mesh_for(4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=mesh.device)
                          .manual_seed(0), mesh=mesh)
    mesh.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab, (MESH_LM_BATCH, MESH_LM_PROMPT),
                           device=mesh.device, generator=torch.Generator(
                               device=mesh.device).manual_seed(1))
    eng = ServeEngine(R.make_prefill(cfg), R.make_decode(cfg),
                      lambda b, s: R.init_caches(cfg, b, s, mesh=mesh))
    warm_logits: list = []
    warm = eng.generate(model, prompt, MESH_LM_EAGER_STEPS + 1,
                        on_step=lambda i, logits: warm_logits.append(
                            logits.clone()))
    check(eng.stats["graph"] and eng.stats["eager_steps"] == 1
          and eng.stats["replays"] == MESH_LM_EAGER_STEPS - 1,
          f"{cfg.name}: the warm-up ran {eng.stats} over the mesh")
    eager = mesh_eager_leg(torch, cfg, model, prompt, mesh, warm_logits,
                           warm)
    del warm_logits
    mesh.synchronize()
    marks: list = []
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = eng.generate(model, prompt, MESH_LM_GEN,
                       on_step=_step_marks(torch, marks))
    mesh.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(eng.stats)
    check(all(bool(m[3]) for m in marks), f"{cfg.name}: non-finite logits")
    check(tuple(out.shape) == (MESH_LM_BATCH, MESH_LM_GEN),
          f"{cfg.name}: out {out.shape}")
    check(stats["graph"] and stats["eager_steps"] == 1
          and stats["replays"] == MESH_LM_GEN - 2,
          f"{cfg.name}: the engine ran {stats} over the mesh, want one "
          f"eager decode step and {MESH_LM_GEN - 2} replays")
    # step i >= 3: one replay, the argmax and the static inputs' writes
    step_ms = [marks[i - 1][1].elapsed_time(marks[i][1])
               for i in range(3, MESH_LM_GEN)]
    host_ms = [1e3 * (marks[i][2] - marks[i - 1][2])
               for i in range(3, MESH_LM_GEN)]
    seq = MESH_LM_PROMPT + MESH_LM_GEN
    caches = R.init_caches(cfg, MESH_LM_BATCH, seq, mesh=mesh)
    with torch.inference_mode():
        _, caches = R.make_prefill(cfg)(model, prompt, caches)
        decode_ops = _aten_ops(lambda: R.make_decode(cfg)(
            model, out[:, :1], caches, MESH_LM_PROMPT))
    params = _shard_bytes(R.placed_leaves(model), mesh.nshards)
    cache = _shard_bytes(R.placed_leaves(caches), mesh.nshards)
    want_params = _counted_bytes(R, *R.abstract_params(cfg), model.rules)
    want_cache = _counted_bytes(R, *R.abstract_caches(cfg, MESH_LM_BATCH,
                                                      seq), model.rules)
    rec = dict(arch=cfg.name, mesh=mesh.shape,
               devices=[str(d) for d in mesh.devices], layers=cfg.n_layers,
               d_model=cfg.d_model, compute=cfg.compute_dtype,
               batch=MESH_LM_BATCH, prompt=MESH_LM_PROMPT, gen=MESH_LM_GEN,
               init_s=init_s, prefill_s=start.elapsed_time(marks[0][1]) / 1e3,
               first_step_and_capture_ms=marks[0][1].elapsed_time(
                   marks[1][1]),
               capture_s=stats["capture_s"], replays=stats["replays"],
               decode_ms_per_token=statistics.median(step_ms),
               decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
               decode_host_ms_per_token=statistics.median(host_ms),
               **eager, decode_aten_ops=decode_ops,
               generate_s=wall, tokens_per_s=MESH_LM_BATCH * MESH_LM_GEN / wall,
               tokens_per_s_without_capture=MESH_LM_BATCH * MESH_LM_GEN
               / (wall - stats["capture_s"]),
               shard_param_bytes=params, shard_cache_bytes=cache,
               shard_shape_param_bytes=want_params,
               shard_shape_cache_bytes=want_cache,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               tokens_row0=out[0, :8].tolist(), card=CARD)
    say("lm-mesh", **rec)
    check(params == [want_params] * mesh.nshards
          and cache == [want_cache] * mesh.nshards,
          f"{cfg.name}: a shard's bytes differ from shard_shape's count")
    del model, caches, eng
    return rec


def mesh_eager_leg(torch, cfg, model, prompt, mesh, seen: list,
                   tokens) -> dict:
    """``MESH_LM_EAGER_STEPS`` greedy decode steps over ``make_decode``
    with a 0-d tensor position, from their own prefill into caches of
    the warm-up's length, against the engine's warm-up (``seen``: its
    logits, the prefill's first; ``tokens``: its tokens): every step's
    logits and the tokens bit for bit (checked).  Timed with
    ``_step_marks``: the eager decode ms a step (CUDA events) and the
    host's ms a step, median over the steps after the first."""
    from repro_torch.models import registry as R

    b, s = prompt.shape
    steps = MESH_LM_EAGER_STEPS
    marks: list = []
    mark = _step_marks(torch, marks)
    kept = []
    with torch.inference_mode():
        caches = R.init_caches(cfg, b, s + steps + 1, mesh=mesh)
        logits, caches = R.make_prefill(cfg)(model, prompt, caches)
        mark(0, logits)
        kept.append(logits.clone())
        tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
        toks = [tok]
        decode = R.make_decode(cfg)
        for i in range(1, steps + 1):
            pos = torch.tensor(s + i - 1, dtype=torch.int32,
                               device=mesh.device)
            logits, caches = decode(model, tok, caches, pos)
            mark(i, logits)
            kept.append(logits.clone())
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            toks.append(tok)
    mesh.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(kept, seen)]
    tokens_same = bool(torch.equal(torch.cat(toks, dim=1), tokens))
    check(all(same) and tokens_same,
          f"{cfg.name}: the engine's replays over the mesh are not the "
          f"eager steps bit for bit: logits {same}, tokens {tokens_same}")
    step_ms = [marks[i - 1][1].elapsed_time(marks[i][1])
               for i in range(2, steps + 1)]
    host_ms = [1e3 * (marks[i][2] - marks[i - 1][2])
               for i in range(2, steps + 1)]
    return dict(eager_leg_steps=steps,
                eager_decode_ms_per_token=statistics.median(step_ms),
                eager_host_ms_per_token=statistics.median(host_ms),
                graph_steps_bitwise_eager=sum(same) - 1,
                graph_tokens_identical_eager=tokens_same)


def _mesh_logits(torch, cfg, mesh, device: str, replayed=None,
                 seq_check=None) -> list:
    """``cfg`` from seed 0 on ``mesh`` (or, with ``None``, on
    ``device``): the prefill's logits and each teacher-forced decode
    step's, on ``device``.  The inputs are ``_lm_inputs``': the
    encoder-decoder's prefill takes frames, the vision frontend's patch
    embeddings and three M-RoPE streams, its decode steps token ids
    (seed 3).  With a list ``replayed``, the same model's decode steps
    also run through a ``DecodeGraph`` against their eager run
    (:func:`graph_vs_eager_decode`, bitwise, checked), the replayed
    logits appended to it.  With a dict ``seq_check``, the same model's
    prefill runs once more under its rules with ``"seq"`` on no axis
    (:func:`_seq_layout`), and the dict gets the comparison."""
    from repro_torch.models import registry as R

    model = R.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                          device=device, mesh=mesh)
    b, p, steps = MESH_LM_CUT_BATCH, MESH_LM_CUT_PROMPT, MESH_LM_CUT_STEPS
    caches = R.init_caches(cfg, b, p + steps, device=device, mesh=mesh)
    if cfg.frontend == "vision":
        inputs = _lm_inputs(torch, cfg, b, p, device)
        tokens = torch.randint(0, cfg.vocab, (b, p + steps), device=device,
                               generator=torch.Generator(device=device)
                               .manual_seed(3))
    else:
        inputs = _lm_inputs(torch, cfg, b, p + steps, device)
        tokens = inputs["tokens"]
        inputs["tokens"] = tokens[:, :p]
    if replayed is not None:
        whole = inputs if cfg.frontend == "vision" else {**inputs,
                                                         "tokens": tokens}
        graph_vs_eager_decode(torch, cfg, model, whole, p, steps, mesh=mesh,
                              seen=replayed)
    out = []
    with torch.inference_mode():
        logits, caches = R.make_prefill(cfg)(model, inputs, caches)
        out.append(logits)
        for t in range(steps):
            logits, caches = R.make_decode(cfg)(
                model, tokens[:, p + t:p + t + 1], caches, p + t)
            out.append(logits)
    if seq_check is not None:
        del caches
        seq_check.update(_seq_layout(torch, cfg, model, inputs, mesh,
                                     device))
    return out


def _seq_layout(torch, cfg, model, inputs, mesh, device: str) -> dict:
    """Phase 16 (b)'s seq-layout leg: the prefill of ``inputs`` under the
    model's rules (the residual stream seq-placed, ``"seq": "model"``)
    and under the same rules with ``"seq"`` on no axis (the stream whole
    on each model shard), on the same model: the logits' largest
    difference, whether they are bitwise, and each shard's stream bytes
    between layers 0 and 1 (the input of layer 1, read by a forward
    pre-hook), the seq layout's checked at ``1 / model`` of the whole
    layout's."""
    from repro_torch.distributed import sharding
    from repro_torch.models import registry as R

    b, p, steps = MESH_LM_CUT_BATCH, MESH_LM_CUT_PROMPT, MESH_LM_CUT_STEPS
    rules = model.rules
    layouts = {"seq": rules, "whole": sharding.AxisRules(
        mesh, {**rules.rules, "seq": None})}
    seen, runs = [], {}
    hook = model.layers[1].register_forward_pre_hook(
        lambda module, args: seen.append(args[0]))
    try:
        for name, layout in layouts.items():
            model.rules = layout
            caches = R.init_caches(cfg, b, p + steps, device=device,
                                   mesh=mesh)
            with torch.inference_mode():
                logits, _ = R.make_prefill(cfg)(model, inputs, caches)
            x = seen.pop()
            runs[name] = (logits, x.spec, [t.numel() * t.element_size()
                                           for t in x.pieces])
            del caches
    finally:
        model.rules = rules
        hook.remove()
    (got, spec, got_bytes), (want, wspec, want_bytes) = runs["seq"], \
        runs["whole"]
    scale = float(want[..., :cfg.vocab].abs().max())
    rec = dict(seq_spec=spec, whole_spec=wspec,
               seq_stream_bytes=got_bytes, whole_stream_bytes=want_bytes,
               seq_vs_whole_max_abs=float((got - want).abs().max()),
               seq_vs_whole_rel=float((got - want).abs().max()) / scale,
               seq_vs_whole_bitwise=bool(torch.equal(got, want)))
    n = mesh.shape["model"]
    check(spec[1] == "model" and wspec[1] is None
          and [g * n for g in got_bytes] == want_bytes,
          f"{cfg.name}: the seq layout's stream bytes {got_bytes} are not "
          f"1/{n} of the whole layout's {want_bytes}")
    check(rec["seq_vs_whole_rel"] <= LM_REL_TOL,
          f"{cfg.name}: the seq layout's logits are off the whole layout's "
          f"by {rec['seq_vs_whole_rel']:.3g} of the largest logit")
    return rec


def _moe_block_bitwise(torch, cfg, mesh) -> bool:
    """Whether the expert-parallel block on ``mesh`` (data = 1) gives the
    one-device block's bits on one seeded input."""
    from repro_torch.distributed import sharding
    from repro_torch.models import moe, registry as R

    dev = mesh.device
    x = torch.randn(MESH_LM_CUT_BATCH, MESH_LM_CUT_PROMPT, cfg.d_model,
                    device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(5))
    outs = []
    for m in (None, mesh):
        block = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev, mesh=m).layers[0].moe
        with torch.inference_mode():
            y, _ = moe.moe(block, x if m is None else sharding.place(
                x, m, (None, None, None)), cfg)
        outs.append(y if m is None else sharding.to_whole(y))
        del block
    return bool(torch.equal(*outs))


def mesh_lm_consistency(torch, arch: str, cards: int) -> dict:
    """(b)-(d) and (f) for one config: full width, f32, cut to
    ``MESH_LM_CUT`` layers (MoE at capacity factor 16), on both meshes
    of the card against its one-device run, relative to the largest
    |logit|, and its decode steps replayed from a ``DecodeGraph``
    bitwise its eager steps; the MoE block bitwise or not at data = 1;
    with two or more cards, each mesh over distinct cards, its eager
    and replayed steps, against the same mesh on the first card.  For
    ``MESH_LM_SEQ_CHECK`` (llama3_8b on (1, 4)) the prefill also runs
    with the residual stream whole, against its seq layout
    (:func:`_seq_layout`)."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R

    t0 = time.perf_counter()
    base = R.get_config(arch)
    kw = {"compute_dtype": "float32"}
    if MESH_LM_CUT[arch] is not None:
        kw["n_layers"] = MESH_LM_CUT[arch]
        if base.family == "encdec":
            kw["enc_layers"] = MESH_LM_CUT[arch]
    if base.n_experts > 0:
        kw["capacity_factor"] = 16.0
    cfg = dataclasses.replace(base, **kw)
    dev = "cuda:0"
    want = _mesh_logits(torch, cfg, None, dev)
    scale = max(float(w[..., :cfg.vocab].abs().max()) for w in want)
    rec = dict(arch=cfg.name, family=cfg.family, frontend=cfg.frontend,
               layers=cfg.n_layers, d_model=cfg.d_model,
               compute=cfg.compute_dtype, batch=MESH_LM_CUT_BATCH,
               prompt=MESH_LM_CUT_PROMPT, steps=MESH_LM_CUT_STEPS,
               max_abs_logit=scale, rel_tol=LM_REL_TOL)
    for name, mp in MESH_LM_MESHES.items():
        mesh = make_mesh_for(4, mp, device=dev)
        replayed: list = []
        seq = {} if (arch, name) == MESH_LM_SEQ_CHECK else None
        got = _mesh_logits(torch, cfg, mesh, dev, replayed, seq)
        if seq is not None:
            rec[f"seq_layout_{name}"] = seq
        rec[f"rel_err_{name}"] = max(max_abs(g, w)
                                     for g, w in zip(got, want)) / scale
        rec[f"graph_steps_bitwise_{name}"] = len(replayed)
        if cfg.n_experts > 0 and mesh.shape["data"] == 1:
            rec[f"moe_block_bitwise_{name}"] = _moe_block_bitwise(
                torch, cfg, mesh)
        if cards > 1:
            far_replayed: list = []
            far = _mesh_logits(torch, cfg, make_mesh_for(4, mp), dev,
                               far_replayed)
            rec[f"distinct_cards_bitwise_{name}"] = all(
                bool(torch.equal(a, b)) for a, b in
                zip(far + far_replayed, got + replayed))
        del got, replayed
        torch.cuda.empty_cache()
    if cards <= 1:
        rec["distinct_cards"] = f"not run: {cards} card visible"
    rec["seconds"] = time.perf_counter() - t0
    say("lm-mesh", **rec)
    for name in MESH_LM_MESHES:
        check(rec[f"rel_err_{name}"] <= LM_REL_TOL,
              f"{cfg.name} on the {name} mesh: logits off the one-device "
              f"run by {rec[f'rel_err_{name}']:.3g} of the largest logit")
        check(rec.get(f"distinct_cards_bitwise_{name}", True),
              f"{cfg.name} on the {name} mesh over distinct cards is not "
              f"the one-card mesh bit for bit")
    return rec


def phase_lm_mesh(torch) -> dict:
    """LM serving over a (data, model) device mesh: (a) llama3_8b at full
    width and depth, then (b)-(d), (e) mamba2_370m at full width and
    depth, and (f) the other three families cut in depth; every decode
    through the engine one eager step and then graph replays.  The path
    has no hand-written kernel: its launch counts are read and shown,
    and must be 0."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry as R

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    ops.reset_launch_counts()
    for arch in (LM_ARCH, MESH_LM_SSM_ARCH):
        mesh_lm_serve(torch, R.get_config(arch))
        torch.cuda.empty_cache()
    for arch in MESH_LM_CUT:
        mesh_lm_consistency(torch, arch, cards)
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    say("lm-mesh", launches=counts,
        phase_seconds=time.perf_counter() - t_phase,
        note="the LM path runs no hand-written kernel")
    check(not any(counts.values()), f"the LM mesh path launched {counts}")
    return counts


#: phase 17 (a) and (a')'s peaks as this script measured them while the
#: residual stream was whole on each model shard (NVIDIA H100 80GB HBM3,
#: 700 W), printed beside this run's with the saving the seq layout is
#: reckoned to bring: each layer's checkpointed input, layers x batch x
#: seq x d_model in the compute dtype a shard, (model - 1) / model of it
#: on every shard
MESH_TRAIN_WHOLE_STREAM_PEAK = {"starcoder2_3b": 55311702528,
                                "mamba2_370m": 10239138816}
#: phase 17: LM training over a (data, model) mesh of the one card.
#: (a) starcoder2_3b at its full CONFIG, two steps of batch 2 x 1024 (its
#: state, params, grads and two f32 moments, is 16 B a parameter: 51 GB);
#: the second step is the timed one (cut from three to keep the smoke
#: inside its 900 s budget), on the (1, 4) mesh alone (the (2, 2) mesh,
#: 9-10 s, cut for the same budget when (a') came; (c) runs nine configs
#: on (2, 2))
MESH_TRAIN_ARCH, MESH_TRAIN_ARCH_MESHES = "starcoder2_3b", ("1x4",)
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 2, 1024, 2
#: (b) moonshot_v1_16b_a3b at full width cut to 2 layers (64 experts, 16
#: a model shard; 1.81 B parameters, 29 GB of state), two steps on the
#: (1, 4) mesh alone (the (2, 2) mesh cut for the smoke's budget; (c)
#: runs moonshot on both)
MESH_TRAIN_MOE_ARCH, MESH_TRAIN_MOE_LAYERS = "moonshot_v1_16b_a3b", 2
MESH_TRAIN_MOE_STEPS, MESH_TRAIN_MOE_MESHES = 2, ("1x4",)
#: (a') mamba2_370m at its full CONFIG (48 layers, d_model 1024, 32 SSD
#: heads of 64, 8 a model shard; 0.42 B parameters, 6.7 GB of state at
#: 16 B a parameter), one timed step of batch 2 x 1024 on the (1, 4)
#: mesh alone, after an untimed step of the config cut to 2 layers on
#: that mesh (a full-depth first step, 12.4-12.5 s, cut for the smoke's
#: budget: the step is the host's enqueue, which the shallow step warms
#: as well)
MESH_TRAIN_SSM_ARCH, MESH_TRAIN_SSM_MESHES = "mamba2_370m", ("1x4",)
MESH_TRAIN_SSM_STEPS, MESH_TRAIN_SSM_WARM = 1, 2
#: (c) the six configs at full width, f32 (MoE at capacity factor 16),
#: cut in depth: 2 layers, dbrx_132b 1 (one layer holds 3.37 B
#: parameters, 16 experts x 3 x 6144 x 10752: with its embeddings 4.6 B,
#: 74 GB of training state, which fills the card; two layers would need
#: 122 GB); two steps of batch 2 x 64.  The other four families, their
#: batches with the train CLI's stub inputs: mamba2_370m at 2 layers
#: (0.12 B parameters); whisper_small whole, 12 + 12 layers (0.26 B with
#: its 32768-row decoder position table, 4.2 GB of state); recurrentgemma_9b
#: at 3 layers, one (rec, rec, local) group (untied 256000 x 4096
#: tables: 2.8 B parameters, 44 GB of state);
#: qwen2_vl_72b at 1 layer (3.4 B parameters, 54 GB of state)
MESH_TRAIN_CUT = {"llama3_8b": 2, "gemma3_12b": 2, "starcoder2_3b": 2,
                  "granite_20b": 2, "dbrx_132b": 1,
                  "moonshot_v1_16b_a3b": 2, "mamba2_370m": 2,
                  "whisper_small": 12, "recurrentgemma_9b": 3,
                  "qwen2_vl_72b": 1}
MESH_TRAIN_CUT_BATCH, MESH_TRAIN_CUT_SEQ, MESH_TRAIN_CUT_STEPS = 2, 64, 2
#: (c)'s meshes by config: both, but dbrx_132b on (1, 4) alone.  On
#: (2, 2) each shard gathers its 8 experts' f32 weights over ``data``
#: (3 x 2.1 GB a shard, 25 GB on the card, saved for the backward, and
#: as much again for their gradients) beside its 74 GB of training
#: state: more than the card.  tests/test_torch_lm_mesh_train.py holds
#: dbrx_132b on (2, 2) against one device and the reference.  The other
#: four families run one mesh each, for the smoke's budget: mamba2_370m
#: and recurrentgemma_9b on (2, 2), where ``w_dt``, ``w_a`` and ``w_i``
#: are gathered over ``data`` and the heads and channels split over
#: ``model``; whisper_small and qwen2_vl_72b on (1, 4) (qwen2_vl's 54 GB
#: of state beside its one-device reference's first moments).
#: tests/test_torch_lm_mesh_train_families.py holds all four on both.
MESH_TRAIN_CUT_MESHES = {"dbrx_132b": ("1x4",), "mamba2_370m": ("2x2",),
                         "recurrentgemma_9b": ("2x2",),
                         "whisper_small": ("1x4",), "qwen2_vl_72b": ("1x4",)}
#: why a mesh of (c) is left out, by config
MESH_TRAIN_CUT_WHY = {"dbrx_132b": "more than the card holds"}
#: (c)'s config whose (1, 4) mesh step also runs twice, bitwise (the MoE:
#: its combine and gather are where an atomic add would show)
MESH_TRAIN_TWICE = ("moonshot_v1_16b_a3b",)
#: the CPU test's tolerance: each leaf within 1e-4 of its largest value
MESH_TRAIN_REL = 1e-4
#: (d) the checkpoint cycle: starcoder2_3b at full width cut to 1 layer
#: (its 4.8 GB slot: embeddings and head are three quarters of it), two
#: steps on (1, 4), a slot, two more steps on (2, 2) and on one device
#: within rtol = atol of the uninterrupted (1, 4) run's four.  The CPU
#: test holds PERF.md section 2's 1e-6; on the card the continuations'
#: steps sum in other orders than the (1, 4) run's: at 2 layers they
#: read up to 1.16e-6 on an H100, 1.5e-7 over 1e-6 * (1 + |w|) (see
#: PERF.md), so the card is held at 1e-5
MESH_TRAIN_FT_LAYERS, MESH_TRAIN_FT_TOL = 1, 1e-5
MESH_TRAIN_MESHES = {"1x4": None, "2x2": 2}
#: the one card the meshes of phase 17 repeat, whatever cards are
#: visible ((e) spans them with ``make_mesh_for(4, mp)``)
ONE_CARD = "cuda:0"


def _aux_over_data(R, cfg, data: int):
    """The training forward of ``cfg`` on one device whose aux loss is
    the mean of the aux losses of ``data`` equal row blocks of the batch:
    what the mesh's MoE computes with ``data`` shards (each routes its
    own rows; the reference's ``pmean``).  Without experts, or with one
    data shard, the plain training forward."""
    base = R.make_train_forward(cfg)
    if cfg.n_experts == 0 or data == 1:
        return base

    def forward(model, batch):
        logits, _ = base(model, batch)
        rows = batch["tokens"].shape[0] // data
        parts = [base(model, {k: v[d * rows:(d + 1) * rows]
                              for k, v in batch.items()})[1]
                 for d in range(data)]
        return logits, sum(parts[1:], parts[0]) / data
    return forward


def _leaves_of(R, model, opt, parts=("p", "m", "v")):
    """``(key, leaf)``: every parameter (``"p|name"``) and moment
    (``"m|name"``, ``"v|name"``) of a model and its optimizer state."""
    for name, leaf in R.named_leaves(model):
        for part in parts:
            yield f"{part}|{name}", (leaf if part == "p" else
                                     opt[part][name])


def _whole(t):
    """A leaf whole on the mesh's first device (a plain tensor as it
    is), detached."""
    from repro_torch.distributed import sharding

    if isinstance(t, sharding.Placed):
        return sharding.to_whole(t).detach()
    return t.detach()


def _worst_off(R, model, opt, want: dict, lr_sum: float) -> dict:
    """How far a run's parameters and moments are from ``want``
    (``"p|name"`` and kin, on the card or the host), each leaf gathered
    whole and compared on the card one at a time: for the moments the
    largest difference over the leaf's largest |value|, with its leaf;
    for the parameters the largest excess of ``|got - want|`` over
    ``MESH_TRAIN_REL * |want| + 2 * lr_sum``, with its leaf and its
    largest relative difference.  Adam's normalised update moves an
    element by up to ``lr`` a step, of either sign where its gradient is
    near zero, so that limit holds the parameters' layout (a piece
    misplaced or taken from the wrong shard is off by the weights' own
    size), not their update: a wrong gradient shows in the moments."""
    out = {"p_excess": -math.inf, "p_rel": 0.0}
    for key, t in _leaves_of(R, model, opt):
        if key not in want:
            continue
        part, name = key.split("|", 1)
        g = _whole(t)
        w = want[key].to(g.device)
        diff = (g - w).abs()
        rel = float(diff.max()) / max(float(w.abs().max()), 1e-30)
        if part == "p":
            excess = float((diff - MESH_TRAIN_REL * w.abs()
                            - 2 * lr_sum).max())
            if excess > out["p_excess"]:
                out["p_excess"], out["p_excess_leaf"] = excess, name
            if rel > out["p_rel"]:
                out["p_rel"], out["p_rel_leaf"] = rel, name
        elif rel >= out.get(f"{part}_rel", 0.0):
            out[f"{part}_rel"], out[f"{part}_rel_leaf"] = rel, name
        del g, w, diff
    return out


def _runs_bitwise(R, a, b) -> bool:
    """Whether two runs' parameters and moments (``(model, opt)`` each,
    on meshes of one shape) are the same bits, piece by piece."""
    for (_, x), (_, y) in zip(_leaves_of(R, *a), _leaves_of(R, *b)):
        xs = x.pieces if hasattr(x, "pieces") else (x,)
        ys = y.pieces if hasattr(y, "pieces") else (y,)
        if not all(torch_equal(p, q.to(p.device)) for p, q in zip(xs, ys)):
            return False
    return True


def _replicas_bitwise(R, model, opt) -> bool:
    from repro_torch.distributed import sharding

    for _, t in _leaves_of(R, model, opt):
        for group in sharding.replica_groups(t):
            if not all(torch_equal(t.pieces[r], t.pieces[group[0]])
                       for r in group[1:]):
                return False
    return True


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def _train_run(torch, cfg, mesh, batches, forward=None, dev=DEVICE):
    """``len(batches)`` AdamW steps of ``cfg`` from seed 0 on ``mesh`` (or
    one device): the model, its optimizer state and each step's
    metrics."""
    from repro_torch.models import registry as R
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, mesh=mesh)
    opt = adamw_init(model)
    step = make_train_step(forward or R.make_train_forward(cfg),
                           AdamWConfig())
    metrics = [step(model, opt, batch) for batch in batches]
    return model, opt, metrics


class _GcClock:
    """The seconds and the count of the cyclic collector's runs while it
    is entered (``gc.callbacks``): how much of a host-bound step is the
    collector's."""

    def __enter__(self):
        self.seconds, self.runs, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._on)
        return self

    def _on(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.runs += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on)


def mesh_train_timed(torch, cfg, steps: int, batch: int, seq: int,
                     meshes=tuple(MESH_TRAIN_MESHES),
                     warm_layers: int = 0) -> list:
    """(a) and (b): ``cfg`` on ``meshes`` of the one card (the (1, 4)
    and (2, 2) ones by default) takes ``steps`` steps of the seeded
    corpus: each step's seconds (CUDA events on the caller's stream,
    which waits for every shard at the step's end) and the host's
    enqueue ms, its loss and grad norm; tokens/s and ``train_mfu`` over
    the median step after the first, the peak bytes (and the last
    step's own peak, and at its backward start the bytes alive and its
    peak up to then), the
    collector's seconds and the caching allocator's retries over the
    steps, and
    every shard's parameter and moment bytes against ``shard_shape``'s
    count (checked equal).  With ``warm_layers``, a step of ``cfg`` cut
    to that depth runs first on the same mesh, untimed, and every step
    of ``cfg`` counts (one step is then a timed warm step)."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.training.data import SyntheticCorpus, to_tensors
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    dev = torch.device(DEVICE)
    data = SyntheticCorpus(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)
    flops = RL.model_flops(cfg, R.Shape("train", "train", seq, batch),
                           "train")
    out = []
    for name in meshes:
        mesh = make_mesh_for(4, MESH_TRAIN_MESHES[name], device=ONE_CARD)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              mesh=mesh)
        opt = adamw_init(model)
        mesh.synchronize()
        init_s = time.perf_counter() - t0
        forward = R.make_train_forward(cfg)
        at_backward, peaks = {}, []

        def marked(model, batch):
            # each step's own peak counted from its start (the run's
            # peak kept in ``peaks``), and the bytes alive as its
            # backward starts, every layer's checkpointed input among
            # them, with the step's peak up to then
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            logits, aux = forward(model, batch)
            if logits.requires_grad:
                logits.register_hook(lambda g: at_backward.update(
                    allocated=torch.cuda.memory_allocated(),
                    peak=torch.cuda.max_memory_allocated()))
            return logits, aux

        step = make_train_step(marked, AdamWConfig())
        if warm_layers:
            shallow = dataclasses.replace(cfg, n_layers=warm_layers)
            warm = R.init_params(shallow, torch.Generator(
                device=dev).manual_seed(0), mesh=mesh)
            make_train_step(R.make_train_forward(shallow), AdamWConfig())(
                warm, adamw_init(warm), to_tensors(data.batch_at(0), dev))
            mesh.synchronize()
            del warm
        marks = []
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        with _GcClock() as collector:
            for s in range(steps):
                b = to_tensors(data.batch_at(s), dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                metrics = step(model, opt, b)
                end.record()
                marks.append((start, end, 1e3 * (time.perf_counter() - t0),
                              metrics))
            mesh.synchronize()
        retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                0) - retries
        steps_rec = [dict(step=i, seconds=st.elapsed_time(en) / 1e3,
                          enqueue_ms=host,
                          **{k: float(v) for k, v in m.items()})
                     for i, (st, en, host, m) in enumerate(marks)]
        later = steps_rec if warm_layers else steps_rec[1:] or steps_rec
        step_s = statistics.median(r["seconds"] for r in later)
        enqueue_ms = statistics.median(r["enqueue_ms"] for r in later)
        params = _shard_bytes(R.placed_leaves(model), mesh.nshards)
        moments = _shard_bytes([(n, t) for part in ("m", "v")
                                for n, t in opt[part].items()], mesh.nshards)
        want = _counted_bytes(R, *R.abstract_params(cfg), model.rules)
        rec = dict(arch=cfg.name, mesh=mesh.shape, layers=cfg.n_layers,
                   d_model=cfg.d_model, compute=cfg.compute_dtype,
                   params=sum(math.prod(leaf.shape) for _, leaf in
                              R.placed_leaves(model)),
                   batch=batch, seq=seq, init_s=init_s, steps=steps_rec,
                   first_step_s=steps_rec[0]["seconds"], step_s=step_s,
                   enqueue_ms=enqueue_ms,
                   host_share=enqueue_ms / 1e3 / step_s,
                   tokens_per_s=batch * seq / step_s,
                   train_tflop=flops / 1e12,
                   train_mfu=flops / step_s / M.PEAK_OPS["bfloat16"],
                   peak_bytes=max(peaks + [torch.cuda.max_memory_allocated()]),
                   last_step_peak_bytes=torch.cuda.max_memory_allocated(),
                   backward_start_bytes=at_backward.get("allocated"),
                   forward_peak_bytes=at_backward.get("peak"),
                   gc_s=collector.seconds, gc_runs=collector.runs,
                   alloc_retries=retries,
                   shard_param_bytes=params, shard_moment_bytes=moments,
                   shard_shape_param_bytes=want,
                   replicas_bitwise=_replicas_bitwise(R, model, opt),
                   card=CARD)
        say("lm-train-mesh", **rec)
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                  for r in steps_rec), f"{cfg.name} on {name}: a non-finite "
              f"loss or grad norm")
        check(params == [want] * mesh.nshards
              and moments == [2 * want] * mesh.nshards,
              f"{cfg.name} on {name}: a shard's parameter or moment bytes "
              f"differ from shard_shape's count")
        check(rec["replicas_bitwise"], f"{cfg.name} on {name}: replicas of "
              f"a leaf differ after the steps")
        out.append(rec)
        del model, opt, marks, metrics
    return out


def _cut_config(arch: str):
    from repro_torch.models import registry as R

    base = R.get_config(arch)
    kw = {"compute_dtype": "float32", "n_layers": MESH_TRAIN_CUT[arch]}
    if base.n_experts > 0:
        kw["capacity_factor"] = 16.0
    return dataclasses.replace(base, **kw)


def _cut_batches(torch, cfg, steps: int, dev=DEVICE):
    """The seeded corpus' batches, with the train CLI's stub inputs:
    frames for the encoder-decoder, patch embeddings and M-RoPE
    positions for the vision frontend."""
    from repro_torch.launch.train import stub_inputs
    from repro_torch.training.data import SyntheticCorpus, to_tensors

    data = SyntheticCorpus(vocab=cfg.vocab, batch=MESH_TRAIN_CUT_BATCH,
                           seq=MESH_TRAIN_CUT_SEQ, seed=7)
    return [stub_inputs(cfg, to_tensors(data.batch_at(s), dev), s,
                        torch.device(dev)) for s in range(steps)]


def mesh_train_agreement(torch, arch: str, cards: int) -> dict:
    """(c) and (e) for one config: ``_cut_config(arch)`` takes two steps
    on one device and on both meshes of the one card: loss and grad norm
    within ``MESH_TRAIN_REL``, every moment within ``MESH_TRAIN_REL`` of
    its leaf's scale and every parameter within ``MESH_TRAIN_REL`` of
    itself plus twice the steps' summed ``lr`` (:func:`_worst_off`) of
    the one-device run's (its aux over the mesh's data shards,
    :func:`_aux_over_data`), every replica bitwise; the
    (1, 4) run twice, bitwise, for ``MESH_TRAIN_TWICE``; with two or
    more cards, each mesh over distinct cards bitwise the one-card
    mesh.  The one-device state stays on the card when it fits beside
    the mesh runs; else its first moments alone are kept, on the card
    where they fit, else on the host, each leaf moved back to the card
    for its comparison (the parameters and second moments too would
    triple the copies), and the record says which (``compared``,
    ``reference_on``).  The meshes are
    ``MESH_TRAIN_CUT_MESHES``' where it names them."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R

    t0 = time.perf_counter()
    cfg = _cut_config(arch)
    batches = _cut_batches(torch, cfg, MESH_TRAIN_CUT_STEPS)
    total = torch.cuda.get_device_properties(0).total_memory
    rec = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               compute=cfg.compute_dtype, batch=MESH_TRAIN_CUT_BATCH,
               seq=MESH_TRAIN_CUT_SEQ, steps=MESH_TRAIN_CUT_STEPS,
               rel_tol=MESH_TRAIN_REL)
    refs = {}
    meshes = MESH_TRAIN_CUT_MESHES.get(arch, tuple(MESH_TRAIN_MESHES))
    for name in MESH_TRAIN_MESHES:
        if name not in meshes:
            why = MESH_TRAIN_CUT_WHY.get(arch, "the smoke's time budget")
            rec[name] = f"not run: {why} (MESH_TRAIN_CUT_MESHES)"
    for name in meshes:
        mesh = make_mesh_for(4, MESH_TRAIN_MESHES[name], device=ONE_CARD)
        data = mesh.shape["data"] if cfg.n_experts > 0 else 1
        if data not in refs:
            refs.clear()
            torch.cuda.empty_cache()
            model, opt, metrics = _train_run(
                torch, cfg, None, batches, _aux_over_data(R, cfg, data))
            nparams = sum(p.numel() for p in model.parameters())
            rec["params"] = nparams
            # beside it: a mesh run (16 B a parameter; a config run twice
            # is an MoE, whose reference is dropped before its second);
            # the reference's parameters and moments take 12 B a
            # parameter, its first moments alone 4 (they carry both
            # steps' gradients; the parameters' limit holds their layout)
            if 28 * nparams < 0.8 * total:
                parts, on_card = ("p", "m", "v"), True
            else:
                parts, on_card = ("m",), 20 * nparams < 0.8 * total
            state = {k: t.detach() if on_card else t.detach().cpu()
                     for k, t in _leaves_of(R, model, opt, parts)}
            rec["reference_on"] = "card" if on_card else "host"
            rec["compared"] = parts
            refs[data] = ([{k: float(v) for k, v in m.items()}
                           for m in metrics], state)
            del model, opt, metrics, state
            torch.cuda.empty_cache()
        want_metrics, want = refs[data]
        run = _train_run(torch, cfg, mesh, batches)
        mesh.synchronize()
        rec[f"replicas_bitwise_{name}"] = _replicas_bitwise(R, *run[:2])
        lr_sum = sum(w["lr"] for w in want_metrics)
        rec[name] = _worst_off(R, *run[:2], want, lr_sum)
        rec[f"metric_rel_err_{name}"] = max(
            abs(float(m[k]) - w[k]) / max(abs(w[k]), 1e-30)
            for m, w in zip(run[2], want_metrics)
            for k in ("loss", "grad_norm"))
        if cfg.n_experts > 0 or name == "2x2":
            refs.clear()        # no later mesh reads this reference
        del want
        torch.cuda.empty_cache()
        if name == "1x4" and arch in MESH_TRAIN_TWICE:
            again = _train_run(torch, cfg, mesh, batches)
            rec["one_card_mesh_bitwise_across_runs"] = _runs_bitwise(
                R, run[:2], again[:2])
            del again
            torch.cuda.empty_cache()
        if cards > 1:
            far = _train_run(torch, cfg, make_mesh_for(
                4, MESH_TRAIN_MESHES[name]), batches)
            rec[f"distinct_cards_bitwise_{name}"] = _runs_bitwise(
                R, run[:2], far[:2])
            del far
        del run
        torch.cuda.empty_cache()
    if cards <= 1:
        rec["distinct_cards"] = f"not run: {cards} card visible"
    rec["seconds"] = time.perf_counter() - t0
    say("lm-train-mesh", **rec)
    for name in meshes:
        off = rec[name]
        check(off["p_excess"] <= 0.0
              and off.get("m_rel", 0.0) <= MESH_TRAIN_REL
              and off.get("v_rel", 0.0) <= MESH_TRAIN_REL
              and rec[f"metric_rel_err_{name}"] <= MESH_TRAIN_REL,
              f"{cfg.name} on the {name} mesh: off the one-device run "
              f"by {off}, its metrics by "
              f"{rec[f'metric_rel_err_{name}']:.3g}")
        check(rec[f"replicas_bitwise_{name}"], f"{cfg.name} on the {name} "
              f"mesh: replicas of a leaf differ")
        check(rec.get(f"distinct_cards_bitwise_{name}", True),
              f"{cfg.name} on the {name} mesh over distinct cards is not "
              f"the one-card mesh bit for bit")
    check(rec.get("one_card_mesh_bitwise_across_runs", True),
          f"{cfg.name}: two runs of the (1, 4) mesh's steps differ")
    return rec


def mesh_train_ft_cycle(torch) -> dict:
    """(d): ``starcoder2_3b`` at full width cut to
    ``MESH_TRAIN_FT_LAYERS`` (f32 compute) takes two steps on the (1, 4)
    mesh; its state is written into a slot through
    ``NVMCheckpointManager.save`` in a fresh temporary directory (its
    free space checked), and the same run goes on two more steps, the
    uninterrupted run.  The slot restored is the state written, array
    for array; placed on the (2, 2) mesh and on one device it takes the
    same two more steps, each held within rtol = atol =
    ``MESH_TRAIN_FT_TOL`` of the uninterrupted run's parameters."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import convert
    from repro_torch.ft import CheckpointConfig, NVMCheckpointManager
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(_cut_config(MESH_TRAIN_ARCH),
                              n_layers=MESH_TRAIN_FT_LAYERS)
    batches = _cut_batches(torch, cfg, 4)
    step = make_train_step(R.make_train_forward(cfg), AdamWConfig())
    model, opt, _ = _train_run(torch, cfg, make_mesh_for(4, device=ONE_CARD),
                               batches[:2])
    nparams = sum(math.prod(leaf.shape) for _, leaf in R.placed_leaves(model))
    directory = tempfile.mkdtemp(prefix="mesh_train_ft_")
    rec = dict(arch=cfg.name, layers=cfg.n_layers, params=nparams,
               tol=MESH_TRAIN_FT_TOL)
    try:
        free = shutil.disk_usage(directory).free
        if free < 2 * 12 * nparams:
            raise SmokeFailure(f"the checkpoint cycle needs {24 * nparams} "
                               f"bytes in {directory}; {free} are free")
        mgr = NVMCheckpointManager(CheckpointConfig(directory))
        written = convert.train_state_to_numpy(model, opt)
        t1 = time.perf_counter()
        mgr.save(written, 2)
        rec["save_s"] = time.perf_counter() - t1
        rec["slot_bytes"] = mgr.last_persist_bytes
        for batch in batches[2:]:
            step(model, opt, batch)
        uninterrupted = {k: _whole(t) for k, t in
                         _leaves_of(R, model, opt, ("p",))}
        del model, opt
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        tree, at, _ = mgr.restore(convert.train_state_like(cfg))
        rec["restore_s"] = time.perf_counter() - t1
        check(at == 2, f"the slot restored step {at}, want 2")
        got, want = _flat_arrays(tree), _flat_arrays(written)
        rec["slot_is_the_state_written"] = got.keys() == want.keys() and all(
            np.array_equal(got[k], w) for k, w in want.items())
        del written, got, want
        for name, target in (("2x2", make_mesh_for(4, 2, device=ONE_CARD)),
                             ("one_device", None)):
            model, opt = convert.train_state_from_numpy(cfg, tree, DEVICE,
                                                        mesh=target)
            for batch in batches[2:]:
                step(model, opt, batch)
            worst = {"excess": -math.inf}
            for k, t in _leaves_of(R, model, opt, ("p",)):
                w = uninterrupted[k]
                diff = (_whole(t) - w).abs()
                excess = float((diff - MESH_TRAIN_FT_TOL * (1 + w.abs())).max())
                if excess > worst["excess"]:
                    worst = {"excess": excess, "leaf": k.split("|", 1)[1],
                             "abs": float(diff.max())}
            rec[f"against_uninterrupted_{name}"] = worst
            del model, opt
            torch.cuda.empty_cache()
        del tree, uninterrupted
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    say("lm-train-mesh", ft=rec)
    check(rec["slot_is_the_state_written"], "the slot restored is not the "
          "state written, array for array")
    for name in ("2x2", "one_device"):
        check(rec[f"against_uninterrupted_{name}"]["excess"] <= 0.0,
              f"the run restored on {name} is off the uninterrupted (1, 4) "
              f"run beyond rtol = atol = {MESH_TRAIN_FT_TOL}: "
              f"{rec[f'against_uninterrupted_{name}']}")
    return rec


def _flat_arrays(tree, prefix="") -> dict:
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_arrays(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _peak_vs_whole_stream(torch, arch: str, recs: list) -> None:
    """(a) and (a')'s peak beside the one measured with the stream whole
    (``MESH_TRAIN_WHOLE_STREAM_PEAK``) and the saving the seq layout is
    reckoned to bring."""
    from repro_torch.models import registry as R

    cfg = R.get_config(arch)
    for rec in recs:
        n = rec["mesh"]["model"]
        item = torch.empty((), dtype=cfg.cdt).element_size()
        saving = (cfg.n_layers * rec["batch"] * rec["seq"] * cfg.d_model
                  * item * (n - 1))
        before = MESH_TRAIN_WHOLE_STREAM_PEAK[arch]
        say("lm-train-mesh", arch=cfg.name, mesh=rec["mesh"],
            peak_bytes=rec["peak_bytes"],
            last_step_peak_bytes=rec["last_step_peak_bytes"],
            forward_peak_bytes=rec["forward_peak_bytes"],
            backward_start_bytes=rec["backward_start_bytes"],
            whole_stream_peak_bytes=before,
            predicted_saving_bytes=saving,
            measured_saving_bytes=before - rec["peak_bytes"], card=CARD,
            note="the peaks of two runs, each on its own call's card")


def phase_lm_train_mesh(torch) -> dict:
    """LM training over a (data, model) device mesh: (a) starcoder2_3b at
    full width and depth on the (1, 4) mesh of the one card, (b) the MoE
    leg,
    (a') mamba2_370m at its full config on (1, 4), (c) the ten configs'
    agreement with one device, with (e) the distinct-card leg, (d) the
    checkpoint cycle across mesh shapes.  The
    path has no hand-written kernel: its launch counts are read and
    shown, and must be 0."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry as R

    t_phase = time.perf_counter()
    # the earlier phases' objects out of the collector's reach: the eager
    # mesh step is bound by the host, and each full collection walks
    # every object still alive (_GcClock shows what is left of it)
    gc.collect()
    gc.freeze()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    ops.reset_launch_counts()
    recs = mesh_train_timed(torch, R.get_config(MESH_TRAIN_ARCH),
                            MESH_TRAIN_STEPS, MESH_TRAIN_BATCH,
                            MESH_TRAIN_SEQ, MESH_TRAIN_ARCH_MESHES)
    _peak_vs_whole_stream(torch, MESH_TRAIN_ARCH, recs)
    torch.cuda.empty_cache()
    moe = dataclasses.replace(R.get_config(MESH_TRAIN_MOE_ARCH),
                              n_layers=MESH_TRAIN_MOE_LAYERS)
    mesh_train_timed(torch, moe, MESH_TRAIN_MOE_STEPS, MESH_TRAIN_BATCH,
                     MESH_TRAIN_SEQ, MESH_TRAIN_MOE_MESHES)
    torch.cuda.empty_cache()
    recs = mesh_train_timed(torch, R.get_config(MESH_TRAIN_SSM_ARCH),
                            MESH_TRAIN_SSM_STEPS, MESH_TRAIN_BATCH,
                            MESH_TRAIN_SEQ, MESH_TRAIN_SSM_MESHES,
                            MESH_TRAIN_SSM_WARM)
    _peak_vs_whole_stream(torch, MESH_TRAIN_SSM_ARCH, recs)
    torch.cuda.empty_cache()
    for arch in MESH_TRAIN_CUT:
        mesh_train_agreement(torch, arch, cards)
    mesh_train_ft_cycle(torch)
    gc.unfreeze()
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    say("lm-train-mesh", launches=counts,
        phase_seconds=time.perf_counter() - t_phase, card=CARD,
        note="the LM training path runs no hand-written kernel")
    check(not any(counts.values()),
          f"the LM mesh training path launched {counts}")
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
    global SRC, CARD
    import torch

    args = sys.argv[1:]
    times_only = "--times-only" in args
    mesh_only = "--mesh-only" in args
    lm_mesh_only = "--lm-mesh-only" in args
    lm_train_mesh_only = "--lm-train-mesh-only" in args
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
        name, CARD = phase_device(torch)
        from repro_torch.launch import mesh

        try:
            rate = mesh.hbm_rate(name)
        except ValueError as e:
            raise SmokeFailure(str(e)) from e
        say("device", hbm_bytes_per_s=rate)
        phase_build()
        if times_only:
            from repro_torch.models import registry as R

            kernel_times(torch, rate)
            train_full_width(torch, R.get_config(TRAIN_ARCH))
            return 0
        if mesh_only:
            phase_mesh(torch, rate, {}, {"steps": {}})
            return 0
        if lm_mesh_only:
            phase_lm_mesh(torch)
            return 0
        if lm_train_mesh_only:
            phase_lm_train_mesh(torch)
            return 0
        records = phase_kernels(torch, rate)
        found = {"steps": {}, "reports": [], "advice": []}
        counts, problem, recovered = phase_main_path(torch, found, records)
        paths = [counts, phase_erasure(torch, problem, recovered, found)]
        del recovered
        phase_convergence(torch)
        paths.append(phase_zoo(torch, problem))
        paths.append(phase_jit(torch, problem, records, found))
        paths.append(phase_advise(torch, problem, found))
        del problem
        paths.append(phase_service(torch, found))
        paths.append(phase_mesh(torch, rate, records, found))
        paths.append(phase_launch(torch, rate, found, t0))
        paths.append(phase_lm(torch, rate))
        paths.append(phase_train(torch))
        paths.append(phase_dryrun_lm(torch))
        paths.append(phase_lm_mesh(torch))
        paths.append(phase_lm_train_mesh(torch))
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
