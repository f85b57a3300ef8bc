"""Preconditioned Conjugate Gradient, one iteration at a time, and the
fused perf-path solve (port of ``repro/core/pcg.py``).

One iteration (paper Algorithm 1 lines 3-8) runs

    ap = A p                                   (K1, stencil7)
    alpha = rz / det_dot(p, ap)                (K2's block reduction)
    x, r, z, rz' = fused_cg_update(...)        (K2)
    beta = rz' / rz ;  p = z + beta p

with ``alpha`` and ``beta`` kept as 0-d device tensors: the step never
pulls a value to the host.  :func:`make_persist_step` is the same
iteration with K4 (``ops.fused_cg_update_persist``) in place of K2: it
also hands back the erasure stripe of the input ``p`` (its chunks and
parity), and its state is bitwise the K2 step's.  Both need a diagonal
preconditioner (one that exposes ``inv_diag``, which K2 reads);
:func:`make_generic_step` is the reference's unfused step for any other
(block Jacobi): K1, ``det_dot`` for both dots, ``precond.apply`` for
``z`` and plain tensor arithmetic for ``x`` and ``r``.  We use ``alpha =
r'z / p'Ap``, identical to the paper's ``r'z / r'Ap`` in exact
arithmetic.

:func:`solve_jit` is the reference's fused perf path: PCG with no
recovery hooks, its loop captured as a CUDA graph on the card.

:func:`solve` is the reference's legacy entry (PCG predates the zoo):
the generic driver with the PCG solver, configured by ``PCGConfig``,
the historical name of ``SolveConfig``.  The driver's config, event and
report names are importable from here as in the reference; they are
looked up in :mod:`repro_torch.solvers.driver` on first use, because
the driver imports this package's modules.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.spmv import make_det_dot, sharded_fused_update
from repro_torch.core.state import PCGState
from repro_torch.kernels import fused_cg, ops


def init_state(op, precond, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
               dot: Optional[Callable] = None) -> PCGState:
    dot = make_det_dot(op.nblocks) if dot is None else dot
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - op.apply(x0)
    z0 = precond.apply(r0)
    return PCGState(
        x=x0, r=r0, z=z0, p=z0, rz=dot(r0, z0),
        beta_prev=torch.zeros((), dtype=b.dtype, device=b.device), k=0,
    )


def _iteration(state: PCGState, op_apply: Callable, dot: Callable,
               update: Callable) -> Tuple[PCGState, tuple]:
    """Lines 3-8 around ``update`` (K2 or K4, which return ``x, r, z,
    rz'`` first); returns the new state and ``update``'s other outputs."""
    ap = op_apply(state.p)                                       # (A) SpMV
    alpha = state.rz / dot(state.p, ap)                          # line 3
    x, r, z, rz_new, *extra = update(state.x, state.r, state.p,  # lines 4-7a
                                     ap, alpha)
    beta = rz_new / state.rz                                     # line 7
    p = z + beta * state.p                                       # line 8
    return PCGState(x=x, r=r, z=z, p=p, rz=rz_new, beta_prev=beta,
                    k=state.k + 1), tuple(extra)


def make_step(op_apply: Callable, inv_diag: torch.Tensor,
              nblocks: int, mesh=None) -> Callable[[PCGState], PCGState]:
    """One PCG iteration with the Jacobi-type preconditioner
    ``z = r * inv_diag``; every inner product is the order-pinned
    ``nblocks`` block dot.  With ``mesh`` (a sharded operator's data
    mesh) the dots and K2 run shard by shard, bitwise the unsharded
    step."""
    dot = make_det_dot(nblocks, mesh)
    if mesh is not None:
        nshards = int(mesh.shape["data"])

        def update(x, r, p, ap, alpha):
            *vectors, sums = sharded_fused_update(x, r, p, ap, alpha,
                                                  inv_diag, nblocks, nshards)
            return (*vectors, fused_cg.chain_plain(sums))
    else:
        def update(x, r, p, ap, alpha):
            return ops.fused_cg_update(x, r, p, ap, alpha, inv_diag, nblocks)

    def step(state: PCGState) -> PCGState:
        return _iteration(state, op_apply, dot, update)[0]

    return step


def make_lane_step(op_apply: Callable, inv_diag: torch.Tensor,
                   dot: Callable) -> Callable[[PCGState], PCGState]:
    """:func:`make_step` over a bucket of tenant lanes: ``(lanes, n)``
    vectors, ``(lanes, 1)`` scalar columns, ``inv_diag`` the lanes'
    diagonal preconditioners and ``dot`` the per-lane inner product.  K2
    runs in lane mode (``ops.fused_cg_update_lanes``: ``alpha`` and
    ``rz'`` one a lane), so an iteration is one K1, one lane dot and one
    K2 launch for the whole bucket."""

    def update(x, r, p, ap, alpha):
        x, r, z, rz = ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv_diag)
        return x, r, z, rz.unsqueeze(-1)

    def step(state: PCGState) -> PCGState:
        return _iteration(state, op_apply, dot, update)[0]

    return step


def make_generic_step(op_apply: Callable, precond_apply: Callable,
                      nblocks: int, mesh=None) -> Callable[[PCGState], PCGState]:
    """One PCG iteration with any preconditioner (the reference's step,
    ``repro/core/pcg.py:51-77``): K1 for ``A p``, the ``nblocks`` block
    dot (over ``mesh``'s shards when given) for both inner products,
    ``precond_apply`` for ``z``."""
    dot = make_det_dot(nblocks, mesh)

    def update(x, r, p, ap, alpha):
        x = x + alpha * p                                        # line 4
        r = r - alpha * ap                                       # line 5
        z = precond_apply(r)                                     # line 6
        return x, r, z, dot(r, z)

    def step(state: PCGState) -> PCGState:
        return _iteration(state, op_apply, dot, update)[0]

    return step


def make_persist_step(op_apply: Callable, inv_diag: torch.Tensor,
                      nblocks: int, k_data: int, nparity: int
                      ) -> Callable[[PCGState], Tuple[PCGState, Dict]]:
    """:func:`make_step` with K4 in place of K2: returns ``(state,
    {"p": (chunks, parity)})``, the stripe of the *input* state's ``p``
    (``k_data`` chunks per partition block and ``nparity`` GF(2^8) parity
    rows).  The state is bitwise :func:`make_step`'s."""
    dot = make_det_dot(nblocks)

    def update(x, r, p, ap, alpha):
        return ops.fused_cg_update_persist(x, r, p, ap, alpha, inv_diag,
                                           nblocks, k_data, nparity)

    def step(state: PCGState) -> Tuple[PCGState, Dict]:
        new, (chunks, parity) = _iteration(state, op_apply, dot, update)
        return new, {"p": (chunks, parity)}

    return step


# ----------------------------------------------------------------------
# The fused perf path: the loop as a CUDA graph
# ----------------------------------------------------------------------
_FIELDS = ("x", "r", "z", "p", "rz", "beta_prev")
#: 0-d results one captured iteration takes from the reduction's pool:
#: det_dot(p, ap), K2's rz' and det_dot(r, r)
_SCALARS_PER_ITERATION = 3


class _Chunk:
    """``size`` PCG iterations on static buffers.  :meth:`run` keeps the
    chunk's starting state in ``backup``, writes each iteration's ``rr =
    det_dot(r, r)`` into its slot of ``rr`` and copies the end state
    back into ``buf``: the same calls whether they run eagerly or are
    captured once and replayed."""

    def __init__(self, step: Callable, dot: Callable, state: PCGState,
                 size: int):
        self.step, self.dot, self.size = step, dot, size
        self.buf = {f: getattr(state, f).clone() for f in _FIELDS}
        self.backup = {f: t.clone() for f, t in self.buf.items()}
        self.rr = torch.empty(size, dtype=state.r.dtype, device=state.r.device)

    def state(self, k: int) -> PCGState:
        return PCGState(k=k, **self.buf)

    def run(self) -> None:
        for f, t in self.buf.items():
            self.backup[f].copy_(t)
        st = self.state(0)
        for j in range(self.size):
            st = self.step(st)
            self.rr[j].copy_(self.dot(st.r, st.r))
        for f, t in self.buf.items():
            t.copy_(getattr(st, f))

    def restore(self) -> None:
        for f, t in self.buf.items():
            t.copy_(self.backup[f])


class _ChunkGraph:
    """A :class:`_Chunk` captured as a CUDA graph on a stream of its own;
    the solve's launches all go to that stream (enter :attr:`stream`).

    Where the capture could go wrong, and what is done about it:

    - *The workspace reallocates.*  ``fused_cg._Workspace.reserve``
      replaces ``partials`` and ``tickets`` when a larger geometry comes
      to the same stream, and a graph captured before that would write
      into freed memory.  The capture runs on its own stream after a
      warm-up of its one geometry there, and the graph keeps a
      reference to the workspace tensors whose pointers it captured.
    - *Scalar-pool views can be freed.*  The 0-d results are views of a
      pool that lives on only through its views.  The pool is topped up
      before the capture so the captured iterations take their results
      from it, and the graph keeps every view of it.
    - *Launch counters miss replays.*  A captured launch is counted once
      and a replay runs no Python: the capture's counts are taken back
      and each :meth:`replay` counts the launches of one chunk
      (``ops.uncount_capture`` / ``ops.count_replay``).
    - *No host reads and no workspace allocation in the capture.*  The
      chunk reads nothing on the host (a read would break the capture),
      and the workspace's allocation count must not move across it.
    """

    def __init__(self, chunk: _Chunk, step: Callable, nblocks: int):
        device = chunk.rr.device
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            # warm-up: the one geometry (n, nblocks) reserves its
            # workspace on this stream, outside the capture
            warm = step(chunk.state(0))
            chunk.dot(warm.r, warm.r)
            ws = fused_cg.workspace(warm.r, nblocks)
            del warm
            views = ws.reserve_scalars(
                chunk.rr.dtype, _SCALARS_PER_ITERATION * chunk.size)
            self._keep = (ws.partials, ws.tickets, views)
            allocations = ws.allocations
            before = ops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream):
                chunk.run()
            self.per_chunk = ops.uncount_capture(before)
        if ws.allocations != allocations:
            raise RuntimeError(
                "the workspace allocated during the CUDA-graph capture; "
                "the graph would hold pointers it does not own")

    def replay(self) -> None:
        self.graph.replay()
        ops.count_replay(self.per_chunk)


def solve_jit(op, precond, b: torch.Tensor, tol: float = 1e-10,
              maxiter: int = 10_000, chunk: int = 32,
              info: Optional[dict] = None) -> Tuple[torch.Tensor, int]:
    """Fused PCG with no recovery hooks: the perf path (the reference's
    ``solve_jit``).

    The reference's contract: PCG from ``x0 = 0``, stopping at the first
    ``k`` where ``rr = det_dot(r, r)`` is not above ``tol^2 * (b.b)`` or at
    ``maxiter``; returns ``(x, k)``.  The port's step fuses the
    preconditioner into K2, which needs its ``inv_diag`` and the
    operator's ``nblocks``, so it takes the operator and preconditioner
    objects ``(op, precond)`` where the reference takes their apply
    functions.  Every dot is ``det_dot``; the state is bitwise that of
    the driver's unprotected PCG loop at the same ``k``.

    The loop runs in chunks of ``chunk`` iterations.  On a CUDA tensor a
    chunk is captured once as a CUDA graph and replayed; on a CPU tensor
    the same chunk runs eagerly (dispatch on the device, not a
    fallback).  After each chunk the host reads its ``chunk`` values of
    ``rr`` at once.  When the stop falls inside a chunk, the chunk's
    starting state is restored and its first iterations rerun eagerly
    with the same step and kernels, so ``k`` is exact at one host sync
    per chunk.  ``info``, when given, is filled with the chunk size,
    the chunks run (``chunks``), the launches of one chunk
    (``launches_per_chunk``, graph only), the host seconds of the
    warm-up and capture (``capture_s``) and of the chunks with their
    reads (``chunk_s``), and the iterations rerun eagerly.
    """
    inv_diag = getattr(precond, "inv_diag", None)
    if inv_diag is None:
        raise ValueError(
            f"solve_jit fuses a diagonal preconditioner into kernel K2; "
            f"{type(precond).__name__} exposes no inv_diag")
    step = make_step(op.apply, inv_diag, op.nblocks)
    dot = make_det_dot(op.nblocks)
    state = init_state(op, precond, b, dot=dot)
    threshold = (tol * tol) * float(dot(b, b))
    on_card = b.device.type == "cuda"
    stats = {} if info is None else info
    stats.update(chunk=0, chunks=0, graph=on_card, launches_per_chunk=None,
                 capture_s=0.0, chunk_s=0.0, eager_iterations=0)
    if maxiter <= 0 or not float(dot(state.r, state.r)) > threshold:
        return state.x, 0

    size = min(chunk, maxiter)
    body = _Chunk(step, dot, state, size)
    run, context = body.run, contextlib.nullcontext()
    if on_card:
        t0 = time.perf_counter()
        graph = _ChunkGraph(body, step, op.nblocks)
        stats.update(launches_per_chunk=graph.per_chunk,
                     capture_s=time.perf_counter() - t0)
        run, context = graph.replay, torch.cuda.stream(graph.stream)
    stats["chunk"] = size
    k = 0
    with context:
        while True:
            t0 = time.perf_counter()
            run()
            rr = body.rr.tolist()  # the chunk's one host read
            stats["chunk_s"] += time.perf_counter() - t0
            stats["chunks"] += 1
            stop = next((j + 1 for j, v in enumerate(rr)
                         if not v > threshold), None)
            todo = min(size if stop is None else stop, maxiter - k)
            if todo < size:
                # the stop (or maxiter) falls inside the chunk: back to its
                # start, then its first `todo` iterations eagerly, on the
                # same kernels and so the same bits
                body.restore()
                st = body.state(k)
                for _ in range(todo):
                    st = step(st)
                x, k = st.x, k + todo
                stats["eager_iterations"] = todo
                break
            k += size
            if stop is not None or k >= maxiter:
                x = body.buf["x"]
                break
    if on_card:
        current = torch.cuda.current_stream(b.device)
        current.wait_stream(graph.stream)
        x.record_stream(current)
    return x, k


# ----------------------------------------------------------------------
# The legacy entry: PCG through the generic driver
# ----------------------------------------------------------------------
#: the driver's names this module re-exports (``PCGConfig`` is the
#: historical name of ``SolveConfig``)
_DRIVER_NAMES = {"PCGConfig": "SolveConfig", "SolveConfig": "SolveConfig",
                 "FailureCampaign": "FailureCampaign",
                 "FailureEvent": "FailureEvent", "FailurePlan": "FailurePlan",
                 "SolveReport": "SolveReport"}


def __getattr__(name: str):
    target = _DRIVER_NAMES.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from repro_torch.solvers import driver

    return getattr(driver, target)


def should_persist(k: int, period: int) -> bool:
    """PCG persistence schedule (pair bursts); see the generic
    :func:`repro_torch.solvers.driver.should_persist`."""
    from repro_torch.solvers import driver

    return driver.should_persist(k, period, history=2)


def solve(op, b: torch.Tensor, precond, config=None, backend=None,
          failures=(), x0: Optional[torch.Tensor] = None,
          capture_states_at=()):
    """PCG with optional ESR/NVM-ESR fault tolerance, on ``b``'s device.

    ``config`` is a ``PCGConfig`` (default: ``PCGConfig()``),
    ``backend`` an in-memory-ESR or NVM-ESR recovery backend (or None for
    plain PCG), ``failures`` the injected block crashes.  Returns the
    final state, a report, and any states captured for verification."""
    from repro_torch.solvers import driver
    from repro_torch.solvers.pcg import PCGSolver

    return driver.solve(
        PCGSolver(), op, b, precond,
        config=driver.SolveConfig() if config is None else config,
        backend=backend, failures=failures, x0=x0,
        capture_states_at=capture_states_at)
