"""The solve service's trace-replay driver (port of
``repro/launch/serve.py``).

Replays a seeded request trace (:func:`repro_torch.api.
generate_request_trace`, the trace the reference replays for the same
seed) through :class:`repro_torch.api.SolveService` on the card and
prints per-tenant outcomes plus the service's admission and queue
statistics, in the reference's format::

    PYTHONPATH=src python -m repro_torch.launch.serve --seed 0 \
        --requests 6 --lanes 4 --failures

``--device cpu`` replays on the CPU (the plain PyTorch versions of the
kernels); the default is the card, and with no card visible the replay
raises.  The reference's LM path (``--arch``: batched prefill and
decode) needs the NN stack, ROADMAP Queue 1 item 3, and exits non-zero
here.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

#: what ``--arch`` answers until the NN stack is ported
LM_PATH_MISSING = ("the LM serving path (--arch) needs the NN stack, which "
                   "the port does not have yet: ROADMAP Queue 1 item 3")


def tenant_lines(tickets: Dict) -> List[str]:
    """One line a tenant, in tenant order: the solver, convergence,
    iterations, recoveries, queue wait and batch occupancy of an accepted
    tenant, the reason of a rejected one."""
    lines = []
    for name, ticket in sorted(tickets.items()):
        if not ticket.accepted:
            lines.append(f"  {name}: REJECTED ({ticket.reason})")
            continue
        rep = ticket.result.report
        lines.append(f"  {name}: {rep.solver:9s} conv={str(rep.converged):5s} "
                     f"iters={rep.iterations:4d} "
                     f"recovered={rep.failures_recovered} "
                     f"wait={rep.service_queue_wait_steps} "
                     f"occupancy={rep.service_batch_occupancy:.2f}")
    return lines


def _serve_solves(args) -> None:
    from repro_torch import api

    reqs = api.generate_request_trace(
        args.seed, nrequests=args.requests,
        failure_rate=args.failure_rate if args.failures else 0.0,
        survivable_only=True)
    svc = api.SolveService(api.ServiceConfig(
        lanes=args.lanes, max_queue=args.max_queue, device=args.device))
    t0 = time.perf_counter()
    tickets = svc.replay(reqs)
    wall = time.perf_counter() - t0

    for line in tenant_lines(tickets):
        print(line)
    completed = sum(t.accepted for t in tickets.values())
    waits = svc.metrics.histogram("service.queue_wait_steps")
    print(f"service: {completed}/{len(reqs)} completed in {svc.now} steps "
          f"({wall:.2f}s, {completed / wall:.2f} solves/s); "
          f"queue-wait p50={waits.percentile(50):.0f} "
          f"p99={waits.percentile(99):.0f} steps")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="LM arch id (the prefill/decode engine): not "
                         "ported yet, exits non-zero")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=8)
    ap.add_argument("--failures", action="store_true",
                    help="inject the trace's per-tenant failure campaigns")
    ap.add_argument("--failure-rate", type=float, default=0.6)
    ap.add_argument("--device", default="cuda",
                    help="where the tenants' problems live: the card "
                         "(default) or cpu")
    args = ap.parse_args(argv)

    if args.arch is not None:
        raise SystemExit(f"--arch {args.arch}: {LM_PATH_MISSING}")
    _serve_solves(args)


if __name__ == "__main__":
    main()
