"""Serving driver (port of ``repro/launch/serve.py``).

Default path — the multi-tenant batched **solve service**: replay a
seeded request trace (:func:`repro_torch.api.generate_request_trace`,
the trace the reference replays for the same seed) through
:class:`repro_torch.api.SolveService` on the card and print per-tenant
outcomes plus the service's admission and queue statistics, in the
reference's format::

    PYTHONPATH=src python -m repro_torch.launch.serve --seed 0 \
        --requests 6 --lanes 4 --failures

LM path — batched greedy prefill + decode of any registered arch with
random parameters (:class:`repro_torch.serving.ServeEngine`), one line
in the reference's format (its "incl. compile" covers the eager first
call's setup here)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --batch 4 --prompt-len 512 --gen 32

``--device cpu`` runs either path on the CPU (the plain PyTorch
versions of the kernels); the default is the card, and with no card
visible the run raises.  A vision arch (``qwen2_vl_72b``) takes patch
embeddings, not token prompts, and is refused, as the reference refuses
it.

As the reference does, the LM path serves over ``make_mesh_for(n)``
(tensor, expert and data parallel) when ``n > 1`` cards are visible;
``--mesh N`` asks for ``N`` shards over the visible cards (or, with
``--device cpu``, on the CPU).  Every family with token prompts serves
there: the decoder LMs, recurrentgemma's RG-LRU hybrid, mamba2's SSD
stack and whisper's encoder-decoder (its frames zeros, as on one
device); the vision arch is refused with or without a mesh.  On the
card, one device or a mesh of one card, the decode runs one eager step
and then replays one CUDA-graph capture, and a second line prints the
engine's ``stats`` (graph, eager steps, replays, capture seconds)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m \
        --smoke --mesh 4 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence


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


def _serve_lm(args) -> None:
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.serving.engine import ServeEngine

    cfg = R.get_config(args.arch, smoke=args.smoke)
    if cfg.frontend == "vision":
        raise SystemExit(f"--arch {args.arch}: vision serving takes patch "
                         f"embeddings, not token prompts")
    dev = resolve_device(args.device)
    shards = args.mesh
    if shards is None:
        shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = make_mesh_for(shards, device=dev) if shards > 1 else None
    if mesh is not None:
        dev = mesh.device
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, mesh=mesh)
    prefill_fn = R.make_prefill(cfg)

    def prefill(p, t, c):
        inputs = {"tokens": t}
        if cfg.family == "encdec":
            inputs["frames"] = torch.zeros((t.shape[0], cfg.enc_seq, cfg.d_model),
                                           dtype=cfg.cdt, device=dev)
        return prefill_fn(p, inputs, c)

    eng = ServeEngine(prefill_fn=prefill, decode_fn=R.make_decode(cfg),
                      cache_init=lambda b, s: R.init_caches(cfg, b, s,
                                                            device=dev,
                                                            mesh=mesh))
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    t0 = time.perf_counter()
    out = eng.generate(model, prompt, steps=args.gen).cpu()
    wall = time.perf_counter() - t0
    where = "" if mesh is None else \
        f" on a ({mesh.shape['data']}, {mesh.shape['model']}) mesh"
    print(f"{cfg.name}: {tuple(out.shape)} tokens in {wall:.2f}s "
          f"({args.batch*args.gen/wall:.1f} tok/s incl. compile){where}")
    if dev.type == "cuda":
        # the decode's route on the card: one eager step, then replays
        st = eng.stats
        print(f"  decode: graph={st['graph']} eager_steps={st['eager_steps']} "
              f"replays={st['replays']} capture_s={st['capture_s']:.3f}")


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
                    help="LM arch id: switches to the prefill/decode "
                         "engine (default: the solve service)")
    # LM path
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh", type=int, default=None,
                    help="serve over a (data, model) mesh of this many "
                         "shards (default: one a visible card)")
    # solve-service path
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=8)
    ap.add_argument("--failures", action="store_true",
                    help="inject the trace's per-tenant failure campaigns")
    ap.add_argument("--failure-rate", type=float, default=0.6)
    ap.add_argument("--device", default="cuda",
                    help="where the model or the tenants' problems "
                         "live: the card (default) or cpu")
    args = ap.parse_args(argv)

    if args.arch is not None:
        from repro_torch.models import registry as R

        if args.arch not in R.ARCH_IDS:
            raise SystemExit(f"unknown arch {args.arch!r}; "
                             f"one of {sorted(R.ARCH_IDS)}")
        _serve_lm(args)
    else:
        _serve_solves(args)


if __name__ == "__main__":
    main()
