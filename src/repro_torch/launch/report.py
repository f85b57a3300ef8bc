"""Report tables: the dry run's roofline rows, solver reports, metrics,
backend capabilities and the advisor's ranking (port of
``repro/launch/report.py``).

The solver, metrics, capability and advice tables are plain Python over
the port's reports and registries and render byte for byte what the
reference renders for reports with equal fields.  The dry-run tables
read the rows of :mod:`repro_torch.launch.dryrun`: each row carries the
card it ran on and that card's memory, so ``fits`` compares the cell's
peak with the memory of the card that measured it.  No row gets a
collective correction: the reference corrects its bf16 LM rows for what
the CPU backend's HLO inflates, but the port's counts are analytic, in
the dtype that is actually moved, like the solver rows.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Optional

from repro_torch.launch import DRYRUN_OUT


def load(path: str) -> Dict:
    """The ``ok`` rows of a dry-run JSONL file by ``(arch, shape,
    mesh)``; a later row replaces an earlier one."""
    rows = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("ok"):
                rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def _gib(nbytes: Optional[float]) -> str:
    return "-" if nbytes is None else f"{nbytes / 2**30:.2f}"


#: the note under a roofline table that holds LM rows: what their
#: counts are (``repro_torch.launch.roofline.OpCounter``)
LM_COUNTS_NOTE = ("LM rows: flops count the products only (elementwise "
                  "work is not counted, so useful-flop can exceed 1); "
                  "t_mem is the eager program's counted ATen traffic over "
                  "the HBM rate, not a compulsory bound, so a memory "
                  "bottleneck names that traffic.")


def table(rows: Dict, mesh: str = "16x16") -> str:
    """The roofline table of the rows on ``mesh`` (the solver's and the
    LM cells' calibrated rows): the step's peak device memory (measured
    for a solver row, estimated for an LM row) against the card's, its
    three time terms on the card, the bottleneck, the useful-operation
    ratio and the share of the step's bound that the useful operations
    alone would take; under LM rows, :data:`LM_COUNTS_NOTE`."""
    out, lm = [], False
    hdr = ("| arch | shape | peak GiB/dev | fits | t_comp ms | t_mem ms | "
           "t_coll ms | bottleneck | useful-flop | roofline frac |")
    out.append(hdr)
    out.append("|" + "---|" * 10)
    for (a, s, m), r in sorted(rows.items()):
        if m != mesh or "roofline" not in r:
            continue
        rf = r["roofline"]
        lm = lm or "measured" in r
        tc, tm, tx = rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"]
        peak = r["memory"].get("peak_bytes")
        memory = r["device"]["memory_bytes"]
        fits = ("-" if peak is None or memory is None
                else "Y" if peak <= memory else "n")
        uf = r.get("useful_flop_ratio")
        # the useful operations' time on the card, against the step's
        # bound (a solver step's copies share HBM with the kernels: tm +
        # tx; an LM cell's collectives cross the network and overlap)
        bound = r.get("step_bound_s", max(tc, tm + tx))
        frac = (uf or 0) * tc / bound if bound > 0 else 0
        out.append(
            f"| {a} | {s} | {_gib(peak)} | {fits} | {tc*1e3:.1f} | "
            f"{tm*1e3:.1f} | {tx*1e3:.1f} | {rf['bottleneck']} | "
            f"{uf:.2f} | {frac:.3f} |" if uf is not None else
            f"| {a} | {s} | {_gib(peak)} | {fits} | - | - | - | - | - | - |")
    if lm:
        out += ["", LM_COUNTS_NOTE]
    return "\n".join(out)


def multipod_table(rows: Dict) -> str:
    """The 2x16x16 layout's rows: peak device memory, first-step
    seconds and, for an LM row, the exact per-device argument bytes (a
    multi-pod pass runs one depth variant, so its peak is not
    estimated)."""
    out = ["| arch | shape | mesh | peak GiB/dev | compile s | args GiB/dev |",
           "|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(rows.items()):
        if m != "2x16x16":
            continue
        peak = r["memory"].get("peak_bytes")
        args = r["memory"].get("argument_bytes")
        out.append(f"| {a} | {s} | {m} | {_gib(peak)} | {r['compile_s']} | "
                   f"{_gib(args)} |")
    return "\n".join(out)


def lm_table(rows: Dict, mesh: str = "16x16") -> str:
    """The LM rows' measurements on ``mesh``: the exact per-device
    argument bytes, the estimated peak against the card's memory, each
    depth variant's median step seconds at its batch, its number of
    timed steps and how they ran (``eager``, or ``graph``: replays of one
    CUDA-graph capture), the extrapolated step of one data replica with its
    range over the quartiles of the variants' steps, and its
    ``model_flops`` share of the bf16 peak, the cuts and refusals
    (``reduced``), and the card."""
    out = ["| arch | shape | args GiB/dev | est. peak GiB/dev | fits | "
           "variant steps s (batch, timed steps, mode) | replica step s (range) | "
           "bf16 share | cuts | card |", "|" + "---|" * 10]
    for (a, s, m), r in sorted(rows.items()):
        if m != mesh or "measured" not in r:
            continue
        msr, dev = r["measured"], r["device"]
        peak = r["memory"].get("peak_bytes")
        fits = ("-" if peak is None or dev["memory_bytes"] is None
                else "Y" if peak <= dev["memory_bytes"] else "n")
        steps = ", ".join(
            f"{g} " + ("-" if v["step_s"] is None else f"{v['step_s']:.4f}")
            + f" ({v['batch']}" + ("" if v.get("timed_steps") is None
                                   else f", {v['timed_steps']}, "
                                   f"{v.get('step_mode', 'eager')}") + ")"
            for g, v in msr["variants"].items())
        step, share = msr["replica_step_s"], msr["bf16_share"]
        span = msr.get("replica_step_range_s")
        if step is not None:
            step = f"{step:.3f}" + ("" if span is None
                                    else " (%.3f-%.3f)" % tuple(span))
        card = ("-" if dev["name"] is None
                else f"{dev['name']}, {dev['power_limit']}")
        out.append(
            f"| {a} | {s} | {_gib(r['memory']['argument_bytes'])} | "
            f"{_gib(peak)} | {fits} | {steps} | "
            f"{'-' if step is None else step} | "
            f"{'-' if share is None else f'{share:.4f}'} | "
            f"{'; '.join(r['reduced']) or '-'} | {card} |")
    return "\n".join(out)


# ----------------------------------------------------------------------
# Solver-run reporting: every SolveReport field in one table (the report
# dataclass docstring in repro_torch/solvers/driver.py defines them).
# ----------------------------------------------------------------------
def solve_report_rows(r) -> Dict[str, str]:
    """One :class:`repro_torch.solvers.SolveReport` as printable columns,
    including the overlapped-persistence metrics."""
    return {
        "solver": r.solver or "-",
        "mode": r.persist_mode,
        "iters": str(r.iterations),
        "conv": "Y" if r.converged else "n",
        "relres": f"{r.final_relres:.2e}",
        "recovered": str(r.failures_recovered),
        "restarts": str(r.recovery_restarts),
        "prd lost": str(r.storage_failures),
        "wasted": str(r.wasted_iterations),
        "events": str(r.persist_events),
        "persist ms": f"{r.persist_cost_s * 1e3:.3f}",
        "exposed ms": f"{r.persist_exposed_s * 1e3:.3f}",
        "hidden %": f"{r.persist_hidden_fraction * 100:.1f}",
        "stage ms": f"{r.persist_stage_s * 1e3:.3f}",
        "drain ms": f"{r.persist_drain_s * 1e3:.3f}",
        # the trailing columns keep the reference's order, so the
        # columns before each stay byte-stable
        "exposed/iter us": f"{r.persist_exposed_per_iteration * 1e6:.3f}",
        "shards": str(getattr(r, "nshards", 1)),
        "persist KiB": f"{getattr(r, 'persist_bytes', 0) / 1024:.1f}",
        "fetch KiB": f"{getattr(r, 'recovery_fetch_bytes', 0) / 1024:.1f}",
    }


def _markdown_table(rows, empty: str) -> str:
    """Render dict rows (shared column order from the first row)."""
    if not rows:
        return empty
    cols = list(rows[0])
    out = ["| " + " | ".join(cols) + " |",
           "|" + "---|" * len(cols)]
    for row in rows:
        out.append("| " + " | ".join(row[c] for c in cols) + " |")
    return "\n".join(out)


def solve_report_table(reports) -> str:
    """Markdown table over solver runs."""
    return _markdown_table([solve_report_rows(r) for r in reports],
                           "(no solver reports)")


# ----------------------------------------------------------------------
# Metrics-registry reporting: the labeled instruments a solve's
# `report.metrics` carries, as a per-phase summary table.
# ----------------------------------------------------------------------
def metrics_rows(registry):
    """One row per instrument in a :class:`repro_torch.obs.MetricsRegistry`
    (sorted by name then labels, like ``registry.snapshot()``).
    Histograms render their per-phase summary (count/total/mean/p50/
    p95/max); counters and gauges render their value with the summary
    columns dashed."""
    rows = []
    base = set(registry.base_labels)
    for inst in registry:
        labels = ", ".join(f"{k}={v}" for k, v in inst.labels
                           if k not in base)
        row = {"metric": inst.name, "kind": inst.kind,
               "labels": labels or "-"}
        if inst.kind == "histogram":
            s = inst.summary()
            row["count"] = str(s["count"])
            row["total"] = f"{s['total']:.3e}"
            for col in ("mean", "p50", "p95", "max"):
                row[col] = (f"{s[col]:.3e}" if s["count"] else "-")
        else:
            row["count"] = "-"
            row["total"] = (str(inst.value) if inst.kind == "counter"
                            else f"{inst.value:g}")
            for col in ("mean", "p50", "p95", "max"):
                row[col] = "-"
        rows.append(row)
    return rows


def metrics_table(registry) -> str:
    """Markdown table over a solve's metrics registry
    (``result.report.metrics``); empty registries render a placeholder."""
    if registry is None or not len(registry):
        return "(no metrics)"
    return _markdown_table(metrics_rows(registry), "(no metrics)")


# ----------------------------------------------------------------------
# Backend capability reporting: what each backend in the registry
# *declares*.
# ----------------------------------------------------------------------
def storage_values(backend) -> int:
    """Total redundancy footprint of a backend in *values* (RAM overhead
    + persistent-tier residency) — the quantity the paper's Fig. 2/8
    memory-overhead argument compares."""
    return backend.memory_overhead_values() + backend.nvm_values()


def capability_rows(name: str, backend,
                    baseline_values: Optional[int] = None) -> Dict[str, str]:
    """One backend's :class:`repro_torch.nvm.backend.BackendCapabilities`
    as printable columns.  ``baseline_values`` (typically a single
    unreplicated backend's :func:`storage_values`) turns the storage
    column into an overhead factor — 2.00x for a mirror pair, 1.25x for
    a 4+p erasure stripe."""
    caps = backend.capabilities
    tol = caps.max_block_failures
    row = {
        "backend": name,
        "durability": caps.durability,
        "node loss": "survives" if caps.survives_node_loss else "fatal",
        "PRD loss": "survives" if caps.survives_prd_loss else "fatal",
        "storage losses": str(caps.max_storage_failures),
        "overlap": caps.overlap,
        "max failures": "unbounded" if tol is None else str(tol),
    }
    values = storage_values(backend)
    if baseline_values:
        row["storage"] = f"{values / baseline_values:.2f}x"
    else:
        row["storage"] = f"{values} values"
    return row


def capability_matrix_table(named_backends,
                            baseline_values: Optional[int] = None) -> str:
    """Markdown capability matrix over ``(name, backend)`` pairs."""
    return _markdown_table(
        [capability_rows(n, b, baseline_values) for n, b in named_backends],
        "(no backends)")


# ----------------------------------------------------------------------
# Advisor reporting: the cheapest-spec ranking a
# `repro_torch.solvers.driver.SpecAdvice` carries, as a readable table.
# ----------------------------------------------------------------------
def _advice_row(r, chosen: Optional[str],
                baseline_values: Optional[int]) -> Dict[str, str]:
    if r.survivable:
        verdict = "chosen" if r.spec == chosen else "ok"
        why = "-"
    else:
        verdict = "rejected"
        # the planner's reason, compacted to the violating fact
        why = r.reason.replace("campaign rejected before iteration 0: ", "")
        if len(why) > 88:
            why = why[:85] + "..."
    if baseline_values:
        storage = f"{r.storage_values / baseline_values:.2f}x"
    else:
        storage = f"{r.storage_values} values"
    cost = ("-" if r.persist_cost_s != r.persist_cost_s  # NaN: not probed
            else f"{r.persist_cost_s * 1e3:.3f}")
    return {"spec": r.spec, "verdict": verdict, "storage": storage,
            "persist ms/event": cost, "why not": why}


def spec_advice_rows(advice, baseline_values: Optional[int] = None):
    """One row per candidate: survivors cheapest-first (the chosen spec
    marked), then the planner-rejected specs with their reason."""
    return [_advice_row(r, advice.chosen, baseline_values)
            for r in list(advice.ranked) + list(advice.rejected)]


def spec_advice_table(advice, baseline_values: Optional[int] = None) -> str:
    """Markdown table over a :class:`repro_torch.solvers.driver.SpecAdvice`
    (``baseline_values`` turns the storage column into overhead
    factors, like :func:`capability_rows`)."""
    return _markdown_table(spec_advice_rows(advice, baseline_values),
                           "(no candidates)")


if __name__ == "__main__":
    rows = load(sys.argv[1] if len(sys.argv) > 1 else DRYRUN_OUT)
    print(table(rows))
    print()
    print(multipod_table(rows))
    if any("measured" in r for r in rows.values()):
        for layout in ("16x16", "2x16x16"):
            print()
            print(lm_table(rows, layout))
