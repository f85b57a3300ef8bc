"""Launchers (port of ``repro/launch``): the card's constants and the
production layouts on one card (``mesh``), the analytic roofline
(``roofline``), the report tables (``report``), the serving CLI
(``serve``: the solve service's trace replay, and LM prefill and decode
with ``--arch``), the fault-tolerant LM trainer (``train``) and the
solver dry run (``dryrun``)."""

#: where the dry run writes its rows, and the report reads them, unless
#: told otherwise
DRYRUN_OUT = "results/torch_dryrun.jsonl"
