"""Serving substrate of the port (port of ``repro/serving``).

Two independent engines live here:

- :class:`SolveService` — the multi-tenant batched *solve* service;
- :class:`ServeEngine` — the LM prefill/decode engine over per-layer
  caches (the ``launch/serve.py --arch ...`` path).

:class:`SolveService` buckets concurrent solve requests by padded size,
embeds each tenant in one lane of a fixed-width bucket, and advances
every bucket with one batched recoverable driver step — one K1, and for
PCG one lane-mode K2 and one lane-mode ``det_dot`` launch, for the whole
bucket — with per-tenant persistence, failure isolation and bounded
admission.
"""
from repro_torch.serving.engine import ServeEngine  # noqa: F401
from repro_torch.serving.solve_service import (  # noqa: F401
    ServiceConfig,
    ServiceError,
    ServiceTicket,
    SolveService,
)
from repro_torch.serving.trace import (  # noqa: F401
    ServiceRequest,
    generate_request_trace,
)
