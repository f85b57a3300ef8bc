"""Serving substrate of the port: the multi-tenant batched *solve*
service (port of ``repro/serving``; the reference's LM prefill/decode
engine belongs to the NN stack and is not ported yet).

:class:`SolveService` buckets concurrent solve requests by padded size,
embeds each tenant in one lane of a fixed-width bucket, and advances
every bucket with one batched recoverable driver step — one K1, and for
PCG one lane-mode K2 and one lane-mode ``det_dot`` launch, for the whole
bucket — with per-tenant persistence, failure isolation and bounded
admission.
"""
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
