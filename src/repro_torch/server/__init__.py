"""Serving front door: async streaming HTTP/SSE with SLO- and energy-aware
admission control (twin of ``repro/server``).

Layering (transport down to the card)::

    HttpFrontDoor   -- stdlib asyncio HTTP/1.1 + SSE   (repro_torch.server.http)
        |
    FrontDoor       -- async request queue, streaming, preemption/resume
        |             (repro_torch.server.frontdoor)
    AdmissionController -- per-tenant priorities, token-budget fairness,
        |             joule buckets (energy SLOs), decision records
        |             (repro_torch.server.admission)
    MeshLeader      -- on a (data, model) mesh, rank 0's scheduler: its
        |             submits and preemptions broadcast before each step
        |             to the followers (repro_torch.server.mesh)
    BatchScheduler  -- the continuous-batching scheduler
                      (repro_torch.serving): dense or paged, on the card's
                      K3/K9 decode kernels; tokens stay a pure f(params,
                      prompt, seed), so the whole async stack is testable
                      against a direct in-process run.
"""

from repro_torch.server.admission import (AdmissionController,
                                          AdmissionRecord, TenantPolicy)
from repro_torch.server.frontdoor import (FrontDoor, QueueFull, RequestResult,
                                          TokenStream)
from repro_torch.server.http import (HttpFrontDoor, generate, http_request,
                                     read_sse)
from repro_torch.server.mesh import MeshLeader, follow

__all__ = [
    "AdmissionController",
    "AdmissionRecord",
    "TenantPolicy",
    "FrontDoor",
    "QueueFull",
    "RequestResult",
    "TokenStream",
    "HttpFrontDoor",
    "MeshLeader",
    "follow",
    "generate",
    "http_request",
    "read_sse",
]
