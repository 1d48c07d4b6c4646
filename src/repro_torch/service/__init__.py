# Integration-as-a-service (port of repro.service): the request-serving
# layer above the MC engine, on one card.
#
#   canonical  - deterministic canonicalization + content hashing of requests
#   cache      - stderr-aware result cache with counter-stream top-up
#   batcher    - cross-request coalescing into fused multi-round buckets
#   engine     - continuously-batching submit/poll worker (fair wave
#                planner, double-buffered wave pipeline, backpressure)
#   store      - crash-safe journal + snapshot persistence (warm restarts,
#                single-writer lease), the reference's on-disk format
#   api        - request/response dataclasses and the blocking client
#   resilience - the ONE retry/backoff/deadline policy
#   faults     - deterministic fault injection (chaos harness)

from repro_torch.service.api import (Backpressure, IntegrationClient,
                                     IntegrationRequest, IntegrationResult,
                                     RequestError, RequestFailed,
                                     SweepRequest, SweepResult,
                                     request_from_numpy)
from repro_torch.service.cache import CacheEntry, ResultCache
from repro_torch.service.canonical import (canonical_family, family_hash,
                                           spec_hash, sweep_slices)
from repro_torch.service.engine import EngineStats, IntegrationEngine
from repro_torch.service.faults import (FAULT_POINTS, FaultPlan,
                                        InjectedFault, NullFaultPlan)
from repro_torch.service.resilience import (Deadline, DeadlineExceeded,
                                            RetryExhausted, RetryPolicy,
                                            run_with_policy)
from repro_torch.service.store import (DurableStore, EntryState, LeaseHeld,
                                       LeaseLost, RecoveredState)

__all__ = [
    "Backpressure",
    "CacheEntry",
    "Deadline",
    "DeadlineExceeded",
    "DurableStore",
    "EngineStats",
    "EntryState",
    "FAULT_POINTS",
    "FaultPlan",
    "InjectedFault",
    "IntegrationClient",
    "IntegrationEngine",
    "IntegrationRequest",
    "IntegrationResult",
    "LeaseHeld",
    "LeaseLost",
    "NullFaultPlan",
    "RecoveredState",
    "RequestError",
    "RequestFailed",
    "ResultCache",
    "RetryExhausted",
    "RetryPolicy",
    "SweepRequest",
    "SweepResult",
    "canonical_family",
    "family_hash",
    "request_from_numpy",
    "run_with_policy",
    "spec_hash",
    "sweep_slices",
]
