"""Serving API of the port: the ``LLM`` facade over the continuous batcher,
and the multi-backend ``Fleet`` with its seeded traces."""
from repro_torch.serving.llm import LLM
from repro_torch.serving.sampling import sample_logits
from repro_torch.serving.scheduler import (ContinuousBatcher,
                                           IncompleteServeError,
                                           SchedulerStats)
from repro_torch.serving.sched import (EDFPolicy, FIFOPolicy, Fleet,
                                       FleetStats, PriorityPolicy,
                                       SchedPolicy, bursty_trace, make_policy,
                                       poisson_trace, replay)
from repro_torch.serving.spec import (CallableDraft, DraftSource, NGramDraft,
                                      OracleDraft, make_draft)
from repro_torch.serving.types import (Request, RequestOutput, RequestTiming,
                                       SamplingParams, TokenEvent)

__all__ = [
    "LLM", "Request", "RequestOutput", "RequestTiming", "SamplingParams",
    "TokenEvent", "ContinuousBatcher", "SchedulerStats",
    "IncompleteServeError", "sample_logits",
    "SchedPolicy", "FIFOPolicy", "PriorityPolicy", "EDFPolicy",
    "make_policy", "Fleet", "FleetStats", "poisson_trace", "bursty_trace",
    "replay",
    "DraftSource", "NGramDraft", "OracleDraft", "CallableDraft",
    "make_draft",
]
