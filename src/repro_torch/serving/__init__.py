"""Serving API of the port: the ``LLM`` facade over the continuous batcher."""
from repro_torch.serving.llm import LLM
from repro_torch.serving.sampling import sample_logits
from repro_torch.serving.scheduler import (ContinuousBatcher,
                                           IncompleteServeError,
                                           SchedulerStats)
from repro_torch.serving.sched import (EDFPolicy, FIFOPolicy, PriorityPolicy,
                                       SchedPolicy, make_policy)
from repro_torch.serving.spec import (CallableDraft, DraftSource, NGramDraft,
                                      OracleDraft, make_draft)
from repro_torch.serving.types import (Request, RequestOutput, RequestTiming,
                                       SamplingParams, TokenEvent)

__all__ = [
    "LLM", "Request", "RequestOutput", "RequestTiming", "SamplingParams",
    "TokenEvent", "ContinuousBatcher", "SchedulerStats",
    "IncompleteServeError", "sample_logits",
    "SchedPolicy", "FIFOPolicy", "PriorityPolicy", "EDFPolicy",
    "make_policy",
    "DraftSource", "NGramDraft", "OracleDraft", "CallableDraft",
    "make_draft",
]
