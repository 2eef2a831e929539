"""SLO-aware traffic scheduling: policies, the multi-backend Fleet, and
reproducible arrival traces (copies of ``repro.serving.sched``)."""
from repro_torch.serving.sched.policy import (DEFAULT_PREEMPT_SLACK,
                                              EDFPolicy, FIFOPolicy, POLICIES,
                                              PriorityPolicy, SchedPolicy,
                                              make_policy)
from repro_torch.serving.sched.trace import (DEFAULT_CLASSES, ReplayReport,
                                             TraceClass, TraceItem,
                                             bursty_trace, poisson_trace,
                                             replay)

__all__ = [
    "SchedPolicy", "FIFOPolicy", "PriorityPolicy", "EDFPolicy",
    "POLICIES", "make_policy", "DEFAULT_PREEMPT_SLACK",
    "Fleet", "FleetStats",
    "TraceClass", "TraceItem", "DEFAULT_CLASSES", "ReplayReport",
    "poisson_trace", "bursty_trace", "replay",
]


def __getattr__(name):
    # Fleet sits on top of ContinuousBatcher, which itself imports the
    # policy module above -- loading it lazily keeps this package importable
    # from inside the scheduler without a cycle
    if name in ("Fleet", "FleetStats"):
        from repro_torch.serving.sched import fleet
        return getattr(fleet, name)
    raise AttributeError(name)
