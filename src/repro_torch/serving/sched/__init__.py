"""Admission / preemption policies (a copy of ``repro.serving.sched.policy``;
the fleet and trace replay come with a later slice)."""
from repro_torch.serving.sched.policy import (DEFAULT_PREEMPT_SLACK,
                                              EDFPolicy, FIFOPolicy, POLICIES,
                                              PriorityPolicy, SchedPolicy,
                                              make_policy)

__all__ = [
    "SchedPolicy", "FIFOPolicy", "PriorityPolicy", "EDFPolicy",
    "POLICIES", "make_policy", "DEFAULT_PREEMPT_SLACK",
]
