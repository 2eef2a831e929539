"""Serving runtime of the port: the backend protocol, the prefix index and
fault injection (copies of ``repro.runtime.base``,
``repro.runtime.prefix_cache`` and ``repro.runtime.faults``), the torch
tensor backend, the no-bubbles stage pipeline backend, the planner's
cost-model backend (a copy of ``repro.runtime.sim``) and the planner ->
backend factory."""
from repro_torch.runtime.base import (BackendDead, BackendError, BackendInfo,
                                      BackendTimeout, BlockAllocator,
                                      InferenceBackend, PoolExhausted,
                                      SlotEvent, SlotPager)
from repro_torch.runtime.factory import from_deployment, plan_pipeline_spec
from repro_torch.runtime.faults import (Fault, FaultInjectionBackend,
                                        parse_faults)
from repro_torch.runtime.pipeline_backend import PipelineBackend
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.sim import SimBackend
from repro_torch.runtime.tensor import TensorBackend, TorchTensorBackend

__all__ = [
    "BackendDead", "BackendError", "BackendInfo", "BackendTimeout",
    "BlockAllocator", "Fault", "FaultInjectionBackend", "InferenceBackend", "PipelineBackend", "PoolExhausted",
    "PrefixCache", "SimBackend", "SlotEvent", "SlotPager", "TensorBackend",
    "TorchTensorBackend", "from_deployment", "parse_faults",
    "plan_pipeline_spec",
]
