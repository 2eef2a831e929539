"""Serving runtime of the port: the backend protocol and the prefix index
(copies of ``repro.runtime.base`` and ``repro.runtime.prefix_cache``), the
torch tensor backend, the no-bubbles stage pipeline backend, the planner's
cost-model backend (a copy of ``repro.runtime.sim``) and the planner ->
backend factory."""
from repro_torch.runtime.base import (BackendDead, BackendError, BackendInfo,
                                      BackendTimeout, BlockAllocator,
                                      InferenceBackend, PoolExhausted,
                                      SlotEvent, SlotPager)
from repro_torch.runtime.factory import from_deployment, plan_pipeline_spec
from repro_torch.runtime.pipeline_backend import PipelineBackend
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.sim import SimBackend
from repro_torch.runtime.tensor import TensorBackend, TorchTensorBackend

__all__ = [
    "BackendDead", "BackendError", "BackendInfo", "BackendTimeout",
    "BlockAllocator", "InferenceBackend", "PipelineBackend", "PoolExhausted",
    "PrefixCache", "SimBackend", "SlotEvent", "SlotPager", "TensorBackend",
    "TorchTensorBackend", "from_deployment", "plan_pipeline_spec",
]
