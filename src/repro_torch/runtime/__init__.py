"""Serving runtime of the port: the backend protocol and the prefix index
(copies of ``repro.runtime.base`` and ``repro.runtime.prefix_cache``) and the
torch tensor backend."""
from repro_torch.runtime.base import (BackendDead, BackendError, BackendInfo,
                                      BackendTimeout, BlockAllocator,
                                      InferenceBackend, PoolExhausted,
                                      SlotEvent, SlotPager)
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.tensor import TensorBackend, TorchTensorBackend

__all__ = [
    "BackendDead", "BackendError", "BackendInfo", "BackendTimeout",
    "BlockAllocator", "InferenceBackend", "PoolExhausted",
    "PrefixCache", "SlotEvent", "SlotPager", "TensorBackend",
    "TorchTensorBackend",
]
