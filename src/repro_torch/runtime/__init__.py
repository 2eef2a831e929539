"""Serving runtime of the port: the backend protocol (a copy of
``repro.runtime.base``) and the torch tensor backend."""
from repro_torch.runtime.base import (BackendDead, BackendError, BackendInfo,
                                      BackendTimeout, BlockAllocator,
                                      InferenceBackend, PoolExhausted,
                                      SlotEvent, SlotPager)
from repro_torch.runtime.tensor import TorchTensorBackend

__all__ = [
    "BackendDead", "BackendError", "BackendInfo", "BackendTimeout",
    "BlockAllocator", "InferenceBackend", "PoolExhausted",
    "SlotEvent", "SlotPager", "TorchTensorBackend",
]
