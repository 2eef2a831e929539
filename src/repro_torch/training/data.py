"""Token data pipeline: synthetic LM streams + byte-level file corpus.

Deterministic, shardable, restart-safe (position is a function of step).
The port's own copy of ``repro.training.data`` (numpy only): the same
config gives the same batches, bit for bit.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0
    corpus_path: Optional[str] = None   # None -> synthetic


class SyntheticLM:
    """Markov-ish synthetic stream: learnable structure, not pure noise.

    token_{t+1} = (a * token_t + b + noise) mod V with per-stream (a, b) —
    a model reducing loss on this stream is genuinely fitting structure.
    (a, b) are a function of the *stream row*, not the step, so the affine
    maps are stable across batches and the structure is actually learnable;
    start token and noise stay step-dependent (restart-safe).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + step * 1_000_003)
        v = cfg.vocab_size
        srng = np.random.default_rng(cfg.seed)            # step-independent
        a = srng.integers(1, 8, size=(cfg.batch, 1))
        b = srng.integers(0, v, size=(cfg.batch, 1))
        x = np.empty((cfg.batch, cfg.seq_len + 1), np.int64)
        x[:, 0] = rng.integers(0, v, size=cfg.batch)
        noise = rng.integers(0, 3, size=(cfg.batch, cfg.seq_len))
        for t in range(cfg.seq_len):
            x[:, t + 1] = (a[:, 0] * x[:, t] + b[:, 0] + noise[:, t]) % v
        return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteCorpus:
    """Byte-level tokens from a file, tiled into (inputs, labels) pairs."""

    def __init__(self, cfg: DataConfig):
        if cfg.corpus_path is None:
            raise ValueError("ByteCorpus needs DataConfig.corpus_path")
        raw = Path(cfg.corpus_path).read_bytes()
        self.tokens = np.frombuffer(raw, np.uint8).astype(np.int32) \
            % cfg.vocab_size
        self.cfg = cfg
        need = cfg.batch * (cfg.seq_len + 1)
        if len(self.tokens) < need:
            raise ValueError(f"corpus too small: {len(self.tokens)} bytes, "
                             f"a batch needs {need}")

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        n = len(self.tokens)
        span = cfg.seq_len + 1
        out = np.empty((cfg.batch, span), np.int32)
        for i in range(cfg.batch):
            start = (step * cfg.batch + i) * span % (n - span)
            out[i] = self.tokens[start:start + span]
        return out[:, :-1], out[:, 1:]

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(cfg: DataConfig):
    if cfg.corpus_path:
        return ByteCorpus(cfg)
    return SyntheticLM(cfg)
