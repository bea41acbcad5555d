"""Synthetic token data pipeline (deterministic, resumable).

Production shape: sharded host loading with a persisted cursor so
checkpoint/restart resumes mid-epoch without replaying or skipping
batches.  The generator is a counter-based PRNG (stateless per index),
so any batch can be regenerated from its global step alone — the
property that makes elastic re-sharding trivial at 1000-node scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataState:
    step: int = 0
    seed: int = 0


class SyntheticLM:
    """Markov-ish synthetic token stream: next-token structure exists so
    training loss visibly decreases (not pure noise)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.state = DataState(seed=seed)

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.state.seed * 1_000_003 + step)
                                    % (2 ** 31))
        V = self.cfg.vocab
        # structured stream: x_{t+1} = (a * x_t + b + noise) mod V
        a = 31
        x = np.zeros((self.batch, self.seq + 1), np.int64)
        x[:, 0] = rng.randint(0, V, size=self.batch)
        noise = rng.randint(0, 7, size=(self.batch, self.seq))
        for t in range(self.seq):
            x[:, t + 1] = (a * x[:, t] + 17 + noise[:, t]) % V
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}

    def next(self) -> Dict[str, np.ndarray]:
        b = self._batch_at(self.state.step)
        self.state.step += 1
        return b

    def snapshot(self) -> dict:
        return dataclasses.asdict(self.state)

    def restore(self, snap: dict) -> None:
        self.state = DataState(**snap)
