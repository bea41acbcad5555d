"""Worker performance model (paper §9.1 hardware).

A worker = one vLLM instance = 4x A100-80GB under TP4 serving
Llama-3-70B-Instruct.  The 64-GPU cluster is 16 workers.  Constants are
calibrated against the paper's own measurements: ~10.7 GB KV per 32K
session (§2.2), regeneration ~0.3 s/step at 8B scaling to ~5 s/step at
405B (§9.1.1 => ~1.5-2.5 s at 70B for 16-32K contexts), migration mean
230 ms / P95 890 ms (Table 7).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass


@dataclass
class PerfModel:
    # serving rates per worker (70B, TP4, A100):
    # prefill: chunked-prefill at ~45% MFU: 4*312e12*0.45/(2*70e9) ~= 8000
    prefill_tokens_per_s: float = 8000.0
    decode_tokens_per_s: float = 45.0          # per sequence
    max_batch: int = 16                        # concurrent decodes
    # KV economics (Llama-3-70B GQA: 10.7GB / 32K tokens)
    kv_bytes_per_token: float = 10.7e9 / 32768.0
    # HBM available for KV per worker: 4x80GB minus weights (140GB TP4)
    # and activations/overheads => ~150GB usable KV pool
    kv_pool_bytes: float = 150e9
    # migration (Llumnix-style, Table 7)
    migration_mean_s: float = 0.230
    migration_p95_s: float = 0.890
    # coordinator epoch
    epoch_s: float = 0.100

    def step_compute_s(self, regen_tokens: float, new_tokens: float,
                       out_tokens: float) -> float:
        prefill = (regen_tokens + new_tokens) / self.prefill_tokens_per_s
        decode = out_tokens / self.decode_tokens_per_s
        return prefill + decode

    def sample_migration_s(self, rng: random.Random) -> float:
        mu = math.log(self.migration_mean_s) - 0.3
        sigma = math.log(self.migration_p95_s /
                         self.migration_mean_s) / 1.645 + 0.3
        return min(math.exp(mu + sigma * rng.gauss(0, 1)), 5.0)
