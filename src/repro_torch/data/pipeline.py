"""Deterministic, sharded, resumable synthetic token pipeline.

Production semantics without external data: every (step, host-shard) pair
maps to an independent PRNG stream, so

  * restarting from a checkpoint at step k reproduces the exact batch k
    (fault-tolerant restart sees the same data),
  * each host generates only its shard (no duplicated host work),
  * elastic re-sharding (different host count) keeps the GLOBAL batch
    identical because streams are keyed by global example index.

Tokens follow a Zipfian distribution with short-range repetition structure so
losses move meaningfully during smoke training runs.

A copy of the reference's ``repro.data.pipeline`` (numpy only), so that the
two packages draw bit-identical batches; the port imports nothing of the
reference.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    prefetch: int = 2


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 start_step: int = 0) -> None:
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- deterministic generation ---------------------------------------------
    def _example(self, step: int, index: int) -> np.ndarray:
        """Global example `index` of batch `step` — host-independent."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.PCG64(cfg.seed * 1_000_003 + step * 65_537 + index))
        # zipf with clipping into vocab, plus repetition structure
        raw = rng.zipf(cfg.zipf_a, size=cfg.seq_len).astype(np.int64)
        toks = (raw - 1) % cfg.vocab
        # repeat a motif so next-token prediction is learnable
        motif_len = 16
        motif = toks[:motif_len]
        reps = cfg.seq_len // (motif_len * 4)
        for r in range(reps):
            at = (r * 4 + 1) * motif_len
            toks[at:at + motif_len] = motif
        return toks.astype(np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        per_shard = cfg.global_batch // self.num_shards
        lo = self.shard * per_shard
        toks = np.stack([self._example(step, lo + i) for i in range(per_shard)])
        return {"tokens": toks}

    # ---- iterator + prefetch ----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            self._start_prefetch()
        return self._q.get()

    def _start_prefetch(self) -> None:
        def worker():
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(self.step), timeout=0.5)
                    self.step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()

    # ---- checkpoint integration ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
