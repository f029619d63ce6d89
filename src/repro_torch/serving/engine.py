"""Serving engine: request batching + prefill/decode loop.

One ServeEngine corresponds to one scheduler *instance* from the paper's
co-location model: the topology-aware scheduler places/preempts instances,
and each instance runs this engine.  The queue pads requests to a fixed
batch and the engine runs prefill (attention through the flash-attention
kernel on the card) and greedy decode steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.shapes import cache_capacity
# Fig. 2 tier-performance model: one copy in repro_torch.core.perfmodel
from repro_torch.core.perfmodel import (TIER_PERF, relative_scheduled_factor,
                                        scheduled_factor)
from repro_torch.models.api import ModelApi

__all__ = ["TIER_PERF", "scheduled_factor", "relative_scheduled_factor",
           "Request", "RequestQueue", "BatchQueue", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class RequestQueue:
    """Pads pending requests into fixed [B, S] prompt batches.

    With ``flush_after > 0`` the queue holds a partial batch back and waits
    for a full ``batch_size``, but only until the HEAD request has waited
    ``flush_after`` seconds; then the partial batch is released padded.
    ``flush=True`` forces the partial batch out regardless of age (the
    synchronous ``ServeEngine.run`` drain).  ``flush_after=0`` serves
    partial batches immediately.
    """

    def __init__(self, batch_size: int, seq_len: int,
                 flush_after: float = 0.0, clock=time.monotonic) -> None:
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.flush_after = flush_after
        self.clock = clock
        self.pending: list[Request] = []
        self._arrived: list[float] = []     # aligned with ``pending``

    def __len__(self) -> int:
        return len(self.pending)

    def submit(self, req: Request) -> None:
        self.pending.append(req)
        self._arrived.append(self.clock())

    def head_age(self) -> float:
        """Seconds the oldest pending request has waited (0 if empty)."""
        return self.clock() - self._arrived[0] if self.pending else 0.0

    def next_batch(self, flush: bool = False) -> list[Request] | None:
        if not self.pending:
            return None
        if (len(self.pending) < self.batch_size and not flush
                and self.flush_after > 0
                and self.head_age() < self.flush_after):
            return None                     # wait for a full batch, bounded
        batch = self.pending[:self.batch_size]
        self.pending = self.pending[self.batch_size:]
        self._arrived = self._arrived[self.batch_size:]
        return batch

    def pad_prompts(self, batch: list[Request]) -> np.ndarray:
        out = np.zeros((self.batch_size, self.seq_len), np.int32)
        for i, r in enumerate(batch):
            s = min(len(r.prompt), self.seq_len)
            out[i, -s:] = r.prompt[:s]        # left-pad (decode continues right)
        return out


#: the eager (flush_after=0) queue under its older name
BatchQueue = RequestQueue


class ServeEngine:
    """Greedy batched serving of one model on ``api.device``.

    As in the reference, prompts are left-padded with token 0 and there is
    no padding mask: the padding is part of the context.  The KV caches are
    updated in place by each decode step (the reference donates them).
    Everything runs under ``torch.inference_mode()``; ``stats`` holds the
    prefill and decode wall times, taken after ``torch.cuda.synchronize()``
    on the card, and the count of generated tokens.
    """

    def __init__(self, api: ModelApi, params: Any, batch_size: int,
                 seq_len: int) -> None:
        self.api = api
        self.cfg = api.cfg
        self.device = api.device
        self.params = params
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.capacity = cache_capacity(self.cfg, seq_len)
        self.queue = RequestQueue(batch_size, seq_len)
        self.stats = {"prefill_s": [], "decode_s": [], "tokens": 0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, requests: list[Request]) -> list[Request]:
        with torch.inference_mode():
            for r in requests:
                self.queue.submit(r)
            while True:
                # synchronous drain: flush partial tails
                group = self.queue.next_batch(flush=True)
                if group is None:
                    break
                self._serve(group)
        return requests

    def _serve(self, group: list[Request]) -> None:
        prompts = self.queue.pad_prompts(group)
        tokens = torch.from_numpy(prompts).to(self.device)
        t0 = time.perf_counter()
        logits, caches = self.api.prefill(self.params, {"tokens": tokens},
                                          self.capacity)
        self._sync()
        self.stats["prefill_s"].append(time.perf_counter() - t0)
        tok = torch.argmax(logits, dim=-1)
        pos = prompts.shape[1]
        for t in range(max(r.max_new_tokens for r in group)):
            host = tok.tolist()
            for i, r in enumerate(group):
                if t < r.max_new_tokens:
                    r.output.append(int(host[i]))
            t0 = time.perf_counter()
            logits, caches = self.api.decode_step(self.params, caches, tok,
                                                  pos + t)
            self._sync()
            self.stats["decode_s"].append(time.perf_counter() - t0)
            self.stats["tokens"] += len(group)
            tok = torch.argmax(logits, dim=-1)
        for r in group:
            r.done = True
