"""Batched serving engine: decode with per-sequence positions.
Port of the JAX package's ``serve/engine.py``.

Slot-based continuous batching: a fixed batch of slots, each holding one
request's cache region; finished slots are refilled from the queue.  A
request's prompt is admitted token by token through ``decode_step``, as
in the reference.  Where the reference jits the step and donates the
cache, the port runs eagerly under ``torch.inference_mode()`` and writes
the cache in place.  Per-sequence ``pos`` makes slots independent, which
is what allows requests of different lengths to share a batch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, init_cache


@dataclass
class Request:
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 profiler=None, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        # optional profiler façade (a context manager, e.g. the reference
        # package's repro.profiler.Profiler): each serve() call runs
        # inside one profiling window
        self.profiler = profiler
        if profiler is not None \
                and getattr(getattr(profiler, "options", None),
                            "tune", False):
            raise NotImplementedError(
                "ServeEngine(profiler=...) with tune=True binds the adaptive "
                "I/O chunker (repro.io.adaptive in the reference), which the "
                "port has not copied yet")
        self.slots = batch_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, batch_slots, max_len, device=self.device)
        self.pos = torch.zeros((batch_slots,), dtype=torch.long,
                               device=self.device)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self._tokens = torch.zeros((batch_slots, 1), dtype=torch.long,
                                   device=self.device)

    def _step(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One greedy decode step over every slot; the cache is updated in
        place.  Returns the next token of each slot, (B,) on the device."""
        logits, self.cache = decode_step(self.params, self.cfg, self.cache,
                                         tokens, pos, device=self.device)
        return torch.argmax(logits, dim=-1)

    # ----------------------------------------------------------- lifecycle
    def _admit(self, queue: List[Request]) -> None:
        for i in range(self.slots):
            if self.active[i] is None and queue:
                req = queue.pop(0)
                self.active[i] = req
                # sequential prefill into slot i (simple: token-by-token)
                for t in np.asarray(req.prompt, np.int32):
                    self._tokens[i, 0] = int(t)
                    nxt = self._step(self._tokens, self.pos)
                    self.pos[i] += 1
                tok = int(nxt[i])
                self._tokens[i, 0] = tok
                req.out.append(tok)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Run until all requests complete; returns them with .out filled.
        With a ``profiler`` attached, the whole call is one profiled
        window (``profiler.report`` afterwards holds it)."""
        with torch.inference_mode():
            if self.profiler is not None:
                with self.profiler:
                    return self._serve(requests)
            return self._serve(requests)

    def _serve(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        self._admit(queue)
        while any(r is not None for r in self.active) or queue:
            nxt = self._step(self._tokens, self.pos)
            self.pos += torch.tensor(
                [1 if r is not None else 0 for r in self.active],
                dtype=torch.long, device=self.device)
            toks, pos = nxt.tolist(), self.pos.tolist()
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                req.out.append(toks[i])
                if (len(req.out) >= req.max_new_tokens
                        or pos[i] >= self.max_len - 1):
                    req.done = True
                    self.active[i] = None
            self._tokens = nxt[:, None]
            self._admit(queue)
        return requests
