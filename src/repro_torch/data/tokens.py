"""Synthetic LM data pipeline: the port of ``repro.data.tokens``.

A deterministic, seekable token stream (restart-safe: a checkpoint needs
only the step counter), Zipf-distributed over the vocabulary with
short-range repetition so the LM loss actually decreases, prefetched on
a background thread.  Draws come from the port's counter-based generator
keyed by (seed, step, lane), so the same step gives the same batch, in
any order and on any device: a batch is drawn on the CPU and then moved.
The bits are not those of the reference's threefry keys; parity tests
feed the reference's batches through ``tokens=``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device


def synthetic_batch(seed: int, step: int, batch: int, seq: int,
                    vocab: int, frontend_tokens: int = 0, d_model: int = 0,
                    encoder_seq: int = 0, dtype=torch.float32) -> dict:
    """One batch of synthetic data on the CPU: (batch, seq) int32 tokens
    and, as the reference draws them, the VLM's ``embeds`` (batch,
    frontend_tokens, d_model) or the enc-dec family's ``frames`` (batch,
    encoder_seq, d_model): 0.02 x standard normals in ``dtype``."""
    lanes = rnd.lanes((batch, seq), "cpu")
    u = rnd.uniform(seed, rnd.TOKEN_ZIPF, step, lanes)
    u = 1e-6 + (1.0 - 1e-6) * u          # the reference's [1e-6, 1)
    tokens = torch.clamp((torch.exp(-torch.log(u) * 0.35) - 1.0) * 7.0, 0,
                         vocab - 1).to(torch.int32)
    # short-range structure: repeat the previous token 25 % of the time
    rep = rnd.uniform(seed, rnd.TOKEN_REPEAT, step, lanes) < 0.25
    out = {"tokens": torch.where(rep, torch.roll(tokens, 1, dims=1),
                                 tokens)}
    for key, n in (("embeds", frontend_tokens), ("frames", encoder_seq)):
        if n and d_model:
            out[key] = (0.02 * rnd.normal(seed, rnd.TOKEN_FRONTEND, step,
                                          rnd.lanes((batch, n, d_model),
                                                    "cpu"))).to(dtype)
    return out


@dataclass
class TokenPipeline:
    """Seekable, prefetching synthetic-token source.

    ``seed`` + ``step`` fully determine a batch, so an elastic restore
    needs no data state beyond the step counter.  ``frontend_tokens``,
    ``d_model`` and ``encoder_seq`` add the VLM's embeds or the enc-dec
    family's frames, as in the reference.  ``tokens`` overrides the
    draws: a callable ``step -> (batch, seq)`` token array, or ``step ->``
    a dict of arrays with ``"tokens"`` and the batch's ``"embeds"`` or
    ``"frames"`` (the reference's batches, in parity tests).
    """

    batch: int
    seq: int
    vocab: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0
    encoder_seq: int = 0
    prefetch: int = 2
    device: str = "cuda"
    tokens: Optional[Callable[[int], "np.ndarray | dict"]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def batch_at(self, step: int) -> dict:
        if self.tokens is not None:
            got = self.tokens(step)
            got = got if isinstance(got, dict) else {"tokens": got}
            b = {k: torch.as_tensor(np.asarray(v), dtype=torch.int32
                                    if k == "tokens" else torch.float32)
                 for k, v in got.items()}
        else:
            b = synthetic_batch(self.seed, step, self.batch, self.seq,
                                self.vocab, self.frontend_tokens,
                                self.d_model, self.encoder_seq)
        return {k: v.to(self.device) for k, v in b.items()}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        """Batches from ``start_step`` on, drawn ahead on a background
        thread (``prefetch`` deep)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                try:
                    q.put((s, self.batch_at(s)), timeout=0.1)
                except queue.Full:
                    continue
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()[1]
        finally:
            stop.set()
            t.join()  # never leave the worker inside a torch op at exit
