"""Data pipeline: deterministic synthetic LM token stream with host-side
prefetch and delivery onto a device.

Synthetic data is a seeded Zipf-ish mixture so runs are reproducible and
loss curves are meaningful (structure to learn: repeated n-grams).
:class:`SyntheticLM` is the JAX package's, numpy for numpy: a batch is
seeded by ``hash((step, batch, seq))``, and the hash of a tuple of
Python ints does not depend on ``PYTHONHASHSEED``, so both packages draw
the same tokens.  :class:`Prefetcher` fills a bounded queue from a
background thread, each batch copied onto its device from pinned memory
without blocking, or placed across a device mesh (``sharding=``).
"""
from __future__ import annotations

import operator
import queue
import threading

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


class SyntheticLM:
    """Deterministic synthetic corpus with learnable bigram structure."""

    def __init__(self, vocab: int, seed: int = 0, ngram: int = 3):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # sparse deterministic bigram table: each token has few successors
        self.successors = rng.integers(0, vocab, size=(vocab, ngram))

    def batch(self, step: int, batch: int, seq: int) -> dict:
        """``{"tokens", "labels"}``, int32 numpy ``(batch, seq)``.
        ``step`` is taken as a Python int (a tensor hashes by identity)."""
        key = (operator.index(step), batch, seq)
        rng = np.random.default_rng(hash(key) % 2**31)
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        noise = rng.random((batch, seq))
        choice = rng.integers(0, self.successors.shape[1],
                              size=(batch, seq))
        for t in range(seq):
            nxt = self.successors[toks[:, t], choice[:, t]]
            rand = rng.integers(0, self.vocab, size=batch)
            toks[:, t + 1] = np.where(noise[:, t] < 0.1, rand, nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (pinned, non-blocking
    copies onto a card)."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


class Prefetcher:
    """Background-thread prefetch + device placement (the card unless
    ``device`` says otherwise).  ``sharding``: a dict of ``(DeviceMesh,
    placements)`` per batch key; each array is then placed with
    ``distribute_tensor`` instead."""

    def __init__(self, source: SyntheticLM, batch: int, seq: int,
                 sharding=None, depth: int = 2, start_step: int = 0,
                 device=None):
        self.source = source
        self.batch, self.seq = batch, seq
        self.sharding = sharding
        self.device = None if sharding is not None \
            else resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        from repro_torch.training.checkpoint import place_sharded
        while not self._stop.is_set():
            b = self.source.batch(self.step, self.batch, self.seq)
            if self.sharding is not None:
                b = {k: place_sharded(torch.from_numpy(
                    np.ascontiguousarray(v)), self.sharding[k])
                    for k, v in b.items()}
            else:
                b = to_device(b, self.device)
            try:
                self.q.put(b, timeout=1.0)
                self.step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self.thread.join(timeout=10.0)
