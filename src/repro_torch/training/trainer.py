"""Training loop: microbatched gradient accumulation, compression,
async checkpointing, fault hooks.

Microbatches run in a Python loop, each one's backward pass adding into
the parameters' ``.grad``; the sum over microbatches divided by their
count is the reference's ``lax.scan`` mean.  Compression with error
feedback and the AdamW update then run in place on the parameter, moment
and error tensors (torch's counterpart of ``donate_argnums``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from . import checkpoint as CKPT
from .fault import StragglerDetector
from .grad_compress import (CompressionConfig, apply_with_error_feedback,
                            init_error_state)
from .optimizer import (adamw_init, adamw_update, cosine_schedule,
                        tree_leaves, tree_map, tree_unflatten)

PyTree = Any


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    microbatches: int = 1
    compression: CompressionConfig = dataclasses.field(
        default_factory=lambda: CompressionConfig("none"))
    ckpt_every: int = 100
    ckpt_dir: str = "checkpoints"
    remat: bool = True


def _grads(cfg: ArchConfig, tcfg: TrainConfig, params, batch):
    """(mean loss, mean grads) over ``tcfg.microbatches`` equal slices of
    ``batch``; a parameter the loss does not reach gets zeros."""
    nmb = tcfg.microbatches
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = None
        for i in range(nmb):
            mb = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])[i]
                  for k, v in batch.items()}
            lm = M.loss_fn(cfg, params, mb, remat=tcfg.remat)[0]
            lm.backward()
            lm = lm.detach()
            loss = lm if loss is None else loss + lm
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    if nmb > 1:
        n = torch.as_tensor(float(nmb), device=loss.device)
        loss = loss / n
        grads = [g.div_(n) for g in grads]
    return loss, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    """(params, opt, err, batch, step) -> (params, opt, err, metrics);
    ``params``, the moments and ``err`` are updated in place."""

    def step_fn(params, opt, err, batch, step):
        loss, grads = _grads(cfg, tcfg, params, batch)
        grads, err = apply_with_error_feedback(grads, err,
                                               tcfg.compression)
        lr = cosine_schedule(step, tcfg.lr, tcfg.warmup, tcfg.total_steps)
        params, opt = adamw_update(params, grads, opt, lr=lr)
        return params, opt, err, dict(loss=loss, lr=lr)

    return step_fn


class Trainer:
    """``params``: a tree of tensors (default: ``init_params`` drawn with
    ``generator``); it runs on ``device``, default the parameters' (or
    the generator's) device, else the card."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, params=None,
                 generator=None, device=None):
        self.cfg, self.tcfg = cfg, tcfg
        if params is None:
            params = M.init_params(cfg, generator, device=device)
        elif device is not None:
            params = tree_map(lambda p: p.to(device), params)
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.opt = adamw_init(self.params)
        self.err = init_error_state(self.params)
        self.step = 0
        self.step_fn = make_train_step(cfg, tcfg)
        self.ckpt = CKPT.AsyncCheckpointer(tcfg.ckpt_dir)
        self.straggler = StragglerDetector()
        self.history: list[dict] = []

    def restore_latest(self) -> bool:
        """Load the latest checkpoint into this trainer's tensors in
        place (through host memory, so the card never holds two
        copies)."""
        latest = CKPT.latest_step(self.tcfg.ckpt_dir)
        if latest is None:
            return False
        state = (self.params, self.opt)
        host, manifest = CKPT.restore(self.tcfg.ckpt_dir, state,
                                      device="cpu")
        with torch.no_grad():
            for dst, src in zip(tree_leaves(state), tree_leaves(host)):
                dst.copy_(src)
        self.step = manifest["step"]
        return True

    def train(self, batches, steps: int, log_every: int = 10) -> list:
        for _ in range(steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(batches).items()}
            t0 = time.perf_counter()
            self.params, self.opt, self.err, metrics = self.step_fn(
                self.params, self.opt, self.err, batch,
                torch.tensor(self.step, dtype=torch.int32,
                             device=self.device))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.observe(self.step, dt)
            self.step += 1
            rec = dict(step=self.step, loss=loss, dt=dt)
            self.history.append(rec)
            if self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(self.step, (self.params, self.opt))
        self.ckpt.wait()
        return self.history
