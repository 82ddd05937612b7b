"""Batched serving engine: continuous batching over KV-cache slots.

Requests enter a waiting queue, get prefilled into a free slot, and the
decode loop steps every active slot in one batched ``decode_step`` call
(one batch of GEMVs per projection — the PIM offload unit).  Finished
slots (EOS or max tokens) free immediately and the next waiting request
takes over — continuous batching.

The engine also carries the PIM telemetry: per decode step it asks the
OffloadPlanner what the step would cost on a host-only vs PIM-offloaded
LPDDR5X system.

Speculative decoding (``spec_decode=``, a
``scenarios.SpecDecodeConfig``): each serve tick runs one draft/verify
*round* per active slot instead of a single decode step.  The seeded
config decides how many draft tokens each request accepts this round
(keyed per ``(rid, round)``, so the schedule is independent of slot
order and identical to the model-free ``simulate_spec_decode`` mirror);
the engine realizes an advance of ``k + 1`` tokens as that many batched
decode sub-steps on the real target model — greedy speculative decoding
is output-identical to greedy vanilla decode.  Slots whose round is
shorter than the tick's longest ride along masked: they feed their last
token at an un-advanced position and their logits are discarded; the
cache write at that position is overwritten by their next genuine
sub-step before anything reads it (as inactive slots decoding token 0).

The model runs on ``device`` (default: the card), where its parameters
must lie; each step takes one argmax over the batch on the device and
one transfer to the host.  On a card the step of a dense model, or of
Mamba-2, attention or latent-attention layers each followed by the
expert-parallel MoE or a dense MLP, is captured once as a CUDA graph and
replayed (``serving/decode_graph.py``).  A latent-attention model's
cache, prefilled and merged a slot at a time like the others, holds one
latent and one rotary key a position and layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import trace
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from . import decode_graph
from .offload import OffloadPlanner
from .policy import OffloadController


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    eos: int = -1
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def prefill_one(cfg: ArchConfig, params, req: Request, max_seq: int,
                device: torch.device):
    """Prefill one request into a fresh one-slot cache of ``max_seq``
    positions; returns ``(last logits (1, vocab), cache)``."""
    assert len(req.prompt) < max_seq
    prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                             device=device)[None]
    one = M.init_cache(cfg, 1, max_seq, torch.float32, device=device)
    return M.prefill(cfg, params, {"tokens": prompt}, one)


def merge_slot(cache: dict, one: dict, slot: int) -> None:
    """Copy a one-slot cache (every position, zeros past the prompt)
    into row ``slot`` of a batched cache, in place."""
    for key, full in cache.items():
        pairs = zip(full, one[key]) if isinstance(full, tuple) \
            else [(full, one[key])]
        for dst, src in pairs:
            dst[:, slot:slot + 1] = src


class DecodeLoop:
    """The batched decode shared by :class:`ServingEngine` and the
    disaggregated decode cell (``serving/cells.py``): one decode step (or
    speculative round) over every active slot, the slots' advance and
    completion, and the per-step controller and planner telemetry."""

    def __init__(self, cfg: ArchConfig, params, slots: int, max_seq: int,
                 planner: Optional[OffloadPlanner],
                 controller: Optional[OffloadController],
                 step_telemetry: bool, spec_decode, device):
        assert cfg.input_mode == "tokens", "engine serves token models"
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.max_seq = max_seq
        self.cache = M.init_cache(cfg, slots, max_seq, torch.float32,
                                  device=self.device)
        self.active: list[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, dtype=np.int32)
        # On a card, the step is replayed as one CUDA graph where
        # decode_graph.engages says it can be.
        self.decoder = decode_graph.for_loop(cfg, slots, self.device)
        # Adaptive offload control: the controller sees every decode
        # step's live batch size and runs its policy; its planner doubles
        # as the telemetry planner unless one was passed explicitly.
        self.controller = controller
        if planner is None and controller is not None:
            planner = controller.planner
        self.planner = planner
        self.stats = dict(steps=0, tokens=0)
        self.batch_occupancy: dict[int, int] = {}
        self.step_batches: list[int] = []      # trace: batch per step
        # Per-request scheduling record: serve tick of admission and of
        # completion.
        self.admit_ticks: dict[int, int] = {}
        self.completions: dict[int, int] = {}
        # Per-step PIM telemetry: one planner query per decode step at
        # the step's true occupancy.
        self.step_telemetry = step_telemetry
        self.step_speedups: list[dict] = []
        # Speculative decoding: the seeded accept/advance schedule plus
        # per-request round counters and per-tick advance telemetry.
        self.spec_decode = spec_decode
        self.spec_rounds: dict[int, int] = {}
        self.spec_drafted: dict[int, int] = {}
        self.spec_accepted: dict[int, int] = {}
        self.spec_advance: list[int] = []
        self.spec_substeps: list[int] = []

    def _decode(self, tokens: np.ndarray) -> np.ndarray:
        """One batched decode step over every slot at its own position;
        the next token of every slot (one argmax, one host transfer).
        The forward's span is ``decode_step``.  ``self.decoder`` runs the
        forward eager, where the MoE and Mamba layers open their spans
        inside it, or replays it as a CUDA graph, which opens none and
        counts the step's counts again (``serving/decode_graph.py``)."""
        with trace.span("decode_step"):
            self.cache = self.decoder.launch(self.cfg, self.params,
                                             self.cache, tokens, self.pos)
        with trace.span("serving.decode_sync"):
            return self.decoder.read()

    def _advance(self, i: int, tok: int, tick: int) -> None:
        req = self.active[i]
        req.out.append(tok)
        self.pos[i] += 1
        self.stats["tokens"] += 1
        if (tok == req.eos or len(req.out) >= req.max_new
                or self.pos[i] >= self.max_seq - 1):
            req.done = True
            self.active[i] = None
            self.completions[req.rid] = tick

    def _decode_active(self, tick: int) -> int:
        """One decode step (or speculative round) over the active slots;
        returns the batch size (0: idle, nothing recorded)."""
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        self.batch_occupancy[len(act)] = \
            self.batch_occupancy.get(len(act), 0) + 1
        if self.spec_decode is not None:
            self._spec_round(tick, act)
        else:
            tokens = np.zeros((self.slots, 1), dtype=np.int32)
            for i in act:
                tokens[i, 0] = self.active[i].out[-1]
            next_tok = self._decode(tokens)
            for i in act:
                self._advance(i, int(next_tok[i]), tick)
        self.step_batches.append(len(act))
        if self.controller is not None:
            self.controller.observe(len(act))
        if self.planner is not None and self.step_telemetry:
            tel = self.planner.decode_speedup(batch=len(act))
            self.step_speedups.append(dict(step=self.stats["steps"],
                                           batch=len(act),
                                           speedup=tel["speedup"]))
        self.stats["steps"] += 1
        return len(act)

    def _spec_round(self, tick: int, act: list[int]) -> None:
        """One speculative round per active slot, as batched sub-steps:
        each slot takes part genuinely for its own first ``advance``
        sub-steps and rides along masked afterwards."""
        sd = self.spec_decode
        adv: dict[int, int] = {}
        for i in act:
            req = self.active[i]
            rem = max(1, req.max_new - len(req.out))
            a, drf, acc = sd.advance(req.rid,
                                     self.spec_rounds.get(req.rid, 0),
                                     rem)
            self.spec_rounds[req.rid] = \
                self.spec_rounds.get(req.rid, 0) + 1
            self.spec_drafted[req.rid] = \
                self.spec_drafted.get(req.rid, 0) + drf
            self.spec_accepted[req.rid] = \
                self.spec_accepted.get(req.rid, 0) + acc
            adv[i] = a
        nsub = max(adv.values())
        advanced = 0
        for s in range(nsub):
            live = [i for i in act
                    if s < adv[i] and self.active[i] is not None]
            if not live:
                break
            tokens = np.zeros((self.slots, 1), dtype=np.int32)
            for i in act:
                if self.active[i] is not None:
                    tokens[i, 0] = self.active[i].out[-1]
            next_tok = self._decode(tokens)
            for i in live:
                self._advance(i, int(next_tok[i]), tick)
                advanced += 1
        self.spec_advance.append(advanced)
        self.spec_substeps.append(nsub)

    def spec_report(self) -> dict:
        """Aggregate speculative telemetry (all zeros when vanilla or
        nothing ran)."""
        drafted = sum(self.spec_drafted.values())
        accepted = sum(self.spec_accepted.values())
        return dict(rounds=sum(self.spec_rounds.values()),
                    drafted=drafted, accepted=accepted,
                    wasted=drafted - accepted,
                    substeps=sum(self.spec_substeps),
                    per_tick_advance=list(self.spec_advance))

    def pim_telemetry(self) -> dict:
        """The planner's offload telemetry for this run's occupancy."""
        planner = self.planner
        tel = planner.decode_speedup(batch=max(1, self.slots))
        batches = sorted(self.batch_occupancy) or [max(1, self.slots)]
        tel["per_batch_speedup"] = {
            b: planner.decode_speedup(batch=b)["speedup"] for b in batches}
        if self.batch_occupancy:
            tel["occupancy_weighted"] = \
                planner.occupancy_weighted_speedup(self.batch_occupancy)
        if self.step_speedups:
            tel["per_step"] = list(self.step_speedups)
        return tel


class ServingEngine(DecodeLoop):
    def __init__(self, cfg: ArchConfig, params, slots: int = 4,
                 max_seq: int = 256, planner: Optional[OffloadPlanner]
                 = None, step_telemetry: bool = False,
                 controller: Optional[OffloadController] = None,
                 spec_decode=None, device=None):
        super().__init__(cfg, params, slots, max_seq, planner, controller,
                         step_telemetry, spec_decode, device)
        self.waiting: list[Request] = []
        self.stats["prefills"] = 0
        self.ticks = 0                         # step() calls, idle included

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.waiting.append(req)

    def _admit(self, tick: int):
        for slot in range(self.slots):
            if self.active[slot] is None and self.waiting:
                req = self.waiting.pop(0)
                self._prefill(slot, req)
                self.active[slot] = req
                self.admit_ticks[req.rid] = tick

    def _prefill(self, slot: int, req: Request):
        """Single-slot prefill, then the whole one-slot cache (zeros past
        the prompt) copied into the batched cache at ``slot``."""
        with trace.span("serving.prefill"):
            logits, one = prefill_one(self.cfg, self.params, req,
                                      self.max_seq, self.device)
            merge_slot(self.cache, one, slot)
            self.pos[slot] = len(req.prompt)
            req.out.append(int(torch.argmax(logits[0])))
        self.stats["prefills"] += 1

    # ------------------------------------------------------------------
    def step(self):
        """One batched decode step over all active slots."""
        with trace.frame("serving.step"):
            tick = self.ticks
            self.ticks += 1      # idle ticks advance too (tick-aligned)
            self._admit(tick)
            return self._decode_active(tick) > 0

    def run(self, max_steps: int = 1000) -> dict:
        while (any(self.active) or self.waiting) and max_steps > 0:
            self.step()
            max_steps -= 1
        return self.summary()

    def summary(self) -> dict:
        """Run stats + PIM telemetry (+ policy report when controlled)."""
        out = dict(self.stats)
        out["batch_occupancy"] = dict(self.batch_occupancy)
        # Derived metrics stay neutral on zero-request runs.
        out["completed"] = len(self.completions)
        out["in_flight"] = (sum(r is not None for r in self.active)
                            + len(self.waiting))
        out["tokens_per_step"] = (self.stats["tokens"] / self.stats["steps"]
                                  if self.stats["steps"] else 0.0)
        if self.planner is not None:
            out["pim_telemetry"] = self.pim_telemetry()
        if self.controller is not None:
            out["policy"] = self.controller.report()
        return out
