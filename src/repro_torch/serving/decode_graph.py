"""The decode loop's step: ``model.decode_step`` and its argmax over
every slot, then one read-back of the next tokens.

A step object has two calls: :meth:`launch` starts the step over the
slots' tokens and positions and hands back the cache, :meth:`read`
waits for the card once and gives the next tokens.  :func:`for_loop`
picks the form a loop takes:

- :class:`GraphStep`, on a card for a model whose every layer is
  attention and a dense MLP, or whose layers (``cfg.layer_types``) are
  Mamba-2, attention or latent attention each followed by the
  expert-parallel MoE or a dense MLP (:func:`engages`).  Such a step is
  a fixed-shape chain: every slot at once, attention over the cache
  (KV or latent) padded to ``max_seq`` with masks built on the device,
  cache rows and SSM / conv state written in place, the MoE's capacity
  the token count with no count read back.  Eager, its
  few thousand launches cost the host more than the card's work takes;
  replayed as one CUDA graph, they cost one graph launch.
- :class:`EagerStep` everywhere else: the CPU, the ``moe`` family,
  Hymba's parallel heads and attention-free Mamba-2.

:class:`GraphStep` holds the static inputs (tokens and positions) and
output (next tokens) on the device, with a pinned host buffer for each
copy.  The first step of a loop runs eager (on a side stream, the
capture's warm-up) and its result is served; the capture follows and
records without computing, so no step runs twice and a step that is not
served writes no cache row.  Every later step copies its tokens and
positions in and replays.

The capture runs inside ``trace.recording()``: the counts the step
makes (``moe.*``, ``ssm.state_bytes``, ``mla.*``) are held, device
tensors summed into tensors the graph writes, and each replay counts
them again, so a loop's counters read what an eager loop's would.  A
replayed step opens no span inside ``decode_step``: it spends no host
time in the layers.

The graph holds the addresses of everything the step reads outside its
arguments, so it is keyed on them (:func:`step_key`): the identity and
address of every parameter leaf and cache tensor, ``model.QUANT_BITS``,
``model.KV_QUANT``, ``layers.LAYOUT``, TF32 matmuls, the configuration
and ``model.decode_step`` itself.  When the key changes the next step
runs eager and the graph is captured anew: a stale graph is never
replayed.  Counters: ``decode_graph.captures``, ``decode_graph.replays``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import trace
from repro_torch.models import layers as L
from repro_torch.models import model as M


def engages(cfg: ArchConfig, device) -> bool:
    """Whether a decode loop of ``cfg`` on ``device`` replays its step as
    a CUDA graph: on a card, for a model of attention and dense MLP
    layers alone, or of Mamba-2, attention or latent-attention layers
    each followed by the expert-parallel MoE or a dense MLP
    (``layer_types``)."""
    return torch.device(device).type == "cuda" and (
        bool(cfg.layer_types) or (cfg.ssm is None and cfg.family != "moe"))


def for_loop(cfg: ArchConfig, slots: int, device):
    """The step object of a decode loop of ``cfg`` over ``slots``."""
    return (GraphStep(slots, device) if engages(cfg, device)
            else EagerStep(device))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def step_key(cfg: ArchConfig, params, cache) -> tuple:
    """Everything a captured step reads from outside its arguments."""
    leaves = tuple((id(t), t.data_ptr(), t.shape)
                   for tree in (params, cache) for t in _tensors(tree))
    return (cfg, M.decode_step, M.QUANT_BITS, M.KV_QUANT, L.LAYOUT,
            torch.backends.cuda.matmul.allow_tf32, leaves)


class EagerStep:
    """The step as it runs, op by op."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._out = None

    def launch(self, cfg: ArchConfig, params, cache, tokens: np.ndarray,
               pos: np.ndarray):
        """Start one step over ``tokens`` (slots, 1) at ``pos`` (slots,);
        returns the cache.  :meth:`read` gives its next tokens."""
        logits, cache = M.decode_step(
            cfg, params, cache, torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(pos, device=self.device))
        self._out = torch.argmax(logits, dim=-1)
        return cache

    def read(self) -> np.ndarray:
        """The launched step's next tokens (slots,)."""
        out, self._out = self._out, None
        return out.cpu().numpy().reshape(-1)


class GraphStep:
    """The step as one CUDA graph of ``model.decode_step`` and its argmax
    over ``slots`` rows, with its static buffers."""

    def __init__(self, slots: int, device):
        self.device = torch.device(device)
        dev = self.device

        def pair(shape, dtype):
            return (torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, pin_memory=True))

        self.tokens, self._tokens_host = pair((slots, 1), torch.int32)
        self.pos, self._pos_host = pair((slots,), torch.int32)
        self._next_host = torch.zeros((slots,), dtype=torch.int64,
                                      pin_memory=True)
        self._stream = torch.cuda.Stream(dev)
        self._graph = None
        self._key = None
        self._next = None           # the captured step's next tokens
        self._counts = None         # the captured step's trace.recording
        self._out = None            # the next tokens :meth:`read` copies

    def launch(self, cfg: ArchConfig, params, cache, tokens: np.ndarray,
               pos: np.ndarray):
        """Start one step over ``tokens`` (slots, 1) at ``pos`` (slots,);
        returns the cache, written in place.  :meth:`read` gives its next
        tokens."""
        self._tokens_host.numpy()[:] = tokens
        self._pos_host.numpy()[:] = pos
        self.tokens.copy_(self._tokens_host, non_blocking=True)
        self.pos.copy_(self._pos_host, non_blocking=True)
        key = step_key(cfg, params, cache)
        if key == self._key:
            self._graph.replay()
            self._counts.recount()
            self._out = self._next
            trace.count("decode_graph.replays")
            return cache
        self._graph, self._next, self._key, self._counts = (None,) * 4
        stream = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(stream)
        with torch.cuda.stream(self._stream):
            logits, cache = M.decode_step(cfg, params, cache, self.tokens,
                                          self.pos)
            self._out = torch.argmax(logits, dim=-1)
        stream.wait_stream(self._stream)
        # A step that hands back other cache tensors changes the key, so
        # its graph is never replayed.
        graph = torch.cuda.CUDAGraph()
        with trace.recording() as counts, torch.cuda.graph(
                graph, stream=self._stream,
                capture_error_mode="thread_local"):
            logits, _ = M.decode_step(cfg, params, cache, self.tokens,
                                      self.pos)
            nxt = torch.argmax(logits, dim=-1)
        self._graph, self._next, self._key = graph, nxt, key
        self._counts = counts
        trace.count("decode_graph.captures")
        return cache

    def read(self) -> np.ndarray:
        """The launched step's next tokens (slots,), after the one wait
        for the card."""
        self._next_host.copy_(self._out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self._out = None
        return self._next_host.numpy().copy()
