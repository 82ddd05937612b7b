"""The decode step replayed as a CUDA graph (``serving/decode_graph.py``).

On the CPU: the scalar constants kept on the device for the capture give
the decode logits and cache of a fresh ``torch.as_tensor`` bit for bit;
which models and devices take the graph; what the graph is keyed on.
On the card (marked ``gpu``, skipped without one): replays equal an
eager loop bit for bit, admissions, ragged positions and speculative
sub-steps included; a change of weights, cache or model settings
re-captures; the counters, the MoE and Mamba layers' counts made
again by every replay among them.  The file imports no JAX, so on a machine
with a card it runs as

    python -m pytest -q --noconftest -m gpu tests/test_torch_decode_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, smoke_config
from repro_torch.core import trace
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import decode_graph as DG
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scenarios import SpecDecodeConfig

# name -> (arch, QUANT_BITS, KV_QUANT)
VARIANTS = {"dense_gqa": ("granite-8b", 0, False),
            "sliding_window": ("gemma3-4b", 0, False),
            "kv_quant": ("granite-8b", 0, True),
            "w8": ("granite-8b", 8, False)}
# and the card's: Mamba-2 and NoPE attention layers, each with the
# expert-parallel MoE
GRAPH_VARIANTS = {**VARIANTS, "hybrid": ("granite-4.0-h-small", 0, False)}

# The MoE and Mamba layers' counts, which a replay makes again.
STEP_COUNTS = ("moe.assignments", "moe.assignments_held",
               "moe.expert_rows", "ssm.state_bytes")
# A latent-attention model's: its MoE layers' and its attention's.
MLA_COUNTS = STEP_COUNTS[:3] + ("mla.attended_positions", "mla.latent_bytes")


def _fresh_div(a, b):
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _smoke(arch, device="cpu", bits=0):
    cfg = smoke_config({**ARCHS, **PORT_ARCHS}[arch])
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device=device)
    return cfg, (M.quantize_for_serving(params, bits) if bits else params)


def _ragged_decode(cfg, params, steps=4, device="cpu"):
    """Prefill two rows, then ``steps`` greedy decode steps with row 1 two
    positions behind row 0: every step's logits and the final cache."""
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 20)),
                           dtype=torch.int32, device=device)
    cache = M.init_cache(cfg, 2, 36, torch.float32, device=device)
    last, cache = M.prefill(cfg, params, {"tokens": toks}, cache)
    out = [last]
    nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
    for j in range(steps):
        pos = torch.tensor([20 + j, 18 + j], dtype=torch.int32,
                           device=device)
        logits, cache = M.decode_step(cfg, params, cache, nxt, pos)
        out.append(logits)
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return out, cache


def _same(a, b):
    flat_a = list(DG._tensors(a))
    flat_b = list(DG._tensors(b))
    return len(flat_a) == len(flat_b) and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(flat_a, flat_b))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kept_scalars_give_the_fresh_ones_numbers(monkeypatch, variant):
    """The decode's logits and cache with every scalar constant kept
    equal those with a fresh ``torch.as_tensor`` each call, bit for bit,
    the second kept run (all hits) as the first."""
    arch, bits, kv_quant = VARIANTS[variant]
    monkeypatch.setattr(M, "QUANT_BITS", bits)
    monkeypatch.setattr(M, "KV_QUANT", kv_quant)
    cfg, params = _smoke(arch, bits=bits)
    with monkeypatch.context() as m:
        m.setattr(L, "_div", _fresh_div)
        want = _ragged_decode(cfg, params)
    monkeypatch.setattr(L, "_SCALARS", {})
    got = _ragged_decode(cfg, params)
    kept = dict(L._SCALARS)
    assert kept, "no scalar was kept"
    again = _ragged_decode(cfg, params)
    assert L._SCALARS == kept
    for run in (got, again):
        assert _same(run[0], want[0]) and _same(run[1], want[1])


def test_a_kept_scalar_is_built_once_per_value_dtype_and_device(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    monkeypatch.setattr(L, "_SCALARS", {})
    f32 = torch.zeros(2)
    a = L.scalar_like(16, f32)
    assert L.scalar_like(16, f32) is a and a.dtype == torch.float32
    assert float(a) == 16.0
    assert L.scalar_like(127, f32) is not a
    assert L.scalar_like(16, f32.double()).dtype == torch.float64
    assert len(L._SCALARS) == 3
    # subclassed and fake tensors, and a plain one under a fake mode, get
    # a fresh one each call, and nothing is kept for them
    param = torch.nn.Parameter(torch.zeros(2))
    assert L.scalar_like(16, param) is not L.scalar_like(16, param)
    with FakeTensorMode():
        fake = torch.zeros(2)
        assert isinstance(L.scalar_like(16, fake), FakeTensor)
        assert isinstance(L.scalar_like(3, f32), FakeTensor)
    assert len(L._SCALARS) == 3


# Which models the graph serves: attention and a dense MLP in every
# layer, or Mamba-2 and attention layers each followed by the
# expert-parallel MoE.
ENGAGES = {"qwen2-72b": True, "granite-8b": True, "gemma3-4b": True,
           "granite-20b": True, "internvl2-26b": True,
           "musicgen-large": True,
           "granite-moe-3b-a800m": False, "dbrx-132b": False,
           "hymba-1.5b": False, "mamba2-130m": False,
           "granite-4.0-h-small": True, "deepseek-v3": True}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("arch", sorted(ENGAGES))
def test_when_the_graph_engages(arch, device):
    cfg = {**ARCHS, **PORT_ARCHS}[arch]
    want = ENGAGES[arch] and device == "cuda"
    assert DG.engages(cfg, torch.device(device)) is want
    assert DG.engages(smoke_config(cfg), device) is want


def test_the_decision_reads_the_layer_kinds():
    dense = ARCHS["granite-8b"]
    n = dense.n_layers
    assert DG.engages(dense, "cuda")
    for change, want in (
            (dict(layer_types=("attention",) * n), True),
            (dict(layer_types=("mamba", "attention") * (n // 2)), True),
            (dict(ssm=PORT_ARCHS["granite-4.0-h-small"].ssm), False),
            (dict(family="moe", moe=ARCHS["dbrx-132b"].moe), False)):
        assert DG.engages(dataclasses.replace(dense, **change),
                          "cuda") is want, change


def test_a_loop_on_the_cpu_holds_no_graph():
    cfg, params = _smoke("granite-8b")
    eng = ServingEngine(cfg, params, slots=2, max_seq=32, device="cpu")
    assert isinstance(eng.decoder, DG.EagerStep)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new=3))
    eng.run()
    assert eng.stats["steps"] == 2


def _key_changes():
    def params_leaf(cfg, params, cache):
        blocks = dict(params["blocks"], ln1=params["blocks"]["ln1"].clone())
        return dict(params, blocks=blocks), cache

    def cache_tensor(cfg, params, cache):
        return params, dict(cache, kv=(cache["kv"][0].clone(),
                                       cache["kv"][1]))

    def same_again(cfg, params, cache):
        return dict(params), dict(cache)

    return {"params_leaf": (params_leaf, None),
            "cache_tensor": (cache_tensor, None),
            "quant_bits": (None, (M, "QUANT_BITS", 8)),
            "kv_quant": (None, (M, "KV_QUANT", True)),
            "layout": (None, (L, "LAYOUT", L.Layout())),
            "decode_step": (None, (M, "decode_step",
                                   lambda *a: M.decode_step(*a))),
            "unchanged": (same_again, None)}


@pytest.mark.parametrize("change", list(_key_changes()))
def test_the_key_follows_what_the_step_reads(monkeypatch, change):
    cfg, params = _smoke("granite-8b")
    cache = M.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    key = DG.step_key(cfg, params, cache)
    assert DG.step_key(cfg, params, cache) == key
    swap, setting = _key_changes()[change]
    if swap is not None:
        params, cache = swap(cfg, params, cache)
    if setting is not None:
        monkeypatch.setattr(*setting)
    assert (DG.step_key(cfg, params, cache) == key) is (change == "unchanged")


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = old


def _requests(cfg, n=9):
    """Prompts of 3-17 tokens, 6-16 new tokens: slots free and refill at
    different steps, so positions are ragged and admissions come
    mid-run."""
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               3 + (5 * i) % 15)
                    .astype(np.int32), max_new=6 + (5 * i) % 11)
            for i in range(n)]


def _decodes(eng) -> int:
    """Decode steps the engine ran, speculative sub-steps each counted."""
    return sum(eng.spec_substeps) if eng.spec_decode else eng.stats["steps"]


def _lockstep(cfg, params, dev, spec=None, slots=3, max_seq=48,
              requests=9, step_counts=STEP_COUNTS):
    """A graph engine and an eager one (an ``EagerStep`` in its place)
    stepped together: after every engine step each slot's tokens so far
    and the whole cache are equal bit for bit, over 24 decode steps or
    more, and so are the counts of ``step_counts`` their steps' frames
    hold.
    Returns the graph engine."""
    engines = []
    for eager in (False, True):
        eng = ServingEngine(cfg, params, slots=slots, max_seq=max_seq,
                            device=dev, spec_decode=spec)
        if eager:
            eng.decoder = DG.EagerStep(dev)
        for r in _requests(cfg, requests):
            eng.submit(r)
        engines.append(eng)
    graph_eng, eager_eng = engines
    assert isinstance(graph_eng.decoder, DG.GraphStep)
    done = 0
    counts = [dict.fromkeys(step_counts, 0) for _ in engines]
    while graph_eng.waiting or any(graph_eng.active):
        for eng, got in zip(engines, counts):
            eng.step()
            f = trace.frames("serving.step")[-1]
            for name in step_counts:
                got[name] += f.counter(name)
        done += 1
        outs = [[r.out if r else None for r in e.active] for e in engines]
        assert outs[0] == outs[1], done
        assert _same(graph_eng.cache, eager_eng.cache), done
    assert _decodes(graph_eng) >= 24
    assert graph_eng.completions == eager_eng.completions
    assert counts[0] == counts[1]
    return graph_eng


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GRAPH_VARIANTS))
def test_replays_equal_an_eager_loop_bit_for_bit(dev, monkeypatch, variant):
    arch, bits, kv_quant = GRAPH_VARIANTS[variant]
    monkeypatch.setattr(M, "QUANT_BITS", bits)
    monkeypatch.setattr(M, "KV_QUANT", kv_quant)
    cfg, params = _smoke(arch, dev, bits)
    trace.reset()
    _lockstep(cfg, params, dev)
    tot = trace.totals()
    assert tot.counter("decode_graph.captures") == 1
    if cfg.layer_types:
        assert all(tot.counter(name) > 0 for name in STEP_COUNTS)


@pytest.mark.gpu
def test_replays_equal_an_eager_loop_at_granite_8b_widths(dev):
    """granite-8b's widths over 2 of its 36 layers, 8 slots over a cache
    of 2048 positions, as the served cell runs them: the matmuls the card
    picks for those shapes, replayed, give the eager step's bits."""
    cfg = dataclasses.replace(ARCHS["granite-8b"], n_layers=2)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    trace.reset()
    _lockstep(cfg, params, dev, slots=8, max_seq=2048, requests=20)
    assert trace.totals().counter("decode_graph.captures") == 1


@pytest.mark.gpu
def test_replays_equal_an_eager_loop_at_granite_4_0_h_small_widths(dev):
    """granite-4.0-h-small's widths over 4 of its 40 layers (two Mamba-2
    layers, its first attention layer, a Mamba-2 layer), each with 18
    held experts of 72, 32 slots over a cache of 2048 positions, as the
    served cell runs them: replayed, the eager step's bits and counts."""
    full = PORT_ARCHS["granite-4.0-h-small"]
    kinds = full.layer_types[3:7]
    cfg = dataclasses.replace(full, n_layers=len(kinds), layer_types=kinds)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    trace.reset()
    _lockstep(cfg, params, dev, slots=32, max_seq=2048, requests=64)
    tot = trace.totals()
    assert tot.counter("decode_graph.captures") == 1
    assert all(tot.counter(name) > 0 for name in STEP_COUNTS)


@pytest.mark.gpu
def test_replays_equal_an_eager_loop_for_latent_attention(dev):
    """DeepSeek-V3 at its smoke size: the absorbed decode over the
    latent cache and the group-limited router, replayed, give the eager
    step's bits and counts."""
    cfg, params = _smoke("deepseek-v3", dev)
    trace.reset()
    _lockstep(cfg, params, dev, step_counts=MLA_COUNTS)
    tot = trace.totals()
    assert tot.counter("decode_graph.captures") == 1
    assert all(tot.counter(name) > 0 for name in MLA_COUNTS)


@pytest.mark.gpu
def test_replays_equal_an_eager_loop_at_deepseek_v3_widths(dev):
    """DeepSeek-V3's widths over 4 of its layers (a dense layer, then
    three MoE layers of 8 held experts of 256), 32 slots over a latent
    cache of 4608 positions, as the served cell runs them: replayed, the
    eager step's bits and counts."""
    full = PORT_ARCHS["deepseek-v3"]
    cfg = dataclasses.replace(full, n_layers=4, layer_types=("mla",) * 4,
                              first_k_dense_replace=1)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    params["blocks"]["moe"]["bias"].normal_(
        0.0, 0.01, generator=torch.Generator(device=dev).manual_seed(1))
    trace.reset()
    _lockstep(cfg, params, dev, slots=32, max_seq=4608, requests=64,
              step_counts=MLA_COUNTS)
    tot = trace.totals()
    assert tot.counter("decode_graph.captures") == 1
    assert all(tot.counter(name) > 0 for name in MLA_COUNTS)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-8b", "granite-4.0-h-small"])
def test_speculative_substeps_replay_the_same_graph(dev, arch):
    """Several replays in one engine step's frame: their repeated counts
    sum to the eager loop's (``_lockstep``)."""
    cfg, params = _smoke(arch, dev)
    trace.reset()
    eng = _lockstep(cfg, params, dev,
                    spec=SpecDecodeConfig(draft_len=3, acceptance=0.6))
    assert _decodes(eng) > eng.stats["steps"]
    tot = trace.totals()
    assert tot.counter("decode_graph.captures") == 1
    assert tot.counter("decode_graph.replays") == _decodes(eng) - 1


@pytest.mark.gpu
def test_captures_once_and_replays_every_later_step(dev):
    cfg, params = _smoke("granite-8b", dev)
    eng = ServingEngine(cfg, params, slots=3, max_seq=48, device=dev)
    for r in _requests(cfg):
        eng.submit(r)
    trace.reset()
    eng.run()
    tot = trace.totals()
    steps = eng.stats["steps"]
    assert steps >= 24
    assert tot.counter("decode_graph.captures") == 1
    assert tot.counter("decode_graph.replays") == steps - 1
    assert tot.spans["decode_step"][0] == steps


def _eager_next(cfg, params, cache, tokens, pos, dev):
    """One eager step on copies of the cache: its next tokens."""
    copy = {k: tuple(t.clone() for t in v) if isinstance(v, tuple)
            else v.clone() for k, v in cache.items()}
    logits, _ = M.decode_step(cfg, params, copy,
                              torch.as_tensor(tokens, device=dev),
                              torch.as_tensor(pos, device=dev))
    return torch.argmax(logits, -1).cpu().numpy()


def _recapture_changes(dev):
    def new_params(loop):
        loop.params = {k: v if k != "embed" else v.clone()
                       for k, v in loop.params.items()}

    def new_cache(loop):
        loop.cache = {k: tuple(t.clone() for t in v)
                      for k, v in loop.cache.items()}

    def quant_bits(loop):
        M.QUANT_BITS = 8
        loop.params = M.quantize_for_serving(loop.params, 8)

    def layout(loop):
        L.LAYOUT = L.Layout()

    return {"params": new_params, "cache": new_cache,
            "quant_bits": quant_bits, "layout": layout}


@pytest.mark.gpu
@pytest.mark.parametrize("change", ["params", "cache", "quant_bits",
                                    "layout"])
def test_a_change_recaptures_and_never_replays_stale(dev, monkeypatch,
                                                     change):
    monkeypatch.setattr(M, "QUANT_BITS", 0)
    monkeypatch.setattr(L, "LAYOUT", L.LAYOUT)
    cfg, params = _smoke("granite-8b", dev)
    eng = ServingEngine(cfg, params, slots=3, max_seq=48, device=dev)
    for r in _requests(cfg):
        eng.submit(r)
    trace.reset()
    for _ in range(4):
        eng.step()
    _recapture_changes(dev)[change](eng)
    key = DG.step_key(cfg, eng.params, eng.cache)
    assert key != eng.decoder._key
    for _ in range(3):
        eng._admit(eng.ticks)
        tokens = np.zeros((eng.slots, 1), np.int32)
        for i, r in enumerate(eng.active):
            if r is not None:
                tokens[i, 0] = r.out[-1]
        want = _eager_next(cfg, eng.params, eng.cache, tokens, eng.pos, dev)
        got = eng._decode(tokens)
        assert np.array_equal(got, want)
        for i, r in enumerate(eng.active):
            if r is not None:
                eng._advance(i, int(got[i]), eng.ticks)
    assert eng.decoder._key == key
    tot = trace.totals()
    assert tot.counter("decode_graph.captures") == 2
    assert tot.counter("decode_graph.replays") == 3 + 2
