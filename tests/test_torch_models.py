"""The port's models, held to the JAX package on every arch's smoke config.

The JAX package's ``init_params`` weights cross into the port through
``params_from_numpy``; inputs are ``tests/test_models_smoke.py``'s
``_smoke_batch`` (embeddings for musicgen-large, patches for
internvl2-26b).  ``forward``, ``prefill`` (last logits and every cache
leaf) and decode steps at batch 2 with ragged positions agree at rtol
1e-4 / atol 1e-4, and greedy tokens are equal.  Quantized serving trees
are bit-equal (``q`` and ``s``) and their logits agree alike, with and
without the int8 KV cache.

``tests/golden/torch_model_logits.json`` pins granite-8b at its
published widths cut to 2 layers, weights drawn by
``draw_numpy_params(cfg, seed)``, as the JAX package serves two prompts
(``torch_card.serve_greedy``'s procedure);
``tests/test_torch_gpu.py`` reproduces it on the card.  Regenerate it deliberately with
``PYTHONPATH=src python tests/test_torch_models.py`` (a few minutes and
about 8 GB of host memory).
"""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
import jax.numpy as jnp
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RMOE

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.convert import (draw_numpy_params, params_from_numpy,
                                        params_to_numpy)
from test_models_smoke import _smoke_batch
import torch_card

FIXTURE = pathlib.Path(__file__).parent / "golden" / "torch_model_logits.json"
ARCH_IDS = list(REF_ARCHS)
TOL = dict(rtol=1e-4, atol=1e-4)
FIXTURE_SEED = 0



@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for mod in (M, RM):
        mod.QUANT_BITS = 0
        mod.KV_QUANT = False
    L.FLASH_SKIP_BLOCKS = RL.FLASH_SKIP_BLOCKS = False


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """(ref cfg, port cfg, JAX params, port params on the CPU)."""
    rcfg = ref_smoke(REF_ARCHS[arch])
    cfg = smoke_config(ARCHS[arch])
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp),
                                            "cpu")


def _batches(rcfg, b=2, s=24, seed=0):
    """``_smoke_batch``'s inputs for both packages (labels dropped)."""
    jb = _smoke_batch(rcfg, np.random.default_rng(seed), b, s)
    jb.pop("labels")
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def _ref_fns(rcfg):
    """The reference's prefill / decode_step, jitted as its engine does
    (flags are read when traced, so trace after setting them)."""
    return (jax.jit(lambda p, b, c: RM.prefill(rcfg, p, b, c)),
            jax.jit(lambda p, c, t, pos: RM.decode_step(rcfg, p, c, t,
                                                        pos)))


def _serve_both(arch, rparams, params, steps=4, prompt_cut=4, max_extra=8,
                positions=None, sync=False):
    """Prefill at batch 2, then ``steps`` greedy decode steps with row 1
    two positions behind row 0 (ragged), in both packages; returns the
    per-step (ref, port) logits and the caches after prefill.  ``sync``
    starts every port step from the reference's cache (the int8 KV
    cache: its prefill-time scales differ by an ulp between the two
    packages' matmul orders, which can move a decode entry across a
    rounding tie), and checks the cache each step writes."""
    rcfg, cfg, _, _ = _weights(arch)
    jb, tb = _batches(rcfg)
    n_in = (jb["embeds"] if "embeds" in jb else jb["tokens"]).shape[1]
    key = "embeds" if "embeds" in jb else "tokens"
    jp = dict(jb, **{key: jb[key][:, :-prompt_cut]})
    tp = dict(tb, **{key: tb[key][:, :-prompt_cut]})
    seq = rcfg.prefix_patches + n_in + max_extra
    rprefill, rdecode = _ref_fns(rcfg)
    rcache = RM.init_cache(rcfg, 2, seq, jnp.float32)
    cache = M.init_cache(cfg, 2, seq, torch.float32, device="cpu")
    rl, rcache = rprefill(rparams, jp, rcache)
    tl, cache = M.prefill(cfg, params, tp, cache)
    prefilled = (jax.tree.map(np.asarray, rcache), params_to_numpy(cache))
    out = [(np.asarray(rl), tl.numpy())]
    start = rcfg.prefix_patches + n_in - prompt_cut
    rng = np.random.default_rng(7)
    for j in range(steps):
        pos = (np.array([start + j, start - 2 + j], np.int32)
               if positions is None else np.asarray(positions[j], np.int32))
        if cfg.input_mode == "embeddings":
            tok = (rng.standard_normal((2, 1, cfg.d_model)) * 0.1).astype(
                np.float32)
        else:
            rtok, ttok = (o.argmax(-1) for o in out[-1])
            assert rtok.tolist() == ttok.tolist(), f"step {j} greedy tokens"
            tok = rtok.astype(np.int32)[:, None]
        if sync:
            cache = params_from_numpy(jax.tree.map(np.asarray, rcache),
                                      "cpu")
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(tok),
                             jnp.asarray(pos))
        tl, cache = M.decode_step(cfg, params, cache, torch.from_numpy(tok),
                                  torch.from_numpy(pos))
        out.append((np.asarray(rl), tl.numpy()))
        if sync:
            for want, got in zip(jax.tree.leaves(rcache),
                                 jax.tree.leaves(params_to_numpy(cache))):
                if want.dtype == np.int8:
                    assert np.array_equal(want, got), f"step {j} int8 KV"
                else:
                    _close(got, want, f"step {j} cache")
    if cfg.input_mode != "embeddings":
        rtok, ttok = (o.argmax(-1) for o in out[-1])
        assert rtok.tolist() == ttok.tolist(), "last greedy tokens"
    return out, prefilled


# ---------------------------------------------------------------------
# Full precision
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_equal(arch):
    rcfg, cfg, rp, p = _weights(arch)
    jb, tb = _batches(rcfg, s=32)
    rl, raux = RM.forward(rcfg, rp, jb, remat=False)
    tl, aux = M.forward(cfg, p, tb)
    _close(tl, rl)
    _close(aux, raux)
    assert tl.shape == (2, jb["embeds" if "embeds" in jb else "tokens"]
                        .shape[1], cfg.vocab_padded)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_cache_and_ragged_decode_equal(arch):
    _, _, rp, p = _weights(arch)
    out, (rcache, cache) = _serve_both(arch, rp, p)
    for want, got in out:
        _close(got, want)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, rcache)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, cache))
    for want, got in zip(jax.tree.leaves(rcache), jax.tree.leaves(cache)):
        assert want.dtype == got.dtype and want.shape == got.shape
        _close(got, want, "cache after prefill")


@pytest.mark.parametrize("arch", ["granite-8b", "gemma3-4b", "hymba-1.5b"])
def test_decode_past_the_cache_clamps_like_the_reference(arch):
    """A row at or past the cache's end writes its last slot, as
    ``dynamic_update_slice`` clamps its start; a row at position 0
    overwrites the first."""
    _, _, rp, p = _weights(arch)
    out, _ = _serve_both(arch, rp, p, steps=3, max_extra=1,
                         positions=[[21, 0], [22, 1], [40, 2]])
    for want, got in out:
        _close(got, want)


def test_causality():
    """A suffix change never moves earlier logits (port and reference)."""
    rcfg, cfg, rp, p = _weights("gemma3-4b")
    jb, tb = _batches(rcfg, s=32)
    t2 = tb["tokens"].clone()
    t2[:, 20:] = (t2[:, 20:] + 1) % cfg.vocab
    a, _ = M.forward(cfg, p, tb)
    b, _ = M.forward(cfg, p, dict(tb, tokens=t2))
    assert torch.equal(a[:, :20], b[:, :20])
    assert not torch.allclose(a[:, 20:], b[:, 20:])
    rb, _ = RM.forward(rcfg, rp, dict(jb, tokens=jnp.asarray(t2.numpy())),
                       remat=False)
    _close(b, rb)


# ---------------------------------------------------------------------
# Quantized serving
# ---------------------------------------------------------------------

@pytest.mark.parametrize("bits,kv_quant", [(8, False), (4, False),
                                           (8, True)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quantized_serving_equal(arch, bits, kv_quant):
    _, _, rp, p = _weights(arch)
    if bits:
        rq = RM.quantize_for_serving(rp, bits)
        q = M.quantize_for_serving(p, bits)
        rflat = jax.tree_util.tree_flatten_with_path(rq)[0]
        flat = jax.tree_util.tree_flatten_with_path(params_to_numpy(q))[0]
        assert [k for k, _ in rflat] == [k for k, _ in flat]
        for (path, want), (_, got) in zip(rflat, flat):
            want = np.asarray(want)
            assert want.dtype == got.dtype, path
            if path[-1].key in ("q", "s"):
                assert np.array_equal(want.view(np.uint8),
                                      got.view(np.uint8)), path
        rp, p = rq, q
    for mod in (M, RM):
        mod.QUANT_BITS = bits
        mod.KV_QUANT = kv_quant
    out, (rcache, cache) = _serve_both(arch, rp, p, steps=2, sync=kv_quant)
    for want, got in out:
        _close(got, want)
    for want, got in zip(jax.tree.leaves(rcache), jax.tree.leaves(cache)):
        assert want.dtype == got.dtype
        if want.dtype == np.int8:
            assert np.array_equal(want, got), "int8 KV after prefill"
        else:
            _close(got, want, "cache after prefill")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_leaf_bit_equal_on_ties_and_extremes(bits):
    """Half-way values round to even and the int4 nibbles pack and
    unpack alike, zero columns included."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 64, 24)).astype(np.float32)
    qmax = 2 ** (bits - 1) - 1
    w[:, :, 0] = 0.0                                 # all-zero column
    w[:, 0, 1] = qmax
    w[:, 1:, 1] = np.arange(63) % (2 * qmax + 1) - qmax + 0.5  # .5 ties
    from repro.models import quant as RQ
    from repro_torch.models import quant as Q
    want = RQ._quantize_leaf(jnp.asarray(w), bits)
    got = Q._quantize_leaf(torch.from_numpy(w), bits)
    assert np.array_equal(np.asarray(want["q"]), got["q"].numpy())
    assert np.array_equal(np.asarray(want["s"]).view(np.uint32),
                          got["s"].numpy().view(np.uint32))
    back = Q.dequant_leaf(got, bits, torch.float32)
    rback = RQ.dequant_leaf(want, bits, jnp.float32)
    assert np.array_equal(np.asarray(rback), back.numpy())


# ---------------------------------------------------------------------
# Attention and MoE pieces
# ---------------------------------------------------------------------

@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_equal(window, skip):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    L.FLASH_SKIP_BLOCKS = RL.FLASH_SKIP_BLOCKS = skip
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, block_q=8, block_k=16)
    got = L.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), window=window, block_q=8,
                            block_k=16)
    _close(got, want)
    dense = L.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    _close(got, dense)
    # through ``attention`` with a small threshold: the flash path
    routed = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), window=window,
                         flash_threshold=16)
    rrouted = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window=window, flash_threshold=16)
    _close(routed, rrouted)


@pytest.mark.parametrize("blocks", [None, 1, 2])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_in_query_chunks_equal(window, skip, blocks,
                                               monkeypatch):
    """``FLASH_CHUNK_SCORES`` cut to ``blocks`` query blocks' scores: the
    query blocks advance in chunks (5 blocks: chunks of 1, or 2, 2, 1;
    ``None``: all at once), and the result is the JAX package's and the
    one-chunk result."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    monkeypatch.setattr(L, "FLASH_SKIP_BLOCKS", skip)
    monkeypatch.setattr(RL, "FLASH_SKIP_BLOCKS", skip)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    whole = L.flash_attention(*args, window=window, block_q=8, block_k=16)
    monkeypatch.setattr(L, "FLASH_CHUNK_SCORES",
                        blocks and blocks * 2 * 4 * 8 * 16)
    got = L.flash_attention(*args, window=window, block_q=8, block_k=16)
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, block_q=8, block_k=16)
    _close(got, want)
    _close(got, whole.numpy())


@pytest.mark.parametrize("drop_tokens", [False, True])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_moe_equal_with_ties(kind, drop_tokens):
    """Dropless and capacity-bounded dispatch; experts 1 and 2 have
    identical router columns, so their gates tie exactly and both
    packages must take the lower index."""
    d, ff, e = 16, 32, 4
    rp = RMOE.moe_init(jax.random.PRNGKey(0), d, ff, e, kind)
    router = np.asarray(rp["router"]).copy()
    router[:, 2] = router[:, 1]
    rp = dict(rp, router=jnp.asarray(router))
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    x = np.random.default_rng(5).standard_normal((3, 7, d)).astype(
        np.float32)
    x[1, 3] = 0.0                              # all gates equal: 4-way tie
    for top_k in (1, 2):
        want, raux = RMOE.moe_apply(rp, jnp.asarray(x), top_k=top_k,
                                    capacity_factor=1.0, mlp_kind=kind,
                                    drop_tokens=drop_tokens)
        got, aux = MOE.moe_apply(p, torch.from_numpy(x), top_k=top_k,
                                 capacity_factor=1.0, mlp_kind=kind,
                                 drop_tokens=drop_tokens)
        _close(got, want)
        _close(aux, raux)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, d)
                          @ p["router"], -1)
    _, idx = MOE.stable_top_k(probs, 3)
    _, ridx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ridx).tolist()


# ---------------------------------------------------------------------
# Weights: the tree, numpy drawing, conversion
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_matches_reference(arch):
    """Port-drawn weights (torch and numpy) have the reference's tree,
    shapes and dtypes, and convert back and forth unchanged."""
    rcfg, cfg, _, _ = _weights(arch)
    shapes = jax.eval_shape(lambda: RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for tree in (draw_numpy_params(cfg, 1),
                 params_to_numpy(M.init_params(
                     cfg, torch.Generator().manual_seed(1), device="cpu"))):
        got = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [(k, tuple(s.shape), np.dtype(s.dtype)) for k, s in want] \
            == [(k, v.shape, v.dtype) for k, v in got]
    tree = draw_numpy_params(cfg, 1)
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(back)))
    assert np.array_equal(tree["embed"], draw_numpy_params(cfg, 1)["embed"])


def test_bfloat16_leaves_cross_as_bit_patterns():
    w = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(w)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_inputs_are_smoke_batch_inputs(arch):
    """``torch_card.smoke_batch`` (numpy only, for the card) draws what
    ``_smoke_batch`` draws."""
    rcfg = ref_smoke(REF_ARCHS[arch])
    want, _ = _batches(rcfg, s=32)
    got = torch_card.smoke_batch(smoke_config(ARCHS[arch]),
                                 np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == np.asarray(want[k]).dtype
        assert np.array_equal(got[k], np.asarray(want[k])), k


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(ARCHS["granite-8b"])
    params = _weights("granite-8b")[3]
    for call in (lambda: M.init_params(cfg), lambda: M.init_cache(cfg, 1, 8),
                 lambda: ServingEngine(cfg, params),
                 lambda: serve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------
# The full-width fixture's procedure, held at smoke size
# ---------------------------------------------------------------------

def ref_serve_greedy(rcfg, rparams, prompts, steps, max_seq):
    """``torch_card.serve_greedy`` on the JAX package (jitted)."""
    rprefill, rdecode = _ref_fns(rcfg)
    cache = RM.init_cache(rcfg, len(prompts), max_seq, jnp.float32)
    rows = []
    for r, prompt in enumerate(prompts):
        one = RM.init_cache(rcfg, 1, max_seq, jnp.float32)
        logits, one = rprefill(rparams,
                               {"tokens": jnp.asarray([prompt], jnp.int32)},
                               one)
        cache = jax.tree.map(lambda full, o, r=r: full.at[:, r:r + 1].set(o),
                             cache, one)
        rows.append(np.asarray(logits[0]))
    out = [np.stack(rows)]
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(steps):
        tok = out[-1].argmax(-1).astype(np.int32)[:, None]
        logits, cache = rdecode(rparams, cache, jnp.asarray(tok),
                                jnp.asarray(pos))
        out.append(np.asarray(logits))
        pos = pos + 1
    return out


def _fixture_inputs(vocab: int, seed: int):
    rng = np.random.default_rng([seed, 1])
    return [rng.integers(0, vocab, 8).tolist(),
            rng.integers(0, vocab, 5).tolist()]


def test_fixture_procedure_matches_reference_at_smoke_size():
    """The fixture's procedure on both packages at granite-8b's smoke
    widths, weights from ``draw_numpy_params``: the port reproduces the
    reference's records at the fixture's tolerance."""
    rcfg = ref_smoke(REF_ARCHS["granite-8b"])
    cfg = smoke_config(ARCHS["granite-8b"])
    tree = draw_numpy_params(cfg, FIXTURE_SEED)
    prompts = _fixture_inputs(cfg.vocab, FIXTURE_SEED)
    want = torch_card.logit_records(
        ref_serve_greedy(rcfg, jax.tree.map(jnp.asarray, tree), prompts, 4,
                         16), FIXTURE_SEED)
    got = torch_card.serve_greedy(M, cfg, params_from_numpy(tree, "cpu"),
                                  prompts, 4, 16, "cpu")
    msg, worst = torch_card.logits_mismatch(want, got, 1e-4)
    assert msg is None, msg
    assert worst < 1e-5


def test_model_logits_fixture_is_well_formed():
    fx = json.loads(FIXTURE.read_text())
    cfg = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab) == (4096, 32, 8, 128, 14336, 49152)
    assert fx["n_layers"] == 2 and fx["rel_tol"] == 1e-4
    assert fx["prompts"] == _fixture_inputs(cfg.vocab, fx["seed"])
    assert [len(p) for p in fx["prompts"]] == [8, 5]
    assert len(fx["steps"]) == 1 + fx["decode_steps"] == 5
    for rec in fx["steps"]:
        assert len(rec["idx"]) == len(rec["val"]) == 2
        for r in range(2):
            assert len(set(rec["idx"][r])) == 64
            assert rec["idx"][r][0] == rec["tokens"][r]
            assert max(rec["val"][r]) == rec["val"][r][0]
            assert max(abs(v) for v in rec["val"][r]) <= rec["max_abs"]


def _fixture() -> dict:
    """The full-width fixture, computed by the JAX package."""
    rcfg = dataclasses.replace(REF_ARCHS["granite-8b"], n_layers=2)
    cfg = dataclasses.replace(ARCHS["granite-8b"], n_layers=2)
    tree = draw_numpy_params(cfg, FIXTURE_SEED)
    shapes = jax.eval_shape(lambda: RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    assert [(k, tuple(s.shape)) for k, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]] \
        == [(k, v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    rparams = jax.tree.map(jnp.asarray, tree)
    del tree
    prompts = _fixture_inputs(cfg.vocab, FIXTURE_SEED)
    steps = ref_serve_greedy(rcfg, rparams, prompts, 4, 16)
    return dict(arch="granite-8b", n_layers=2, seed=FIXTURE_SEED,
                max_seq=16, decode_steps=4, rel_tol=1e-4, prompts=prompts,
                steps=torch_card.logit_records(steps, FIXTURE_SEED))


if __name__ == "__main__":          # regenerate the committed fixture
    FIXTURE.write_text(json.dumps(_fixture(), indent=1, sort_keys=True))
    print(f"wrote {FIXTURE}")
