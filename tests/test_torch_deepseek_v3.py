"""DeepSeek-V3 (``configs/deepseek_v3.py``) in the port, at its smoke size
on the CPU: multi-head latent attention in every layer (expanded over a
prompt, absorbed in decode, a cache of one latent and one rotary key a
position), a dense layer, then MoE layers routed by the sigmoid
group-limited rule over every expert with the experts held here and a
shared expert, held to the plain reference
``tests/reference/deepseek_v3.py`` (a copy of the benchmark's), which is
in turn held to ``transformers``' model of the same name.

Tolerances are relative to the reference logits' largest magnitude:
1e-5, where float32 sums taken in another order (the absorbed decode
against the expanded form, blockwise attention against whole rows,
batched experts against a loop) measure about 1e-7 to 2e-6; TF32 matmuls
(emulated here by rounding their operands to 10 mantissa bits) and
bfloat16 land at 1e-4 to 1e-2, and
``test_lower_precision_fails_the_tolerance`` shows both fail it.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import math
import pathlib

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCHS, PORT_ARCHS, smoke_config
from repro_torch.core import trace
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import decode_gemv_sites

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_PATH = ROOT / "tests" / "reference" / "deepseek_v3.py"
BENCH_REF_PATH = ROOT / "bench" / "reference" / "deepseek_v3.py"
FULL = PORT_ARCHS["deepseek-v3"]
CFG = smoke_config(FULL)
REL_TOL = 1e-5


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location("deepseek_v3_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(REF_PATH)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(cfg=CFG, seed: int = 0) -> dict:
    """The program's tree drawn from ``seed``, every norm moved off its
    initial value so that each one counts, the router's bias drawn (at
    zero the bias-for-choice rule would not show), and the embedding at
    unit norm a row."""
    g = torch.Generator().manual_seed(seed)
    p = M.init_params(cfg, g, device="cpu")
    blk = p["blocks"]
    for t in (p["ln_f"], blk["ln1"], blk["ln2"], blk["mla"]["q_norm"],
              blk["mla"]["kv_norm"]):
        t.normal_(0.0, 0.1, generator=g)
    blk["moe"]["bias"].normal_(0.0, 0.05, generator=g)
    p["embed"].mul_(1 / (0.02 * math.sqrt(cfg.d_model)))
    p["lm_head"].mul_(1 / (0.02 * math.sqrt(cfg.d_model)))
    return p


def cfg_dict(cfg=CFG) -> dict:
    return dataclasses.asdict(cfg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def tokens(n: int, seed: int = 1) -> torch.Tensor:
    return torch.randint(0, CFG.vocab, (n,),
                         generator=torch.Generator().manual_seed(seed))


# -- the model ----------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
def test_full_forward_matches_the_reference(monkeypatch, flash):
    """The expanded form, by dense attention and by the blockwise path
    (its threshold lowered below the sequence)."""
    if flash:
        monkeypatch.setattr(L, "FLASH_THRESHOLD", 16)
    p = weights()
    seq = tokens(75)
    got, _ = M.forward(CFG, p, {"tokens": seq[None]})
    want = REF.logits(cfg_dict(), p, seq, block=32)
    assert want.abs().max() > 0.1
    assert rel_err(got[0], want) < REL_TOL


def _tf32_operands(a, b):
    """``a @ b`` with the operands cut to TF32's 10-bit mantissa
    (truncated), as a card computes with TF32 on."""
    def cut(t):
        return (t.float().contiguous().view(torch.int32)
                & ~0x1FFF).view(torch.float32)

    return cut(a) @ cut(b)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_lower_precision_fails_the_tolerance(monkeypatch, precision):
    p = weights()
    seq = tokens(75)
    want = REF.logits(cfg_dict(), p, seq)
    if precision == "tf32":             # the model's projections
        monkeypatch.setattr(L, "mm", _tf32_operands)
        monkeypatch.setattr(MOE, "mm", _tf32_operands)
    else:
        p = _cast(p, torch.bfloat16)
    got, _ = M.forward(CFG, p, {"tokens": seq[None]})
    assert rel_err(got[0].float(), want) > 10 * REL_TOL


def test_serving_prefill_then_decode_matches_the_reference(monkeypatch):
    """Slots admitted at different ticks with prompts of different
    lengths (one of a single token), so every absorbed decode step holds
    slots at different positions; every logit the engine computed
    (prefill's last and each decode step's) is held to the reference's
    full forward at that position."""
    p = weights()
    seen: dict = {}                     # rid -> [logits by position]
    eng = ServingEngine(CFG, p, slots=3, max_seq=96, device="cpu")
    real_prefill, real_decode = M.prefill, M.decode_step

    def prefill(cfg, params, batch, cache):
        out, cache = real_prefill(cfg, params, batch, cache)
        seen[eng.waiting_rid] = [out[0]]
        return out, cache

    def decode_step(cfg, params, cache, token, pos):
        out, cache = real_decode(cfg, params, cache, token, pos)
        for i, req in enumerate(eng.active):
            if req is not None:
                seen[req.rid].append(out[i])
        return out, cache

    monkeypatch.setattr(M, "prefill", prefill)
    monkeypatch.setattr(M, "decode_step", decode_step)
    real_admit = eng._prefill

    def admit(slot, req):
        eng.waiting_rid = req.rid
        return real_admit(slot, req)

    eng._prefill = admit
    reqs = [Request(rid=i, prompt=tokens(n, seed=10 + i).numpy(),
                    max_new=m)
            for i, (n, m) in enumerate([(40, 9), (7, 14), (33, 5), (20, 8),
                                        (1, 6)])]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=100)
    assert all(r.done for r in reqs)
    assert len(set(eng.step_batches)) > 1
    for r in reqs:
        seq = list(r.prompt) + r.out[:-1]
        want = REF.logits(cfg_dict(), p, torch.as_tensor(seq),
                          range(len(r.prompt) - 1, len(seq)))
        got = torch.stack(seen[r.rid])
        assert got.shape == want.shape
        assert rel_err(got, want) < REL_TOL, r.rid


def test_expert_shares_sum_to_the_uncut_layer():
    """Four chips' shares of 16 experts (4 each) under the sigmoid
    group-limited router: their routed parts, with the shared expert
    counted once, add up to the layer holding all 16."""
    d = 64
    g = torch.Generator().manual_seed(3)
    whole_cfg = dataclasses.replace(CFG.moe, n_experts=16, router_experts=16,
                                    first_expert=0)
    whole = MOE.held_moe_init(L.TorchDraw(g, torch.float32, torch.device(
        "cpu")), d, 32, whole_cfg)
    whole["bias"].normal_(0.0, 0.05, generator=g)
    x = torch.randn(3, 5, d, generator=g)
    shared = L.mlp_apply(whole["shared"], x, "swiglu")
    want = MOE.held_moe_apply(whole, x, whole_cfg)
    parts = []
    for c in range(4):
        share_cfg = dataclasses.replace(whole_cfg, n_experts=4,
                                        first_expert=4 * c)
        share = dict(whole, **{k: whole[k][4 * c:4 * c + 4]
                               for k in ("wg", "wi", "wo")})
        parts.append(MOE.held_moe_apply(share, x, share_cfg) - shared)
        one = MOE.held_moe_apply(share, x[:, :1], share_cfg)
        torch.testing.assert_close(one, parts[-1][:, :1] + shared[:, :1],
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sum(parts) + shared, want, rtol=1e-5,
                               atol=1e-6)


def test_the_router_on_a_hand_example():
    """8 experts in 4 groups of 2, the best 2 groups kept, top-2.  The
    best single score lies in a group the group rule leaves out; the
    bias moves a choice without moving the gates, which are the chosen
    unbiased scores over their sum, times 2.5."""
    moe = dataclasses.replace(CFG.moe, router_experts=8, n_group=4,
                              topk_group=2, top_k=2, norm_topk_prob=True,
                              routed_scaling_factor=2.5)
    # scores by group: (0.90, 0.10) (0.60, 0.55) (0.58, 0.57) (0.20, 0.20)
    scores = torch.tensor([[0.90, 0.10, 0.60, 0.55, 0.58, 0.57, 0.20, 0.20]])
    logits = torch.log(scores / (1 - scores))
    zero = torch.zeros(8)
    idx, gates = MOE.group_limited_top_k(logits, zero, moe)
    # group sums 1.00, 1.15, 1.15, 0.40: groups 1 and 2 kept, expert 0 out
    assert sorted(idx[0].tolist()) == [2, 4]
    torch.testing.assert_close(_by_expert(idx, gates), 2.5 * torch.tensor(
        [0.60, 0.58]) / (0.60 + 0.58))
    # a bias of 0.05 on expert 5 lifts it past expert 4 for the choice;
    # its gate is its unbiased score
    bias = zero.clone()
    bias[5] = 0.05
    idx, gates = MOE.group_limited_top_k(logits, bias, moe)
    assert sorted(idx[0].tolist()) == [2, 5]
    assert float(gates.sum()) == pytest.approx(2.5)
    torch.testing.assert_close(_by_expert(idx, gates), 2.5 * torch.tensor(
        [0.60, 0.57]) / (0.60 + 0.57))
    # the plain reference's rule agrees
    ref_idx, ref_gates = REF._route(
        dict(router_experts=8, n_group=4, topk_group=2, top_k=2,
             norm_topk_prob=True, routed_scaling_factor=2.5),
        {"router": torch.eye(8), "bias": bias}, logits)
    assert sorted(ref_idx[0].tolist()) == [2, 5]
    torch.testing.assert_close(_by_expert(ref_idx, ref_gates),
                               _by_expert(idx, gates))


def _by_expert(idx, gates):
    """The first row's gates in the order of its expert ids."""
    return gates[0][idx[0].argsort()]


def test_yarn_frequencies_and_scale_follow_the_published_formula():
    """DeepSeek-V3's rope dimensions: YaRN's frequencies as
    ``transformers`` computes them, and by hand at the ends of the ramp;
    the softmax scale 192 ** -0.5 * (0.1 ln 40 + 1) ** 2."""
    rs = FULL.rope_scaling
    inv, factor = L.rope_frequencies(64, 10000.0, rs)
    plain = 1.0 / 10000.0 ** (torch.arange(0, 64, 2).float() / 64)
    # low = floor(64 ln(4096 / (32 * 2 pi)) / (2 ln 1e4)) = 10,
    # high = ceil(64 ln(4096 / (2 pi)) / (2 ln 1e4)) = 23
    assert torch.equal(inv[:11], plain[:11])
    torch.testing.assert_close(inv[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert factor == 1.0
    assert M.mla_softmax_scale(FULL) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2)
    assert M.mla_softmax_scale(FULL) * 192 ** 0.5 == pytest.approx(1.8738,
                                                                   abs=1e-4)
    want, want_factor = REF.yarn(cfg_dict(FULL))
    torch.testing.assert_close(inv, want, rtol=1e-6, atol=0)
    assert factor == want_factor
    rope_utils = pytest.importorskip("transformers.modeling_rope_utils")
    tf = pytest.importorskip("transformers")
    hf_cfg = tf.DeepseekV3Config(
        rope_scaling=dataclasses.asdict(rs), rope_theta=10000.0,
        qk_rope_head_dim=64, max_position_embeddings=163840)
    hf_inv, hf_factor = rope_utils._compute_yarn_parameters(hf_cfg, "cpu")
    torch.testing.assert_close(inv, hf_inv, rtol=1e-6, atol=0)
    assert factor == hf_factor


def test_the_cache_holds_only_the_latent_and_rope_key():
    cache = M.init_cache(CFG, 2, 64, torch.float32, device="cpu")
    assert set(cache) == {"mla"}
    lat, rope = cache["mla"]
    assert lat.shape == (4, 2, 64, CFG.kv_lora_rank)
    assert rope.shape == (4, 2, 64, CFG.qk_rope_head_dim)
    # the published widths: 2,304 B a position a layer in float32, 57x
    # less than per-head keys and values; 32 slots x 4608 x 16 layers
    full = M.init_cache(FULL, 32, 4608, torch.float32, device="meta")
    per = sum(t.shape[-1] * 4 for t in full["mla"])
    assert per == 2304
    assert 128 * 256 * 4 // per == 56
    nbytes = sum(t.numel() * 4 for t in full["mla"])
    assert nbytes == 16 * 32 * 4608 * 2304
    assert round(nbytes / 1e9, 2) == 5.44


def test_the_params_tree_stacks_each_ffn_over_its_own_layers():
    p = M.param_specs(FULL, torch.float32)
    blk = p["blocks"]
    assert blk["mla"]["wq_a"].shape == (16, 7168, 1536)
    assert blk["mla"]["wq_b"].shape == (16, 1536, 128 * 192)
    assert blk["mla"]["wkv_a"].shape == (16, 7168, 576)
    assert blk["mla"]["wkv_b"].shape == (16, 512, 128 * 256)
    assert blk["mla"]["wo"].shape == (16, 128 * 128, 7168)
    assert blk["mlp"]["wg"].shape == (3, 7168, 18432)
    assert blk["moe"]["wg"].shape == (13, 8, 7168, 2048)
    assert blk["moe"]["router"].shape == (13, 7168, 256)
    assert blk["moe"]["bias"].shape == (13, 256)
    assert blk["moe"]["shared"]["wo"].shape == (13, 2048, 7168)
    assert p["lm_head"].shape == (7168, 129280)
    n = sum(t.numel() for t in _leaves(p))
    assert n == FULL.param_count()
    assert round(n / 1e9, 2) == 11.21


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_decode_gemv_sites_are_the_published_model_s():
    sites = {s.name: (s.h, s.w, s.count) for s in decode_gemv_sites(FULL)}
    assert sites == {
        "mla.q_a": (1536, 7168, 61), "mla.q_b": (24576, 1536, 61),
        "mla.kv_a": (576, 7168, 61),
        "mla.q_absorb": (512, 128, 61 * 128),
        "mla.v_absorb": (128, 512, 61 * 128),
        "mla.o": (7168, 16384, 61),
        "mlp.w0": (18432, 7168, 3), "mlp.w1": (18432, 7168, 3),
        "mlp.wo": (7168, 18432, 3),
        "moe.router": (256, 7168, 58),
        "moe.w0": (2048, 7168, 58 * 8), "moe.w1": (2048, 7168, 58 * 8),
        "moe.wo": (7168, 2048, 58 * 8),
        "moe.shared.w0": (2048, 7168, 58), "moe.shared.w1": (2048, 7168, 58),
        "moe.shared.wo": (7168, 2048, 58),
        "lm_head": (129280, 7168, 1)}
    # the smoke configuration holds its whole depth
    small = {s.name: s.count for s in decode_gemv_sites(CFG)}
    assert small["mla.q_a"] == 4 and small["moe.router"] == 3


def test_spans_and_counters_equal_a_hand_count():
    """One prompt's prefill and one batched decode step, each in a frame:
    the latent-attention spans open twice a layer (projections before
    and after) and once (attention), the MoE's once a MoE layer; the
    counters as counted by hand."""
    p = weights()
    n_mla, n_moe, s = CFG.n_layers, CFG.n_layers - 1, 30
    row = (CFG.kv_lora_rank + CFG.qk_rope_head_dim) * 4
    prompt = tokens(s)
    cache = M.init_cache(CFG, 1, 64, torch.float32, device="cpu")
    with trace.frame("t.mla_prefill"):
        M.prefill(CFG, p, {"tokens": prompt[None]}, cache)
    f = trace.frames("t.mla_prefill")[-1]
    assert f.spans["mla.project"][0] == 2 * n_mla
    assert f.spans["mla.attend"][0] == n_mla
    assert f.spans["moe.route"][0] == n_moe
    assert f.counter("mla.attended_positions") == n_mla * s * (s + 1) // 2
    assert f.counter("mla.latent_bytes") == n_mla * s * row
    assert f.counter("moe.assignments") == n_moe * s * CFG.moe.top_k
    # a decode step over 3 slots at positions 4, 0 and 9
    cache = M.init_cache(CFG, 3, 64, torch.float32, device="cpu")
    pos = torch.tensor([4, 0, 9], dtype=torch.int32)
    with trace.frame("t.mla_decode"):
        M.decode_step(CFG, p, cache, prompt[:3, None], pos)
    f = trace.frames("t.mla_decode")[-1]
    attended = 5 + 1 + 10
    assert f.counter("mla.attended_positions") == n_mla * attended
    assert f.counter("mla.latent_bytes") == n_mla * (attended + 3) * row
    assert f.counter("moe.expert_rows") == n_moe * CFG.moe.n_experts * 3
    # the granite hybrid and dense models run none of them
    dense = smoke_config(ARCHS["granite-8b"])
    q = M.init_params(dense, torch.Generator().manual_seed(0), device="cpu")
    with trace.frame("t.dense"):
        M.forward(dense, q, {"tokens": prompt[None]})
    f = trace.frames("t.dense")[-1]
    assert not {"mla.project", "mla.attend"} & set(f.spans)
    assert "mla.attended_positions" not in f.counts


def _old_dense_attention(q, k, v, *, q_offset=0, kv_len=None, scale=None):
    """``layers.dense_attention`` as it was before values had a width of
    their own (no window)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd) if scale is None else scale)
    qo = torch.as_tensor(q_offset)
    ar = torch.arange(sq)
    qi = qo[:, None] + ar if qo.ndim == 1 else (qo + ar)[None]
    ki = torch.arange(sk)
    mask = ki[None, None, :] <= qi[..., None]
    if kv_len is not None:
        kl = torch.as_tensor(kv_len)
        kl = kl[:, None, None] if kl.ndim == 1 else kl
        mask = mask & (ki[None, None, :] < kl)
    scores = torch.where(mask[:, None, None], scores, L.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, hq, hd)


def _old_flash_attention(q, k, v, *, block_q=512, block_k=512):
    """``layers.flash_attention`` as it was before values had a width of
    their own (no window, queries from position 0, no block skipping)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * bq - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * bk - sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * bk - sk))
    qb = qp.reshape(b, nq, bq, hkv, g, hd).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(b, nk, bk, hkv, hd).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(b, nk, bk, hkv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / math.sqrt(hd)
    qi = torch.arange(nq * bq).reshape(nq, bq)
    m = torch.full((nq, b, hkv, g, bq), L.NEG_INF)
    l = torch.zeros((nq, b, hkv, g, bq))
    acc = torch.zeros((nq, b, hkv, g, bq, hd))
    qf = qb.float()
    for ki_idx in range(nk):
        kblk, vblk = kb[ki_idx], vb[ki_idx]
        ki = ki_idx * bk + torch.arange(bk)
        s = torch.einsum("nbkgqd,bksd->nbkgqs", qf, kblk.float()) * scale
        msk = ki[None, None, :] <= qi[:, :, None]
        msk = msk & (ki < sk)[None, None, :]
        s = torch.where(msk[:, None, None, None], s, L.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(s - m_new[..., None])
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "nbkgqs,bksd->nbkgqd", pr.to(vblk.dtype), vblk)
        m = m_new
    ob = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    out = ob.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * bq, hq, hd)
    return out[:, :sq]


def test_attention_takes_a_value_width_of_its_own():
    """At 192 / 128 (query and key / value) the blockwise path equals the
    dense one; at equal widths both give what they gave before values
    had a width of their own, bit for bit."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(1, 70, 4, 192, generator=g)
    k = torch.randn(1, 70, 4, 192, generator=g)
    v = torch.randn(1, 70, 4, 128, generator=g)
    dense = L.dense_attention(q, k, v, scale=0.1)
    flash = L.flash_attention(q, k, v, block_q=16, block_k=16, scale=0.1)
    assert dense.shape == flash.shape == (1, 70, 4, 128)
    torch.testing.assert_close(flash, dense, rtol=1e-5, atol=1e-6)
    kv = torch.randn(2, 70, 2, 192, generator=g)
    assert torch.equal(L.dense_attention(q.expand(2, -1, -1, -1), kv, kv),
                       _old_dense_attention(q.expand(2, -1, -1, -1), kv,
                                            kv))
    pos = torch.tensor([3, 60])
    assert torch.equal(
        L.dense_attention(q[:, :1].expand(2, -1, -1, -1), kv, kv,
                          q_offset=pos, kv_len=pos + 1),
        _old_dense_attention(q[:, :1].expand(2, -1, -1, -1), kv, kv,
                             q_offset=pos, kv_len=pos + 1))
    assert torch.equal(L.flash_attention(q, k, k, block_q=16, block_k=32),
                       _old_flash_attention(q, k, k, block_q=16,
                                            block_k=32))


# -- the configuration ----------------------------------------------------

def test_the_configuration_is_the_port_s_alone():
    assert FULL.name not in ARCHS
    assert FULL.layer_types == ("mla",) * 16
    assert (FULL.first_k_dense_replace, FULL.total_layers) == (3, 61)
    assert (FULL.moe.n_experts, FULL.moe.n_routed, FULL.moe.top_k) == \
        (8, 256, 8)
    assert FULL.expert_d_ff == 2048 and FULL.d_ff == 18432
    assert CFG.layer_types == ("mla",) * 4
    assert CFG.first_k_dense_replace == 1
    assert (CFG.moe.n_experts, CFG.moe.n_routed, CFG.moe.top_k,
            CFG.moe.n_group, CFG.moe.topk_group) == (4, 16, 4, 4, 2)
    assert CFG.moe.shared_d_ff > 0 and CFG.rope_scaling == FULL.rope_scaling
    assert CFG.q_lora_rank and CFG.kv_lora_rank
    assert CFG.v_head_dim != CFG.qk_head_dim
    # built from plain data, as a JSON config gives it, and hashable
    plain = dataclasses.asdict(FULL)
    again = type(FULL)(**{**plain, "layer_types": list(FULL.layer_types)})
    assert again == FULL and hash(again) == hash(FULL)


def test_the_serve_launcher_takes_the_configuration():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", FULL.name, "--help"])
    assert e.value.code == 0


# -- the reference --------------------------------------------------------

def test_the_two_reference_copies_are_byte_identical():
    assert REF_PATH.read_bytes() == BENCH_REF_PATH.read_bytes()


def test_the_reference_imports_torch_alone():
    tree = ast.parse(REF_PATH.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "torch"}, names


def test_the_reference_follows_transformers():
    """The reference, holding every expert, against ``transformers``'
    ``DeepseekV3ForCausalLM`` with the same weights (its eager,
    plain-torch paths): the two are written apart, so they agree only if
    both follow the published model."""
    tf = pytest.importorskip("transformers")
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(
        CFG.moe, n_experts=16, router_experts=16, first_expert=0))
    p = weights(cfg, seed=5)
    m = cfg.moe
    hf_cfg = tf.DeepseekV3Config(
        vocab_size=cfg.vocab_padded, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, moe_intermediate_size=m.expert_d_ff,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_heads, n_shared_experts=1,
        n_routed_experts=m.n_routed,
        routed_scaling_factor=m.routed_scaling_factor,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        qk_nope_head_dim=cfg.qk_nope_head_dim, n_group=m.n_group,
        topk_group=m.topk_group, num_experts_per_tok=m.top_k,
        first_k_dense_replace=cfg.first_k_dense_replace,
        norm_topk_prob=m.norm_topk_prob, rope_theta=cfg.rope_theta,
        rope_scaling=dataclasses.asdict(cfg.rope_scaling),
        rope_interleave=cfg.rope_interleave, rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=False, attention_bias=False,
        max_position_embeddings=163840)
    hf_cfg._attn_implementation = "eager"
    model = tf.DeepseekV3ForCausalLM(hf_cfg).eval()
    missing, unexpected = model.load_state_dict(_hf_state(cfg, p),
                                                strict=False)
    assert not unexpected and not missing
    seq = tokens(75, seed=6)
    with torch.no_grad():
        got = model(seq[None]).logits[0]
    want = REF.logits(cfg_dict(cfg), p, seq)
    assert want.abs().max() > 0.1
    assert rel_err(got, want) < REL_TOL


def _hf_state(cfg, p) -> dict:
    """The program's tree as ``transformers``' state dict (its matrices
    are (out, in); norm scales are whole, not offsets)."""
    blk, sd = p["blocks"], {}
    sd["model.embed_tokens.weight"] = p["embed"]
    sd["model.norm.weight"] = 1 + p["ln_f"]
    sd["lm_head.weight"] = p["lm_head"].T
    k = cfg.first_k_dense_replace
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = 1 + blk["ln1"][i]
        sd[pre + "post_attention_layernorm.weight"] = 1 + blk["ln2"][i]
        a, at = blk["mla"], pre + "self_attn."
        for src, dst in (("wq_a", "q_a_proj"), ("wq_b", "q_b_proj"),
                         ("wkv_a", "kv_a_proj_with_mqa"),
                         ("wkv_b", "kv_b_proj"), ("wo", "o_proj")):
            sd[at + dst + ".weight"] = a[src][i].T
        sd[at + "q_a_layernorm.weight"] = 1 + a["q_norm"][i]
        sd[at + "kv_a_layernorm.weight"] = 1 + a["kv_norm"][i]
        names = (("wg", "gate_proj"), ("wi", "up_proj"), ("wo", "down_proj"))
        if i < k:
            for src, dst in names:
                sd[pre + f"mlp.{dst}.weight"] = blk["mlp"][src][i].T
            continue
        moe, j = blk["moe"], i - k
        sd[pre + "mlp.gate.weight"] = moe["router"][j].T
        sd[pre + "mlp.gate.e_score_correction_bias"] = moe["bias"][j]
        for e in range(cfg.moe.n_experts):
            for src, dst in names:
                sd[pre + f"mlp.experts.{e}.{dst}.weight"] = \
                    moe[src][j][e].T
        for src, dst in names:
            sd[pre + f"mlp.shared_experts.{dst}.weight"] = \
                moe["shared"][src][j].T
    return {k: v.contiguous() for k, v in sd.items()}
