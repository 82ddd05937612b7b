"""The ``serve_mla`` driver and its references, whole runs at smoke widths
on the CPU: a sound run is correct and reports its metrics, and the
timed path broken underneath (the router's bias dropped, YaRN's
attention scale dropped, the rotary pairs taken as halves, an expert
dropped) comes out
as not correct; a program without the configuration's keys is refused
at once; the reference planner's sites are the program's; the FLOP
count against a hand count; the controls fail their limits."""
from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

import tinyroot

from bench import control_mla, harness, peaks_mla, program
from bench.drivers import serve_mla
from bench.reference import mla_sites

FULL = json.loads((tinyroot.ROOT / "bench" / "configs" / "deepseek-v3.json")
                  .read_text())
TINY = dict(name="tinym", source="smoke widths of a latent-attention MoE",
            family="moe_mla", n_layers=4, d_model=128, n_heads=4,
            n_kv_heads=4, d_head=24, d_ff=256, vocab=512, mlp="swiglu",
            tie_embeddings=False, norm_eps=1e-6, rope_theta=10000,
            layer_types=["mla"] * 4, first_k_dense_replace=1,
            q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, rope_interleave=True,
            rope_scaling=FULL["rope_scaling"], total_layers=0,
            moe=dict(n_experts=4, top_k=4, router_experts=16,
                     first_expert=4, shared_d_ff=64, expert_d_ff=64,
                     scoring_func="sigmoid", n_group=4, topk_group=2,
                     norm_topk_prob=True, routed_scaling_factor=2.5),
            reduced=[])
MIX = dict(slots=4, max_seq=160, prompt_len=[16, 128], new_tokens=[4, 16],
           block=4, warm_prompt_lens=[16, 128], profile_after_steps=3,
           profile_steps=2)
CELL = "tinym.serve_mla"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the runs' windows are seconds long: with several test processes on
    # the machine, one thread each keeps their steps from contending
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """tinyroot's copy with the smoke latent-attention cell added by
    files."""
    root = tinyroot.make(tmp_path_factory.mktemp("mla"))
    (root / "bench" / "configs" / "tinym.json").write_text(json.dumps(TINY))
    mix = json.loads((root / "bench" / "traffic" / "serve_mla.json")
                     .read_text())
    mix.update(MIX)
    (root / "bench" / "traffic" / "serve_mla_tiny.json").write_text(
        json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    twin = "deepseek-v3.serve_mla"
    bench["workloads"].append(dict(name=CELL, config="tinym",
                                   traffic="serve_mla_tiny", chips=1,
                                   why="smoke widths on the CPU"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if twin in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root, seconds: float = 3.0, trace: bool = False, seed=2 ** 31 + 5):
    return harness.execute(root, CELL, seed, seconds, trace,
                           torch.device("cpu"), time.perf_counter())


def test_a_sound_run_is_correct_and_reports_its_metrics(root):
    run = _run(root, trace=True)
    assert run.correct, run.checks
    assert run.obs["tokens_compared"] > 0
    got = harness.read_metrics(root, harness.load_json(root / "BENCHMARK.json"),
                               run)
    # the device-trace metrics need the card's profile; the rest read here
    assert {"mla_step.mfu", "mla.ms_per_prefill.mla"} <= set(got)
    assert got["mla.ms_per_prefill.mla"]["value"] > 0
    assert run.obs["attended_positions"] > run.obs["prompt_positions"] > 0


def _fault(kind, monkeypatch):
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    if kind == "bias_dropped":
        real = MOE.group_limited_top_k

        def unbiased(logits, bias, moe):
            return real(logits, torch.zeros_like(bias), moe)

        monkeypatch.setattr(MOE, "group_limited_top_k", unbiased)
    elif kind == "mscale_dropped":
        monkeypatch.setattr(M, "mla_softmax_scale",
                            lambda cfg: cfg.qk_head_dim ** -0.5)
    elif kind == "rope_halves":
        real = L.rope_rotate

        def halves(x, positions, inv_freq, interleave=False, factor=1.0):
            return real(x, positions, inv_freq, False, factor)

        monkeypatch.setattr(L, "rope_rotate", halves)
    else:                               # an expert dropped
        real = MOE.held_moe_apply

        def dropped(params, x, moe):
            params = dict(params, wo=params["wo"].clone())
            params["wo"][0] = 0.0
            return real(params, x, moe)

        monkeypatch.setattr(MOE, "held_moe_apply", dropped)


@pytest.mark.parametrize("kind", ["bias_dropped", "mscale_dropped",
                                  "rope_halves", "expert_dropped"])
def test_planted_faults_are_caught(root, monkeypatch, kind):
    _fault(kind, monkeypatch)
    run = _run(root)
    assert not run.correct, (run.checks, run.obs["tokens_compared"])


def test_a_program_without_the_configuration_keys_is_refused(root,
                                                             monkeypatch):
    from repro_torch.configs import base

    assert serve_mla.missing_mla_keys(TINY) == []
    assert serve_mla.missing_mla_keys(FULL) == []

    @dataclasses.dataclass(frozen=True)
    class MoeBefore:                    # the parent's MoeConfig
        n_experts: int
        top_k: int
        capacity_factor: float = 1.25
        router_experts: object = None
        first_expert: int = 0
        shared_d_ff: int = 0

    monkeypatch.setattr(base, "MoeConfig", MoeBefore)
    assert "moe.scoring_func" in serve_mla.missing_mla_keys(FULL)
    t = time.perf_counter()
    with pytest.raises(SystemExit, match="moe.expert_d_ff"):
        _run(root)
    assert time.perf_counter() - t < 5.0


def test_the_reference_planner_sites_are_the_program_s():
    from repro_torch.serving.offload import decode_gemv_sites

    for cfg in (FULL, TINY):
        got = [(s.name, s.h, s.w, s.count)
               for s in decode_gemv_sites(program.arch(cfg))]
        want = [(s.name, s.h, s.w, s.count)
                for s in mla_sites.decode_sites(cfg)]
        assert got == want


def test_the_flop_count_against_a_hand_count():
    c = FULL
    d, h, q, kv = 7168, 128, 1536, 512
    mla = 2 * (d * q + q * h * 192 + d * 576 + kv * h * 256 + h * 128 * d)
    moe = 2 * d * 256 + 6 * d * 2048
    token = 16 * mla + 3 * 6 * d * 18432 + 13 * moe
    assert peaks_mla.token_flops(c) == token
    head = 2 * d * 129280
    assert peaks_mla.prefill_flops(c, 3) == 3 * token + head
    assert peaks_mla.prompt_positions(c, 3) == 16 * 6
    assert peaks_mla.decode_flops(c, 2) == 2 * (token + head)
    # 6 prompt positions expanded, 11 decode positions absorbed
    assert peaks_mla.attention_flops(c, 6, 11) == \
        6 * 2 * h * (192 + 128) + 11 * 2 * h * (2 * kv + 64)
    assert peaks_mla.expert_flops(c, 10) == 10 * 6 * d * 2048


def test_the_float32_control_fails_the_telemetry():
    assert control_mla.telemetry_control(FULL, [1, 2, 8, 32], "W8A8",
                                         True) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 31, 32, 33])
def test_the_tf32_control_fails_served_tokens(root, seed):
    """The cell itself, a 10 s window."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    run = harness.execute(root, "deepseek-v3.serve_mla", seed, 10.0, False,
                          torch.device("cuda", 0), time.perf_counter())
    assert run.correct, run.checks
    assert control_mla.served_control(run) > serve_mla.OFF_BEST_LIMIT
