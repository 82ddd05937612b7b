"""Serving DeepSeek-V3's share of a pipeline-and-expert-parallel
deployment: 16 layers of multi-head latent attention (its cache one
latent and one rotary key a position), three dense layers, then MoE
layers routed by the sigmoid group-limited rule, holding this chip's
experts and a shared expert, in float32 (TF32 off), weights made on the
device from the seed, served by ``ServingEngine`` over the mix's slots
with the per-step ``OffloadController`` and per-step planner telemetry.
A closed loop keeps every slot busy, as ``serve_hybrid.py``'s does, and
the window starts from an empty engine.

It refuses at once a program whose configuration types lack a key the
configuration file sets (``serve_hybrid.missing_keys``, and the latent
attention's, the FFN kind's, YaRN's and the stage's), so such a program
fails in seconds and never serves another model under this name.

After the window, up to the mix's ``check_requests`` finished requests
(the longest always among them) each run once through the plain
reference (``reference/deepseek_v3.py``, attention in blocks of query
rows so its scores fit beside the model) over the prompt and served
tokens; the share of served tokens that are not the reference's best
must stay under its limit (the reason is ``serve_hybrid.py``'s: a
router near-tie, which float32 sums taken in another order tip, moves an
expert, and 16 layers of random weights carry that to a logit gap as
wide as TF32's; ``served_logit_gap``, the widest, is kept as an
observation).  Every step's planner telemetry and controller record
must equal the reference planner's (``reference/mla_sites.py``) at the
step's batch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench import generator, peaks_mla, program
from bench.drivers.serve_hybrid import missing_keys, profile
from bench.reference import deepseek_v3 as ref_model
from bench.reference import mla_sites, sim

# The largest share of compared served tokens that may lie below the
# float32 reference's best; PERF.md gives the readings it was set from.
OFF_BEST_LIMIT = 0.01

# Keys of the configuration file, beyond serve_hybrid's, that set the
# model's equations.
MLA_KEYS = ("first_k_dense_replace", "q_lora_rank", "kv_lora_rank",
            "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
            "rope_interleave", "rope_scaling", "total_layers")

# The router bias's spread: top-8 of 128 sigmoid scores lie ~0.01 apart,
# so it moves some choices and not most
BIAS_STD = 0.01


def missing_mla_keys(c: dict) -> list:
    """Keys the configuration file sets that the program's configuration
    types do not take."""
    from repro_torch.configs import base

    names = {f.name for f in dataclasses.fields(base.ArchConfig)}
    return missing_keys(c) + [k for k in MLA_KEYS
                              if k in c and k not in names]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The program's tree (per-layer leaves stacked; the dense MLP over
    the dense layers and the MoE over the MoE layers alone), drawn on
    ``device`` from the seed, one call a leaf: matrices at
    1/sqrt(fan-in), so queries and keys spread as N(0, 1) a dimension
    and the scaled scores by ~1.9; the embedding and the output head at
    1/sqrt(d_model), a unit-norm row, so the layers and not the token's
    own row set the next token; norm scales as small offsets from one;
    the router's bias at ``BIAS_STD``."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    L, dense = cfg["n_layers"], cfg["first_k_dense_replace"]
    E = L - dense
    d, ff, h = cfg["d_model"], cfg["d_ff"], cfg["n_heads"]
    q, kv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    m = cfg["moe"]
    e, eff, sff = m["n_experts"], m["expert_d_ff"], m["shared_d_ff"]
    v = -(-cfg["vocab"] // 256) * 256

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).mul_(scale)

    return {
        "embed": normal((v, d), d ** -0.5),
        "ln_f": normal((d,), 0.1),
        "lm_head": normal((d, v), d ** -0.5),
        "blocks": {
            "ln1": normal((L, d), 0.1), "ln2": normal((L, d), 0.1),
            "moe": {"router": normal((E, d, m["router_experts"]), d ** -0.5),
                    "wg": normal((E, e, d, eff), d ** -0.5),
                    "wi": normal((E, e, d, eff), d ** -0.5),
                    "wo": normal((E, e, eff, d), eff ** -0.5),
                    "shared": {"wg": normal((E, d, sff), d ** -0.5),
                               "wi": normal((E, d, sff), d ** -0.5),
                               "wo": normal((E, sff, d), sff ** -0.5)},
                    "bias": normal((E, m["router_experts"]), BIAS_STD)},
            "mlp": {"wi": normal((dense, d, ff), d ** -0.5),
                    "wo": normal((dense, ff, d), ff ** -0.5),
                    "wg": normal((dense, d, ff), d ** -0.5)},
            "mla": {"wq_a": normal((L, d, q), d ** -0.5),
                    "q_norm": normal((L, q), 0.1),
                    "wq_b": normal((L, q, h * (nope + rope)), q ** -0.5),
                    "wkv_a": normal((L, d, kv + rope), d ** -0.5),
                    "kv_norm": normal((L, kv), 0.1),
                    "wkv_b": normal((L, kv, h * (nope + dv)), kv ** -0.5),
                    "wo": normal((L, h * dv, d), (h * dv) ** -0.5)}}}


def run(r) -> None:
    missing = missing_mla_keys(r.config)
    if missing:
        raise SystemExit(f"bench: the program's configuration lacks "
                         f"{', '.join(missing)}; it cannot serve "
                         f"{r.config['name']}")
    from repro_torch.core import trace
    from repro_torch.core.pimsim import PimSimulator
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.offload import OffloadPlanner
    from repro_torch.serving.policy import OffloadController

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix, dev, c = r.mix, r.device, r.config
    cfg = program.arch(c)
    slots, max_seq = mix["slots"], mix["max_seq"]
    plain = generator.serve_requests(mix, r.seed, c["vocab"], mix["blocks"])

    program.build(r)
    params = make_weights(c, r.seed, dev)
    planner = OffloadPlanner(cfg, sim=PimSimulator(device=dev))
    controller = OffloadController(planner, policy=mix["policy"])
    planner.plan()                       # the lanes resolve in set-up
    warm = ServingEngine(cfg, params, slots=slots, max_seq=max_seq,
                         device=dev)
    for i, n in enumerate(mix["warm_prompt_lens"]):
        warm.submit(Request(rid=-1 - i, prompt=np.zeros(n, np.int32),
                            max_new=2))
    warm.run(max_steps=8)
    del warm
    program.sync(dev)

    engine = ServingEngine(cfg, params, slots=slots, max_seq=max_seq,
                           controller=controller,
                           step_telemetry=mix["step_telemetry"], device=dev)
    flops, prompt_pos = [0], [0]
    if r.trace:
        real_prefill, real_decode = engine._prefill, engine._decode

        def prefill(slot, req):
            flops[0] += peaks_mla.prefill_flops(c, len(req.prompt))
            prompt_pos[0] += peaks_mla.prompt_positions(c, len(req.prompt))
            return real_prefill(slot, req)

        def decode(tokens):
            flops[0] += peaks_mla.decode_flops(
                c, sum(q is not None for q in engine.active))
            return real_decode(tokens)

        engine._prefill, engine._decode = prefill, decode

    reqs, nxt = [], 0

    def top_up():
        nonlocal nxt
        busy = sum(q is not None for q in engine.active) + len(engine.waiting)
        while busy < slots and nxt < len(plain):
            q = plain[nxt]
            reqs.append(Request(rid=q["rid"], prompt=q["prompt"],
                                max_new=q["max_new"]))
            engine.submit(reqs[-1])
            nxt += 1
            busy += 1

    def step():
        top_up()
        engine.step()

    before = trace.totals()
    r.window_opens()
    steps0 = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        if (r.trace and dev.type == "cuda" and r.profile is None
                and engine.stats["steps"] >= mix["profile_after_steps"]):
            n0 = engine.stats["steps"]
            r.profile = profile(
                lambda: [step() for _ in range(mix["profile_steps"])])
            steps0 = engine.stats["steps"] - n0
            continue
        step()
    program.sync(dev)
    window_s = time.perf_counter() - t0

    r.memory_peak = program.memory_peak(dev)
    tokens = sum(len(q.out) for q in reqs)
    done = [q for q in reqs if q.done]
    r.attempted, r.failed = len(reqs), 0
    r.obs.update(tokens=tokens, window_s=window_s, requests=len(reqs),
                 finished=len(done), steps=engine.stats["steps"],
                 prefills=engine.stats["prefills"])
    if r.trace:
        after = trace.totals()

        def grew(name):
            return after.counter(name) - before.counter(name)

        attended = grew("mla.attended_positions")
        r.obs.update(
            attended_positions=attended, prompt_positions=prompt_pos[0],
            model_flops=flops[0]
            + peaks_mla.attention_flops(c, prompt_pos[0],
                                        attended - prompt_pos[0])
            + peaks_mla.expert_flops(c, grew("moe.assignments_held")))
        if r.profile is not None:
            r.obs.update(busy_s=r.profile["busy_s"],
                         profiled_s=r.profile["window_s"],
                         profiled_steps=steps0,
                         profiled_launches=r.profile["decode_launches"])
    deadline = time.perf_counter() + 60
    with trace.frame("bench.late"):    # its steps record no step frame
        while not done and time.perf_counter() < deadline:
            engine.step()              # late, not wrong: wait for one
            done = [q for q in reqs if q.done]

    # -- correctness ------------------------------------------------------
    telemetry = list(engine.step_speedups)
    records = [rec.to_record() for rec in controller.trace]
    del engine, controller, planner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_dec = mla_sites.plan(c, sim.Spec(), mix.get("dtype", "W8A8"),
                             mix.get("fence", True))
    differing = 0
    for tel, rec in zip(telemetry, records):
        want = sim.decode_speedup(ref_dec, tel["batch"])
        differing += (tel["speedup"] != want["speedup"]
                      or rec["batch"] != tel["batch"]
                      or rec["speedup"] != want["speedup"]
                      or rec["offloaded"] != len(want["offloaded"]))
    differing += abs(len(telemetry) - len(records))
    r.check("telemetry_steps_differing", differing, 0)
    r.telemetry_batches = [t["batch"] for t in telemetry]

    longest = max(range(len(done)), key=lambda i: len(done[i].out),
                  default=None)
    pick = set(generator.sample(r.seed, 5, len(done),
                                mix["check_requests"] - 1))
    if longest is not None:
        pick.add(longest)
    gap, off, served = 0.0, 0, 0
    r.weights = params
    t_judge = time.perf_counter()
    for i in sorted(pick):
        q = done[i]
        r.judged.append((q.prompt.tolist(), list(q.out)))
        g = ref_model.served_gaps(c, params, q.prompt.tolist(), q.out)
        gap = max(gap, float(g.max()))
        off += int((g > 0).sum())
        served += len(q.out)
    r.obs.update(tokens_compared=served, tokens_off_best=off,
                 served_logit_gap=gap, judge_s=time.perf_counter() - t_judge)
    r.check("served_tokens_off_best", off / served if served else 1.0,
            OFF_BEST_LIMIT)
