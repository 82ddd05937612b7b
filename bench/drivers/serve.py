"""Serving with a model: granite-8b's every layer in float32 (TF32 off),
weights made on the device from the seed, served by ``ServingEngine``
over the mix's slots with the per-step ``OffloadController`` and per-step
planner telemetry.  A closed loop keeps every slot busy: before each
engine step the loop submits requests until the running and waiting ones
fill the slots.  Requests come from the generator in blocks of the same
prompt and output lengths, greedy, with no end-of-sequence token.

The window runs engine steps until ``--seconds`` have passed.  After it,
the requests it finished are sampled (up to the mix's ``check_requests``,
the longest always among them) and each is run once through the plain
reference over its prompt and served tokens;
every served token's reference logit must lie within the limit of the
reference's best.  Every step's planner telemetry and controller record
must equal the reference planner's at the step's batch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import generator, peaks, program, tracing
from bench.reference import model as ref_model
from bench.reference import sim

# The widest gap (logit units) by which a served token's float32
# reference logit may lie below the reference's best; PERF.md gives the
# readings it was set from.
LOGIT_GAP_LIMIT = 5e-4


def make_weights(cfg: dict, seed: int, device) -> dict:
    """A dense decoder's weights in the program's tree (per-layer leaves
    stacked), drawn on ``device`` from the seed, one call a leaf:
    projections at 1/sqrt(fan-in), embedding and head at 0.02, norm
    scales as small offsets from one."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    L, d, ff = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    v = -(-cfg["vocab"] // 256) * 256

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).mul_(scale)

    return {
        "embed": normal((v, d), 0.02),
        "ln_f": normal((d,), 0.1),
        "blocks": {
            "ln1": normal((L, d), 0.1), "ln2": normal((L, d), 0.1),
            "attn": {"wq": normal((L, d, hq * hd), d ** -0.5),
                     "wk": normal((L, d, hkv * hd), d ** -0.5),
                     "wv": normal((L, d, hkv * hd), d ** -0.5),
                     "wo": normal((L, hq * hd, d), (hq * hd) ** -0.5)},
            "mlp": {"wi": normal((L, d, ff), d ** -0.5),
                    "wg": normal((L, d, ff), d ** -0.5),
                    "wo": normal((L, ff, d), ff ** -0.5)}},
        "lm_head": normal((d, v), 0.02)}


def run(r) -> None:
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
    spans = tracing.Spans(r.trace)
    flops = [0]
    if r.trace:
        real_prefill, real_decode = engine._prefill, engine._decode

        def prefill(slot, req):
            flops[0] += peaks.prefill_flops(c, len(req.prompt))
            with spans.span("prefill"):
                return real_prefill(slot, req)

        def decode(tokens):
            flops[0] += peaks.decode_flops(
                c, [engine.pos[i] for i, q in enumerate(engine.active)
                    if q is not None])
            with spans.span("decode_step"):
                return real_decode(tokens)

        engine._prefill, engine._decode = prefill, decode
        controller.observe = spans.wrap(controller.observe, "controller")
        planner.decode_speedup = spans.wrap(planner.decode_speedup,
                                            "telemetry")

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

    r.window_opens()
    steps0 = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        if (r.trace and dev.type == "cuda" and r.profile is None
                and engine.stats["steps"] >= mix["profile_after_steps"]):
            before = engine.stats["steps"]
            r.profile = tracing.profile(
                lambda: [step() for _ in range(mix["profile_steps"])])
            steps0 = engine.stats["steps"] - before
            continue
        step()
    program.sync(dev)
    window_s = time.perf_counter() - t0

    r.memory_peak = program.memory_peak(dev)
    tokens = sum(len(q.out) for q in reqs)
    done = [q for q in reqs if q.done]
    r.attempted, r.failed = len(reqs), 0
    r.obs.update(tokens=tokens, window_s=window_s, requests=len(reqs),
                 finished=len(done), steps=engine.stats["steps"])
    if r.trace:
        r.obs.update(model_flops=flops[0],
                     plan_s=spans.seconds.get("controller", 0.0)
                     + spans.seconds.get("telemetry", 0.0))
        if r.profile is not None:
            r.obs.update(busy_s=r.profile["busy_s"],
                         profiled_s=r.profile["window_s"],
                         profiled_steps=steps0,
                         profiled_launches=r.profile["launches_by_span"]
                         .get("decode_step", 0))
    deadline = time.perf_counter() + 60
    while not done and time.perf_counter() < deadline:
        engine.step()                  # late, not wrong: wait for one
        done = [q for q in reqs if q.done]

    # -- correctness ------------------------------------------------------
    telemetry = list(engine.step_speedups)
    records = [rec.to_record() for rec in controller.trace]
    del engine, controller, planner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_dec = sim.plan(c, sim.Spec(), mix.get("dtype", "W8A8"),
                       mix.get("fence", True))[0]
    differing = 0
    for tel, rec in zip(telemetry, records):
        want = sim.decode_speedup(ref_dec, tel["batch"])
        differing += (tel["speedup"] != want["speedup"]
                      or rec["batch"] != tel["batch"]
                      or rec["speedup"] != want["speedup"]
                      or rec["offloaded"] != len(want["offloaded"]))
    differing += abs(len(telemetry) - len(records))
    r.check("telemetry_steps_differing", differing, 0)

    longest = max(range(len(done)), key=lambda i: len(done[i].out),
                  default=None)
    pick = set(generator.sample(r.seed, 5, len(done),
                                mix["check_requests"] - 1))
    if longest is not None:
        pick.add(longest)
    gap, served = (0.0 if pick else float("inf")), 0
    r.weights = params
    for i in sorted(pick):
        q = done[i]
        r.judged.append((q.prompt.tolist(), list(q.out)))
        g = ref_model.served_gaps(c, params, q.prompt.tolist(), q.out)
        gap = max(gap, float(g.max()))
        served += len(q.out)
    r.obs["tokens_compared"] = served
    r.check("served_logit_gap", gap, LOGIT_GAP_LIMIT)
