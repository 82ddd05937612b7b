#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):

1. The card (``nvidia-smi``) and the kernel build (``nvcc`` from the
   sources under ``src/repro_torch/kernels/csrc``), with the registers
   and spills ptxas reports for the lane-scan kernel (one per bank
   count), the tensor-core fp and int GEMM kernels and the int GEMV's
   vector kernel (one per format and rows per warp).
2. The lane-scan kernel against its plain torch version on the card:
   fuzzed lanes at every instantiated bank count (ragged lengths,
   out-of-range opcodes and banks, wrapping timings), the probe lane,
   totals-only launches, and the PIM streams of one Fig-4 point.  Issue
   arrays and totals must be bit-equal.
3. The reference's numbers at full width: ``tests/golden/fleet_parity.json``
   and ``tests/golden/torch_port_points.json`` (the quickstart points and
   the granite-8b W8A8 offload plan, computed by the JAX package) must
   come out exactly.
4. The main path, with the lane LRU cold and the launch count at 0: the
   quickstart flow, the full Fig-4 sweep (7 dtypes, both axes) and the
   granite-8b ``decode_speedup(batch=1)``.  Each part's wall time ends in
   ``torch.cuda.synchronize()`` and is split into host planning
   (``plan_many``), packing and the host-to-card copy, the lane-scan
   kernel (CUDA events), the read-back, and the rest of the host's work.
5. The kernel's time at the main path's own launches, beside its bound.
6. The four PIM-tile GEMV/GEMM kernels against their plain torch
   versions on the card, on the operands ``pim_linear`` hands them:
   fuzzed and ragged shapes, all 7 dtypes, batch 1 (GEMV) and 1, 3, 8,
   9 (GEMM); int4 nibbles and int8/int16 extremes, the int32-wraparound
   cases (one through each GEMM variant's own accumulators), fp8 NaN
   and saturation, misaligned views (the byte-wise path), the
   tensor-core GEMMs' tile edges (batch 2, 7, 17; rows past a 16-row
   tile; widths ending inside a warp's span), and the int GEMV's vector
   kernel at the edges of its warps' row groups (H = 1, R +- 1, 15, 17,
   1024, 1025 and around the least H that takes the large-H R; widths up
   to 14336; each shape's variant asserted) and a W4A16 sum that wraps.
   Int outputs must be bit-equal; fp outputs within
   ``2 W 2**-24 sum|w x|`` per output, the bound of an f32 sum.
7. ``granite_8b_linear``, the quantized-linear path at full width, with
   the kernels' launch counts at 0: one granite-8b layer plus
   ``lm_head`` (8 sites), each weight prepared on the card for all 7
   dtypes and run at batch 1 and 8, must reproduce
   ``tests/golden/torch_pim_linear.json`` (computed by the JAX package).
   Every GEMM there must take the tensor-core variant and every int
   GEMV a vector one.  Then the int GEMV at all 40 site x format
   launches, each beside its bound, and the sum over them of time -
   bound; the tensor-core int GEMM on ``lm_head``'s GEMV operands as a
   batch of one, beside the GEMV; each kernel's time at ``lm_head``,
   beside its bound, its plain version and, where one exists, one
   PyTorch call of the same function; and the int GEMM at W8A8, batch 16
   (two N tiles), beside ``_int_mm``.
8. Serving without a model, with the lane LRU cold and the lane-scan
   launch count at 0, on one full-width granite-8b ``OffloadPlanner``:
   the serving goldens (``serve_trace``, ``disagg_trace``,
   ``spec_decode_trace``) re-derived exactly — scheduling by the
   model-free mirrors, ``controller`` report and ``per_step`` records by
   ``run_policy_over_trace``; every scenario x policy with the policy
   battery's assertions; ``plan_draft`` / ``touch_draft`` /
   ``spec_decode_speedup``; then every registry arch planned at full
   width (the LRU cleared between archs), and the port's ``RefEngine``
   on every lane of those plans up to 100,000 commands, whose issue
   arrays and totals must equal the kernel's.  Each part prints its wall
   beside the card's name and power limit.
9. Serving with a model (float32; TF32 must be off), each part's wall
   beside the card's name and power limit:
   ``model_logits``, granite-8b at its published widths cut to 2 layers,
   weights redrawn with numpy from the fixture's seed, must reproduce
   ``tests/golden/torch_model_logits.json`` (the JAX package's prefill +
   4 ragged greedy decode steps) within 1e-4 x max|logit| with equal
   greedy tokens; ``serve_full``, the 36-layer granite-8b (33 GB of f32
   weights drawn on the card) with a cold full-width planner, must
   replay ``serve_trace.json`` and ``spec_decode_trace.json`` exactly
   (lane-scan launches counted from 0), serve three requests together as
   each alone, and agree with ``forward``; then prefill and decode-step
   times beside the decode step's bytes bound; ``launcher_warm``, the
   serve launcher in fresh processes, cold then warm from one cache
   directory (zero misses warm) and once in its monolithic mode;
   ``archs_smoke``, every arch's smoke config on the card == on the CPU,
   in float32 and served quantized (W8, W4, W8 with the int8 KV cache:
   the quantized leaves bit-equal, the int8 KV entries bit-equal to the
   CPU's quantizer of the card's own float keys and values).
10. The rest of serving, on the 36-layer f32 granite-8b drawn on the
   card again, the lane-scan launch count at 0, each part's wall beside
   the card's name and power limit: ``disagg_golden``, the disaggregated
   cells with per-cell backend scopes and a cold full-width granite-8b
   planner, then ``replay_trace``, must reproduce
   ``tests/golden/disagg_trace.json``; ``chaos_golden``, the golden's
   seeded incident (faults at ``backend.scan`` and the planner, poison,
   scrub, four eviction storms with forced re-plans, handoff pressure,
   shedding) on a fresh full-width mamba2-130m planner, must reproduce
   ``tests/golden/chaos_trace.json`` with its chaos record; ``daemon``,
   ``ServeDaemon`` in scenario mode must give
   ``run_scenario(disagg=, autoscale=)``'s trace, and a drain under
   handoff and ``backend.scan`` faults must end with nothing in flight
   and no exception; ``launcher_daemon``, ``python -m
   repro_torch.launch.serve --daemon --autoscale --chaos --trace-out F
   --quick``, whose streamed trace must load.

11. The dry-run's PIM report and training (``pim_report``,
   ``pim_report_all``, ``train_fixture``, ``train_full``, ``train_smoke``,
   ``launcher_train``).
12. The lane mesh and the dry-run's cell lowering, each part's wall
   beside the card's name and power limit: ``lowering``, six cells
   traced by ``python -m repro_torch.launch.dryrun --shape`` in parallel
   processes (granite-8b's three shapes on pod1, its ``train_4k`` on
   pod2, dbrx-132b ``decode_32k`` on pod1 and granite-8b ``decode_32k``
   under ``--variant serve-tp-w4-kv8``; fake tensors on the card's
   device type over a fake 512-rank group), each record ``ok`` and
   printed with its roofline terms at the H100's spec figures;
   ``lane_mesh``, granite-8b's report (``tests/golden/
   torch_pim_report.json``) over a lane mesh of four shards of the card
   (at least one lane-scan launch a shard), then again with a persistent
   ``backend.mesh`` fault that must step down to ``backend.scan`` with
   the report unchanged, then ``dryrun --pim --mesh 4`` in a fresh
   process; ``serve_mesh``, ``serve_trace.json`` replayed through the
   36-layer granite-8b with ``mesh=4``.

Times (phases 2, 5 and 7) follow one protocol, :func:`timed_ms`: L2
flushed before every launch, one pair of CUDA events per launch, the
median, min and max over many launches (100 for the PIM-tile kernels,
5 for each lane-scan launch, which runs for up to 0.1 s), a kernel and its
library call timed in turns.

The second-to-last line is the ``kernels`` JSON record (all five
kernels; the lane scan's launches are phases 4 and 8-12's); the last is
``{"ok": true, "device": {...}}``.
"""
import gc
import hashlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
# H100 SXM dense tensor-core peaks: int8 and fp8, and bf16 (an int16
# activation counts as two int8 halves, so A16 paths take the bf16 rate).
PEAK_OPS_8BIT = 1979e12
PEAK_OPS_16BIT = 989e12
CHAIN_CYCLES_PER_STEP = 32         # 8 dependent int ops x ~4 cycles
L2_FLUSH_BYTES = 128 << 20         # written before each timed launch
HOST_COVER_CYCLES = 400_000        # device sleep before each: ~0.2 ms
KERNEL_REPS = 100                  # timed launches per PIM-tile kernel
LANE_REPS = 5                      # per lane-scan launch (each <= 0.1 s)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def site_inputs(seed: int, index: int, h: int, w: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Inputs of one site of ``tests/golden/torch_pim_linear.json``
    (float32): weights ``(h, w)`` drawn N(0, 1) x 0.02 and activations
    ``(8, w)`` drawn N(0, 1); batch 1 takes row 0 as a 1-D ``x``."""
    wts = (np.random.default_rng([seed, index])
           .standard_normal((h, w), dtype=np.float32) * np.float32(0.02))
    acts = np.random.default_rng([seed, index, 1]).standard_normal(
        (8, w), dtype=np.float32)
    return wts, acts


def sample_index(n: int, k: int = 64) -> np.ndarray:
    """``k`` evenly strided flat positions of an output of ``n`` values."""
    return np.unique(np.linspace(0, n - 1, k).round().astype(np.int64))


def fixture_mismatch(entry: dict, y: np.ndarray, rel_tol: float):
    """Why the float32 output ``y`` does not reproduce one entry of
    ``torch_pim_linear.json`` (a message), or None when it does.

    Int entries pin the sha256 of the output's bytes.  Fp entries pin a
    strided sample, the sum and the largest magnitude, each within
    ``rel_tol`` times the matching sum of |w * x| (float32 sums taken in
    another order differ by far less; a wrong or missing product by
    more)."""
    y = np.ascontiguousarray(y, dtype=np.float32)
    if "sha256" in entry:
        got = hashlib.sha256(y.tobytes()).hexdigest()
        return (None if got == entry["sha256"]
                else f"sha256 {got[:16]} != {entry['sha256'][:16]}")
    flat = y.reshape(-1).astype(np.float64)
    idx = np.asarray(entry["idx"])
    off = np.abs(flat[idx] - np.asarray(entry["y"]))
    lim = rel_tol * np.asarray(entry["abs_sum"])
    if not (off <= lim).all():
        k = int(np.argmax(np.where(off <= lim, -np.inf, off / lim)))
        return (f"output {int(idx[k])}: {flat[idx[k]]!r} vs "
                f"{entry['y'][k]!r} (limit {lim[k]:.3g})")
    if not abs(flat.sum() - entry["sum"]) <= rel_tol * entry["total_abs"]:
        return f"sum {flat.sum()!r} vs {entry['sum']!r}"
    if not (abs(np.abs(flat).max() - entry["max_abs"])
            <= rel_tol * entry["max_abs_sum"]):
        return f"max |y| {np.abs(flat).max()!r} vs {entry['max_abs']!r}"
    return None


def serve_greedy(M, cfg, params, prompts, steps: int, max_seq: int, dev
                 ) -> list[np.ndarray]:
    """The procedure of ``tests/golden/torch_model_logits.json``, on the
    port's model module ``M``: each prompt prefilled alone into a
    one-slot float32 cache and merged into row r of a batched cache, then
    ``steps`` greedy ``decode_step``s at batch ``len(prompts)``, each row
    at its own position.  Returns the (B, vocab) float32 logits of the
    prefills and of every step."""
    from repro_torch.serving.engine import merge_slot

    cache = M.init_cache(cfg, len(prompts), max_seq, torch.float32,
                         device=dev)
    rows = []
    for r, prompt in enumerate(prompts):
        one = M.init_cache(cfg, 1, max_seq, torch.float32, device=dev)
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        logits, one = M.prefill(cfg, params, {"tokens": toks}, one)
        merge_slot(cache, one, r)
        rows.append(logits[0])
    out = [torch.stack(rows)]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=dev)
    for _ in range(steps):
        tok = out[-1].argmax(dim=-1).to(torch.int32)[:, None]
        logits, cache = M.decode_step(cfg, params, cache, tok, pos)
        out.append(logits)
        pos = pos + 1
    return [o.float().cpu().numpy() for o in out]


def logit_records(steps: list, seed: int, k: int = 64) -> list[dict]:
    """Per step: the greedy tokens, max |logit| and, per row, ``k``
    (index, value) samples: the greedy token's and ``k - 1`` drawn from
    ``np.random.default_rng([seed, step, row])``."""
    out = []
    for s, logits in enumerate(steps):
        logits = np.asarray(logits, np.float32)
        toks = logits.argmax(axis=-1)
        idx, val = [], []
        for r in range(logits.shape[0]):
            pick = np.random.default_rng([seed, s, r]).choice(
                logits.shape[1], size=k - 1, replace=False)
            ii = [int(toks[r])] + [int(i) for i in pick]
            idx.append(ii)
            val.append([float(logits[r, i]) for i in ii])
        out.append(dict(tokens=[int(t) for t in toks],
                        max_abs=float(np.abs(logits).max()),
                        idx=idx, val=val))
    return out


def logits_mismatch(fixture_steps: list, steps: list, rel_tol: float
                    ) -> tuple[str | None, float]:
    """Why ``steps`` (per step, (B, vocab) logits) do not reproduce the
    fixture's records, or None; and the largest error over the recorded
    logits relative to its step's max |logit|."""
    worst = 0.0
    for s, (rec, logits) in enumerate(zip(fixture_steps, steps)):
        tol = rel_tol * rec["max_abs"]
        for r, (ii, vv) in enumerate(zip(rec["idx"], rec["val"])):
            err = np.abs(logits[r, ii].astype(np.float64) - np.asarray(vv))
            worst = max(worst, float(err.max()) / rec["max_abs"])
            if not (err <= tol).all():
                k = int(err.argmax())
                return (f"step {s} row {r} logit {ii[k]}: "
                        f"{logits[r, ii[k]]!r} vs {vv[k]!r} (limit "
                        f"{tol:.3g})", worst)
        got = [int(t) for t in logits.argmax(axis=-1)]
        if got != rec["tokens"]:
            return f"step {s}: greedy tokens {got} != {rec['tokens']}", worst
    if len(steps) != len(fixture_steps):
        return f"{len(steps)} steps != {len(fixture_steps)}", worst
    return None, worst


def train_state_records(named: list, k: int = 64) -> dict:
    """For each ``(name, array)`` leaf of params, m and v: its float64
    sum, sum of |x|, max |x| and ``k`` strided entries."""
    out = {}
    for name, arr in named:
        flat = np.asarray(arr, np.float32).reshape(-1)
        idx = sample_index(flat.size, k)
        mag = np.abs(flat)
        out[name] = dict(sum=float(flat.sum(dtype=np.float64)),
                         abs_sum=float(mag.sum(dtype=np.float64)),
                         max_abs=float(mag.max()), idx=idx.tolist(),
                         val=[float(v) for v in flat[idx]])
    return out


def port_train_run(fx: dict, cfg, params, dev) -> dict:
    """The procedure of ``tests/golden/torch_train_steps.json`` on the
    port: a ``Trainer`` on ``fx["train"]``'s settings from ``params`` (a
    tree of tensors on ``dev``, updated in place) takes ``fx["steps"]``
    steps on ``SyntheticLM(vocab, seed=0)`` batches.  Returns each
    step's loss and lr and :func:`train_state_records` of params, m and
    v after the last step (checkpoint leaf names)."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.training.grad_compress import CompressionConfig
    from repro_torch.training.optimizer import (cosine_schedule,
                                                tree_flatten_with_path)
    from repro_torch.training.trainer import TrainConfig, Trainer

    tr = dict(fx["train"])
    tcfg = TrainConfig(compression=CompressionConfig(tr.pop("compression")),
                       ckpt_every=1 << 30, **tr)
    trainer = Trainer(cfg, tcfg, params=params)
    src = SyntheticLM(cfg.vocab, seed=0)

    def batches():
        for step in range(fx["steps"]):
            yield to_device(src.batch(step, fx["batch"], fx["seq"]), dev)

    hist = trainer.train(batches(), fx["steps"], log_every=1 << 30)
    named = [("__".join(path), leaf.cpu().numpy())
             for path, leaf in tree_flatten_with_path(
                 (trainer.params, trainer.opt)) if path[-1] != ".step"]
    lrs = [float(cosine_schedule(s, tcfg.lr, tcfg.warmup,
                                 tcfg.total_steps))
           for s in range(fx["steps"])]
    return dict(losses=[h["loss"] for h in hist], lrs=lrs,
                leaves=train_state_records(named))


def train_mismatch(fx: dict, got: dict) -> tuple[str | None, dict]:
    """Why a run's records (:func:`port_train_run`) do not hold to the
    fixture's within its tolerances ``fx["tol"]``, or None; and the
    largest distance of each kind as a share of its limit.

    Losses within ``loss_rel`` of the fixture's; every leaf's sum and sum
    of |x| within ``sum_rel`` x its sum of |x|; sampled params within
    ``param_lrs`` x the sum of the steps' lrs (Adam moves an entry whose
    grad is at float32 noise level by up to 2 lr a step, either way);
    sampled m and v within ``moment_rel`` x the leaf's max |x|."""
    tol, want = fx["tol"], fx["records"]
    worst = dict.fromkeys(("loss", "sum", "param", "moment"), 0.0)

    def over(kind, err, lim):
        worst[kind] = max(worst[kind], float(np.max(err / lim)))
        return not bool(np.all(err <= lim))

    for s, (w, g) in enumerate(zip(want["losses"], got["losses"])):
        if over("loss", abs(g - w), tol["loss_rel"] * abs(w)):
            return f"step {s + 1} loss {g!r} vs {w!r}", worst
    if len(got["losses"]) != len(want["losses"]):
        return f"{len(got['losses'])} steps", worst
    if not np.allclose(got["lrs"], want["lrs"], rtol=1e-6, atol=0):
        return f"lrs {got['lrs']} vs {want['lrs']}", worst
    if sorted(got["leaves"]) != sorted(want["leaves"]):
        return "leaf names differ", worst
    lr_sum = float(sum(want["lrs"]))
    for name, w in want["leaves"].items():
        g = got["leaves"][name]
        lim = tol["sum_rel"] * w["abs_sum"]
        if (over("sum", abs(g["sum"] - w["sum"]), lim)
                or over("sum", abs(g["abs_sum"] - w["abs_sum"]), lim)):
            return (f"{name}: sum {g['sum']!r} / {g['abs_sum']!r} vs "
                    f"{w['sum']!r} / {w['abs_sum']!r}"), worst
        err = np.abs(np.asarray(g["val"]) - np.asarray(w["val"]))
        kind = "param" if name.startswith("0__") else "moment"
        lim = (tol["param_lrs"] * lr_sum if kind == "param"
               else tol["moment_rel"] * max(w["max_abs"], 1e-30))
        if over(kind, err, lim):
            k = int(err.argmax())
            return (f"{name}[{w['idx'][k]}]: {g['val'][k]!r} vs "
                    f"{w['val'][k]!r} (limit {lim:.3g})"), worst
    return None, worst


def smoke_batch(cfg, rng, b: int = 2, s: int = 32) -> dict:
    """``tests/test_models_smoke.py::_smoke_batch``'s inputs as float32 /
    int32 numpy arrays (labels drawn, to keep the draws in step, and
    dropped): embeddings for embedding models, token ids (and patches
    for prefix-patch models) otherwise."""
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                           .astype(np.float32) * np.float32(0.1))
        rng.integers(0, cfg.vocab, (b, s))
    else:
        toks = s - cfg.prefix_patches
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, toks)).astype(
            np.int32)
        rng.integers(0, cfg.vocab, (b, toks))
        if cfg.prefix_patches:
            batch["patches"] = (rng.standard_normal(
                (b, cfg.prefix_patches, cfg.d_model)).astype(np.float32)
                * np.float32(0.1))
    return batch


def paired_steps(M, cfg, cpu, card, batch: dict, dev, steps: int = 4,
                 sync: bool = False) -> list[tuple[list, dict]]:
    """``forward`` of ``batch``, then ``prefill`` of all but its last 4
    inputs and ``steps`` greedy ``decode_step``s at batch 2, row 1 two
    positions behind row 0: with the weights ``cpu`` on the CPU and
    ``card`` on ``dev``, in lockstep, each side decoding its own greedy
    tokens.  Embedding models decode seeded random frame embeddings.
    ``sync`` starts each of the card's decode steps from the CPU's cache:
    the int8 KV cache turns a float rounding difference that crosses a
    rounding tie into a whole int8 step.  Per side (CPU, card): the
    float32 logits of each call, and the cache after the prefill as
    numpy arrays."""
    from repro_torch.models.convert import params_from_numpy, params_to_numpy

    key = "embeds" if "embeds" in batch else "tokens"
    n_in = batch[key].shape[1]
    start = cfg.prefix_patches + n_in - 4
    sides = []
    for params, d in ((cpu, torch.device("cpu")), (card, dev)):
        tb = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
        fwd, _ = M.forward(cfg, params, tb)
        cache = M.init_cache(cfg, 2, start + 12, torch.float32, device=d)
        last, cache = M.prefill(cfg, params,
                                dict(tb, **{key: tb[key][:, :-4]}), cache)
        sides.append(dict(params=params, dev=d, cache=cache,
                          out=[fwd, last], prefilled=params_to_numpy(cache)))
    rng = np.random.default_rng(7)
    for j in range(steps):
        pos = np.array([start + j, start - 2 + j], np.int32)
        frames = ((rng.standard_normal((2, 1, cfg.d_model)) * 0.1)
                  .astype(np.float32) if cfg.input_mode == "embeddings"
                  else None)
        if sync:
            sides[1]["cache"] = params_from_numpy(
                params_to_numpy(sides[0]["cache"]), dev)
        for side in sides:
            d = side["dev"]
            tok = (torch.as_tensor(frames, device=d) if frames is not None
                   else side["out"][-1].argmax(dim=-1).to(torch.int32)[:, None])
            logits, side["cache"] = M.decode_step(
                cfg, side["params"], side["cache"], tok,
                torch.as_tensor(pos, device=d))
            side["out"].append(logits)
    return [([o.float().cpu().numpy() for o in side["out"]], side["prefilled"])
            for side in sides]


def steps_mismatch(want: list, got: list, rel_tol: float,
                   greedy: bool = True) -> tuple[str | None, float]:
    """Why the two sides of :func:`paired_steps` differ (every logit within
    ``rel_tol`` x its step's max |logit|, greedy tokens equal), or None;
    and the largest error relative to its step's max |logit|."""
    worst = 0.0
    for s, (w, g) in enumerate(zip(want, got)):
        scale = float(np.abs(w).max())
        err = float(np.abs(w.astype(np.float64) - g).max())
        worst = max(worst, err / scale)
        if not err <= rel_tol * scale:
            return f"step {s}: max error {err!r} of max |logit| {scale!r}", \
                worst
        if greedy and not np.array_equal(w.argmax(-1), g.argmax(-1)):
            return f"step {s}: greedy tokens differ", worst
    return None, worst


QUANT_CASES = ((8, False), (4, False), (8, True))   # (weight bits, int8 KV)


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def quantized_mismatch(M, cfg, cpu, card, batch: dict, dev, bits: int,
                       kv_quant: bool) -> tuple[str | None, float]:
    """``quantize_for_serving(bits)`` served with ``M.QUANT_BITS = bits``
    (and ``M.KV_QUANT`` when ``kv_quant``), the card against the CPU;
    ``cpu`` and ``card`` hold the same weights.  Every leaf of the
    quantized tree, ``q`` and ``s`` included, bit-equal; the logits of
    :func:`paired_steps` within 1e-4 x their step's max |logit| with
    greedy tokens equal (with the int8 KV cache, each card decode step
    starts from the CPU's cache); the card's int8 KV entries and scales
    after the prefill bit-equal to the CPU's quantizer applied to the
    card's own float32 keys and values.  Why not (a message) or None,
    and the largest logit error relative to its step's max |logit|."""
    qc = M.quantize_for_serving(cpu, bits)
    qd = M.quantize_for_serving(card, bits)
    for (path, a), (_, b) in zip(_items(qc), _items(qd)):
        if not bits_equal(a.numpy(), b.cpu().numpy()):
            return f"W{bits}: leaf {'/'.join(path)} not bit-equal", 0.0
    M.QUANT_BITS = bits
    try:
        (want, _), (got, floats) = paired_steps(M, cfg, qc, qd, batch, dev)
        if kv_quant:
            M.KV_QUANT = True
            (want, _), (got, int8) = paired_steps(M, cfg, qc, qd, batch,
                                                  dev, sync=True)
    finally:
        M.QUANT_BITS, M.KV_QUANT = 0, False
    msg, worst = steps_mismatch(want, got, 1e-4)
    if msg is None and kv_quant and "kv" in floats:
        for i, name in enumerate(("keys", "values")):
            x = torch.from_numpy(floats["kv"][i])      # (L, B, S, H, D)
            for layer in range(x.shape[0]):
                sc = M.kv_quant_scale(x[layer])
                if not (bits_equal(sc.numpy(), int8["kv_scale"][i][layer])
                        and bits_equal(M.kv_quant(x[layer], sc).numpy(),
                                       int8["kv"][i][layer])):
                    msg = (f"layer {layer}'s int8 {name} on the card != "
                           f"the CPU's quantizer of the card's floats")
                    break
    return (None if msg is None else f"W{bits} kv_quant={kv_quant}: {msg}",
            worst)


def kv_quant_mismatch(M, dev) -> str | None:
    """The int8 KV cache's quantizer (``kv_quant_scale``, ``kv_quant``)
    on the card against the CPU on the same float32 keys, half-way
    values and all-zero heads included: scales and entries bit-equal,
    or why not."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 40, 4, 64)).astype(np.float32)
    x[1, :, 2] = 0.0                                  # an all-zero head
    x[2, 0, :, 0] = 127.0                             # scale exactly 1
    x[2, 1:, :, :] = (rng.integers(-127, 127, (39, 4, 64)) + 0.5)
    cpu = torch.from_numpy(x)
    card = cpu.to(dev)
    sc, sd = M.kv_quant_scale(cpu), M.kv_quant_scale(card)
    if not bits_equal(sc.numpy(), sd.cpu().numpy()):
        return "kv_quant_scale: card != CPU"
    if not bits_equal(M.kv_quant(cpu, sc).numpy(),
                      M.kv_quant(card, sd).cpu().numpy()):
        return "kv_quant: card != CPU"
    return None


def run_launcher(args: list[str], timeout: int = 600) -> tuple[str, float]:
    """``python -m repro_torch.launch.serve ARGS``: see :func:`run_module`."""
    return run_module(["repro_torch.launch.serve", *args], timeout=timeout)


def lane_cache_row(out: str) -> dict:
    """The launcher's ``serve/lane_cache,hits=..,misses=..,size=..`` row."""
    row = re.search(r"^serve/lane_cache,(.*)$", out, re.M)
    check(row is not None, f"no serve/lane_cache row in:\n{out}")
    return {k: int(v) for k, v in
            (kv.split("=") for kv in row.group(1).split(","))}


# The PIM-tile kernels: wrapper name -> (the TPU kernel it replaces, source).
PIM_KERNELS = {
    "pim_gemv_int": ("src/repro/kernels/pim_gemv.py:37",
                     "src/repro_torch/kernels/csrc/pim_gemv.cu"),
    "pim_gemv_fp": ("src/repro/kernels/pim_gemv.py:63",
                    "src/repro_torch/kernels/csrc/pim_gemv.cu"),
    "pim_gemm_int": ("src/repro/kernels/pim_gemm.py:22",
                     "src/repro_torch/kernels/csrc/pim_gemm.cu"),
    "pim_gemm_fp": ("src/repro/kernels/pim_gemm.py:46",
                    "src/repro_torch/kernels/csrc/pim_gemm.cu"),
}


def patch_pim_kernels(mods: dict, on_call) -> dict:
    """Route every call of the four wrappers (as ``pim_linear`` makes
    them) through ``on_call(name, out, args, kw)`` after the real call;
    returns the real wrappers, for :func:`restore_pim_kernels`."""
    real = {name: getattr(mod, name) for name, mod in mods.items()}
    for name, mod in mods.items():
        def call(*args, _name=name, **kw):
            out = real[_name](*args, **kw)
            on_call(_name, out, args, kw)
            return out
        setattr(mod, name, call)
    return real


def restore_pim_kernels(mods: dict, real: dict) -> None:
    for name, mod in mods.items():
        setattr(mod, name, real[name])


def pim_error(name: str, out: torch.Tensor, want: torch.Tensor,
              args: tuple) -> float:
    """Hold a kernel's output to its plain version's; the largest finite
    difference.  Int: bit-equal.  Fp: NaN in the same places, and every
    other output within ``2 W 2**-24 sum|w x|`` (two float32 sums of the
    same exact products, in different orders)."""
    if name.endswith("_int"):
        check(torch.equal(out, want),
              f"{name} != plain on {tuple(args[0].shape)} x "
              f"{tuple(args[1].shape)} {args[1].dtype}")
        return 0.0
    w8, x = args[0], args[1]
    wa, xa = w8.float().abs(), x.float().abs()
    lim = 2 * w8.shape[1] * 2.0 ** -24 * (wa @ xa if x.dim() == 1
                                          else xa @ wa.T)
    nan = want.isnan()
    check(torch.equal(out.isnan(), nan),
          f"{name}: NaN positions differ from plain")
    diff = (out - want).abs()
    ok = (out == want) | (diff <= lim) | nan
    check(bool(ok.all()), f"{name}: {int((~ok).sum())} outputs off plain "
          f"beyond the f32 sum bound on {tuple(w8.shape)} x "
          f"{tuple(x.shape)} {x.dtype}")
    finite = torch.isfinite(want)
    return float(diff[finite].max()) if bool(finite.any()) else 0.0


_FLUSH: list = []


def timed_ms(fns: dict, reps: int) -> dict:
    """Device time of each callable in ``fns``, taken in turns, with L2
    cold: before every launch a buffer of ``L2_FLUSH_BYTES`` (above the
    card's 50 MB L2) is written and then another of half that size is
    read, so L2 holds none of the operands and no dirty lines whose
    write-back the timed launch would pay for.  A device-side sleep then
    keeps the card busy while the host records the start event and
    enqueues the launch, so host work in a wrapper never lands between a
    launch's own pair of CUDA events.  Returns, per name, the median, min
    and max over ``reps`` launches."""
    if not _FLUSH:
        _FLUSH.extend([
            torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"),
            torch.zeros(L2_FLUSH_BYTES // 2, dtype=torch.uint8,
                        device="cuda")])
    for fn in fns.values():                         # warm-up
        fn()
    torch.cuda.synchronize()
    pairs = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            _FLUSH[0].zero_()
            _FLUSH[1].max()
            torch.cuda._sleep(HOST_COVER_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs[name].append((start, end))
    torch.cuda.synchronize()
    out = {}
    for name, ev in pairs.items():
        t = sorted(a.elapsed_time(b) for a, b in ev)
        out[name] = dict(ms=t[len(t) // 2] if len(t) % 2
                         else (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2,
                         min_ms=t[0], max_ms=t[-1], launches=len(t))
    return out


def ptxas_kernels(log: str, pattern: str) -> list[dict]:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for
    each entry function whose mangled name matches ``pattern``."""
    found = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if not re.search(pattern, name):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        args = re.findall(r"ILi(\d+)E|Li(\d+)E", name)
        found.append(dict(
            name=re.search(pattern, name).group(0) + "<" + ",".join(
                a or b for a, b in args) + ">",
            registers=int(regs.group(1)) if regs else None,
            spill_bytes=(int(spill.group(1)) + int(spill.group(2))
                         if spill else None)))
    return found


def pim_kernels_vs_plain(dev, mods: dict, plain: dict) -> dict:
    """Phase 6: the four kernels against their plain versions on the
    card; returns each kernel's largest difference."""
    from repro_torch.kernels import ops, pim_gemm, pim_gemv, ref
    from repro_torch.pimkernel.tileconfig import ALL_DTYPES

    worst = {name: 0.0 for name in mods}
    held = {name: 0 for name in mods}

    def hold(name, out, args, kw):
        want = plain[name](*args, **kw)
        worst[name] = max(worst[name], pim_error(name, out, want, args))
        held[name] += 1

    real = patch_pim_kernels(mods, hold)
    rng = np.random.default_rng(6)
    dev_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # Fuzzed and ragged shapes through pim_linear, all dtypes: row bytes
    # that are and are not multiples of 16 (vector and byte-wise paths).
    for h, w in ((1, 32), (7, 16), (130, 258), (37, 1000), (256, 4096),
                 (1023, 2050), (64, 4128), (300, 96)):
        wf = rng.standard_normal((h, w)) * rng.uniform(0.01, 3.0)
        xf = rng.standard_normal((9, w)) * rng.uniform(0.1, 10.0)
        xf[2, ::97] *= 60.0        # one row with outliers: fp8 NaN there
        wd, xd = dev_t(wf.astype(np.float32)), dev_t(xf.astype(np.float32))
        for dtype in ALL_DTYPES:
            qw = ops.prepare_weights(wd, dtype, device=dev)
            ops.pim_linear(xd[0], qw)
            for b in (1, 3, 8, 9):
                ops.pim_linear(xd[:b], qw)

    # Every int4 nibble / int8 byte in every row, against int8 and int16
    # extremes; then the same operands as misaligned views (byte-wise).
    wq = torch.stack([torch.randperm(256) for _ in range(16)]) - 128
    wq = wq.to(torch.int8).to(dev)
    ws = dev_t(rng.uniform(0.5, 2.0, 16).astype(np.float32))
    for w_bits in (8, 4):
        width = 256 * (2 if w_bits == 4 else 1)
        for xdt, lo, hi in ((np.int8, -128, 128), (np.int16, -32768, 32768)):
            xb = rng.integers(lo, hi, size=(9, width))
            xb[:, :4] = [lo, hi - 1, -1, 0]
            xb = dev_t(xb.astype(xdt))
            for wop, xop in ((wq, xb),
                             (misaligned(wq), misaligned(xb))):
                pim_gemv.pim_gemv_int(wop, xop[0].contiguous(), ws, 0.37,
                                      w_bits=w_bits)
                pim_gemm.pim_gemm_int(wop, xop, ws, 0.37, w_bits=w_bits)
    w8 = ref.to_e4m3fn(dev_t(rng.standard_normal((48, 200))
                             .astype(np.float32)))
    for xdt in (torch.float8_e4m3fn, torch.bfloat16):
        xb = dev_t(rng.standard_normal((5, 200)).astype(np.float32))
        xb = ref.to_e4m3fn(xb) if xdt == torch.float8_e4m3fn else xb.to(xdt)
        pim_gemv.pim_gemv_fp(misaligned(w8), misaligned(xb)[1].contiguous())
        pim_gemm.pim_gemm_fp(misaligned(w8), misaligned(xb))

    # The tensor-core fp GEMM's tile edges: batch rows past 8 and 16,
    # weight rows past each 32-row block, widths that end inside a
    # 128-column span; a +-448 weight row and a NaN activation.
    for b, h, w in ((2, 15, 48), (7, 17, 4128), (17, 130, 4096),
                    (17, 33, 16)):
        wf = rng.standard_normal((h, w)).astype(np.float32) * 4.0
        wf[h // 2] = np.where(np.arange(w) % 2, 448.0, -448.0)
        xf = rng.standard_normal((b, w)).astype(np.float32) * 4.0
        xf[b - 1, w // 3] = np.nan
        w8 = ref.to_e4m3fn(dev_t(wf))
        for xb in (ref.to_e4m3fn(dev_t(xf)), dev_t(xf).to(torch.bfloat16)):
            pim_gemm.pim_gemm_fp(w8, xb)

    # The tensor-core int GEMM's tile edges, every format: rows of
    # -128 / 127 (int4 -8 / 7) weights and every nibble / byte value,
    # activations at the int8 / int16 extremes and the byte planes'
    # edges (-32768, 32767, -1, 0, 255, 256).
    for b, h, w in ((2, 15, 32), (7, 17, 4128), (9, 130, 4096),
                    (17, 33, 64), (17, 16, 4128)):
        for w_bits, a_bits in INT_FORMATS.values():
            wq, xb = int_edge_operands(rng, b, h, w, w_bits, a_bits, dev)
            check(pim_gemm.int_variant(wq, xb) == "mma",
                  f"int GEMM edge {b}x{h}x{w} not on the MMA variant")
            pim_gemm.pim_gemm_int(wq, xb, dev_t(rng.uniform(
                0.5, 2.0, h).astype(np.float32)), 0.37, w_bits=w_bits)

    # The int GEMV's vector kernel at its edges, every format, the same
    # extremes: rows 1, R - 1, R + 1, 15, 17, 1024, 1025 and widths up to
    # mlp.wo's 14336 (R rows per warp for small H), then around the
    # smallest H that takes the large-H R; each shape's variant is
    # asserted.
    for w_bits, a_bits in INT_FORMATS.values():
        x_bytes = 2 if a_bits == 16 else 1
        small, large = pim_gemv.GEMV_INT_ROWS[(w_bits, x_bytes)]
        least = pim_gemv.gemv_int_large_h(w_bits, x_bytes, dev)
        shapes = [(h, w) for h in sorted({1, max(1, small - 1), small + 1,
                                          15, 17, 1024, 1025})
                  for w in (32, 64, 4096, 4128, 14336)]
        shapes += [(h, w) for h in (least - 1, least, least + large + 1)
                   for w in (32, 4128)]
        for h, w in shapes:
            wq, xb = int_edge_operands(rng, 1, h, w, w_bits, a_bits, dev)
            want = f"rows{large if h >= least else small}"
            check(pim_gemv.gemv_int_variant(wq, xb[0], w_bits) == want,
                  f"int GEMV {h}x{w} W{w_bits}A{a_bits} not on {want}")
            pim_gemv.pim_gemv_int(wq, xb[0], dev_t(rng.uniform(
                0.5, 2.0, h).astype(np.float32)), 0.37, w_bits=w_bits)
    # A W4A16 GEMV whose sum wraps: 7 * 32767 * 16384 passes 2^31.
    wq = ref.pack_w4(torch.full((8, 16384), 7, dtype=torch.int8,
                                device=dev))
    xq = torch.full((16384,), 32767, dtype=torch.int16, device=dev)
    ws = torch.linspace(0.5, 1.5, 8, device=dev)
    y = pim_gemv.pim_gemv_int(wq, xq, ws, 1.0, w_bits=4)
    wrapped = 7 * 32767 * 16384 - (1 << 32)
    check(torch.equal(y, torch.tensor(float(wrapped), device=dev) * ws),
          f"int GEMV W4A16 wraparound: {y[:2].tolist()}")

    # The int32 wraparound: 127 * 32767 * 16384 through pim_linear (GEMV
    # and a B = 8 GEMM on the MMA variant, where the byte planes' sums
    # are combined), and W8A8 over 1.5 M columns, where each warp's share
    # passes 2^31 inside the MMA's own s32 accumulators.
    qw = ops.prepare_weights(torch.full((8, 16384), 0.5, device=dev),
                             "W8A16", device=dev)
    x = torch.full((16384,), 3.0, device=dev)
    ws = pim_gemv.row_scale(qw.scale, ref.quantize_acts(x, 16)[1])
    want = torch.tensor(-538951680.0, device=dev) * ws
    xq = ref.quantize_acts(x.expand(8, -1), 16)[0].contiguous()
    check(pim_gemm.int_variant(qw.q, xq) == "mma",
          "the wraparound GEMM is not on the MMA variant")
    for y in (ops.pim_linear(x, qw), ops.pim_linear(x.expand(8, -1), qw)):
        check(torch.equal(y, want.expand_as(y)),
              f"int32 wraparound: {y.reshape(-1)[:2].tolist()}")
    wq = torch.full((16, 3 << 19), 127, dtype=torch.int8, device=dev)
    xq = torch.full((8, 3 << 19), -128, dtype=torch.int8, device=dev)
    y = pim_gemm.pim_gemm_int(wq, xq, torch.ones(16, device=dev), 1.0)
    check(bool((y == float(-127 * 128 * (3 << 19) % (1 << 32))).all()),
          f"int32 wraparound in the MMA accumulators: {y[0, :2].tolist()}")

    # fp8 saturation and NaN: weights at +-448 and past the range,
    # activations at 448, 464 (-> 448), 464.01 and 1000 (-> NaN), inf, NaN.
    wf = rng.standard_normal((40, 64)).astype(np.float32)
    wf[:, 0], wf[3], wf[5, 1] = 448.0, -448.0, 1000.0
    xf = rng.standard_normal((6, 64)).astype(np.float32)
    xf[1, 2], xf[2, 3], xf[3, 4] = 464.0, 464.01, -1000.0
    xf[4, 5], xf[5, 6], xf[1, 7] = np.inf, np.nan, 448.0
    for dtype in ("FP_W8A8", "FP_W8A16"):
        qw = ops.prepare_weights(dev_t(wf), dtype, device=dev)
        ops.pim_linear(dev_t(xf), qw)
        for row in range(6):
            ops.pim_linear(dev_t(xf[row]), qw)
    torch.cuda.synchronize()
    restore_pim_kernels(mods, real)
    check(all(n > 0 for n in held.values()), f"kernels not held: {held}")
    print(f"[6] PIM-tile kernels == plain on the card: {held} calls; "
          f"largest fp difference {max(worst.values()):.3g} (int: exact)")
    return worst


# The int formats: (weight bits, activation bits).
INT_FORMATS = {"W8A8": (8, 8), "W8A16": (8, 16), "W4A8": (4, 8),
               "W4A4": (4, 4), "W4A16": (4, 16)}


def int_edge_operands(rng, b: int, h: int, w: int, w_bits: int,
                      a_bits: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Int weights (H, W[/2]) with a row of -128 / 127 (int4: -8 / 7)
    and a row cycling through every int4 nibble / int8 byte; activations
    (B, W) with the type's extremes, and for int16 the byte planes':
    -32768 (hi -128, lo 0), 32767 (127, 255), -1 (-1, 255), 0, 255 and
    256, at the start of the last row and the end of the first."""
    from repro_torch.kernels import ref

    lo, hi = -2 ** (w_bits - 1), 2 ** (w_bits - 1) - 1
    wq = rng.integers(lo, hi + 1, size=(h, w))
    wq[h // 2] = np.where(np.arange(w) % 2, hi, lo)
    wq[h - 1] = np.arange(w) % (hi - lo + 1) + lo
    wq = torch.from_numpy(wq.astype(np.int8)).to(dev)
    wq = ref.pack_w4(wq) if w_bits == 4 else wq
    alo, ahi = -2 ** (a_bits - 1), 2 ** (a_bits - 1) - 1
    xb = rng.integers(alo, ahi + 1, size=(b, w))
    edge = [alo, ahi, -1, 0] + ([255, 256] if a_bits == 16 else [])
    xb[b - 1, :len(edge)] = edge
    xb[0, -len(edge):] = edge
    xb = xb.astype(np.int16 if a_bits == 16 else np.int8)
    return wq, torch.from_numpy(xb).to(dev)


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the kernels then read it byte by byte)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def granite_8b_linear(dev, mods: dict, plain: dict, fixture: dict) -> dict:
    """Phase 7: one granite-8b layer plus lm_head at full width through
    ``pim_linear`` on the card (launch counts from 0), held to the JAX
    package's fixture; then each kernel's time at lm_head."""
    from repro_torch.configs import granite_8b
    from repro_torch.kernels import ops
    from repro_torch.pimkernel.tileconfig import ALL_DTYPES
    from repro_torch.serving.offload import decode_gemv_sites

    sites = fixture["sites"]
    check([(s.name, s.h, s.w) for s in decode_gemv_sites(granite_8b.CONFIG)]
          == [(s["name"], s["h"], s["w"]) for s in sites],
          "the fixture's sites are not granite-8b's decode GEMV sites")
    heavy: dict = {}
    gemv_calls: dict = {}
    now: dict = {"gemv_calls": False}

    def keep_lm_head(name, out, args, kw):
        if now["gemv_calls"]:
            if name == "pim_gemv_int":
                gemv_calls[(now["site"], now["dtype"])] = (out, args, kw)
        elif now["site"] == "lm_head":
            heavy[(name, now["dtype"])] = (out, args, kw)

    from repro_torch.kernels import pim_gemm, pim_gemv

    real = patch_pim_kernels(mods, keep_lm_head)
    for name, mod in mods.items():
        mod.LAUNCHES[name] = 0
    for counts in (pim_gemm.FP_VARIANT_LAUNCHES,
                   pim_gemm.INT_VARIANT_LAUNCHES,
                   pim_gemv.GEMV_INT_VARIANT_LAUNCHES):
        for variant in counts:
            counts[variant] = 0
    t0 = time.perf_counter()
    for index, site in enumerate(sites):
        wts, acts = site_inputs(fixture["seed"], index, site["h"],
                                site["w"])
        wd, xd = torch.from_numpy(wts).to(dev), torch.from_numpy(acts).to(dev)
        for dtype in ALL_DTYPES:
            now.update(site=site["name"], dtype=dtype.name)
            qw = ops.prepare_weights(wd, dtype, device=dev)
            for b in (1, 8):
                key = f"{site['name']}/{dtype.name}/b{b}"
                y = ops.pim_linear(xd[0] if b == 1 else xd, qw)
                msg = fixture_mismatch(fixture["results"][key],
                                       y.cpu().numpy(), fixture["fp_rel_tol"])
                check(msg is None, f"granite_8b_linear {key}: {msg}")
        del wd, xd, qw
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES[name] for name, mod in mods.items()}
    variants = {"pim_gemm_fp": dict(pim_gemm.FP_VARIANT_LAUNCHES),
                "pim_gemm_int": dict(pim_gemm.INT_VARIANT_LAUNCHES),
                "pim_gemv_int": dict(pim_gemv.GEMV_INT_VARIANT_LAUNCHES)}
    # The int GEMV's operands at every site, made again after the timed
    # pass (which frees each site's before the next) for the site timings.
    now["gemv_calls"] = True
    for index, site in enumerate(sites):
        wts, acts = site_inputs(fixture["seed"], index, site["h"],
                                site["w"])
        wd, xd = torch.from_numpy(wts).to(dev), torch.from_numpy(acts).to(dev)
        for dtype in ALL_DTYPES:
            if not dtype.is_fp:
                now.update(site=site["name"], dtype=dtype.name)
                ops.pim_linear(xd[0], ops.prepare_weights(wd, dtype,
                                                          device=dev))
    restore_pim_kernels(mods, real)
    check(all(n > 0 for n in launches.values()),
          f"granite_8b_linear did not launch every kernel: {launches}")
    for name in ("pim_gemm_fp", "pim_gemm_int"):
        check(variants[name] == {"mma": launches[name], "bytes": 0},
              f"full-width {name} calls did not all take the tensor-core "
              f"kernel: {variants[name]}")
    gv = variants["pim_gemv_int"]
    check(gv["bytes"] == 0 and sum(gv.values())
          == launches["pim_gemv_int"] == len(gemv_calls),
          f"full-width pim_gemv_int calls did not all take a vector "
          f"variant: {gv}")
    print(f"[7] granite_8b_linear: {len(fixture['results'])} outputs "
          f"reproduce torch_pim_linear.json; {wall:.2f} s wall, launches "
          f"{launches}; GEMM variants {variants}")

    sites = gemv_int_sites(
        real["pim_gemv_int"], gemv_calls,
        lambda args, kw: pim_gemv.gemv_int_variant(args[0], args[1],
                                                   kw["w_bits"]))
    mma_b1 = mma_at_batch_1(real["pim_gemv_int"], gemv_calls)
    # The protocol's floor: a 1 x 32 W8A8 GEMV, whose bytes take
    # nanoseconds (x_scale on the card, as pim_linear gives it).
    args = (torch.ones((1, 32), dtype=torch.int8, device=dev),
            torch.ones(32, dtype=torch.int8, device=dev),
            torch.ones(1, device=dev), torch.ones((), device=dev))
    floor = timed_ms({"kernel": lambda: real["pim_gemv_int"](*args)},
                     KERNEL_REPS)["kernel"]
    print(f"[7] pim_gemv_int floor, 1 x 32 W8A8: {json.dumps(floor)}")
    sites["floor"] = floor
    timed = {}
    for (name, dtype), (out, args, kw) in sorted(heavy.items()):
        timed[(name, dtype)] = time_kernel(name, dtype, real[name],
                                           plain[name], out, args, kw)
    # The int GEMM at batch 16 (two N tiles per pass): lm_head's W8A8
    # operands with 8 more activation rows.
    out, args, kw = heavy[("pim_gemm_int", "W8A8")]
    args = (args[0], torch.cat([args[1], args[1].roll(1, dims=1)]),
            *args[2:])
    out = real["pim_gemm_int"](*args, **kw)
    timed[("pim_gemm_int", "W8A8/b16")] = time_kernel(
        "pim_gemm_int", "W8A8", real["pim_gemm_int"], plain["pim_gemm_int"],
        out, args, kw)
    return dict(wall=wall, launches=launches, variants=variants,
                timed=timed, gemv_int_sites=sites, mma_at_batch_1=mma_b1)


def kernel_bound(out: torch.Tensor, args: tuple) -> tuple[float, str, int]:
    """The least time (ms) the card could take for one PIM-tile call on
    ``args`` giving ``out``: the larger of the bytes it must move (each
    tensor argument read once, the output written once) over the memory
    rate and its 2 B H W operations at the tensor-core peak; what bounds
    it; and the bytes."""
    w_op, x_op = args[0], args[1]
    width = x_op.shape[-1]
    batch = 1 if x_op.dim() == 1 else x_op.shape[0]
    nbytes = out.numel() * 4 + sum(a.numel() * a.element_size()
                                   for a in args
                                   if isinstance(a, torch.Tensor))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_OPS_16BIT if x_op.element_size() == 2 else PEAK_OPS_8BIT
    ops_ms = 2 * batch * w_op.shape[0] * width / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def time_kernel(name: str, dtype: str, kernel, plain, out: torch.Tensor,
                args: tuple, kw: dict) -> dict:
    """One timed row of phase 7: the kernel on ``args`` (median of
    ``KERNEL_REPS``, in turns with its library call), its plain version,
    its bound and its largest difference from plain."""
    w_op, x_op = args[0], args[1]
    batch = 1 if x_op.dim() == 1 else x_op.shape[0]
    err = pim_error(name, out, plain(*args, **kw), args)
    fns = {"kernel": lambda: kernel(*args, **kw)}
    lib = library_call(dtype, w_op, x_op)
    if lib is not None:
        fns["library"] = lib
    t = timed_ms(fns, KERNEL_REPS)          # kernel and library in turns
    plain_t = timed_ms({"plain": lambda: plain(*args, **kw)}, 5)["plain"]
    bound_ms, bound_by, nbytes = kernel_bound(out, args)
    row = dict(
        ms=t["kernel"]["ms"], plain_ms=plain_t["ms"],
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=t["library"]["ms"] if lib else None,
        max_abs_err=err, batch=batch, bytes=nbytes,
        spread={k: [v["min_ms"], v["max_ms"]] for k, v in t.items()},
        launches_timed=KERNEL_REPS)
    print(f"[7] {name} lm_head {dtype} B={batch}: {json.dumps(row)}")
    return row


def gemv_int_sites(kernel, calls: dict, variant_of=None) -> dict:
    """The int GEMV at every site and int format of ``granite_8b_linear``
    (``calls``: (site, dtype) -> the out, args and kw of its call), each
    timed on its own operands (median of ``KERNEL_REPS``, L2 flushed)
    beside its bound; then the sums over those launches, each launched
    once there, of time, bound and time - bound.  ``variant_of(args,
    kw)`` names the kernel variant a call takes, where there are
    variants."""
    rows = {}
    for (site, dtype), (out, args, kw) in calls.items():
        t = timed_ms({"kernel": lambda: kernel(*args, **kw)},
                     KERNEL_REPS)["kernel"]
        bound_ms, bound_by, _ = kernel_bound(out, args)
        row = dict(h=args[0].shape[0], w=args[1].shape[0], ms=t["ms"],
                   spread=[t["min_ms"], t["max_ms"]], bound_ms=bound_ms,
                   bound_by=bound_by, gap_ms=t["ms"] - bound_ms,
                   variant=variant_of(args, kw) if variant_of else None)
        rows[f"{site}/{dtype}"] = row
        print(f"[7] pim_gemv_int {site} {dtype}: {json.dumps(row)}")
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "bound_ms", "gap_ms")}
    print(f"[7] pim_gemv_int over {len(rows)} site x format launches: "
          f"time {total['ms']!r} ms, bound {total['bound_ms']!r} ms, "
          f"sum(time - bound) {total['gap_ms']!r} ms")
    return dict(sites=rows, launches=len(rows), **total)


def mma_at_batch_1(kernel, calls: dict) -> dict:
    """The tensor-core int GEMM (``pim_gemm_int``) on the int GEMV's
    ``lm_head`` operands as a batch of one, timed beside the GEMV (in
    turns): a yardstick for the GEMV, which the port never replaces by
    it."""
    from repro_torch.kernels import pim_gemm

    out = {}
    for (site, dtype), (_, args, kw) in calls.items():
        if site != "lm_head":
            continue
        gemm_args = (args[0], args[1][None], *args[2:])
        check(pim_gemm.int_variant(args[0], gemm_args[1]) == "mma",
              f"lm_head {dtype} at B = 1 is not on the MMA GEMM")
        t = timed_ms({"gemv": lambda: kernel(*args, **kw),
                      "mma": lambda: pim_gemm.pim_gemm_int(*gemm_args,
                                                           **kw)},
                     KERNEL_REPS)
        out[dtype] = {k: v["ms"] for k, v in t.items()}
        print(f"[7] lm_head {dtype} B=1: pim_gemv_int "
              f"{t['gemv']['ms']!r} ms, MMA GEMM {t['mma']['ms']!r} ms")
    return out


def library_call(dtype: str, w_op: torch.Tensor, x_op: torch.Tensor):
    """One PyTorch call of the same function, to time as a yardstick (the
    port never calls it), or None where no single call computes it:
    ``torch._int_mm`` for W8A8 (its batch padded with zero rows to 32,
    above its minimum of 16 and a multiple of 8) and ``torch._scaled_mm``
    with unit scales for FP_W8A8 (batch padded to 16).  A16, W4 and
    FP_W8A16 have no such call."""
    xb = x_op if x_op.dim() == 2 else x_op[None]
    if dtype == "W8A8":
        a = torch.zeros((32, xb.shape[1]), dtype=torch.int8, device=xb.device)
        a[: xb.shape[0]] = xb
        return lambda: torch._int_mm(a, w_op.T)
    if dtype == "FP_W8A8":
        a = torch.zeros((16, xb.shape[1]), dtype=torch.uint8,
                        device=xb.device)
        a[: xb.shape[0]] = xb.view(torch.uint8)
        a = a.view(torch.float8_e4m3fn)
        one = torch.ones((), device=xb.device)
        return lambda: torch._scaled_mm(
            a, w_op.T, scale_a=one, scale_b=one, out_dtype=torch.float32)
    return None


ORACLE_MAX_COMMANDS = 100_000      # lanes up to this long go to RefEngine


def serving_without_a_model(dev, card: str) -> dict:
    """Phase 8: the offload policies and scenario mirrors over the port's
    planner at full width, through the lane-scan kernel.  Every part's
    wall ends in ``torch.cuda.synchronize()``; the lane-scan launch count
    is set to 0 before the parts and read after the last of them (the
    oracle's comparison launches come after and are not counted)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import engine
    from repro_torch.core.engine_ref import RefEngine
    from repro_torch.kernels import lane_scan
    from repro_torch.serving import scenarios as scen
    from repro_torch.serving.offload import OffloadPlanner

    def roundtrip(x):
        return json.loads(json.dumps(x))

    # Every launch's lanes and commands; during the ten-arch part, the
    # lanes up to ORACLE_MAX_COMMANDS long with the totals the kernel gave.
    real_scan, real_pack = lane_scan.lane_scan, engine.pack_lanes
    packed: list = []
    stats = {"lanes": 0, "commands": 0}
    short: list = []
    keep_short = [False]

    def counting_pack(lanes):
        packed[:] = lanes
        return real_pack(lanes)

    def counting_scan(cycs, streams, lengths, nb, **kw):
        iss, tot = real_scan(cycs, streams, lengths, nb, **kw)
        stats["lanes"] += int(streams.shape[0])
        stats["commands"] += int(lengths.sum())
        if keep_short[0]:
            tot_host = tot.cpu().numpy()
            for row, (cyc, s) in enumerate(packed):
                if s.shape[0] <= ORACLE_MAX_COMMANDS:
                    short.append((cyc, s, int(tot_host[row])))
        return iss, tot

    lane_scan.lane_scan, engine.pack_lanes = counting_scan, counting_pack
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0
    walls, part_launches = {}, {}

    def close(part: str, t0: float, launches0: int) -> None:
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t0
        part_launches[part] = lane_scan.LAUNCHES - launches0
        print(f"[8] {part}: {walls[part]!r} s wall, {part_launches[part]} "
              f"lane-scan launches ({card})")

    # -- the three serving goldens at full granite-8b width ---------------
    t0, n0 = time.perf_counter(), lane_scan.LAUNCHES
    planner = OffloadPlanner(ARCHS["granite-8b"], device=dev)
    for name in ("serve_trace", "disagg_trace", "spec_decode_trace"):
        fixture = json.loads((ROOT / "tests/golden" / f"{name}.json")
                             .read_text())
        if name == "disagg_trace":
            rec = fixture["disagg"]
            slo = {int(r): c for r, c in rec["slo"].items()}
            sim = scen.simulate_disagg(
                scen.ScenarioSpec.from_record(fixture["scenario"]),
                scen.DisaggConfig.from_record(rec["config"]), slo)
            check(sim["per_tick_batch"] == fixture["per_tick_batch"],
                  f"{name}: per_tick_batch not reproduced")
            for key in ("prefill_ticks", "admit_ticks", "completion_ticks"):
                check(rec["requests"][key]
                      == {str(r): t for r, t in sim[key].items()},
                      f"{name}: disagg {key} not reproduced")
            check(rec["handoff"]["max_depth"] == sim["max_handoff_depth"],
                  f"{name}: handoff depth not reproduced")
        else:
            check(scen.replay_batches(fixture) == fixture["per_tick_batch"],
                  f"{name}: per_tick_batch not reproduced")
        c = scen.run_policy_over_trace(planner, fixture["policy"],
                                       fixture["per_tick_batch"],
                                       fence=fixture["fence"])
        check(roundtrip(c.report()) == fixture["controller"],
              f"{name}: controller report not reproduced")
        check(roundtrip([r.to_record() for r in c.trace])
              == fixture["per_step"], f"{name}: per_step not reproduced")
    close("goldens", t0, n0)
    check(part_launches["goldens"] > 0, "the goldens launched no lane scan")

    # -- the policy battery: every scenario x policy -----------------------
    t0, n0 = time.perf_counter(), lane_scan.LAUNCHES
    battery = {}
    for name in sorted(scen.SCENARIOS):
        trace = scen.occupancy_trace(scen.make_scenario(name, seed=0))
        for pol in ("per-step", "hysteresis", "sticky"):
            rep = scen.run_policy_over_trace(planner, pol, trace).report()
            check(rep["steps"] == len(trace), f"{name}/{pol}: steps")
            if pol == "per-step":
                check(rep["efficiency"] == 1.0
                      and rep["planner_queries"] == rep["steps"],
                      f"{name}/{pol}: not the oracle: {rep}")
            else:
                check(rep["efficiency"] >= 0.95
                      and rep["realized_speedup"]
                      <= rep["oracle_speedup"] + 1e-12
                      and rep["planner_queries"] < rep["steps"],
                      f"{name}/{pol}: battery assertion failed: {rep}")
            battery[f"{name}/{pol}"] = {k: rep[k] for k in (
                "steps", "planner_queries", "replans", "switches",
                "efficiency", "realized_speedup")}
    close("battery", t0, n0)
    print(f"[8] battery: {json.dumps(battery)}")

    # -- speculative planning ---------------------------------------------
    t0, n0 = time.perf_counter(), lane_scan.LAUNCHES
    draft = planner.plan_draft()
    touched = planner.touch_draft()
    tel = planner.spec_decode_speedup(batch=1)
    close("speculative", t0, n0)
    check(part_launches["speculative"] > 0,
          "draft planning launched no lane scan")
    check(len(draft) == len(planner.plan()) and touched > 0
          and all(d.pim_ns > 0 and d.host_ns > 0 for d in draft)
          and np.isfinite(tel["speedup"]) and tel["speedup"] > 0,
          f"speculative planning: {touched} lanes touched, {tel}")
    print(f"[8] speculative: {touched} draft lanes touched; "
          f"{json.dumps(tel)}")

    # -- every arch at full width through the kernel ----------------------
    t0, n0 = time.perf_counter(), lane_scan.LAUNCHES
    archs = {}
    keep_short[0] = True
    for name, cfg in ARCHS.items():
        engine.lane_cache_clear()
        ta, na = time.perf_counter(), lane_scan.LAUNCHES
        s0 = dict(stats)
        plan = OffloadPlanner(cfg, device=dev).plan(fence=True)
        torch.cuda.synchronize()
        archs[name] = dict(
            wall_s=time.perf_counter() - ta,
            launches=lane_scan.LAUNCHES - na,
            lanes=stats["lanes"] - s0["lanes"],
            commands=stats["commands"] - s0["commands"], sites=len(plan),
            offloaded_at_b1=sum(d.offload_at(1) for d in plan))
        check(archs[name]["launches"] > 0
              and all(d.pim_ns > 0 and d.host_ns > 0 for d in plan),
              f"{name}: plan {archs[name]}")
        print(f"[8] {name}: {json.dumps(archs[name])} ({card})")
    keep_short[0] = False
    close("archs", t0, n0)
    launches = lane_scan.LAUNCHES
    lane_scan.lane_scan, engine.pack_lanes = real_scan, real_pack

    # -- the oracle: RefEngine on every lane up to ORACLE_MAX_COMMANDS ----
    t0 = time.perf_counter()
    by_banks: dict = {}
    for cyc, s, total in short:
        by_banks.setdefault(cyc.num_banks, []).append((cyc, s, total))
    for nb, lanes in sorted(by_banks.items()):
        cycs, streams, lengths = engine.pack_lanes(
            [(c, s) for c, s, _t in lanes])
        iss, tot = real_scan(cycs.to(dev), streams.to(dev),
                             lengths.to(dev), nb)
        iss, tot = iss.cpu().numpy(), tot.cpu().numpy()
        for row, (cyc, s, total) in enumerate(lanes):
            iss_ref, tot_ref = RefEngine(cyc, validate=False).run(s)
            check(np.array_equal(iss[row, : s.shape[0]].astype(np.int64),
                                 iss_ref)
                  and int(tot[row]) == tot_ref == total,
                  f"RefEngine != kernel on a {s.shape[0]}-command lane")
    torch.cuda.synchronize()
    walls["oracle"] = time.perf_counter() - t0
    oracle = dict(lanes=len(short),
                  commands=sum(s.shape[0] for _c, s, _t in short))
    check(oracle["lanes"] > 0, "no lane for the oracle")
    print(f"[8] oracle: RefEngine == kernel on {oracle['lanes']} lanes, "
          f"{oracle['commands']} commands, {walls['oracle']!r} s wall "
          f"({card})")
    return dict(launches=launches, walls=walls, part_launches=part_launches,
                archs=archs, oracle=oracle,
                phase_wall_s=sum(walls.values()))


DECODE_REPS = 20                   # timed decode steps per batch size


def decode_bytes(cfg, params, batch: int) -> int:
    """Bytes one decode step must read: every parameter once except the
    embedding table, of which only the ``batch`` gathered rows."""
    def size(tree):
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    emb = params["embed"]
    return (size(params) - size(emb)
            + batch * cfg.d_model * emb.element_size())


def serving_with_a_model(dev, card: str) -> dict:
    """Phase 9: the port's models and serving engine on the card.  Every
    part's wall ends in ``torch.cuda.synchronize()``; the lane-scan
    launch count is set to 0 before ``serve_full`` and read after its
    replays (the launcher's subprocesses count their own)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core import engine
    from repro_torch.kernels import lane_scan
    from repro_torch.models import model as M
    from repro_torch.models.convert import (draw_numpy_params,
                                            params_from_numpy,
                                            params_to_numpy)
    from repro_torch.serving import scenarios as scen
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.offload import OffloadPlanner

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would not run in full float32")
    walls: dict = {}
    out: dict = {"walls": walls}

    def close(part: str, t0: float) -> None:
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t0
        print(f"[9] {part}: {walls[part]!r} s wall ({card})")

    # -- model_logits: granite-8b widths, 2 layers, vs the JAX fixture ----
    t0 = time.perf_counter()
    fx = json.loads((ROOT / "tests/golden/torch_model_logits.json")
                    .read_text())
    cfg2 = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    params = params_from_numpy(draw_numpy_params(cfg2, fx["seed"]), dev)
    steps = serve_greedy(M, cfg2, params, fx["prompts"], fx["decode_steps"],
                         fx["max_seq"], dev)
    msg, worst = logits_mismatch(fx["steps"], steps, fx["rel_tol"])
    check(msg is None, f"model_logits: {msg}")
    del params, steps
    torch.cuda.empty_cache()
    close("model_logits", t0)
    out["model_logits"] = dict(worst_rel_err=worst, rel_tol=fx["rel_tol"],
                               tokens=[r["tokens"] for r in fx["steps"]])
    print(f"[9] model_logits: granite-8b widths x {fx['n_layers']} layers "
          f"== tests/golden/torch_model_logits.json, largest error "
          f"{worst!r} x max|logit| (limit {fx['rel_tol']})")

    # -- serve_full: 36 layers, f32 weights drawn on the card --------------
    t0 = time.perf_counter()
    cfg = ARCHS["granite-8b"]
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0
    planner = OffloadPlanner(cfg, device=dev)
    replays = {}
    for name in ("serve_trace", "spec_decode_trace"):
        fixture = json.loads((ROOT / "tests/golden" / f"{name}.json")
                             .read_text())
        tr = time.perf_counter()
        got = scen.replay_trace(fixture, cfg, params, planner, device=dev)
        torch.cuda.synchronize()
        replays[name] = dict(wall_s=time.perf_counter() - tr,
                             steps=got["steps"], tokens=got["tokens"],
                             prefills=got["prefills"])
        check(json.loads(json.dumps(got)) == fixture,
              f"serve_full: {name} not reproduced at full width")
    launches = lane_scan.LAUNCHES
    check(launches > 0, "serve_full launched no lane scan")
    out["launches"] = launches

    # three requests together == each alone in one slot
    rng = np.random.default_rng(5)
    shapes = ((5, 6), (9, 4), (3, 7))
    prompts = [rng.integers(0, cfg.vocab, size=n) for n, _m in shapes]

    def serve(idx: list[int]) -> list[list[int]]:
        eng = ServingEngine(cfg, params, slots=len(idx), max_seq=32,
                            device=dev)
        reqs = [Request(rid=i, prompt=prompts[i], max_new=shapes[i][1])
                for i in idx]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.out for r in reqs]

    together = serve([0, 1, 2])
    alone = [serve([i])[0] for i in range(3)]
    check(together == alone, f"batched streams {together} != alone {alone}")

    # forward of prompt + generated == prefill + decode_step's logits
    seq = np.concatenate([prompts[1], np.asarray(together[1][:-1])])
    cache = M.init_cache(cfg, 1, 32, torch.float32, device=dev)
    logits, cache = M.prefill(cfg, params, {"tokens": torch.as_tensor(
        prompts[1][None].astype(np.int32), device=dev)}, cache)
    for j, tok in enumerate(together[1][:-1]):
        logits, cache = M.decode_step(
            cfg, params, cache, torch.tensor([[tok]], dtype=torch.int32,
                                             device=dev),
            torch.tensor(len(prompts[1]) + j, dtype=torch.int32, device=dev))
    fwd, _ = M.forward(cfg, params, {"tokens": torch.as_tensor(
        seq[None].astype(np.int32), device=dev)})
    scale = float(fwd[0, -1].abs().max())
    err = float((fwd[0, -1] - logits[0]).abs().max())
    check(err <= 1e-3 * scale, f"forward vs decode: {err!r} of {scale!r}")
    out["forward_vs_decode_rel_err"] = err / scale

    # times: prefill by prompt length, decode steps at batch 1 and 4
    prefill_ms = {}
    for n in (4, 8, 16, 32):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, n))
                               .astype(np.int32), device=dev)
        times = []
        for _ in range(4):
            c1 = M.init_cache(cfg, 1, 64, torch.float32, device=dev)
            torch.cuda.synchronize()
            tp = time.perf_counter()
            M.prefill(cfg, params, {"tokens": toks}, c1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - tp) * 1e3)
        prefill_ms[n] = float(np.median(times[1:]))
    decode = {}
    for b in (1, 4):
        cache = M.init_cache(cfg, b, 64, torch.float32, device=dev)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        pos = torch.arange(8, 8 + b, dtype=torch.int32, device=dev)
        times = []
        for _ in range(DECODE_REPS + 2):
            torch.cuda.synchronize()
            tp = time.perf_counter()
            logits, cache = M.decode_step(cfg, params, cache, tok, pos)
            tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - tp) * 1e3)
            pos = pos + 1
        ms = float(np.median(times[2:]))
        nbytes = decode_bytes(cfg, params, b)
        decode[b] = dict(ms=ms, min_ms=float(min(times[2:])),
                         bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         tokens_per_s=b / ms * 1e3,
                         **profile_decode(M, cfg, params, cache, tok, pos))
        decode[b]["busy_share"] = (decode[b]["device_ms"] / ms
                                   if decode[b]["device_ms"] else None)
    out.update(params=n_params, init_s=init_s, replays=replays,
               prefill_ms=prefill_ms, decode=decode,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    del params, cache, logits, fwd
    torch.cuda.empty_cache()
    close("serve_full", t0)
    print(f"[9] serve_full: {cfg.name}, {cfg.n_layers} layers, {n_params} "
          f"f32 params "
          f"drawn on the card in {init_s:.3f} s; replays "
          f"{json.dumps(replays)}; {launches} lane-scan launches")
    print(f"[9] serve_full: prefill ms by prompt length "
          f"{json.dumps(prefill_ms)}")
    for b, d in decode.items():
        print(f"[9] serve_full: decode step at batch {b}: {d['ms']!r} ms "
              f"median of {DECODE_REPS} (min {d['min_ms']!r}), bytes bound "
              f"{d['bound_ms']!r} ms ({d['bytes']} bytes), "
              f"{d['tokens_per_s']!r} tokens/s; profiler: device "
              f"{d['device_ms']!r} ms and {d['launches_per_step']!r} "
              f"kernel launches a step, busy share {d['busy_share']!r} "
              f"({card})")
        print(f"[9] serve_full: decode step at batch {b}, most device time: "
              f"{json.dumps(d['top_kernels'])}")
    print(f"[9] serve_full: max_memory_allocated "
          f"{out['max_memory_allocated']} bytes")

    # -- launcher_warm: the entry point, cold then warm --------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--scenario", "bursty", "--policy", "hysteresis", "--quick",
                "--cache-dir", tmp]
        runs = []
        for _ in range(2):
            text, wall = run_launcher(argv)
            ttfb = re.search(r"^serve/time_to_first_batch,([0-9.]+)$", text,
                             re.M)
            check(ttfb is not None, f"no time_to_first_batch row:\n{text}")
            runs.append(dict(text=text, wall_s=wall,
                             ttfb_s=float(ttfb.group(1)),
                             lane_cache=lane_cache_row(text)))
        cold, warm = runs
        saved = re.search(r"^warm start: saved (\d+) lanes$", cold["text"],
                          re.M)
        check(cold["lane_cache"]["misses"] > 0 and saved is not None
              and int(saved.group(1)) > 0,
              f"cold launcher run:\n{cold['text']}")
        check(f"{saved.group(1)} lanes loaded" in warm["text"]
              and warm["lane_cache"]["misses"] == 0
              and warm["lane_cache"]["hits"] > 0
              and warm["ttfb_s"] <= cold["ttfb_s"],
              f"warm launcher run:\n{warm['text']}")
        mono, mono_wall = run_launcher(["--requests", "8"])
        check("served 8 requests (monolithic engine)" in mono,
              f"monolithic launcher run:\n{mono}")
    close("launcher_warm", t0)
    out["launcher"] = dict(
        cold={k: v for k, v in cold.items() if k != "text"},
        warm={k: v for k, v in warm.items() if k != "text"},
        monolithic_wall_s=mono_wall)
    print(f"[9] launcher_warm: {json.dumps(out['launcher'])}")

    # -- archs_smoke: every arch's smoke config, card == CPU ---------------
    t0 = time.perf_counter()
    msg = kv_quant_mismatch(M, dev)
    check(msg is None, f"archs_smoke: {msg}")
    archs, quant = {}, {}
    for name, full in ARCHS.items():
        scfg = smoke_config(full)
        cpu = M.init_params(scfg, torch.Generator().manual_seed(0),
                            device="cpu")
        card_params = params_from_numpy(params_to_numpy(cpu), dev)
        batch = smoke_batch(scfg, np.random.default_rng(0))
        (want, _), (got, _) = paired_steps(M, scfg, cpu, card_params, batch,
                                           dev)
        msg, worst = steps_mismatch(want, got, 1e-4)
        check(msg is None, f"archs_smoke {name}: card != CPU: {msg}")
        archs[name] = worst
        for bits, kvq in QUANT_CASES:
            msg, worst = quantized_mismatch(M, scfg, cpu, card_params,
                                            batch, dev, bits, kvq)
            check(msg is None, f"archs_smoke {name}: card != CPU: {msg}")
            case = f"W{bits}" + ("+kv8" if kvq else "")
            quant[case] = max(quant.get(case, 0.0), worst)
    close("archs_smoke", t0)
    out["archs_smoke"] = dict(archs, **{f"max {k}": v
                                        for k, v in quant.items()})
    print(f"[9] archs_smoke: card == CPU on all {len(archs)} archs, largest "
          f"error x max|logit| {json.dumps(archs)}")
    print(f"[9] archs_smoke: served quantized (W8, W4, W8 + int8 KV), card "
          f"== CPU: q / s leaves bit-equal, int8 KV entries bit-equal to the "
          f"CPU's quantizer of the card's floats, the KV quantizer "
          f"bit-equal on half-way values; largest error x max|logit| over "
          f"the archs {json.dumps(quant)}")
    out["phase_wall_s"] = sum(walls.values())
    return out


def serving_rest(dev, card: str) -> dict:
    """Phase 10: the disaggregated cells, the chaos harness, the daemon
    and the launcher's daemon mode, serving the 36-layer f32 granite-8b
    drawn on the card from seed 0, with full-width planners.  Every part's wall ends in
    ``torch.cuda.synchronize()``; the lane-scan launch count is set to 0
    before the first part and read after the daemon's (the launcher's
    subprocess counts its own)."""
    import tempfile

    from repro_torch.configs import ARCHS
    from repro_torch.core import engine, faults
    from repro_torch.kernels import lane_scan
    from repro_torch.models import model as M
    from repro_torch.serving import chaos, scenarios as scen
    from repro_torch.serving.daemon import ServeDaemon, TraceWriter
    from repro_torch.serving.offload import OffloadPlanner

    walls: dict = {}
    out: dict = {"walls": walls}
    launches: dict = {}

    def roundtrip(x):
        return json.loads(json.dumps(x))

    def close(part: str, t0: float, launches0: int | None = None) -> None:
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t0
        if launches0 is not None:
            launches[part] = lane_scan.LAUNCHES - launches0
        print(f"[10] {part}: {walls[part]!r} s wall, "
              f"{launches.get(part, 0)} lane-scan launches ({card})")

    def golden(name: str) -> dict:
        return json.loads((ROOT / "tests/golden" / f"{name}.json")
                          .read_text())

    cfg = ARCHS["granite-8b"]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    engine.reset_backend_scopes()
    faults.reset()
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0

    # -- disagg_golden: the cells at full width, scoped, cold planner ------
    t0 = time.perf_counter()
    fixture = golden("disagg_trace")
    planner = OffloadPlanner(cfg, device=dev)
    spec = scen.ScenarioSpec.from_record(fixture["scenario"])
    scopes = (engine.BackendScope(name="prefill"),
              engine.BackendScope(name="decode"))
    got = roundtrip(scen.run_scenario(
        spec, cfg, params, planner, policy=fixture["policy"],
        fence=fixture["fence"],
        disagg=scen.DisaggConfig.from_record(fixture["disagg"]["config"]),
        slo={int(r): s for r, s in fixture["disagg"]["slo"].items()},
        prefill_scope=scopes[0], decode_scope=scopes[1], device=dev))
    described = got["disagg"].pop("scopes")
    check(got == fixture, "disagg_golden: the scoped cells at full width "
          "did not reproduce tests/golden/disagg_trace.json")
    check(all(d["rungs"] == ["scan"] and d["breaker"]["open"] == []
              for d in described.values()),
          f"disagg_golden: scopes {described}")
    got = scen.replay_trace(fixture, cfg, params, planner, device=dev)
    check(roundtrip(got) == fixture,
          "disagg_golden: replay_trace did not reproduce the golden")
    close("disagg_golden", t0, 0)
    out["disagg_golden"] = dict(steps=got["steps"], tokens=got["tokens"],
                                prefills=got["prefills"],
                                handoffs=got["disagg"]["handoff"])
    print(f"[10] disagg_golden: tests/golden/disagg_trace.json reproduced "
          f"by the scoped cells and by replay_trace through the "
          f"{cfg.n_layers}-layer granite-8b with a cold full-width planner "
          f"({json.dumps(out['disagg_golden'])})")

    # -- chaos_golden: the incident, fresh full-width mamba2-130m planner --
    t0, l0 = time.perf_counter(), lane_scan.LAUNCHES
    fixture = golden("chaos_trace")
    engine.lane_cache_reset()
    faults.reset()
    spec = scen.make_scenario("chaos", seed=5, slots=4, quick=True)
    horizon = max(a.step for a in spec.arrivals) + 1
    timeline = chaos.make_chaos_timeline(5, horizon=max(horizon, 8),
                                         rungs=["scan"], scheduling=True)
    got = roundtrip(chaos.run_chaos_scenario(
        cfg, params, OffloadPlanner(ARCHS["mamba2-130m"], device=dev),
        scenario=spec, timeline=timeline,
        disagg=scen.DisaggConfig(prefill_budget=2, handoff_bound=3,
                                 starvation_age=4, admission_capacity=6),
        slo=scen.assign_slo(spec, 0.6), device=dev))
    for key in fixture:
        check(got.get(key) == fixture[key],
              f"chaos_golden: {key} differs from tests/golden/"
              f"chaos_trace.json")
    check(set(got) == set(fixture), f"chaos_golden: keys {sorted(got)}")
    close("chaos_golden", t0, l0)
    check(launches["chaos_golden"] >= 5,
          f"chaos_golden: {launches['chaos_golden']} lane-scan launches "
          f"for a cold plan and four storms")
    rec = got["chaos"]
    out["chaos_golden"] = dict(events=len(rec["events"]),
                               injected=rec["injected"],
                               breaker=rec["breaker"],
                               backoff_sleeps=rec["backoff_sleeps"],
                               steps=got["steps"], tokens=got["tokens"])
    print(f"[10] chaos_golden: tests/golden/chaos_trace.json reproduced, "
          f"chaos record included ({json.dumps(out['chaos_golden'])})")

    # -- daemon: scenario mode == run_scenario; drain under chaos ---------
    t0, l0 = time.perf_counter(), lane_scan.LAUNCHES
    faults.reset()
    spec = scen.make_scenario("bursty", seed=3, slots=4, quick=True)
    kw = dict(policy="hysteresis",
              disagg=scen.DisaggConfig(prefill_budget=2, handoff_bound=3,
                                       starvation_age=4),
              slo=scen.assign_slo(spec),
              autoscale=scen.AutoscaleConfig(min_slots=1))
    want = scen.run_scenario(spec, cfg, params, planner, device=dev, **kw)
    daemon = ServeDaemon(cfg, params, planner, scenario=spec, device=dev,
                         **kw)
    rep = daemon.run()
    check(json.dumps(daemon.trace(), sort_keys=True)
          == json.dumps(want, sort_keys=True),
          "daemon: scenario mode != run_scenario(disagg=, autoscale=)")
    inj = faults.FaultInjector()
    holder = {}

    def on_tick(t, eng):
        faults.set_tick(t)
        if t == 4:
            holder["d"].drain()
        if t in (5, 7):
            inj.arm("handoff", count=1)
        if t == 6:
            inj.arm("backend.scan", count=1)
            engine.lane_cache_clear()
            eng.controller.replan(1, refresh=True)

    drained = ServeDaemon(cfg, params, planner, scenario=spec,
                          disagg=kw["disagg"], on_tick=on_tick, device=dev)
    holder["d"] = drained
    try:
        with faults.fault_scope(inj), \
                faults.retry_scope(retries=2, clock=faults.VirtualClock()):
            drain = drained.run()
    finally:
        faults.set_tick(None)
    acct = drain["accounting"]
    check(drain["draining"] and acct["in_flight"] == 0
          and acct["ingested"] == acct["completed"] + acct["shed"]
          and acct["dropped"] + acct["ingested"] == len(spec.arrivals)
          and inj.injected >= 3,
          f"daemon: drain under chaos {drain} (injected {inj.injected})")
    close("daemon", t0, l0)
    out["daemon"] = dict(scenario_ticks=rep["ticks"],
                         autoscale=rep["autoscale"]["limits"],
                         drain=dict(acct, unhandled=0,
                                    injected=inj.injected))
    print(f"[10] daemon: scenario mode == run_scenario(disagg=, autoscale=)"
          f"; drain under chaos {json.dumps(out['daemon']['drain'])}")
    out["launches"] = sum(launches.values())
    out["launches_by_part"] = dict(launches)
    check(out["launches"] > 0, "phase 10 launched no lane scan")
    del params, planner, daemon, drained
    gc.collect()
    torch.cuda.empty_cache()

    # -- launcher_daemon: --daemon --autoscale --chaos --trace-out ---------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.jsonl"
        text, wall = run_launcher(["--daemon", "--autoscale", "--chaos",
                                   "--trace-out", str(path), "--quick"])
        row = re.search(r"^serve/daemon,(.*)$", text, re.M)
        chaos_row = re.search(r"^serve/chaos,(.*)$", text, re.M)
        check(row is not None and chaos_row is not None,
              f"launcher_daemon: no serve/daemon or serve/chaos row:\n{text}")
        fields = dict(kv.split("=") for kv in row.group(1).split(","))
        trace = TraceWriter.load(path)
        check(fields["unhandled"] == "0" and fields["in_flight"] == "0"
              and int(fields["completed"]) > 0
              and len(trace["per_tick_batch"]) == int(fields["ticks"])
              and trace["autoscale"]["limits"],
              f"launcher_daemon:\n{text}")
    close("launcher_daemon", t0)
    out["launcher_daemon"] = dict(wall_s=wall, daemon=fields,
                                  chaos=chaos_row.group(1))
    print(f"[10] launcher_daemon: {json.dumps(out['launcher_daemon'])}")
    out["phase_wall_s"] = sum(walls.values())
    return out


PEAK_FLOPS_F32 = 67e12            # H100 SXM float32 outside the tensor cores
TRAIN_LAYERS = 8                  # train_full's depth: 8 of granite-8b's 36
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6


def train_step_bound(cfg, batch: int, seq: int, remat: bool) -> dict:
    """The least time one training step of ``cfg`` could take on the
    card: float32 matmul FLOPs (6 per weight and token for forward and
    backward, 2 more per block weight and token when the blocks are
    recomputed, and the dense attention's score and value products, which
    compute the whole S x S square) over the float32 peak, against the
    optimizer's bytes (params, grads, both moments and the error state,
    each read once and all but the grads written once) over the memory
    rate; the larger of the two."""
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff)
    block = d * hq * hd * 2 + d * hkv * hd * 2 + 3 * d * ff
    head = d * cfg.vocab_padded
    tokens = batch * seq
    attn_fwd = 2 * 2 * seq * seq * hq * hd * batch * cfg.n_layers
    flops = (tokens * (6 * (cfg.n_layers * block + head)
                       + (2 * cfg.n_layers * block if remat else 0))
             + attn_fwd * (4 if remat else 3))
    n_params = (cfg.n_layers * (block + 2 * d) + head
                + cfg.vocab_padded * d + d)
    nbytes = 4 * n_params * (5 + 4)
    flops_ms = flops / PEAK_FLOPS_F32 * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, bytes=nbytes, n_params=n_params,
                flops_ms=flops_ms, bytes_ms=bytes_ms,
                bound_ms=max(flops_ms, bytes_ms),
                bound_by="operations" if flops_ms >= bytes_ms else "bytes")


def adam_mismatch(want: list, got: list, lr_sum: float,
                  frac: float = 1e-3) -> tuple[str | None, float]:
    """Why params after AdamW steps from one start differ more than
    float32 noise allows, or None; and the largest difference as a share
    of ``lr_sum``.  Every entry within 2 x ``lr_sum`` (a grad at noise
    level may take an update of either sign) and all but ``frac`` of all
    entries within 1 % of it."""
    worst, loose, total = 0.0, 0, 0
    for (name, w), (_n, g) in zip(want, got):
        d = np.abs(np.asarray(g, np.float64) - w)
        worst = max(worst, float(d.max()) / lr_sum)
        if d.max() > 2 * lr_sum:
            return f"{name}: {d.max()!r} > 2 x sum(lr)", worst
        loose += int((d > 0.01 * lr_sum).sum())
        total += d.size
    if loose > frac * total:
        return f"{loose} of {total} entries past 1 % of sum(lr)", worst
    return None, worst


def grads_mismatch(want: list, got: list, rtol: float = 1e-4
                   ) -> tuple[str | None, float]:
    """Why two lists of (name, grad) differ past ``rtol`` and ``rtol`` x
    each leaf's max |grad|, or None; and the largest difference as a
    share of its leaf's max |grad|."""
    worst = 0.0
    for (name, w), (_n, g) in zip(want, got):
        scale = max(float(np.abs(w).max()), 1e-30)
        d = np.abs(np.asarray(g, np.float64) - w)
        worst = max(worst, float(d.max()) / scale)
        if not (d <= rtol * scale + rtol * np.abs(w)).all():
            return f"{name}: {d.max()!r} of max |grad| {scale!r}", worst
    return None, worst


def run_streamed(args: list[str], timeout: int) -> tuple[str, dict]:
    """``python -m ARGS`` in a fresh process on this checkout's sources:
    its output, and the host seconds from the start (or the previous
    arch) to each arch's first ``[pim] ARCH:`` line.  Fails on a nonzero
    exit or after ``timeout`` seconds."""
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines, first = [], {}
    for line in proc.stdout:
        lines.append(line)
        m = re.match(r"\[pim\] (\S+):", line)
        if m and m.group(1) not in first:
            first[m.group(1)] = time.perf_counter()
    proc.wait()
    timer.cancel()
    text = "".join(lines)
    check(proc.returncode == 0, f"{args} exited {proc.returncode}:\n"
          f"{text[-4000:]}")
    marks = [t0, *first.values()]
    return text, {a: marks[i + 1] - marks[i] for i, a in enumerate(first)}


def train_smoke_mismatch(cfg, dev) -> tuple[str | None, dict]:
    """``loss_fn``'s loss and grads, then one trainer step (int8, 2
    microbatches, lr at its peak), from the same seeded weights on the
    CPU and on ``dev``: why they differ past float32 noise (losses within
    1e-5, :func:`grads_mismatch`, :func:`adam_mismatch`), or None; and
    the largest differences."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.training.grad_compress import CompressionConfig
    from repro_torch.training.optimizer import tree_flatten_with_path
    from repro_torch.training.trainer import TrainConfig, Trainer

    start = params_to_numpy(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    batch = SyntheticLM(cfg.vocab, seed=0).batch(0, 2, 16)
    if cfg.prefix_patches:
        batch["patches"] = (np.random.default_rng(0).standard_normal(
            (2, cfg.prefix_patches, cfg.d_model)) * 0.1).astype(np.float32)
    sides = []
    for d in (torch.device("cpu"), dev):
        p = params_from_numpy(start, d)
        named = tree_flatten_with_path(p)
        for _, t in named:
            t.requires_grad_(True)
        loss, _ = M.loss_fn(cfg, p, to_device(batch, d))
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        for _, t in named:
            t.requires_grad_(False)
        g = [("__".join(path), (torch.zeros_like(t) if gr is None else gr)
              .cpu().numpy()) for (path, t), gr in zip(named, grads)]
        tr = Trainer(cfg, TrainConfig(
            lr=1e-3, warmup=0, total_steps=10, microbatches=2,
            compression=CompressionConfig("int8"), ckpt_every=1 << 30),
            params=p)
        step_loss = tr.train(iter([to_device(batch, d)]), 1,
                             log_every=1 << 30)[0]["loss"]
        after = [("__".join(path), t.cpu().numpy())
                 for path, t in tree_flatten_with_path(tr.params)]
        sides.append((float(loss.detach()), g, step_loss, after))
    (lc, gc_, tlc, pc), (lg, gg, tlg, pg) = sides
    if not (abs(lg - lc) <= 1e-5 * abs(lc)
            and abs(tlg - tlc) <= 1e-5 * abs(tlc)):
        return (f"loss {lg!r} / {tlg!r} vs CPU {lc!r} / {tlc!r}", {})
    msg, gworst = grads_mismatch(gc_, gg)
    if msg is not None:
        return f"grads: {msg}", {}
    msg, pworst = adam_mismatch(pc, pg, 1e-3)
    return (None if msg is None else f"params: {msg}",
            dict(grad_worst_of_max=gworst, param_worst_of_lr=pworst))


def training_and_report(dev, card: str) -> dict:
    """Phase 11: the dry-run's PIM offload report and training on the
    card, in float32 with TF32 off.  Every part's wall ends in
    ``torch.cuda.synchronize()``; the lane-scan launch count is set to 0
    before ``pim_report`` and read after it (the subprocesses count their
    own)."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core import engine
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import lane_scan
    from repro_torch.launch import dryrun
    from repro_torch.models.convert import draw_numpy_params, params_from_numpy
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.grad_compress import CompressionConfig
    from repro_torch.training.optimizer import (tree_flatten_with_path,
                                                tree_leaves, tree_map)
    from repro_torch.training.trainer import TrainConfig, Trainer

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would not run in full float32")
    walls: dict = {}
    out: dict = {"walls": walls}

    def close(part: str, t0: float) -> None:
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t0
        print(f"[11] {part}: {walls[part]!r} s wall ({card})")

    # -- pim_report: granite-8b's report in-process, then every arch ------
    t0 = time.perf_counter()
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0
    rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                    policy="hysteresis", disagg=True,
                                    device=dev)
    torch.cuda.synchronize()
    out["launches"] = lane_scan.LAUNCHES
    fx = json.loads((ROOT / "tests/golden/torch_pim_report.json").read_text())
    check(json.loads(json.dumps(rec)) == fx,
          "pim_report: granite-8b != tests/golden/torch_pim_report.json")
    check(out["launches"] >= 1, "pim_report launched no lane scan")
    close("pim_report", t0)
    base = rec["variants"]["lp5x-9600"]["decode_speedup"]["1"]
    print(f"[11] pim_report: granite-8b (bursty x hysteresis, disagg) == "
          f"tests/golden/torch_pim_report.json, {out['launches']} lane-scan "
          f"launches; decode b=1 speedup {base['speedup']!r}")
    t0 = time.perf_counter()
    text, per_arch = run_streamed(["repro_torch.launch.dryrun", "--pim",
                                   "--all"], timeout=400)
    close("pim_report_all", t0)
    check(sorted(per_arch) == sorted(ARCHS),
          f"dryrun --pim --all reported {sorted(per_arch)}")
    out["pim_report_all_s"] = per_arch
    print(f"[11] pim_report_all: python -m repro_torch.launch.dryrun --pim "
          f"--all exited 0; seconds per arch (the first with the process's "
          f"start) {json.dumps(per_arch)}")

    # -- train_fixture: granite-8b widths, 2 layers, vs the JAX Trainer ----
    t0 = time.perf_counter()
    fx = json.loads((ROOT / "tests/golden/torch_train_steps.json")
                    .read_text())
    cfg2 = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    params = params_from_numpy(draw_numpy_params(cfg2, fx["seed"]), dev)
    got = port_train_run(fx, cfg2, params, dev)
    del params
    torch.cuda.empty_cache()
    msg, worst = train_mismatch(fx, got)
    check(msg is None, f"train_fixture: {msg}")
    close("train_fixture", t0)
    out["train_fixture"] = dict(worst_share_of_limit=worst, tol=fx["tol"],
                                losses=got["losses"])
    print(f"[11] train_fixture: granite-8b widths x {fx['n_layers']} layers, "
          f"{fx['steps']} steps == tests/golden/torch_train_steps.json; "
          f"losses {got['losses']}; worst share of each limit "
          f"{json.dumps(worst)} (limits {json.dumps(fx['tol'])})")

    # -- train_full: granite-8b widths, 8 of 36 layers ---------------------
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(ARCHS["granite-8b"], n_layers=TRAIN_LAYERS)
    ckpt_dir = tempfile.mkdtemp(prefix="train_full_")
    tcfg = TrainConfig(lr=3e-4, warmup=2, total_steps=TRAIN_STEPS,
                       microbatches=2, compression=CompressionConfig("int8"),
                       ckpt_every=1 << 30, ckpt_dir=ckpt_dir, remat=True)
    src = SyntheticLM(cfg8.vocab, seed=0)
    batches = [to_device(src.batch(s, TRAIN_BATCH, TRAIN_SEQ), dev)
               for s in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg8, tcfg,
                      generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for _, p in
                   tree_flatten_with_path(trainer.params))
    step_s = []

    def one_step(tr) -> float:
        t = time.perf_counter()
        tr.train(iter([batches[tr.step]]), 1, log_every=1 << 30)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return tr.history[-1]["loss"]

    losses = [one_step(trainer) for _ in range(3)]
    tc = time.perf_counter()
    saved = tree_map(lambda t: t.detach().to("cpu", copy=True),
                     (trainer.params, trainer.opt))
    CKPT.save(ckpt_dir, trainer.step, saved)
    save_s = time.perf_counter() - tc
    losses += [one_step(trainer) for _ in range(TRAIN_STEPS - 3)]
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"train_full: losses {losses}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    tc = time.perf_counter()
    fresh = Trainer(cfg8, tcfg,
                    generator=torch.Generator(device=dev).manual_seed(1))
    check(fresh.restore_latest() and fresh.step == 3,
          "train_full: no checkpoint restored at step 3")
    restore_s = time.perf_counter() - tc
    for (path, t), want in zip(
            tree_flatten_with_path((fresh.params, fresh.opt)),
            tree_leaves(saved)):
        check(torch.equal(t.detach().cpu(), want),
              f"train_full: restored {'__'.join(path)} != saved")
    del saved
    prof = profile_step(lambda: fresh.train(iter([batches[3]]), 1,
                                            log_every=1 << 30))
    restored_loss = fresh.history[-1]["loss"]
    check(abs(restored_loss - losses[3]) <= 1e-5 * abs(losses[3]),
          f"train_full: step 4 from the checkpoint {restored_loss!r} vs "
          f"{losses[3]!r}")
    del fresh
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    close("train_full", t0)
    bound = train_step_bound(cfg8, TRAIN_BATCH, TRAIN_SEQ, remat=True)
    step_ms = statistics.median(step_s[3:TRAIN_STEPS]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out["train_full"] = dict(
        layers=TRAIN_LAYERS, n_params=n_params, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, microbatches=2, losses=losses,
        restored_step4_loss=restored_loss, step_s=step_s, step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), peak_bytes=peak,
        save_s=save_s, restore_s=restore_s, profile=prof, bound=bound,
        card=card)
    print(f"[11] train_full: granite-8b widths x {TRAIN_LAYERS} layers "
          f"({n_params} params), batch {TRAIN_BATCH} x {TRAIN_SEQ}, 2 "
          f"microbatches, int8 compression, remat; losses {losses}; step 4 "
          f"from the step-3 checkpoint {restored_loss!r} (tree bit-equal "
          f"after save {save_s!r} s / restore {restore_s!r} s)")
    print(f"[11] train_full: step {step_ms!r} ms (median of steps 4-6), "
          f"{tokens / (step_ms / 1e3)!r} tokens/s, peak {peak} bytes; one "
          f"step under the profiler: {prof['wall_ms']!r} ms wall, device "
          f"{prof['device_ms']!r} ms (busy share {prof['busy_share']!r}), "
          f"{prof['launches']} kernel launches; bound {bound['bound_ms']!r} "
          f"ms by {bound['bound_by']} ({bound['flops']} FLOP at "
          f"{PEAK_FLOPS_F32:.3g} FLOP/s; {bound['bytes']} bytes) ({card})")

    # -- train_smoke: every token-input smoke arch, card == CPU ------------
    t0 = time.perf_counter()
    smoke = {}
    for name, full in ARCHS.items():
        if full.input_mode != "tokens":
            continue
        msg, smoke[name] = train_smoke_mismatch(smoke_config(full), dev)
        check(msg is None, f"train_smoke {name}: card != CPU: {msg}")
    close("train_smoke", t0)
    out["train_smoke"] = smoke
    print(f"[11] train_smoke: card == CPU on {len(smoke)} token-input smoke "
          f"archs (loss, grads, one trainer step): {json.dumps(smoke)}")

    # -- launcher_train: the launcher and the examples ---------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        text, wall = run_module(["repro_torch.launch.train", "--smoke",
                                 "--steps", "20", "--microbatches", "2",
                                 "--compression", "int8",
                                 "--simulate-failure", "--ckpt-dir", d])
    done = [ln for ln in text.splitlines() if ln.startswith("done:")]
    check(bool(done) and math.isfinite(float(done[-1].split("=")[-1])),
          f"launcher_train: no finite 'done:' line:\n{text[-2000:]}")
    runs = {"launcher": wall}
    for script, args, want in (
            ("torch_train_small.py", ["--steps", "40"], "loss "),
            ("torch_quickstart.py", [], "== numpy GEMV? True")):
        text, wall = run_module([str(ROOT / "examples" / script), *args],
                                module=False)
        check(want in text, f"{script}: no '{want}' in:\n{text[-2000:]}")
        runs[script] = wall
    close("launcher_train", t0)
    out["launcher_train"] = dict(runs, done=done[-1])
    print(f"[11] launcher_train: {done[-1]}; seconds {json.dumps(runs)}")
    out["phase_wall_s"] = sum(walls.values())
    return out


LOWERING_CELLS = (("granite-8b", "train_4k", "pod1", "baseline"),
                  ("granite-8b", "prefill_32k", "pod1", "baseline"),
                  ("granite-8b", "decode_32k", "pod1", "baseline"),
                  ("granite-8b", "train_4k", "pod2", "baseline"),
                  ("dbrx-132b", "decode_32k", "pod1", "baseline"),
                  ("granite-8b", "decode_32k", "pod1", "serve-tp-w4-kv8"))


def lane_mesh_and_lowering(dev, card: str,
                           single_s: float | None = None) -> dict:
    """Phase 12: the lane mesh on the card and the dry-run's cell
    lowering.  ``single_s``: phase 11's single-device report seconds,
    printed beside the mesh's.  The six lowering cells run as ``dryrun`` processes in the
    background while the lane-mesh parts use the card; the lane-scan
    launch count is set to 0 before ``lane_mesh`` and read after
    ``serve_mesh`` (the subprocesses count their own)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import engine, faults
    from repro_torch.kernels import lane_scan
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.serving import scenarios as scen
    from repro_torch.serving.offload import OffloadPlanner

    walls: dict = {}
    out: dict = {"walls": walls}

    def close(part: str, t0: float) -> None:
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t0
        print(f"[12] {part}: {walls[part]!r} s wall ({card})")

    # -- lowering: six cells, one process each, started first ------------
    t_low = time.perf_counter()
    procs = []
    for arch, shape, mesh, variant in LOWERING_CELLS:
        args = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--mesh", mesh, "--variant",
                variant]
        procs.append(subprocess.Popen(
            args, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    # -- lane_mesh: granite-8b's report over four shards of the card -----
    fx = json.loads((ROOT / "tests/golden/torch_pim_report.json").read_text())
    mesh = engine.build_lane_mesh(4, [dev] * 4)
    t0 = time.perf_counter()
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0
    engine.MESH_SHARD_LAUNCHES.clear()
    with engine.lane_mesh_scope(mesh):
        check(engine.ladder_rungs() == ["mesh", "scan"],
              f"lane mesh ladder {engine.ladder_rungs()}")
        rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                        policy="hysteresis", disagg=True,
                                        device=dev)
    torch.cuda.synchronize()
    check(engine.lane_mesh() is None, "the lane mesh scope leaked")
    check(json.loads(json.dumps(rec)) == fx,
          "lane_mesh: granite-8b's report != tests/golden/"
          "torch_pim_report.json")
    shards = dict(engine.MESH_SHARD_LAUNCHES)
    check(sorted(shards) == [0, 1, 2, 3] and min(shards.values()) >= 1,
          f"lane_mesh: lane-scan launches by shard {shards}")
    mesh_launches = lane_scan.LAUNCHES
    close("lane_mesh", t0)
    beside = ("" if single_s is None else
              f" (phase 11's single-device report: {single_s!r} s)")
    print(f"[12] lane_mesh: granite-8b's report over 4 shards of {dev} == "
          f"tests/golden/torch_pim_report.json in {walls['lane_mesh']!r} s"
          f"{beside}; {mesh_launches} lane-scan launches, by shard "
          f"{json.dumps(shards)}")

    # the same report with every mesh launch failing: scan takes over
    t0 = time.perf_counter()
    engine.lane_cache_reset()
    faults.reset_events()
    inj = faults.FaultInjector()
    inj.arm("backend.mesh", count=1_000_000)
    before = lane_scan.LAUNCHES
    with faults.fault_scope(inj), faults.retry_scope(
            retries=1, clock=faults.VirtualClock()), \
            engine.lane_mesh_scope(mesh):
        rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                        policy="hysteresis", disagg=True,
                                        device=dev)
    torch.cuda.synchronize()
    steps = [(e["site"], e["kind"]) for e in faults.events()]
    faults.reset()          # events, injector and the tripped breaker
    check(json.loads(json.dumps(rec)) == fx,
          "lane_mesh_fault: the report changed on the scan rung")
    check(("backend.mesh", "degrade") in steps,
          "lane_mesh_fault: no step-down from backend.mesh")
    check(not any(site == "backend.scan" for site, _k in steps),
          "lane_mesh_fault: the scan rung faulted")
    check(lane_scan.LAUNCHES > before, "lane_mesh_fault: scan never ran")
    close("lane_mesh_fault", t0)
    print(f"[12] lane_mesh_fault: backend.mesh failing on every attempt: "
          f"{steps.count(('backend.mesh', 'degrade'))} step-downs to "
          f"backend.scan, then {steps.count(('backend.mesh', 'skip'))} "
          f"skips with the breaker open; report == the golden, "
          f"{lane_scan.LAUNCHES - before} scan launches")

    t0 = time.perf_counter()
    text, _wall = run_module(["repro_torch.launch.dryrun", "--pim", "--arch",
                              "granite-8b", "--scenario", "bursty",
                              "--policy", "hysteresis", "--disagg",
                              "--mesh", "4"], timeout=300)
    got = json.loads((ROOT / "experiments/dryrun_torch/pim/granite-8b.json")
                     .read_text())
    check(got == fx, "dryrun --pim --mesh 4: granite-8b.json != the golden")
    check("[pim] lane mesh: 4 shard(s)" in text,
          "dryrun --pim --mesh 4 did not take the lane mesh")
    close("lane_mesh_cli", t0)

    # -- serve_mesh: serve_trace through the 36-layer model, mesh=4 ------
    t0 = time.perf_counter()
    cfg = ARCHS["granite-8b"]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    engine.lane_cache_reset()
    engine.MESH_SHARD_LAUNCHES.clear()
    planner = OffloadPlanner(cfg, device=dev)
    fixture = json.loads((ROOT / "tests/golden/serve_trace.json").read_text())
    got = scen.replay_trace(fixture, cfg, params, planner, mesh=4,
                            device=dev)
    torch.cuda.synchronize()
    check(engine.lane_mesh() is None, "serve_mesh: the mesh scope leaked")
    check(json.loads(json.dumps(got)) == fixture,
          "serve_mesh: serve_trace not reproduced under mesh=4")
    serve_shards = dict(engine.MESH_SHARD_LAUNCHES)
    check(sorted(serve_shards) == [0, 1, 2, 3],
          f"serve_mesh: lane-scan launches by shard {serve_shards}")
    del params, planner
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = lane_scan.LAUNCHES
    close("serve_mesh", t0)
    print(f"[12] serve_mesh: serve_trace == the golden through the "
          f"{cfg.n_layers}-layer {cfg.name} with mesh=4, launches by shard "
          f"{json.dumps(serve_shards)}")

    # -- lowering: collect the six records --------------------------------
    rows = []
    for (arch, shape, mesh_name, variant), proc in zip(LOWERING_CELLS,
                                                       procs):
        try:
            text, _ = proc.communicate(timeout=max(
                30, 280 - (time.perf_counter() - t_low)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"lowering: {arch} {shape} {mesh_name} {variant} "
                 f"timed out")
        check(proc.returncode == 0,
              f"lowering: {arch} {shape} {mesh_name} {variant} exited "
              f"{proc.returncode}: {text[-1500:]}")
        rec = json.loads(dryrun._out_path(arch, shape, mesh_name, variant)
                         .read_text())
        check(rec["status"] == "ok", f"lowering: {arch} {shape} "
              f"{mesh_name} {variant}: {rec.get('error')}")
        row = rec["roofline"]
        rows.append(dict(variant=variant, flops_dev=rec["flops"],
                         collective=rec["collective"],
                         arg_gib_dev=rec["per_device_arg_gib"],
                         lower_s=rec["lower_s"], wall_s=rec["wall_s"],
                         device_type=rec["device_type"], **row))
        print(f"[12] lowering: {arch} {shape} {mesh_name} {variant}: "
              f"{rec['flops']!r} flops/device, collective bytes "
              f"{json.dumps(rec['collective'])}, "
              f"{rec['per_device_arg_gib']!r} GiB of arguments/device, "
              f"useful_ratio {row['useful_ratio']!r}, t_compute "
              f"{row['t_compute_s']!r} s, t_memory {row['t_memory_s']!r} s, "
              f"t_collective {row['t_collective_s']!r} s "
              f"({row['bottleneck']}), traced {rec['lower_s']} s on "
              f"{rec['device_type']} fake tensors ({card})")
    out["lowering"] = rows
    walls["lowering"] = time.perf_counter() - t_low
    print(f"[12] lowering: {walls['lowering']!r} s wall for the six cells "
          f"in parallel processes ({card})")
    return out


def run_module(args: list[str], module: bool = True, timeout: int = 600
               ) -> tuple[str, float]:
    """``python -m ARGS`` (or ``python ARGS`` with ``module=False``) in a
    fresh process on this checkout's sources: its standard output and
    wall seconds.  Fails on a nonzero exit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *(["-m"] if module else []),
                          *args], capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=ROOT)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"{args} exited {out.returncode}:\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout, wall


def profile_step(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall (ending in a
    synchronize), device time, busy share, kernel launches and the five
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    launches, by_kernel = kernel_times(prof)
    device_ms = sum(us for us, _k, _n in by_kernel) / 1e3
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, launches=launches,
                top_kernels=[dict(kernel=k, ms=us / 1e3, calls=n)
                             for us, k, n in sorted(by_kernel,
                                                    reverse=True)[:5]])


def kernel_times(prof) -> tuple[int, list]:
    """A ``torch.profiler`` run's kernel launches, and (device us, kernel
    name, calls) of each CUDA kernel (CPU ops carry their kernels' time
    too: each kernel is counted once)."""
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                 "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    return launches, [(ev.self_device_time_total, ev.key[:80], ev.count)
                      for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA]


def profile_decode(M, cfg, params, cache, tok, pos, steps: int = 3) -> dict:
    """Device time and kernel launches per decode step, and the five
    kernels with the most device time, from ``torch.profiler`` over
    ``steps`` steps (device_ms 0 when the profiler saw no device
    activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _logits, cache = M.decode_step(cfg, params, cache, tok, pos)
            pos = pos + 1
        torch.cuda.synchronize()
    launches, by_kernel = kernel_times(prof)
    device_us = sum(us for us, _k, _n in by_kernel)
    top = [dict(kernel=k, ms=us / 1e3 / steps, calls=n / steps)
           for us, k, n in sorted(by_kernel, reverse=True)[:5]]
    return dict(device_ms=device_us / 1e3 / steps,
                launches_per_step=launches / steps, top_kernels=top)


def _items(tree, path=()):
    """(key path, leaf) of a nested dict (tuples of leaves, as the KV
    cache holds, indexed), in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, (*path, str(k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, (*path, str(i)))
    else:
        yield path, tree


def _leaves(tree):
    return (t for _, t in _items(tree))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import granite_8b
    from repro_torch.core import engine
    from repro_torch.core.pimsim import PimSimulator
    from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings,
                                         PimSpec, SystemSpec)
    from repro_torch.kernels import build, lane_scan
    from repro_torch.pimkernel.executor import (FunctionalGemv,
                                                GemvRequest, PimExecutor)
    from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType
    from repro_torch.serving.offload import OffloadPlanner

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = smi("name,power.limit")
    print(card)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"card: {torch.cuda.get_device_name(0)}, max SM clock {sm_mhz} "
          f"MHz, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    print(f"[1] kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_INFO['seconds']:.2f} s)")
    for source, log in build.BUILD_INFO["logs"].items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        print(f"    ptxas {source}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill "
              f"bytes {spills}")
    lane_ptxas = ptxas_kernels(build.BUILD_INFO["logs"].get("lane_scan.cu",
                                                            ""),
                               r"lane_scan_kernel")
    for k in lane_ptxas:
        print(f"    ptxas {k['name']} (NB): {k['registers']} registers, "
              f"{k['spill_bytes']} spill bytes")
    check(not build.BUILD_INFO["logs"]
          or len(lane_ptxas) == len(lane_scan.SUPPORTED_BANKS),
          f"ptxas reported {len(lane_ptxas)} lane-scan kernels")
    gemm_log = build.BUILD_INFO["logs"].get("pim_gemm.cu", "")
    gemv_log = build.BUILD_INFO["logs"].get("pim_gemv.cu", "")
    kernel_ptxas = {
        "pim_gemm_fp": ptxas_kernels(gemm_log, r"gemm_fp_mma_kernel"),
        "pim_gemm_int": ptxas_kernels(gemm_log, r"gemm_int_mma_kernel"),
        "pim_gemv_int": ptxas_kernels(gemv_log, r"gemv_int_rows_kernel")}
    for name, log, want, params in (
            ("pim_gemm_fp", gemm_log, 4, "XBYTES, NT"),
            ("pim_gemm_int", gemm_log, 8, "WBITS, XBYTES, NT"),
            ("pim_gemv_int", gemv_log, 6, "WBITS, XBYTES, R")):
        for k in kernel_ptxas[name]:
            print(f"    ptxas {k['name']} ({params}): {k['registers']} "
                  f"registers, {k['spill_bytes']} spill bytes")
        check(not log or len(kernel_ptxas[name]) == want,
              f"ptxas reported {len(kernel_ptxas[name])} vector {name} "
              f"kernels, not {want}")

    # ---- 2. kernel == plain on the card ---------------------------------
    rng = np.random.default_rng(0)
    worst = 0

    def compare(cycs, streams, lengths, nb, what):
        nonlocal worst
        args = (cycs.to(dev), streams.to(dev), lengths.to(dev), nb)
        for need_issue in (True, False):
            ik, tk = lane_scan.lane_scan(*args, need_issue=need_issue)
            ip, tp = lane_scan.lane_scan_plain(*args, need_issue=need_issue)
            torch.cuda.synchronize()
            err = int((tk.long() - tp.long()).abs().max()) if tk.numel() \
                else 0
            if need_issue and ik.numel():
                err = max(err, int((ik.long() - ip.long()).abs().max()))
            worst = max(worst, err)
            check(err == 0, f"kernel != plain on {what} "
                  f"(need_issue={need_issue}, max abs err {err})")

    def fuzz(nb: int, f: int, n: int):
        cycs = rng.integers(0, 64, size=(f, len(lane_scan.CYC_FIELDS)))
        wrap = rng.random(cycs.shape) < 0.03       # int32 wraparound
        cycs = np.where(wrap, (1 << 30) + rng.integers(0, 1 << 20,
                                                       cycs.shape), cycs)
        streams = np.zeros((f, n, 4), np.int64)
        streams[..., 0] = rng.integers(0, 17, size=(f, n))
        odd = rng.random((f, n)) < 0.05
        streams[..., 0] = np.where(odd, rng.integers(-40, 60, (f, n)),
                                   streams[..., 0])
        streams[..., 1] = rng.integers(0, nb, size=(f, n))
        odd = rng.random((f, n)) < 0.05
        streams[..., 1] = np.where(odd, rng.integers(-2 * nb, 3 * nb,
                                                     (f, n)),
                                   streams[..., 1])
        streams[..., 2:] = rng.integers(0, 128, size=(f, n, 2))
        lengths = rng.integers(0, n + 1, size=f)
        lengths[0] = n
        as_i32 = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x, dtype=np.int32))
        return as_i32(cycs), as_i32(streams), as_i32(lengths)

    for nb in lane_scan.SUPPORTED_BANKS:
        compare(*fuzz(nb, 8, 64), nb, f"fuzzed lanes, {nb} banks")
    for nb in (8, 12, 16):
        compare(*fuzz(nb, 96, 400), nb, f"long fuzzed lanes, {nb} banks")
        spec = SystemSpec(timings=LpddrTimings(num_bankgroups=nb // 4))
        probe = lane_scan.probe_stream(nb)[None].contiguous()
        compare(engine.pack_cycles([spec.derive_cycles()]), probe,
                torch.tensor([probe.shape[1]], dtype=torch.int32), nb,
                f"probe lane, {nb} banks")

    # The PIM streams of one Fig-4 point (512 x 4096 W8A8, ~8k commands
    # per channel: the plain side stays short enough for the card).
    fig4 = PimExecutor(device=dev).plan_many(
        [GemvRequest.pim(512, 4096, PimDType.W8A8)])[0]
    pim_inputs = engine.pack_lanes([(fig4.ctx.cyc, s)
                                    for s in fig4.streams])
    compare(*pim_inputs, 16, "Fig-4 PIM streams 512x4096 W8A8")
    steps = int(pim_inputs[2].max())
    cu = [x.to(dev) for x in pim_inputs]
    plain_ms = timed_ms({"plain": lambda: lane_scan.lane_scan_plain(
        *cu, 16, need_issue=False)}, 1)["plain"]["ms"]
    short_kernel_ms = timed_ms({"kernel": lambda: lane_scan.lane_scan(
        *cu, 16, need_issue=False)}, 9)["kernel"]["ms"]
    print(f"[2] kernel == plain on the card (max abs err {worst}); "
          f"Fig-4 PIM lanes ({cu[1].shape[0]} x {steps} steps): plain "
          f"{plain_ms:.1f} ms, kernel {short_kernel_ms:.3f} ms")

    # ---- 3. the reference's numbers at full width ------------------------
    def record(res) -> dict:
        return dict(cycles=res.cycles, ns=res.ns, flops=res.flops,
                    weight_bytes=res.weight_bytes,
                    utilization=res.utilization, split=res.split,
                    counts=[int(c) for c in res.counts], energy=res.energy)

    def roundtrip(x):
        return json.loads(json.dumps(x))

    golden_specs = {"lp5x-9600": DEFAULT_SYSTEM,
                    "rcd24-mac2": SystemSpec(timings=LpddrTimings(tRCD=24.0),
                                             pim=PimSpec(mac_interval_ck=2))}
    fixture = json.loads((ROOT / "tests/golden/fleet_parity.json")
                         .read_text())
    reqs = []
    for label in fixture:
        sname, rest = label.split("/")
        kind, shape, dt, *flags = rest.split("-")
        h, w = (int(v) for v in shape.split("x"))
        sp = golden_specs[sname]
        reqs.append(GemvRequest.pim(h, w, dt, fence="fence" in flags,
                                    reshape="reshape" in flags, spec=sp)
                    if kind == "pim" else GemvRequest.baseline(h, w, dt,
                                                               spec=sp))
    got = PimExecutor(device=dev).run_many(reqs)
    check(roundtrip({k: record(r) for k, r in zip(fixture, got)}) == fixture,
          "fleet_parity.json not reproduced")

    points = json.loads((ROOT / "tests/golden/torch_port_points.json")
                        .read_text())
    quick = [("pim-4096x4096-W8A8", dict()),
             ("pim-4096x4096-W8A8-fence", dict(fence=True)),
             ("pim-1024x4096-W8A8", dict()),
             ("pim-1024x4096-W8A8-reshape", dict(reshape=True))]

    def quickstart_records(sim) -> dict:
        out = {"base-4096x4096-W8A8": record(sim.baseline(4096, 4096,
                                                          "W8A8"))}
        for label, kw in quick:
            h = int(label.split("-")[1].split("x")[0])
            out[label] = record(sim.gemv(h, 4096, "W8A8", **kw))
        return roundtrip(out)

    check(quickstart_records(PimSimulator(device=dev))
          == points["quickstart"], "quickstart points not reproduced")

    def plan_records(planner) -> list:
        return roundtrip([dict(site=d.site.name, h=d.site.h, w=d.site.w,
                               count=d.site.count, pim_ns=d.pim_ns,
                               host_ns=d.host_ns, reshape=d.reshape,
                               offload_below_batch=d.offload_below_batch)
                          for d in planner.plan()])

    planner = OffloadPlanner(granite_8b.CONFIG, device=dev)
    check(plan_records(planner) == points["granite_8b_plan"],
          "granite-8b offload plan not reproduced")
    print(f"[3] fleet_parity.json ({len(fixture)} points) and "
          f"torch_port_points.json (quickstart + granite-8b plan, "
          f"{len(points['granite_8b_plan'])} sites) reproduced exactly")

    # ---- 4. the main path ------------------------------------------------
    # Each part's wall, split: the wrappers below add their seconds to
    # the running part's pieces; a synchronize before the kernel closes
    # the copies, and the kernel's results are read back here.
    launched: list[tuple] = []
    real_scan = lane_scan.lane_scan
    real_pack = engine.pack_lanes
    real_plan = PimExecutor.plan_many
    pieces = ("plan_many", "pack_copy", "kernel", "read_back")
    split: dict = {}
    packed_at = [0.0]

    def timed_plan(self, reqs):
        t = time.perf_counter()
        out = real_plan(self, reqs)
        split[part]["plan_many"] += time.perf_counter() - t
        return out

    def timed_pack(lanes):
        packed_at[0] = time.perf_counter()
        return real_pack(lanes)

    def recording_scan(*args, **kw):     # keeps the inputs for phase 5
        torch.cuda.synchronize()
        split[part]["pack_copy"] += time.perf_counter() - packed_at[0]
        launched.append((part, args, kw))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        iss, tot = real_scan(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        split[part]["kernel"] += start.elapsed_time(end) / 1e3
        t = time.perf_counter()
        out = (None if iss is None else iss.cpu(), tot.cpu())
        split[part]["read_back"] += time.perf_counter() - t
        return out

    lane_scan.lane_scan = recording_scan
    engine.pack_lanes = timed_pack
    PimExecutor.plan_many = timed_plan
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0
    walls, launches = {}, {}
    for p in ("quickstart", "fig4_sweep", "granite_8b_decode"):
        split[p] = dict.fromkeys(pieces, 0.0)

    part = "quickstart"
    t0 = time.perf_counter()
    sim = PimSimulator(device=dev)
    check(quickstart_records(sim) == points["quickstart"],
          "quickstart numbers changed on the main path")
    qrng = np.random.default_rng(0)
    wts = qrng.integers(-128, 128, size=(256, 2048)).astype(np.int32)
    x = qrng.integers(-128, 128, size=(2048,)).astype(np.int32)
    y, res = sim.gemv_functional(wts, x, "W8A8")
    check(np.array_equal(y, wts.astype(np.int64) @ x.astype(np.int64)),
          "functional GEMV != W @ x")
    items = []
    for hs, ws in ((128, 512), (192, 1024), (64, 2048)):
        items.append(FunctionalGemv(
            qrng.integers(-8, 8, size=(hs, ws)).astype(np.int32),
            qrng.integers(-8, 8, size=(ws,)).astype(np.int32),
            PimDType.W4A8))
    for it, (yv, _r) in zip(items, sim.gemv_functional_many(items)):
        check(np.array_equal(yv, it.weights.astype(np.int64)
                             @ it.x.astype(np.int64)),
              "batched functional GEMV != W @ x")
    torch.cuda.synchronize()
    walls[part] = time.perf_counter() - t0
    launches[part] = lane_scan.LAUNCHES

    part = "fig4_sweep"
    t0 = time.perf_counter()
    dims = [512, 1024, 2048, 4096, 8192]
    surfaces = {axis: sim.sweep(dims, ALL_DTYPES, axis=axis)
                for axis in ("activation", "output")}
    torch.cuda.synchronize()
    walls[part] = time.perf_counter() - t0
    launches[part] = lane_scan.LAUNCHES - sum(launches.values())
    head = (points["quickstart"]["base-4096x4096-W8A8"]["ns"]
            / points["quickstart"]["pim-4096x4096-W8A8"]["ns"])
    for axis, surf in surfaces.items():
        check(sorted(surf) == sorted(d.name for d in ALL_DTYPES),
              f"sweep {axis}: dtypes {sorted(surf)}")
        vals = np.asarray([surf[d.name] for d in ALL_DTYPES])
        check(vals.shape == (7, 5) and bool(np.isfinite(vals).all())
              and bool((vals > 0).all()), f"sweep {axis}: {vals}")
        check(surf["W8A8"][dims.index(4096)] == head,
              f"sweep {axis}: 4096x4096 W8A8 point != quickstart")

    part = "granite_8b_decode"
    t0 = time.perf_counter()
    tel = OffloadPlanner(granite_8b.CONFIG,
                         sim=PimSimulator(device=dev)).decode_speedup(1)
    torch.cuda.synchronize()
    walls[part] = time.perf_counter() - t0
    launches[part] = lane_scan.LAUNCHES - sum(launches.values())
    lane_scan.lane_scan = real_scan
    engine.pack_lanes = real_pack
    PimExecutor.plan_many = real_plan
    check(roundtrip(tel) == points["granite_8b_decode_speedup_b1"],
          "granite-8b decode speedup != fixture")
    total_launches = lane_scan.LAUNCHES
    check(total_launches > 0 and all(v > 0 for v in launches.values()),
          f"main path did not launch the kernel: {launches}")
    for p in walls:
        split[p]["other"] = walls[p] - sum(split[p].values())
        print(f"[4] {p}: {walls[p]:.3f} s wall, {launches[p]} kernel "
              f"launches; seconds: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split[p].items()))
    print(f"[4] W8A8 4096x4096 speedup {head:.3f}x; granite-8b decode "
          f"speedup at batch 1: {tel['speedup']:.4f}x "
          f"({len(tel['offloaded'])}/{tel['n_sites']} sites offloaded)")

    # ---- 5. the kernel at the main path's launches ----------------------
    def bound(args, need_issue: bool) -> tuple[float, str]:
        cycs, streams, lengths = args[0], args[1], args[2]
        f, n = streams.shape[0], streams.shape[1]
        nbytes = (16 * int(lengths.sum()) + 4 * cycs.numel()
                  + 4 * lengths.numel() + 4 * f
                  + (4 * f * n if need_issue else 0))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        chain_ms = (int(lengths.max()) * CHAIN_CYCLES_PER_STEP
                    / (sm_mhz * 1e6) * 1e3)
        return max(bytes_ms, chain_ms), ("operations" if chain_ms
                                         >= bytes_ms else "bytes")

    fleets = {}
    for p in ("fig4_sweep", "granite_8b_decode"):
        runs = [(a, kw) for q, a, kw in launched if q == p]
        ms = bound_ms = 0.0
        spread = [0.0, 0.0]
        by = "operations"
        for args, kw in runs:
            t = timed_ms({"kernel": lambda: real_scan(*args, **kw)},
                         LANE_REPS)["kernel"]
            ms += t["ms"]
            spread = [spread[0] + t["min_ms"], spread[1] + t["max_ms"]]
            b, by = bound(args, kw.get("need_issue", True))
            bound_ms += b
        fleets[p] = dict(
            launches=len(runs), ms=ms, spread=spread, launches_timed=LANE_REPS,
            bound_ms=bound_ms, bound_by=by,
            lanes=sum(int(a[1].shape[0]) for a, _ in runs),
            commands=sum(int(a[2].sum()) for a, _ in runs),
            longest_lane=max(int(a[2].max()) for a, _ in runs))
        print(f"[5] {p}: {json.dumps(fleets[p])}")
    del launched

    # ---- 6-7. the PIM-tile quantized linear layer ------------------------
    from repro_torch.kernels import pim_gemm, pim_gemv

    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32: the fp plain versions need "
          "full float32")
    mods = {"pim_gemv_int": pim_gemv, "pim_gemv_fp": pim_gemv,
            "pim_gemm_int": pim_gemm, "pim_gemm_fp": pim_gemm}
    plain = {name: getattr(mod, f"{name}_plain") for name, mod in mods.items()}
    worst_pim = pim_kernels_vs_plain(dev, mods, plain)
    linear = granite_8b_linear(
        dev, mods, plain,
        json.loads((ROOT / "tests/golden/torch_pim_linear.json").read_text()))
    headline = {"pim_gemv_int": "W8A8", "pim_gemv_fp": "FP_W8A8",
                "pim_gemm_int": "W8A8", "pim_gemm_fp": "FP_W8A8"}
    pim_entries = []
    for name, (replaces, source) in PIM_KERNELS.items():
        by_dtype = {d: t for (n, d), t in linear["timed"].items() if n == name}
        head = by_dtype[headline[name]]
        pim_entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": linear["launches"][name],
            "max_abs_err": max(worst_pim[name],
                               max(t["max_abs_err"]
                                   for t in by_dtype.values())),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "matches_plain": True,
            "ms_on": f"lm_head 49152x4096 {headline[name]}, batch "
                     f"{head['batch']}, granite_8b_linear's operands; median "
                     f"of {KERNEL_REPS} launches, L2 flushed before each, in "
                     f"turns with the library call",
            "library_on": ("torch._int_mm, batch padded to 32"
                           if name.endswith("_int")
                           else "torch._scaled_mm, unit scales, batch "
                                "padded to 16"),
            "granite_8b_linear_wall_s": linear["wall"],
            "by_dtype": by_dtype,
            **({"variants": linear["variants"][name],
                "ptxas": kernel_ptxas[name]} if name in kernel_ptxas
               else {}),
            **({"sites": {k: v for k, v in linear["gemv_int_sites"].items()
                          if k != "sites"},
                "mma_at_batch_1": linear["mma_at_batch_1"]}
               if name == "pim_gemv_int" else {})})

    # ---- 8. serving without a model ---------------------------------------
    serving = serving_without_a_model(dev, card)

    # ---- 9. serving with a model --------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    with_model = serving_with_a_model(dev, card)

    # ---- 10. the rest of serving ---------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    rest = serving_rest(dev, card)

    # ---- 11. the dry-run's PIM report and training --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    training = training_and_report(dev, card)

    # ---- 12. the lane mesh and the dry-run's cell lowering -------------------
    gc.collect()
    torch.cuda.empty_cache()
    meshes = lane_mesh_and_lowering(dev, card,
                                    training["walls"]["pim_report"])

    main_fleet = fleets["granite_8b_decode"]
    kernels = {"kernels": [{
        "name": "lane_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_scan.cu",
        "replaces": "src/repro/kernels/lane_scan.py:49",
        "launches": (total_launches + serving["launches"]
                     + with_model["launches"] + rest["launches"]
                     + training["launches"] + meshes["launches"]),
        "max_abs_err": worst,
        "ms": main_fleet["ms"], "plain_ms": plain_ms,
        "bound_ms": main_fleet["bound_ms"],
        "bound_by": main_fleet["bound_by"], "library_ms": None,
        "matches_plain": worst == 0,
        "ms_on": "granite-8b decode_speedup fleet, LRU cold",
        "plain_on": f"Fig-4 PIM 512x4096 W8A8 lanes ({steps} steps)",
        "kernel_ms_on_plain_inputs": short_kernel_ms,
        "fleets": fleets, "ptxas": lane_ptxas,
        "part_seconds": {p: dict(wall=walls[p], **split[p])
                         for p in walls},
        "launches_by_phase": {"4": total_launches,
                              "8": serving["launches"],
                              "9": with_model["launches"],
                              "10": rest["launches"],
                              "11": training["launches"],
                              "12": meshes["launches"]},
        "serving": serving, "serving_with_a_model": with_model,
        "serving_rest": rest,
        "pim_report": {k: training[k] for k in ("launches",
                                                 "pim_report_all_s")},
        "training": {k: v for k, v in training.items()
                     if k not in ("launches", "pim_report_all_s")},
        "lane_mesh_and_lowering": meshes},
        *pim_entries]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
