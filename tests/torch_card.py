"""Helpers shared by the port's card tests, its CPU tests and
``chip_smoke.py``: fixture inputs and comparisons, the paired CPU / card
model runs, the launchers in fresh processes, and the tracer's kernel
launch counters.

Not a test module (pytest collects nothing here).  It imports only the
standard library, numpy, torch and ``repro_torch``, never JAX, so the
card's tests load it under ``--noconftest`` on a machine without JAX.
"""
import hashlib
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def launch_counts() -> dict:
    """Every kernel launch counter of the tracer (``core/trace.py``) that
    is not 0: ``lane_scan.launches``, ``pim_gemv_int.launches.<variant>``,
    ``pim_gemv_fp.launches``, ``pim_gemm_int.launches.<variant>``,
    ``pim_gemm_fp.launches.<variant>`` and ``engine.mesh_launches.<k>``."""
    from repro_torch.core import trace

    return {k: v for k, v in trace.totals().counts.items()
            if ".launches" in k or ".mesh_launches." in k}


def launches(prefix: str) -> int:
    """The launches counted under ``prefix`` (a kernel, one of its
    variants, or the mesh rung's shards), summed."""
    return sum(v for k, v in launch_counts().items()
               if k == prefix or k.startswith(prefix + "."))


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
    assert row is not None, f"no serve/lane_cache row in:\n{out}"
    return {k: int(v) for k, v in
            (kv.split("=") for kv in row.group(1).split(","))}


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
        assert torch.equal(out, want), (
            f"{name} != plain on {tuple(args[0].shape)} x "
            f"{tuple(args[1].shape)} {args[1].dtype}")
        return 0.0
    w8, x = args[0], args[1]
    wa, xa = w8.float().abs(), x.float().abs()
    lim = 2 * w8.shape[1] * 2.0 ** -24 * (wa @ xa if x.dim() == 1
                                          else xa @ wa.T)
    nan = want.isnan()
    assert torch.equal(out.isnan(), nan), \
        f"{name}: NaN positions differ from plain"
    diff = (out - want).abs()
    ok = (out == want) | (diff <= lim) | nan
    assert bool(ok.all()), (
        f"{name}: {int((~ok).sum())} outputs off plain beyond the f32 sum "
        f"bound on {tuple(w8.shape)} x {tuple(x.shape)} {x.dtype}")
    finite = torch.isfinite(want)
    return float(diff[finite].max()) if bool(finite.any()) else 0.0


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the kernels then read it byte by byte)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


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
    assert out.returncode == 0, (f"{args} exited {out.returncode}:\n"
                                 f"{out.stdout[-2000:]}\n"
                                 f"{out.stderr[-4000:]}")
    return out.stdout, wall


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

