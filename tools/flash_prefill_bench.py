"""Time and peak memory of the port's flash attention on the card.

    PYTHONPATH=src python tools/flash_prefill_bench.py [--cases a,b]

The cases, at granite-8b's attention widths (32 query heads, 8 kv
heads, head dim 128):

* ``attn_prefill_32k``: ``layers.flash_attention`` forward over one
  32768-token bf16 sequence;
* ``attn_train_4k``: its forward and backward over one 4096-token bf16
  sequence;
* ``model_prefill_32k``: ``model.prefill`` of granite-8b cut to 2 layers
  (f32 weights drawn from seed 0) over a 32768-token prompt, the path a
  long prompt takes through serving.

Each case runs with ``FLASH_SKIP_BLOCKS`` off and on: one warm-up, then
the median of 3 runs timed with CUDA events, and the peak of
``torch.cuda.max_memory_allocated`` above what was allocated before the
call.  ``repro_torch`` comes from ``PYTHONPATH``, so the same script
measures another checkout's package.  Prints one JSON line a case and
the card's name and power limit.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess

import torch


def _measure(fn, reps: int = 3) -> dict:
    fn()
    torch.cuda.synchronize()
    times = []
    peak = 0
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        del out
    return dict(ms=statistics.median(times), ms_all=times,
                peak_bytes=peak)


def _attn_inputs(s: int, grad: bool):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, s, h, 128), generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(grad)
               for h in (32, 8, 8))
    return q, k, v


def case_attn_prefill_32k(L):
    q, k, v = _attn_inputs(32768, False)
    with torch.no_grad():
        return _measure(lambda: L.flash_attention(q, k, v))


def case_attn_train_4k(L):
    q, k, v = _attn_inputs(4096, True)

    def step():
        out = L.flash_attention(q, k, v)
        return torch.autograd.grad(out.float().square().sum(), (q, k, v))
    return _measure(step)


def case_model_prefill_32k(L):
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M
    cfg = dataclasses.replace(ARCHS["granite-8b"], n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, 32768), generator=g,
                         device="cuda")
    cache = M.init_cache(cfg, 1, 32768, torch.float32, device="cuda")
    with torch.no_grad():
        return _measure(lambda: M.prefill(cfg, params, {"tokens": toks},
                                          cache)[0])


CASES = {"attn_prefill_32k": case_attn_prefill_32k,
         "attn_train_4k": case_attn_train_4k,
         "model_prefill_32k": case_model_prefill_32k}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.models import layers as L
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    for name in args.cases.split(","):
        for skip in (False, True):
            L.FLASH_SKIP_BLOCKS = skip
            rec = dict(case=name, skip_blocks=skip, card=card,
                       chunk_scores=getattr(L, "FLASH_CHUNK_SCORES", None),
                       **CASES[name](L))
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    L.FLASH_SKIP_BLOCKS = False
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
