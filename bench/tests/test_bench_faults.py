"""Whole runs on the CPU with the timed path broken underneath must come
out as not correct, and so must the controls: the reference put in the
program's place one precision lower."""
from __future__ import annotations

import json

import pytest
import torch

import tinyroot

from bench import control, generator


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinyroot.make(tmp_path_factory.mktemp("faults"))


def _scan_fault(kind):
    from repro_torch.kernels import lane_scan

    real = lane_scan.lane_scan

    def broken(cycs, streams, lengths, num_banks, need_issue=True):
        issue, tot = real(cycs, streams, lengths, num_banks, need_issue)
        tot = tot.clone()
        n = tot.shape[0] // 2
        if kind == "unchanged":          # the lane state never advances
            tot.zero_()
        elif kind == "half" and n:       # half left out, the mean taken
            tot[n:] = tot[:n].float().mean().round().int()
        elif kind == "one":              # one lane of a launch altered
            tot[-1] += 1
        else:                            # every answer off by a cycle
            tot += 1
        return issue, tot

    return lane_scan, broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "one", "altered"])
def test_sweep_faults_are_caught(root, monkeypatch, kind):
    mod, broken = _scan_fault(kind)
    monkeypatch.setattr(mod, "lane_scan", broken)
    try:
        run = tinyroot.run(root, "tiny.sweep")
    except ZeroDivisionError:
        # the planner divides by a zero time: the run ends without a
        # result, which fails it as surely
        assert kind == "unchanged"
        return
    assert not run.correct, run.checks


def _decode_fault(kind, monkeypatch):
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E

    real_step = M.decode_step
    real_decode = E.DecodeLoop._decode

    def unchanged(cfg, params, cache, token, pos):
        saved = {k: tuple(t.clone() for t in v) if isinstance(v, tuple)
                 else v.clone() for k, v in cache.items()}
        logits, cache = real_step(cfg, params, cache, token, pos)
        for k, v in saved.items():
            for dst, src in zip(cache[k] if isinstance(v, tuple)
                                else (cache[k],),
                                v if isinstance(v, tuple) else (v,)):
                dst.copy_(src)
        return logits, cache

    def half(cfg, params, cache, token, pos):
        logits, cache = real_step(cfg, params, cache, token, pos)
        logits = logits.clone()
        n = logits.shape[0] // 2
        logits[n:] = logits[:n].mean(0)
        return logits, cache

    def altered(self, tokens):
        out = real_decode(self, tokens).copy()
        out[0] = (out[0] + 1) % self.cfg.vocab
        return out

    if kind == "altered":
        monkeypatch.setattr(E.DecodeLoop, "_decode", altered)
    else:
        monkeypatch.setattr(M, "decode_step",
                            unchanged if kind == "unchanged" else half)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_serve_faults_are_caught(root, monkeypatch, kind):
    _decode_fault(kind, monkeypatch)
    # a window long enough that requests of every slot finish, also on a
    # loaded host
    run = tinyroot.run(root, "tiny.serve", seconds=4.0)
    assert not run.correct, run.checks


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 13])
def test_the_float32_control_fails_the_simulated_numbers(seed):
    mix = json.loads((tinyroot.ROOT / "bench" / "traffic" / "sweep_cold.json")
                     .read_text())
    space = generator.spec_space(tinyroot.ROOT, mix)
    spec = generator.sweep_queries(mix, space, seed, 1)[0][0]
    got = control.sim_control(dict(tinyroot.TINY), spec, "W8A8", True)
    assert got["points"] > 0 and got["gap"] > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 22, 23])
def test_the_tf32_control_fails_served_tokens(root, seed):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    import time

    from bench import harness
    from bench.drivers import serve

    run = harness.execute(root, "mid.serve", seed, 10.0, False,
                          torch.device("cuda", 0), time.perf_counter())
    assert run.correct, run.checks
    assert control.serve_control(run) > serve.LOGIT_GAP_LIMIT
