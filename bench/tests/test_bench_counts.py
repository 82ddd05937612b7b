"""The yardstick's counts against hand counts, and the readers that use
them."""
from __future__ import annotations

import pytest

import tinyroot

from bench import harness, peaks

G8 = dict(n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
          d_ff=14336, vocab=49152, mlp="swiglu")


def _reader(name):
    return harness.load_module(tinyroot.ROOT / "bench" / "metrics"
                               / f"{name}.py")


def test_lane_scan_bytes_by_hand():
    # two lanes of 3 and 5 commands: 8 x 16 B of commands, and per lane a
    # 28-field int32 timing row, a length and a total
    assert peaks.lane_scan_bytes([3, 5]) == 8 * 16 + 2 * (28 * 4 + 4 + 4)
    assert peaks.lane_scan_bytes([3, 5], need_issue=True) == \
        peaks.lane_scan_bytes([3, 5]) + 8 * 4
    # 1 GB of command bytes in 1 s of kernel time at 3.35 TB/s: 0.0298 %
    obs = dict(kernel_s=1.0, lane_bytes=1e9)
    assert abs(_reader("lane_scan_roofline").read(obs)
               - 100 * 1e9 / 3.35e12) < 1e-12
    assert _reader("lane_scan_roofline").read({}) is None


def test_granite_flops_by_hand():
    layers, head = peaks.matmul_params(G8)
    per_layer = (4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096
                 + 3 * 4096 * 14336)
    assert layers == 36 * per_layer and head == 4096 * 49152
    # one decode token at position 99: the matmuls, and scores plus
    # weighted values over 100 positions in 36 layers of 32 heads of 128
    assert peaks.decode_flops(G8, [99]) == \
        2 * (layers + head) + 2 * 2 * 36 * 32 * 128 * 100
    # a 3-token prompt: 3 tokens through the layers, causal contexts
    # 1 + 2 + 3, the head once
    assert peaks.prefill_flops(G8, 3) == \
        2 * layers * 3 + 4 * 36 * 32 * 128 * 6 + 2 * head
    obs = dict(model_flops=67e12, window_s=2.0)
    assert _reader("serve_step.mfu").read(obs) == 50.0


def test_readers_find_nothing_without_their_data():
    bench = harness.load_json(tinyroot.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert _reader(m["name"]).read({}) is None, m["name"]


def test_trace_reduction_by_hand():
    from bench import tracing

    ev = [dict(ph="X", name=tracing.WINDOW, cat="user_annotation", ts=0,
               dur=100),
          dict(ph="X", name="query", cat="user_annotation", ts=0, dur=100),
          dict(ph="X", name="plan_many", cat="user_annotation", ts=10,
               dur=30),
          dict(ph="X", name="k", cat="kernel", ts=50, dur=20),
          dict(ph="X", name="k", cat="kernel", ts=60, dur=20),
          dict(ph="X", name="copy", cat="gpu_memcpy", ts=90, dur=5),
          dict(ph="X", name="cudaLaunchKernel", cat="cuda_runtime", ts=20,
               dur=1),
          dict(ph="X", name="cudaLaunchKernel", cat="cuda_runtime", ts=45,
               dur=1)]
    got = tracing.reduce_trace(ev)
    # busy: [50, 80) and [90, 95); idle: [0, 50), [80, 90), [95, 100)
    assert got["busy_s"] == pytest.approx(35e-6)
    assert got["window_s"] == pytest.approx(100e-6)
    assert dict(got["idle_gaps"]) == pytest.approx({"query": 35e-6,
                                                    "plan_many": 30e-6})
    assert got["launches_by_span"] == {"plan_many": 1, "query": 1}
    assert got["device_ops"][0] == ["k", pytest.approx(40e-6)]
