"""The traffic generator: deterministic in the seed, the same work for
every seed, and never a spec a sweep window has already seen."""
from __future__ import annotations

import collections
import json

import tinyroot  # noqa: F401  (puts the repo on the path)

from bench import generator
from bench.reference import sim

ROOT = tinyroot.ROOT


def _mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def test_deterministic_in_the_seed():
    mix = _mix("sweep_cold")
    space = generator.spec_space(ROOT, mix)
    big = 2 ** 31 + 4093
    assert generator.sweep_queries(mix, space, big, 3) == \
        generator.sweep_queries(mix, space, big, 3)
    assert generator.sweep_queries(mix, space, big, 3) != \
        generator.sweep_queries(mix, space, big + 1, 3)
    assert generator.sweep_queries(mix, space, 2 ** 40 + 1, 1)
    smix = _mix("serve_decode")
    a = generator.serve_requests(smix, big, 49152, 2)
    b = generator.serve_requests(smix, big, 49152, 2)
    assert all((x["prompt"] == y["prompt"]).all()
               and x["max_new"] == y["max_new"] for x, y in zip(a, b))


def test_a_sweep_window_never_repeats_a_spec():
    mix = _mix("sweep_cold")
    space = generator.spec_space(ROOT, mix)
    for seed in (1, 2 ** 31 + 99):
        queries = generator.sweep_queries(mix, space, seed, 1 + 150)
        keys = [(d["num_channels"], sim.cycles_key(sim.spec_from_dict(d)))
                for q in queries for d in q]
        assert len(keys) == len(set(keys)) == 151 * 8
        for q in queries:          # the same lane lengths in every query
            assert collections.Counter(d["num_channels"] for d in q) == \
                {2: 4, 4: 4}
        for d in (d for q in queries for d in q):
            for k in ("tRCD", "tRP", "tRAS", "tRC", "tRL"):
                lo, hi = space["spans"][k]
                assert lo <= d["timings"][k] <= hi


def test_every_seed_serves_the_same_lengths():
    mix = _mix("serve_decode")
    blocks = []
    for seed in (3, 2 ** 31 + 5):
        reqs = generator.serve_requests(mix, seed, 49152, 4)
        for b in range(4):
            blk = reqs[b * mix["block"]:(b + 1) * mix["block"]]
            blocks.append((sorted(len(q["prompt"]) for q in blk),
                           sorted(q["max_new"] for q in blk)))
            assert all(0 <= q["prompt"].min() and q["prompt"].max() < 49152
                       for q in blk)
    assert all(b == blocks[0] for b in blocks)
    lens = blocks[0][0]
    assert mix["prompt_len"][0] <= lens[0] and lens[-1] <= \
        mix["prompt_len"][1]
