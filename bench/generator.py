"""The benchmark's one traffic generator: a mix file's parameters and the
run's seed in, the cell's queries or requests out.

Every seed gets the same amount of work in another order and with other
values: a design-point query always holds the mix's count of specs per
channel count (the only spec field that changes a lane's length), and a
serving run's requests come in blocks that each hold the same prompt and
output lengths, shuffled by the seed.  Spec values are drawn inside the
spans of a spec space; no two specs of one run share their timing cycles, so no
lane of one repeats another's.  A spec space (the families and the spans
their values cover) sits in a file of its own, ``bench/specs/<name>.json``,
which a mix names under ``specs``.
"""
from __future__ import annotations

import copy
import json
import pathlib

import numpy as np

from bench.reference import sim


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Stream ``stream`` of the run's seed (any size of whole number)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def spec_space(root: pathlib.Path, mix: dict) -> dict:
    """The spec space the mix names: ``families``, ``spans``,
    ``ns_step``."""
    with open(root / "bench" / "specs" / f"{mix['specs']}.json") as f:
        return json.load(f)


class SpecDraw:
    """Draws design points inside a spec space's spans, each new to the
    run."""

    def __init__(self, space: dict, mix: dict, seed: int, stream: int = 0):
        self.space, self.mix = space, mix
        self.rng = rng_for(seed, stream)
        self.seen: set = set()
        self.families = list(space["families"].items())

    def _value(self, span):
        lo, hi = span
        step = self.space.get("ns_step", 0.25)
        return lo + step * int(self.rng.integers(0, round((hi - lo) / step)
                                                 + 1))

    def one(self, channels: int) -> dict:
        """A spec of ``channels`` channels: a family picked by the seed,
        then every spanned field drawn anew."""
        sp = self.space["spans"]
        for _ in range(1000):
            _name, fam = self.families[int(self.rng.integers(
                len(self.families)))]
            d = copy.deepcopy(fam)
            t = d.setdefault("timings", {})
            p = d.setdefault("pim", {})
            t["data_rate_mtps"] = int(self.rng.choice(sp["data_rate_mtps"]))
            for k in ("tRCD", "tRP", "tRAS", "tRC", "tRL"):
                t[k] = self._value(sp[k])
            p["mac_interval_ck"] = int(self.rng.choice(
                sp["mac_interval_ck"]))
            d["fence_ns"] = self._value(sp["fence_ns"])
            d["num_channels"] = int(channels)
            key = (channels, sim.cycles_key(sim.spec_from_dict(d)))
            if key not in self.seen:
                self.seen.add(key)
                return d
        raise RuntimeError("spans too narrow for a new design point")

    def query(self) -> list[dict]:
        """One query's specs: the mix's count per channel count, in a
        seeded order."""
        chans = [int(c) for c, n in sorted(self.mix["channel_mix"].items())
                 for _ in range(n)]
        self.rng.shuffle(chans)
        return [self.one(c) for c in chans]


def sweep_queries(mix: dict, space: dict, seed: int, n: int
                  ) -> list[list[dict]]:
    """``n`` design-point queries, each of specs the run has not seen."""
    draw = SpecDraw(space, mix, seed)
    return [draw.query() for _ in range(n)]


def serve_lengths(mix: dict) -> list[tuple[int, int]]:
    """The mix's block of (prompt length, new tokens): prompt lengths at
    the block's log-uniform quantiles, output lengths at its uniform
    quantiles, the same for every seed."""
    k = mix["block"]
    (plo, phi), (olo, ohi) = mix["prompt_len"], mix["new_tokens"]
    prompts = [int(round(plo * (phi / plo) ** ((i + 0.5) / k)))
               for i in range(k)]
    outs = [int(round(olo + (ohi - olo) * (i + 0.5) / k)) for i in range(k)]
    return list(zip(prompts, outs))


def serve_requests(mix: dict, seed: int, vocab: int, n_blocks: int
                   ) -> list[dict]:
    """Requests in blocks: each block pairs the mix's prompt and output
    lengths in a seeded order; prompt tokens drawn from the seed."""
    rng = rng_for(seed, 3)
    pairs = serve_lengths(mix)
    prompts = [p for p, _o in pairs]
    outs = [o for _p, o in pairs]
    reqs = []
    for _ in range(n_blocks):
        ps, os_ = rng.permutation(prompts), rng.permutation(outs)
        for p, o in zip(ps, os_):
            reqs.append(dict(rid=len(reqs), max_new=int(o),
                             prompt=rng.integers(0, vocab, size=int(p),
                                                 dtype=np.int64)
                             .astype(np.int32)))
    return reqs


def sample(seed: int, stream: int, n: int, k: int) -> list[int]:
    """``k`` of ``range(n)`` drawn from the seed (all when ``k >= n``)."""
    if k >= n:
        return list(range(n))
    return sorted(int(i) for i in rng_for(seed, stream).choice(
        n, size=k, replace=False))

