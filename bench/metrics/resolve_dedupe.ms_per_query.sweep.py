"""Milliseconds per design-point query of ``resolve_lanes``'s dedupe: key
building, the byte digests, the LRU lookups and the second-level digests
of the misses (the program's ``engine.dedupe`` span), from the window's
unprofiled queries."""
from bench import program_spans

UNIT = "ms/query"
LAYER = "core.engine"


def read(obs: dict):
    return program_spans.ms_per_frame(program_spans.sweep_frames(obs),
                                      "engine.dedupe")
