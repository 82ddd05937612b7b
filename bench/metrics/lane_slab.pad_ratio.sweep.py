"""Bytes of the padded lane slabs over the bytes of the true commands in
them (``engine.slab_bytes`` / ``engine.stream_bytes``, 16 B a command):
1 is a slab with no NOP padding, from the window's unprofiled queries."""
from bench import program_spans

UNIT = "ratio"
LAYER = "core.engine"


def read(obs: dict):
    frames = program_spans.sweep_frames(obs)
    true = program_spans.counter(frames, "engine.stream_bytes")
    if not true:
        return None
    return program_spans.counter(frames, "engine.slab_bytes") / true
