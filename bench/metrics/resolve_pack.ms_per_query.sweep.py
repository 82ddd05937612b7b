"""Milliseconds per design-point query of packing the lane slabs:
``pack_lanes`` (timing rows, streams NOP-padded to the longest lane,
lengths) and the launch's padding rows (the program's ``engine.pack``
span), from the window's unprofiled queries."""
from bench import program_spans

UNIT = "ms/query"
LAYER = "core.engine"


def read(obs: dict):
    return program_spans.ms_per_frame(program_spans.sweep_frames(obs),
                                      "engine.pack")
