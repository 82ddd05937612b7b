"""Rows of command streams that result assembly histograms over the rows
its results are built from (``executor.counted_rows`` /
``executor.assembled_rows``): 1 counts every channel's stream, and less
than 1 is the share left once each stream array held by several channels
is counted once, from the window's unprofiled queries.  A program without
the two counters finds nothing."""
from bench import program_spans

UNIT = "ratio"
LAYER = "pimkernel.executor"


def read(obs: dict):
    frames = program_spans.sweep_frames(obs)
    assembled = program_spans.counter(frames, "executor.assembled_rows")
    if not assembled:
        return None
    return program_spans.counter(frames, "executor.counted_rows") / assembled
