"""Milliseconds per design-point query of result assembly: the
``executor.assemble`` span around ``PimExecutor.run_many``'s ``_finish``
loop (opcode counts and energy of every point), from the program's own
frames of the window's unprofiled queries."""
from bench import program_spans

UNIT = "ms/query"
LAYER = "pimkernel.executor"


def read(obs: dict):
    return program_spans.ms_per_frame(program_spans.sweep_frames(obs),
                                      "executor.assemble")
