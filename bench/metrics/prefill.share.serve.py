"""Share of the engine steps' host time spent in prefill (the program's
``serving.prefill`` span over its ``serving.step`` frames), from the
window's unprofiled steps; 0 where none of them admitted a request."""
from bench import program_spans

UNIT = "ratio"
LAYER = "serving.engine"


def read(obs: dict):
    frames = program_spans.serve_frames(obs)
    step = program_spans.span_s(frames, program_spans.SERVE_ROOT)
    if not step:
        return None
    return (program_spans.span_s(frames, "serving.prefill") or 0.0) / step
