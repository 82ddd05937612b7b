"""Host milliseconds per engine step of the batched decode's forward and
argmax (the program's ``decode_step`` span: the eager dispatch of the
model's launches, without the read-back), from the window's unprofiled
steps."""
from bench import program_spans

UNIT = "ms/step"
LAYER = "models.model"


def read(obs: dict):
    return program_spans.ms_per_frame(program_spans.serve_frames(obs),
                                      "decode_step")
