"""Host milliseconds per engine step spent waiting for the decode's next
tokens to reach the host (the program's ``serving.decode_sync`` span
around the read-back), from the window's unprofiled steps."""
from bench import program_spans

UNIT = "ms/step"
LAYER = "models.model"


def read(obs: dict):
    return program_spans.ms_per_frame(program_spans.serve_frames(obs),
                                      "serving.decode_sync")
