"""Share of the decode steps that replayed the captured CUDA graph (the
program's ``decode_graph.replays`` counter over its ``decode_step``
spans), from the window's unprofiled engine steps in which a decode step
ran: near 1 where the graph engages, 0 where the step stays eager (a
model with MoE or Mamba layers); nothing on a program without the
graph."""
import importlib.util

from bench import program_spans

UNIT = "ratio"
LAYER = "models.model"


def read(obs: dict):
    try:
        if importlib.util.find_spec(
                "repro_torch.serving.decode_graph") is None:
            return None
    except ImportError:
        return None
    frames = [f for f in program_spans.serve_frames(obs)
              if "decode_step" in f.spans]
    steps = sum(f.spans["decode_step"][0] for f in frames)
    if not steps:
        return None
    return program_spans.counter(frames, "decode_graph.replays") / steps
