"""Host milliseconds of latent attention per prefill: the program's
``mla.project`` and ``mla.attend`` spans over the window's unprofiled
engine steps, over the prefills those steps ran.  A replayed decode step
opens neither span, so they hold prefill's time and each loop's eager
first decode step."""
from bench import program_spans

UNIT = "ms/prefill"
LAYER = "models.mla"
SPANS = ("mla.project", "mla.attend")


def read(obs: dict):
    frames = program_spans.serve_frames(obs)
    prefills = sum(f.spans.get("serving.prefill", (0,))[0] for f in frames)
    parts = [program_spans.span_s(frames, name) for name in SPANS]
    if not prefills or all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts) * 1e3 / prefills
