"""The program's own spans and counters (``repro_torch.core.trace``), as
the window of a run left them: the frames the window's queries or engine
steps recorded, less those ``torch.profiler`` ran in (a profiled frame
holds the profiler's cost).  On a program without the tracer, or with no
frame, every reader finds nothing and returns ``None``."""
from __future__ import annotations

SWEEP_ROOT = "offload.plan_grid"    # one frame a design-point query
SERVE_ROOT = "serving.step"         # one frame an engine step


def frames(obs: dict, root: str, n_key: str) -> list:
    """The last ``obs[n_key]`` frames rooted at ``root`` (the window's,
    as nothing after the window opens such a frame), unprofiled."""
    n = obs.get(n_key)
    if not n:
        return []
    try:
        from repro_torch.core import trace
    except ImportError:
        return []
    return [f for f in trace.frames(root)[-n:] if not f.profiled]


def sweep_frames(obs: dict) -> list:
    return frames(obs, SWEEP_ROOT, "queries")


def serve_frames(obs: dict) -> list:
    return frames(obs, SERVE_ROOT, "steps")


def span_s(frames: list, name: str):
    """Seconds of span ``name`` over ``frames``; ``None`` where it never
    ran."""
    if not any(name in f.spans for f in frames):
        return None
    return sum(f.span_ns(name) for f in frames) / 1e9


def counter(frames: list, name: str) -> int:
    return sum(f.counter(name) for f in frames)


def ms_per_frame(frames: list, name: str):
    """Milliseconds of span ``name`` per frame."""
    s = span_s(frames, name)
    return None if s is None else s * 1e3 / len(frames)
