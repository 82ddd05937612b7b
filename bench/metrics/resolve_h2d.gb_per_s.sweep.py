"""Host-to-device copy rate of the lane slabs on the card's clock: the
bytes handed to the launches' three ``.to(device)`` copies
(``engine.h2d_bytes``) over the CUDA-event time between the stream's
marks before and after those copies (``engine.h2d_device_ns``), 1e9 bytes
a GB, from the window's unprofiled queries.  The engine keeps the event
time only on a card, so on the CPU this finds nothing."""
from bench import program_spans

UNIT = "GB/s"
LAYER = "core.engine"


def read(obs: dict):
    frames = program_spans.sweep_frames(obs)
    ns = program_spans.counter(frames, "engine.h2d_device_ns")
    n = program_spans.counter(frames, "engine.h2d_bytes")
    if not ns or not n:
        return None
    return n / ns
