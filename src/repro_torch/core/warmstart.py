"""Persistent warm-start caches: the kernel build + an on-disk lane LRU.

A fresh simulator process pays two cold-start costs before it reaches
steady-state throughput: the ``nvcc`` build of the kernel library and a
cold resolved-lane LRU (every structural stream key re-resolved once).
Both are caches of deterministic computations, so both persist:

* :func:`enable_build_cache` points the kernel library's build directory
  at ``<cache_dir>/nvcc`` (``kernels/build.py`` names the library by a
  hash of its sources and flags, so a second process loads it instead of
  rebuilding).
* :func:`save_lane_snapshot` / :func:`load_lane_snapshot` round-trip the
  engine's resolved-lane LRU (``engine.lane_cache_export`` /
  ``lane_cache_import``) through a versioned, fingerprinted pickle at
  ``<cache_dir>/lanes.pkl``, so a fresh serve process replays cached
  lanes with *zero* resolves.

The snapshot is advisory, never load-bearing: the fingerprint (blake2b
over this package's magic, the snapshot format version, the opcode table
and the ``TimingCycles`` field layout) rejects snapshots written by a
different engine revision or by another package, and *any* failure to
read — truncated file, corrupt pickle, wrong magic, version or
fingerprint — degrades to a cold cache and a ``warmstart`` ``detect``
event instead of raising.  Writes are atomic (tmp + ``os.replace``) so a
crashed writer can at worst leave the previous snapshot in place.

The serve launcher (``launch/serve.py``) wires this behind
``--cache-dir`` / ``REPRO_CACHE_DIR`` via :func:`enable_warm_start` at
startup and :func:`save_warm_start` at exit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile

from . import commands as C
from . import engine
from . import faults
from .timing import TimingCycles

SNAPSHOT_VERSION = 1
_MAGIC = b"repro-torch-lane-snapshot"

_ENV_CACHE_DIR = "REPRO_CACHE_DIR"


def cache_dir_from_env() -> str | None:
    """The ``REPRO_CACHE_DIR`` env knob (None when unset/empty)."""
    d = os.environ.get(_ENV_CACHE_DIR, "").strip()
    return d or None


def snapshot_fingerprint() -> str:
    """Engine-revision fingerprint a snapshot must match to load.

    Hashes what a cached ``(key -> total, issue)`` mapping is only valid
    under: this package's magic, the snapshot format version, the opcode
    table (names and count) and the ``TimingCycles`` field layout (keys
    embed ``TimingCycles`` instances).
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(_MAGIC)
    h.update(str(SNAPSHOT_VERSION).encode())
    h.update((",".join(C.OP_NAMES) + f":{C.NUM_OPCODES}").encode())
    h.update(",".join(
        f.name for f in dataclasses.fields(TimingCycles)).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Lane-LRU snapshot
# ---------------------------------------------------------------------------

def lane_snapshot_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "lanes.pkl")


def save_lane_snapshot(cache_dir: str) -> int:
    """Atomically write the current lane LRU under ``cache_dir``.

    Returns the number of entries written.  An empty cache still writes a
    (valid, empty) snapshot.
    """
    os.makedirs(cache_dir, exist_ok=True)
    entries = engine.lane_cache_export()
    payload = {
        "magic": _MAGIC,
        "version": SNAPSHOT_VERSION,
        "fingerprint": snapshot_fingerprint(),
        "entries": entries,
    }
    path = lane_snapshot_path(cache_dir)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=".lanes-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        faults.maybe_fail("warmstart")   # crash-mid-write injection seam
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(entries)


def load_lane_snapshot(cache_dir: str) -> int:
    """Load a lane snapshot into the engine's LRU; returns entries kept.

    Any failure — missing file, truncation, bytes that do not unpickle
    (a snapshot of another package whose modules are absent included),
    magic, version or fingerprint mismatch, malformed entries — returns
    0 and leaves the cache cold.  Never raises.
    """
    path = lane_snapshot_path(cache_dir)
    if not os.path.exists(path):
        return 0
    try:
        faults.maybe_fail("warmstart")   # corrupt-read injection seam
        with open(path, "rb") as f:
            payload = pickle.load(f)
        reason = _reject_reason(payload)
        if reason is None:
            return engine.lane_cache_import(payload["entries"])
    except Exception as e:  # noqa: BLE001 - cold start beats a crash
        reason = f"{type(e).__name__}: {e}"
    faults.record_event("warmstart", "detect",
                        f"snapshot rejected, cold start: {reason}")
    return 0


def _reject_reason(payload) -> str | None:
    """Why a decoded snapshot payload is unusable (None = valid)."""
    if not isinstance(payload, dict):
        return f"payload is {type(payload).__name__}, not dict"
    if payload.get("magic") != _MAGIC:
        return "bad magic"
    if payload.get("version") != SNAPSHOT_VERSION:
        return f"version {payload.get('version')!r} != {SNAPSHOT_VERSION}"
    if payload.get("fingerprint") != snapshot_fingerprint():
        return "engine fingerprint mismatch"
    if not isinstance(payload.get("entries"), list):
        return "entries is not a list"
    return None


# ---------------------------------------------------------------------------
# Kernel build cache
# ---------------------------------------------------------------------------

def enable_build_cache(cache_dir: str) -> bool:
    """Build and load the kernel library under ``<cache_dir>/nvcc``.

    Takes effect when the library is first loaded in this process (a
    library already loaded stays in use).  Returns True.
    """
    from repro_torch.kernels import build

    build.configure_build_dir(os.path.join(cache_dir, "nvcc"))
    return True


# ---------------------------------------------------------------------------
# One-call launcher wiring
# ---------------------------------------------------------------------------

def enable_warm_start(cache_dir: str | None = None) -> dict:
    """Enable every persistent cache under ``cache_dir`` (or env knob).

    Returns ``{"cache_dir", "compile_cache", "lanes"}``; with no
    directory configured it is a no-op reporting ``{"cache_dir": None,
    ...}`` so launchers can call it unconditionally.
    """
    cache_dir = cache_dir or cache_dir_from_env()
    if not cache_dir:
        return {"cache_dir": None, "compile_cache": False, "lanes": 0}
    os.makedirs(cache_dir, exist_ok=True)
    ok = enable_build_cache(cache_dir)
    lanes = load_lane_snapshot(cache_dir)
    return {"cache_dir": cache_dir, "compile_cache": ok, "lanes": lanes}


def save_warm_start(cache_dir: str | None = None) -> int:
    """Persist the lane LRU under ``cache_dir`` (or env knob); returns
    entries written, or -1 when no directory is configured (no-op) or
    the save failed (recorded as a ``warmstart`` ``fault`` event)."""
    cache_dir = cache_dir or cache_dir_from_env()
    if not cache_dir:
        return -1
    try:
        return save_lane_snapshot(cache_dir)
    except Exception as e:  # noqa: BLE001 - persistence is advisory
        faults.record_event("warmstart", "fault",
                            f"snapshot save failed: "
                            f"{type(e).__name__}: {e}")
        return -1
