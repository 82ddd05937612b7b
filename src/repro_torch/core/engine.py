"""Cycle-accurate timing engine — the fleet execution core.

A *lane* is one channel's command stream under one timing configuration.
:func:`resolve_lanes` dedupes lanes (planner-provided structural keys,
then a byte hash), serves repeats from the resolved-lane LRU, groups the
misses by bank count and hands each group to the lane resolver
(``kernels/lane_scan.py``) as one launch: the timing rows packed into one
int32 ``(F, 28)`` tensor (:func:`pack_cycles`), the streams laid end to
end in one ragged slab of their true commands alone, and the lengths
beside them (:func:`pack_lanes`).

Every entry point takes a ``device``: by default the card, and a caller
without one must ask for ``device="cpu"`` (the plain torch resolver).
Nothing drops to the CPU on its own, and a kernel that fails to build or
launch raises.

The launches run under a :class:`BackendScope`'s degradation ladder
(:func:`ladder_rungs`), highest rung first: ``mesh`` when a lane mesh is
configured (the lanes split into equal shards, one launch a shard, each
on its shard's device and CUDA stream), ``threaded`` when more than one
lane device is configured (slabs balanced across the devices, one worker
thread a distinct device), and ``scan``, always, last: one launch per
bank count on the resolve's device.  Every rung runs the same lane
resolver (the kernel on the card, the plain version on the CPU), so where
a resolve lands never changes its bytes.  Each rung passes through the
``backend.<rung>`` fault seam, retries, and steps down on failure, with
the scope's circuit breaker skipping a rung that failed K resolves in a
row.  The terminal rung's failure, an injected fault or a real build or
launch error, raises once its retries are spent: nothing runs the plain
version on a card tensor.

A lane mesh is a 1-D list of torch devices, the counterpart of the JAX
package's 1-D ``lanes`` mesh; a device may repeat (``["cuda:0"] * 4`` is
four shards of one card, as the JAX package forces host devices).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Hashable, Iterable, Sequence

import numpy as np
import torch

from . import commands as C
from . import faults, trace
from .timing import TimingCycles
from repro_torch.kernels import lane_scan


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device; raises when none was given and no card exists."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain resolver on the host")
    return torch.device("cuda", torch.cuda.current_device())


def pack_cycles(cycs: Sequence[TimingCycles]) -> torch.Tensor:
    """Timing configs -> int32 ``(F, len(lane_scan.CYC_FIELDS))`` (CPU
    tensor), columns in the kernel's field order."""
    fields = lane_scan.CYC_FIELDS
    rows = [[getattr(c, name) for name in fields] for c in cycs]
    return torch.tensor(rows, dtype=torch.int32).reshape(len(rows),
                                                         len(fields))


# The stream of a zero-length lane (a launch's padding rows).
_NO_COMMANDS = np.zeros((0, 4), np.int32)


def pack_lanes(lanes: Sequence[tuple[TimingCycles, np.ndarray]]
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One resolver launch's inputs for same-bank-count lanes (CPU):
    ``(cycs (F, 28), streams (T, 4), lengths (F,))``, all int32.  The
    slab is ragged: the lanes' true commands end to end, ``T =
    sum(lengths)``, lane ``f``'s from the sum of the lengths before it."""
    buf = np.concatenate([s.reshape(-1, 4) for _c, s in lanes]
                         or [_NO_COMMANDS], dtype=np.int32)
    lengths = torch.tensor([s.shape[0] for _c, s in lanes],
                           dtype=torch.int32)
    return pack_cycles([c for c, _s in lanes]), torch.from_numpy(buf), \
        lengths


@dataclasses.dataclass
class FleetResult:
    """Resolved timing for one fleet point (one spec + channel streams).

    ``issue`` entries are ``None`` when the fleet was resolved with
    ``need_issue=False`` (totals-only — the sweep/serving fast path).
    """

    issue: list[np.ndarray | None]  # per-channel issue cycles, true lengths
    totals: np.ndarray              # (n_channels,) int32 total cycles


# ---------------------------------------------------------------------------
# Resolved-lane LRU: (TimingCycles, stream key) -> (total, issue | None).
#
# Serving loops (per-step PIM telemetry, offload plan grids) re-resolve the
# *same* lanes every decode step / replan; with planner-provided structural
# keys the repeat costs a dict lookup instead of an engine dispatch.  Totals
# are always cached; issue arrays only up to ``_LANE_ISSUE_BYTES``.
# Entries carry an integrity tag checked on every hit: a corrupted entry
# is evicted, counted as a miss, recorded as a ``lane_cache`` ``detect``
# event, and the lane resolves cold.
# ---------------------------------------------------------------------------

_LANE_CACHE: "OrderedDict[tuple, tuple[int, np.ndarray | None, int]]" = \
    OrderedDict()
_LANE_CACHE_LOCK = threading.Lock()
_LANE_CACHE_MAX = 4096
_LANE_ISSUE_BYTES = 1 << 16
# The LRU's counters live in the tracer (``core/trace.py``).
_LANE_COUNTERS = {"hits": "engine.lane_hits", "misses": "engine.lane_misses",
                  "evictions": "engine.lane_evictions"}


def _lane_tag(total: int, issue: np.ndarray | None) -> int:
    """Constant-time integrity tag over a cache entry (the total mixed
    with the issue array's endpoints and size; not cryptographic)."""
    h = (int(total) * 0x9E3779B1) & 0xFFFFFFFF
    if issue is not None and issue.size:
        h ^= (int(issue[0]) * 31 + int(issue[-1]) * 17
              + int(issue.size)) & 0xFFFFFFFF
    return h


def configure_lane_cache(maxsize: int) -> None:
    """Set the lane-cache capacity (entries); 0 disables caching.  The
    capacity already in effect is a no-op; a change drops the entries
    and zeroes the counters."""
    global _LANE_CACHE_MAX
    maxsize = max(0, int(maxsize))
    with _LANE_CACHE_LOCK:
        if maxsize == _LANE_CACHE_MAX:
            return
        _LANE_CACHE_MAX = maxsize
        _LANE_CACHE.clear()
        trace.reset(*_LANE_COUNTERS.values())


def lane_cache_reset() -> None:
    """Drop every cached lane AND zero the counters (capacity survives)."""
    with _LANE_CACHE_LOCK:
        _LANE_CACHE.clear()
        trace.reset(*_LANE_COUNTERS.values())


def lane_cache_clear() -> None:
    """Drop every cached lane (capacity and counters survive)."""
    with _LANE_CACHE_LOCK:
        _LANE_CACHE.clear()


def lane_cache_info() -> dict:
    """Lane-LRU counters; ``misses`` counts lanes that needed the engine."""
    with _LANE_CACHE_LOCK:
        counted = trace.totals()
        return dict(size=len(_LANE_CACHE), maxsize=_LANE_CACHE_MAX,
                    **{k: counted.counter(name)
                       for k, name in _LANE_COUNTERS.items()})


def lane_cache_touch(pairs: Iterable[tuple]) -> int:
    """Mark structurally-keyed lanes ``(TimingCycles, key)`` most recently
    used; returns how many were present.  Silent on the counters."""
    n = 0
    with _LANE_CACHE_LOCK:
        for cyc, key in pairs:
            ukey = (cyc, 0, key)
            if ukey in _LANE_CACHE:
                _LANE_CACHE.move_to_end(ukey)
                n += 1
    return n


def lane_cache_export() -> list[tuple]:
    """The lane LRU as ``[(key, total, issue | None), ...]``, oldest
    first, so re-importing keeps the eviction order.  Keys are plain
    frozen dataclasses, enums, tuples and bytes, so the list pickles
    (``core/warmstart.py`` writes it to disk)."""
    with _LANE_CACHE_LOCK:
        return [(k, total, issue)
                for k, (total, issue, _tag) in _LANE_CACHE.items()]


def lane_cache_import(entries: Iterable[tuple]) -> int:
    """Insert exported entries into the lane LRU (tags recomputed, each
    entry moved to the MRU end); returns the count kept.  Silent on the
    counters: loading a snapshot is not engine work.  Entries beyond
    capacity evict oldest first without counting evictions; a disabled
    cache keeps nothing."""
    n = 0
    with _LANE_CACHE_LOCK:
        if _LANE_CACHE_MAX <= 0:
            return 0
        for key, total, issue in entries:
            if issue is not None:
                issue = np.asarray(issue)
                issue.setflags(write=False)
            total = int(total)
            _LANE_CACHE[key] = (total, issue, _lane_tag(total, issue))
            _LANE_CACHE.move_to_end(key)
            n += 1
        while len(_LANE_CACHE) > _LANE_CACHE_MAX:
            _LANE_CACHE.popitem(last=False)
            n -= 1
    return n


def _lane_cache_get(key, need_issue: bool):
    if _LANE_CACHE_MAX <= 0:
        return None
    with _LANE_CACHE_LOCK:
        ent = _LANE_CACHE.get(key)
        if ent is None or (need_issue and ent[1] is None):
            trace.count("engine.lane_misses")
            return None
        total, issue, tag = ent
        if tag != _lane_tag(total, issue):
            # Poisoned entry: evict and fall back cold — never serve a
            # stale lane.  Counted as a miss (the caller re-resolves).
            del _LANE_CACHE[key]
            trace.count("engine.lane_misses")
            faults.record_event("lane_cache", "detect",
                                "poisoned entry evicted (tag mismatch)")
            return None
        _LANE_CACHE.move_to_end(key)
        trace.count("engine.lane_hits")
        return (total, issue)


def _lane_cache_put(key, total: int, issue: np.ndarray | None) -> None:
    if _LANE_CACHE_MAX <= 0:
        return
    if issue is not None and issue.nbytes > _LANE_ISSUE_BYTES:
        issue = None
    with _LANE_CACHE_LOCK:
        prev = _LANE_CACHE.get(key)
        if issue is None and prev is not None:
            issue = prev[1]          # never downgrade a cached issue array
        _LANE_CACHE[key] = (total, issue, _lane_tag(total, issue))
        _LANE_CACHE.move_to_end(key)
        while len(_LANE_CACHE) > _LANE_CACHE_MAX:
            _LANE_CACHE.popitem(last=False)
            trace.count("engine.lane_evictions")


def lane_cache_poison(n: int = 1, seed: int = 0) -> int:
    """Chaos hook: corrupt the totals of up to ``n`` cached entries in
    place (stale tags, so the integrity check catches them on the next
    hit or :func:`lane_cache_verify` sweep).  Returns entries poisoned.
    """
    rng = np.random.default_rng(seed)
    with _LANE_CACHE_LOCK:
        keys = list(_LANE_CACHE)
        if not keys:
            return 0
        picks = rng.choice(len(keys), size=min(int(n), len(keys)),
                           replace=False)
        for i in picks:
            total, issue, tag = _LANE_CACHE[keys[i]]
            _LANE_CACHE[keys[i]] = (total + 1 + int(rng.integers(1000)),
                                    issue, tag)
        return len(picks)


def lane_cache_verify() -> int:
    """Integrity sweep: evict every poisoned entry (tag mismatch),
    recording one ``detect`` event each; returns the eviction count."""
    with _LANE_CACHE_LOCK:
        bad = [k for k, (total, issue, tag) in _LANE_CACHE.items()
               if tag != _lane_tag(total, issue)]
        for k in bad:
            del _LANE_CACHE[k]
    for _ in bad:
        faults.record_event("lane_cache", "detect",
                            "poisoned entry evicted (scrub)")
    return len(bad)


# ---------------------------------------------------------------------------
# Backend scopes and the degradation ladder.
#
# A BackendScope holds the requested lane backend, the lane mesh, the
# lane devices and its OWN circuit breaker.  The process keeps one
# default scope behind the classic configure_* API; serving cells each
# carry their own, so a breaker tripped by one cell's faults never
# changes the other cell's ladder.  The JAX package's backend names are
# accepted: "pallas" and "auto" resolve to "scan", as there where no
# Pallas kernel runs.
# ---------------------------------------------------------------------------

_LANE_BACKENDS = ("scan", "pallas", "auto")


def _check_backend(name: str | None) -> str | None:
    if name is None:
        return None
    b = str(name).lower()
    if b not in _LANE_BACKENDS:
        raise ValueError(f"lane backend must be one of {_LANE_BACKENDS}, "
                         f"got {name!r}")
    return b


@dataclasses.dataclass
class BackendScope:
    """One lane-execution scope: requested backend, lane mesh, lane
    devices and its own circuit breaker (``breaker=None`` delegates to
    the process breaker, which is what the default scope does).  Serving
    cells activate theirs around their tick work with
    :class:`backend_scope`.

    ``mesh``: ``None``, an ``int`` n (a lane mesh over the first n
    visible devices) or a 1-D list of devices.  ``max_devices``: the lane
    devices, as an ``int`` cap on the visible devices (``None``: the
    ``REPRO_LANE_DEVICES`` variable, else all) or a list of devices."""

    backend: str | None = None
    mesh: "list | int | None" = None
    max_devices: "int | list | None" = None
    breaker: "faults.CircuitBreaker | None" = dataclasses.field(
        default_factory=faults.CircuitBreaker)
    name: str = ""

    def __post_init__(self):
        self.backend = _check_backend(self.backend)
        if self.mesh is not None:
            self.mesh = _as_lane_mesh(self.mesh)

    def scope_breaker(self) -> "faults.CircuitBreaker":
        return (self.breaker if self.breaker is not None
                else faults.backend_breaker())

    def describe(self) -> dict:
        """Trace-exportable view, keyed as the JAX package's."""
        return dict(name=self.name, backend=lane_backend(self),
                    resolved=resolved_lane_backend(self),
                    mesh=None if self.mesh is None else len(self.mesh),
                    devices=len(lane_devices(self)),
                    rungs=ladder_rungs(self),
                    breaker=self.scope_breaker().info())


_DEFAULT_SCOPE = BackendScope(breaker=None, name="default")
_ACTIVE_SCOPE: BackendScope | None = None


def default_backend_scope() -> BackendScope:
    """The process-default scope (what ``configure_lane_backend`` sets)."""
    return _DEFAULT_SCOPE


def active_backend_scope() -> BackendScope:
    """The scope lane resolution runs under right now."""
    return _ACTIVE_SCOPE if _ACTIVE_SCOPE is not None else _DEFAULT_SCOPE


class backend_scope:
    """Context manager: activate ``scope`` (``None`` = the default scope)
    for every lane resolve in the block, then restore the previous one."""

    def __init__(self, scope: BackendScope | None):
        self._scope = scope

    def __enter__(self) -> BackendScope:
        global _ACTIVE_SCOPE
        self._prev = _ACTIVE_SCOPE
        _ACTIVE_SCOPE = self._scope
        return active_backend_scope()

    def __exit__(self, *exc):
        global _ACTIVE_SCOPE
        _ACTIVE_SCOPE = self._prev
        return False


def reset_backend_scopes() -> None:
    """Deactivate any active scope and restore the default scope's
    fields to their boot state (test hygiene)."""
    global _ACTIVE_SCOPE
    _ACTIVE_SCOPE = None
    _DEFAULT_SCOPE.backend = None
    _DEFAULT_SCOPE.mesh = None
    _DEFAULT_SCOPE.max_devices = None


def configure_lane_backend(name: str | None) -> str:
    """Set the default scope's requested backend ("scan" | "pallas" |
    "auto"; ``None``: the ``REPRO_LANE_BACKEND`` variable, else "scan").
    Returns the requested backend."""
    _DEFAULT_SCOPE.backend = _check_backend(name)
    return lane_backend()


def lane_backend(scope: BackendScope | None = None) -> str:
    """The requested lane backend (scope > environment > "scan")."""
    scope = active_backend_scope() if scope is None else scope
    if scope.backend is not None:
        return scope.backend
    env = os.environ.get("REPRO_LANE_BACKEND", "").lower()
    return env if env in _LANE_BACKENDS else "scan"


def resolved_lane_backend(scope: BackendScope | None = None) -> str:
    """The backend lanes run on: always "scan" (no Pallas kernel here)."""
    return "scan"


class lane_backend_scope:
    """Context manager: request ``name`` on the default scope, then
    restore the previous request."""

    def __init__(self, name: str | None):
        self._name = name

    def __enter__(self) -> str:
        self._prev = _DEFAULT_SCOPE.backend
        return configure_lane_backend(self._name)

    def __exit__(self, *exc):
        _DEFAULT_SCOPE.backend = self._prev
        return False


# ---------------------------------------------------------------------------
# Lane devices and the lane mesh.
# ---------------------------------------------------------------------------

def visible_devices() -> list[torch.device]:
    """The devices lanes may shard over: every visible CUDA device, or
    the host when there is none."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


def configure_lane_devices(n: "int | Sequence | None") -> None:
    """Set the default scope's lane devices: an ``int`` caps the visible
    devices, a list names them (a device may repeat), ``None`` restores
    the ``REPRO_LANE_DEVICES`` variable, else every visible device."""
    _DEFAULT_SCOPE.max_devices = (None if n is None else
                                  n if isinstance(n, int) else
                                  [torch.device(d) for d in n])


def lane_devices(scope: BackendScope | None = None) -> list:
    """The devices the threaded rung shards over."""
    scope = active_backend_scope() if scope is None else scope
    n = scope.max_devices
    if isinstance(n, (list, tuple)):
        return [torch.device(d) for d in n]
    devs = visible_devices()
    if n is None:
        n = int(os.environ.get("REPRO_LANE_DEVICES", "0") or 0) or len(devs)
    return devs[: max(1, min(n, len(devs)))]


def build_lane_mesh(n: int, devices: "Sequence | None" = None) -> list:
    """Construct (without configuring) a lane mesh: the first ``n`` of
    ``devices`` (default: :func:`visible_devices`), the one place that
    validates lane-mesh sizes (``launch.mesh.make_lane_mesh`` delegates
    here)."""
    devs = visible_devices() if devices is None else \
        [torch.device(d) for d in devices]
    if not 1 <= n <= len(devs):
        raise ValueError(
            f"lane mesh size {n} needs 1..{len(devs)} of the devices "
            f"given (hint: repeat a device, as ['cuda:0'] * {n})")
    return devs[:n]


def _as_lane_mesh(mesh) -> list | None:
    if mesh is None:
        return None
    if isinstance(mesh, int):
        return build_lane_mesh(mesh)
    mesh = list(mesh)
    if not mesh or any(isinstance(d, (list, tuple)) for d in mesh):
        raise ValueError(f"lane mesh must be 1-D and non-empty, got "
                         f"{mesh!r}")
    return [torch.device(d) for d in mesh]


def configure_lane_mesh(mesh: "list | int | None") -> list | None:
    """Select the default scope's lane mesh: ``None`` turns it off, an
    ``int`` n builds one over the first n visible devices, a 1-D list of
    devices is used as is.  Returns the configured mesh (or None)."""
    _DEFAULT_SCOPE.mesh = _as_lane_mesh(mesh)
    return _DEFAULT_SCOPE.mesh


def lane_mesh(scope: BackendScope | None = None) -> list | None:
    """The configured lane mesh (None: no mesh rung)."""
    scope = active_backend_scope() if scope is None else scope
    return scope.mesh


def lane_mesh_on(mesh, device) -> list | None:
    """A run's lane mesh: an ``int`` n is n shards of the run's
    ``device`` (``[device] * n``), a list is used as is, ``None`` is
    none (serving, chaos and the launchers take ``mesh=`` this way)."""
    if isinstance(mesh, int):
        return build_lane_mesh(mesh, [resolve_device(device)] * mesh)
    return _as_lane_mesh(mesh)


class lane_mesh_scope:
    """Context manager: run lane resolution under ``mesh`` on the default
    scope, then restore the previous mesh (also on an exception)."""

    def __init__(self, mesh: "list | int | None"):
        self._mesh = mesh

    def __enter__(self):
        self._prev = _DEFAULT_SCOPE.mesh
        return configure_lane_mesh(self._mesh)

    def __exit__(self, *exc):
        _DEFAULT_SCOPE.mesh = self._prev
        return False


# Widest slab per launch of the mesh and threaded rungs (the JAX
# package's per-program width).
_MAX_WIDTH = 128


def _fleet_bucket(n: int) -> int:
    """Pad a slab's width to powers of two (>= 4)."""
    return 1 << max(2, (max(n, 1) - 1).bit_length())


def _mesh_width(n: int, m: int) -> int:
    """Global width for ``n`` lanes on an ``m``-way mesh: the per-shard
    width is power-of-two bucketed and every shard gets the same width,
    so the global width is ``m`` times that."""
    return _fleet_bucket(-(-n // m)) * m


_STREAMS: dict = {}


def _shard_stream(dev: torch.device, k: int):
    """Shard ``k``'s own CUDA stream on ``dev`` (None off the card)."""
    if dev.type != "cuda":
        return None
    key = (dev.index, k)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=dev)
    return _STREAMS[key]


def _ladder_rungs(scope: BackendScope | None = None) -> list[str]:
    """The degradation ladder for ``scope``, highest rung first: "mesh"
    when a lane mesh is configured, "threaded" when more than one lane
    device is, and "scan" always, as the terminal rung."""
    scope = active_backend_scope() if scope is None else scope
    rungs = []
    if lane_mesh(scope) is not None:
        rungs.append("mesh")
    if len(lane_devices(scope)) > 1:
        rungs.append("threaded")
    rungs.append("scan")
    return rungs


def ladder_rungs(scope: BackendScope | None = None) -> list[str]:
    """Public view of a scope's ladder (default: the active scope's) —
    what the chaos harness arms fault schedules against."""
    return _ladder_rungs(active_backend_scope() if scope is None
                         else scope)


def _length_bucket(n: int) -> int:
    """The reference engine's stream-length bucket ({2^k, 3*2^(k-2)},
    >= 16); here it only orders LRU insertion (launches are not padded
    to it)."""
    n = max(n, 1)
    b = 1 << max(4, (n - 1).bit_length())
    three_q = (3 * b) // 4
    return three_q if (n <= three_q and three_q >= 16) else b


def _digest(s: np.ndarray) -> bytes:
    return hashlib.blake2b(s.tobytes(), digest_size=16).digest()


def resolve_lanes(
    lanes: Sequence[tuple[TimingCycles, np.ndarray]],
    keys: Sequence[Hashable | None] | None = None,
    need_issue: bool = True,
    device: "str | torch.device | None" = None,
    scope: BackendScope | None = None,
) -> list[tuple[np.ndarray | None, int]]:
    """Resolve a flat list of (timing config, stream) lanes.

    Returns ``(issue cycles | None, total cycles)`` per lane, in input
    order; issue arrays are read-only (deduplicated lanes and the LRU
    share them).

    ``keys`` — optional per-lane *structural* identity the planner
    guarantees to determine the stream bytes; keyed lanes dedupe and hit
    the LRU without hashing the stream.  ``None`` entries fall back to a
    byte hash.  Cache misses are deduplicated once more by byte hash, so
    structurally-distinct lanes whose streams coincide resolve once.
    ``need_issue=False`` skips the issue arrays (totals only).

    The misses go to the resolver one launch per bank count, on
    ``device`` (default: the card; see :func:`resolve_device`), under the
    degradation ladder of ``scope`` (default: the active scope): a rung
    that raises is retried through ``faults.retry_call`` at its
    ``backend.<rung>`` site and then stepped past, counting toward its
    breaker; lanes a failing rung already stored are not run again.  The
    terminal rung's failure propagates.
    """
    with trace.span("engine.resolve_lanes"):
        return _resolve_lanes(
            list(lanes), keys, need_issue, resolve_device(device),
            active_backend_scope() if scope is None else scope)


def _resolve_lanes(lanes: list, keys, need_issue: bool, dev: torch.device,
                   scope: BackendScope) -> list:
    with trace.span("engine.dedupe"):
        uniq: list[list] = []              # [cyc, stream, ukey]
        lane_of: list[int] = []            # flat lane -> unique lane
        uniq_index: dict = {}
        for i, (cyc, s) in enumerate(lanes):
            k = keys[i] if keys is not None else None
            if k is not None:
                ukey = (cyc, 0, k)
            else:
                s = np.ascontiguousarray(s, dtype=np.int32)
                ukey = (cyc, 1, s.shape[0], _digest(s))
            u = uniq_index.get(ukey)
            if u is None:
                u = len(uniq)
                uniq_index[ukey] = u
                uniq.append([cyc, s, ukey])
            lane_of.append(u)

        issues: list[np.ndarray | None] = [None] * len(uniq)
        totals = np.zeros(len(uniq), dtype=np.int32)
        misses: list[int] = []
        for u, (cyc, s, ukey) in enumerate(uniq):
            ent = _lane_cache_get(ukey, need_issue)
            if ent is not None:
                totals[u] = ent[0]
                issues[u] = ent[1] if need_issue else None
            else:
                misses.append(u)

        # Second-level dedupe of the misses by byte identity; ``todo``
        # holds one representative per distinct (config, bytes),
        # ``alias`` the cache-key lanes that share its result.
        todo: list[int] = []
        alias: dict[int, list[int]] = {}
        hash_index: dict = {}
        for u in misses:
            cyc, s, _ukey = uniq[u]
            s = np.ascontiguousarray(s, dtype=np.int32)
            uniq[u][1] = s
            hkey = (cyc, s.shape[0], _digest(s))
            rep = hash_index.get(hkey)
            if rep is None:
                hash_index[hkey] = u
                todo.append(u)
                alias[u] = []
            else:
                alias[rep].append(u)

    # Lanes are ordered by length bucket within each bank count, and
    # every rung stores its results in that order, so results enter the
    # LRU in the reference engine's slab order and eviction under
    # capacity pressure matches it exactly.
    order = sorted(todo, key=lambda u: _length_bucket(uniq[u][1].shape[0]))
    done: set[int] = set()

    def _pending() -> list[tuple[int, list[int]]]:
        groups: dict[int, list[int]] = {}
        for u in order:
            if u not in done:
                groups.setdefault(uniq[u][0].num_banks, []).append(u)
        return sorted(groups.items())

    def _launch(nb: int, idxs: list[int], dev: torch.device,
                width: int | None = None, stream=None, like: int = 0):
        """Pack ``idxs`` (padded to ``width`` rows of zero-length lanes,
        which carry no command, with the timing row of their first lane,
        or of lane ``like`` when there is none) and launch the resolver
        on ``dev`` (on ``stream``, if given); returns the device results
        and, on a card, the CUDA events around the copies (``_read`` adds
        their interval to ``engine.h2d_device_ns`` once the results are
        back)."""
        with trace.span("engine.pack"):
            lanes = [(uniq[u][0], uniq[u][1]) for u in idxs]
            filler = (uniq[idxs[0] if idxs else like][0], _NO_COMMANDS)
            lanes += [filler] * ((width or len(lanes)) - len(lanes))
            cycs, streams, lengths = pack_lanes(lanes)
        trace.count("engine.stream_bytes", streams.element_size() * 4 * sum(
            uniq[u][1].shape[0] for u in idxs))
        trace.count("engine.slab_bytes",
                    streams.element_size() * streams.numel())
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with ctx:
            copied = None
            if dev.type == "cuda":
                copied = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                copied[0].record()
            with trace.span("engine.h2d"):
                on_dev = [t.to(dev, non_blocking=True)
                          for t in (cycs, streams, lengths)]
            if copied is not None:
                copied[1].record()
            trace.count("engine.h2d_bytes", sum(
                t.element_size() * t.numel()
                for t in (cycs, streams, lengths)))
            with trace.span("lane_scan.launch"):
                return (lane_scan.lane_scan(*on_dev, nb,
                                            need_issue=need_issue),
                        copied)

    def _read(launched, stream=None):
        with trace.span("engine.readback"):
            (iss, tot), copied = launched
            if stream is not None:
                stream.synchronize()
            out = (iss.cpu().numpy() if need_issue else None,
                   tot.cpu().numpy())
        if copied is not None:
            # the copies precede the kernel whose results are back
            trace.count("engine.h2d_device_ns",
                        round(copied[0].elapsed_time(copied[1]) * 1e6))
        return out

    def _store(idxs: list[int], iss, tot) -> None:
        """Write one launch's lanes into the results and the LRU, each
        lane's issue cycles from its offset in the flat issue array;
        rows past ``idxs`` (padding) are never read."""
        with trace.span("engine.store"):
            start = 0
            for row, u in enumerate(idxs):
                if need_issue:
                    # copy: a view would pin the whole launch's array;
                    # read-only: results are shared between deduped
                    # lanes and the LRU, so mutation must be an error
                    n = uniq[u][1].shape[0]
                    arr = iss[start:start + n].copy()
                    arr.setflags(write=False)
                    issues[u] = arr
                    start += n
                for v in (u, *alias[u]):
                    totals[v] = tot[row]
                    issues[v] = issues[u]
                    _lane_cache_put(uniq[v][2], int(tot[row]), issues[u])
                done.add(u)

    def _run_scan() -> None:
        # One launch per bank count on the resolve's device.
        for nb, idxs in _pending():
            _store(idxs, *_read(_launch(nb, idxs, dev)))

    def _run_mesh() -> None:
        # Each bank count's lanes in <= 128 x m chunks, each padded to
        # _mesh_width and split into m equal shards, one launch a shard
        # on its device and stream; every launch goes out before any
        # read-back.
        mesh = lane_mesh(scope)
        m = len(mesh)
        jobs = []
        for nb, idxs in _pending():
            for lo in range(0, len(idxs), _MAX_WIDTH * m):
                chunk = idxs[lo:lo + _MAX_WIDTH * m]
                per = _mesh_width(len(chunk), m) // m
                for k, shard_dev in enumerate(mesh):
                    rows = chunk[k * per:(k + 1) * per]
                    stream = _shard_stream(shard_dev, k)
                    res = _launch(nb, rows, shard_dev, width=per,
                                  stream=stream, like=chunk[0])
                    if shard_dev.type == "cuda":
                        # a shard has per > 0 rows, so the kernel ran
                        trace.count(f"engine.mesh_launches.{k}")
                    jobs.append((rows, res, stream))
        for rows, res, stream in jobs:
            iss, tot = _read(res, stream)
            _store(rows, iss, tot)

    def _run_threaded() -> None:
        # <= 128-lane slabs balanced greedily over the lane devices by
        # padded width x length; one worker thread per distinct device,
        # each launching its slabs on its entries' streams, then reading
        # back; results are stored in slab order once all are back.
        devs = lane_devices(scope)
        slabs = [(nb, idxs[lo:lo + _MAX_WIDTH])
                 for nb, idxs in _pending()
                 for lo in range(0, len(idxs), _MAX_WIDTH)]
        loads = [0] * len(devs)
        assignment = [0] * len(slabs)
        for i in sorted(range(len(slabs)), key=lambda j: -(
                _fleet_bucket(len(slabs[j][1]))
                * max(uniq[u][1].shape[0] for u in slabs[j][1]))):
            d = loads.index(min(loads))
            assignment[i] = d
            loads[d] += _fleet_bucket(len(slabs[i][1])) * max(
                uniq[u][1].shape[0] for u in slabs[i][1])
        per_dev: dict = {}
        for i, d in enumerate(assignment):
            per_dev.setdefault(devs[d], []).append((i, d))
        results: dict = {}
        errors: list[BaseException] = []

        def work(jobs) -> None:
            try:
                launched = [(i, _shard_stream(devs[d], d)) for i, d in jobs]
                launched = [(i, st, _launch(slabs[i][0], slabs[i][1],
                                            devs[d], stream=st))
                            for (i, st), (_i, d) in zip(launched, jobs)]
                for i, st, res in launched:
                    results[i] = _read(res, st)
            except BaseException as e:      # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(jobs,))
                   for jobs in per_dev.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for i, (_nb, idxs) in enumerate(slabs):
            _store(idxs, *results[i])

    runners = {"mesh": _run_mesh, "threaded": _run_threaded,
               "scan": _run_scan}

    # Walk the ladder: the highest closed rung first, transient faults
    # absorbed by retries, a persistent failure stepping down (and
    # counting toward the rung's breaker).  The terminal rung is never
    # skipped, and its failure propagates.
    if todo:
        breaker = scope.scope_breaker()
        rungs = _ladder_rungs(scope)
        for i, rung in enumerate(rungs):
            site = "backend." + rung
            terminal = i == len(rungs) - 1
            if not terminal and breaker.tripped(site):
                faults.record_event(site, "skip", "circuit open")
                continue
            try:
                faults.retry_call(runners[rung], site)
                breaker.record_success(site)
                break
            except Exception as e:  # noqa: BLE001 - the ladder absorbs it
                breaker.record_failure(site)
                if terminal:
                    raise
                faults.record_event(
                    site, "degrade",
                    f"stepping down to backend.{rungs[i + 1]}: "
                    f"{type(e).__name__}: {e}")

    return [(issues[lane_of[i]], int(totals[lane_of[i]]))
            for i in range(len(lane_of))]


def resolve_fleet(
    points: Sequence[tuple[TimingCycles, Iterable[np.ndarray]]],
    keys: Sequence[Sequence[Hashable | None]] | None = None,
    need_issue: bool = True,
    device: "str | torch.device | None" = None,
    scope: BackendScope | None = None,
) -> list[FleetResult]:
    """Resolve many (timing config, per-channel streams) points at once:
    the *(point x channel)* fleet flattened into lanes, one
    :func:`resolve_lanes` pass, regrouped per point."""
    flat: list[tuple[TimingCycles, np.ndarray]] = []
    flat_keys: list = []
    owner: list[int] = []
    for pi, (cyc, streams) in enumerate(points):
        pkeys = keys[pi] if keys is not None else None
        for ci, s in enumerate(streams):
            flat.append((cyc, s))
            flat_keys.append(pkeys[ci] if pkeys is not None else None)
            owner.append(pi)

    resolved = resolve_lanes(flat, keys=flat_keys if keys is not None
                             else None, need_issue=need_issue,
                             device=device, scope=scope)
    out = [FleetResult(issue=[], totals=np.zeros(0, np.int32))
           for _ in points]
    per_point: list[list[int]] = [[] for _ in points]
    for pi, (iss, tot) in zip(owner, resolved):
        out[pi].issue.append(iss)
        per_point[pi].append(tot)
    for pi, fr in enumerate(out):
        fr.totals = np.asarray(per_point[pi], dtype=np.int32)
    return out


def run_streams(cyc: TimingCycles, streams,
                device: "str | torch.device | None" = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Resolve a list/array of per-channel streams; pads to equal length."""
    dev = resolve_device(device)
    if isinstance(streams, list):
        streams = C.pad_streams(streams)
    streams = np.asarray(streams, dtype=np.int32)
    if streams.ndim == 2:
        streams = streams[None]
    if streams.shape[0] == 0:
        return (np.zeros((0, streams.shape[1]), dtype=np.int32),
                np.zeros((0,), dtype=np.int32))
    fr = resolve_fleet([(cyc, list(streams))], device=dev)[0]
    return np.stack(fr.issue), fr.totals
