"""Cycle-accurate timing engine — the fleet execution core.

A *lane* is one channel's command stream under one timing configuration.
:func:`resolve_lanes` dedupes lanes (planner-provided structural keys,
then a byte hash), serves repeats from the resolved-lane LRU, groups the
misses by bank count and hands each group to the lane resolver
(``kernels/lane_scan.py``) as one launch: the timing rows packed into one
int32 ``(F, 28)`` tensor (:func:`pack_cycles`), the streams NOP-padded to
the group's longest lane, and the true lengths beside them.  A NOP
advances nothing and issue arrays are cut back to true lengths, so the
padding never changes a result.

Every entry point takes a ``device``: by default the card, and a caller
without one must ask for ``device="cpu"`` (the plain torch resolver).
Nothing drops to the CPU on its own, and a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Hashable, Iterable, Sequence

import numpy as np
import torch

from . import commands as C
from . import faults
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


def pack_lanes(lanes: Sequence[tuple[TimingCycles, np.ndarray]]
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One resolver launch's inputs for same-bank-count lanes (CPU):
    ``(cycs (F, 28), streams (F, N, 4) NOP-padded to the longest lane,
    lengths (F,))``, all int32."""
    n = max((s.shape[0] for _c, s in lanes), default=0)
    buf = np.zeros((len(lanes), n, 4), dtype=np.int32)
    for row, (_c, s) in enumerate(lanes):
        buf[row, : s.shape[0]] = s
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
_LANE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


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
        for k in _LANE_STATS:
            _LANE_STATS[k] = 0


def lane_cache_reset() -> None:
    """Drop every cached lane AND zero the counters (capacity survives)."""
    with _LANE_CACHE_LOCK:
        _LANE_CACHE.clear()
        for k in _LANE_STATS:
            _LANE_STATS[k] = 0


def lane_cache_clear() -> None:
    """Drop every cached lane (capacity and counters survive)."""
    with _LANE_CACHE_LOCK:
        _LANE_CACHE.clear()


def lane_cache_info() -> dict:
    """Lane-LRU counters; ``misses`` counts lanes that needed the engine."""
    with _LANE_CACHE_LOCK:
        return dict(size=len(_LANE_CACHE), maxsize=_LANE_CACHE_MAX,
                    hits=_LANE_STATS["hits"], misses=_LANE_STATS["misses"],
                    evictions=_LANE_STATS["evictions"])


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
            _LANE_STATS["misses"] += 1
            return None
        total, issue, tag = ent
        if tag != _lane_tag(total, issue):
            # Poisoned entry: evict and fall back cold — never serve a
            # stale lane.  Counted as a miss (the caller re-resolves).
            del _LANE_CACHE[key]
            _LANE_STATS["misses"] += 1
            faults.record_event("lane_cache", "detect",
                                "poisoned entry evicted (tag mismatch)")
            return None
        _LANE_CACHE.move_to_end(key)
        _LANE_STATS["hits"] += 1
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
            _LANE_STATS["evictions"] += 1


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
    ``device`` (default: the card; see :func:`resolve_device`).
    """
    dev = resolve_device(device)
    lanes = list(lanes)
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

    # Second-level dedupe of the misses by byte identity; ``todo`` holds
    # one representative per distinct (config, bytes), ``alias`` the
    # cache-key lanes that share its result.
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

    # One launch per bank count.  Within it, lanes are ordered by length
    # bucket, so results enter the LRU in the reference engine's slab
    # order and eviction under capacity pressure matches it exactly.
    groups: dict[int, list[int]] = {}
    for u in sorted(todo, key=lambda u: _length_bucket(uniq[u][1].shape[0])):
        groups.setdefault(uniq[u][0].num_banks, []).append(u)

    for nb, idxs in sorted(groups.items()):
        cycs, streams, lengths = pack_lanes([(uniq[u][0], uniq[u][1])
                                             for u in idxs])
        iss, tot = lane_scan.lane_scan(cycs.to(dev), streams.to(dev),
                                       lengths.to(dev), nb,
                                       need_issue=need_issue)
        tot = tot.cpu().numpy()
        iss = iss.cpu().numpy() if need_issue else None
        for row, u in enumerate(idxs):
            if need_issue:
                # copy: a view would pin the whole padded slab;
                # read-only: results are shared between deduped lanes
                # and the LRU, so mutation must be an error
                arr = iss[row, : uniq[u][1].shape[0]].copy()
                arr.setflags(write=False)
                issues[u] = arr
            for v in (u, *alias[u]):
                totals[v] = tot[row]
                issues[v] = issues[u]
                _lane_cache_put(uniq[v][2], int(tot[row]), issues[u])

    return [(issues[lane_of[i]], int(totals[lane_of[i]]))
            for i in range(len(lane_of))]


def resolve_fleet(
    points: Sequence[tuple[TimingCycles, Iterable[np.ndarray]]],
    keys: Sequence[Sequence[Hashable | None]] | None = None,
    need_issue: bool = True,
    device: "str | torch.device | None" = None,
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
                             device=device)
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
