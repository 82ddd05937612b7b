"""Fault tolerance: heartbeats, straggler mitigation, elastic re-planning.

The multi-host control plane is modeled the way a deployment drills it:
a :class:`HeartbeatMonitor` tracks per-host liveness (tests inject
failures), a :class:`StragglerDetector` flags slow steps from the
step-time stream, and :func:`elastic_plan` computes the survivor layout
and restore plan after a failure.  ``launch/train.py`` wires these into
the training loop: on a detected failure it builds a fresh trainer,
restores the latest checkpoint and continues.  Pure Python apart from
the injectable clock, so its outputs equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core.faults import SYSTEM_CLOCK


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    """Tracks host liveness from heartbeat timestamps.

    ``clock`` is any ``time.monotonic``-style callable; the default is
    the process :data:`repro_torch.core.faults.SYSTEM_CLOCK`, and tests
    pass :class:`repro_torch.core.faults.VirtualClock` — the same
    injectable clock the serving retry/backoff path uses, so no
    fault-tolerance test ever real-sleeps."""

    def __init__(self, n_hosts: int, timeout_s: float = 30.0,
                 clock=SYSTEM_CLOCK):
        self.timeout = timeout_s
        self.clock = clock
        now = clock()
        self.hosts = {i: HostState(i, now) for i in range(n_hosts)}

    def beat(self, host_id: int):
        h = self.hosts[host_id]
        h.last_beat = self.clock()
        h.alive = True

    def sweep(self) -> list[int]:
        """Returns newly-dead host ids."""
        now = self.clock()
        dead = []
        for h in self.hosts.values():
            if h.alive and now - h.last_beat > self.timeout:
                h.alive = False
                dead.append(h.host_id)
        return dead

    @property
    def alive_hosts(self) -> list[int]:
        return [i for i, h in self.hosts.items() if h.alive]


class StragglerDetector:
    """Flags steps slower than ``threshold`` x rolling median.

    Mitigation hooks: the trainer can (a) exclude the straggler host from
    the next data-parallel assignment (elastic_plan), or (b) lower its
    microbatch count (returned advice).
    """

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times: deque = deque(maxlen=window)
        self.threshold = threshold
        self.events: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                is_straggler = True
                self.events.append((step, dt))
        self.times.append(dt)
        return is_straggler

    def advice(self) -> str:
        if len(self.events) >= 3:
            return "persistent"   # re-mesh without the slow host
        if self.events:
            return "transient"    # keep, maybe shrink its microbatch
        return "none"


@dataclasses.dataclass
class ElasticPlan:
    n_hosts: int
    data_parallel: int
    drop_batch: int        # global batch shrink to stay divisible
    restore_step: int | None


def elastic_plan(alive_hosts: list[int], devices_per_host: int,
                 model_parallel: int, global_batch: int,
                 latest_ckpt: int | None) -> ElasticPlan:
    """Survivor topology after failures: keep model-parallel intact,
    shrink the data-parallel axis to what the survivors support."""
    n_dev = len(alive_hosts) * devices_per_host
    if n_dev < model_parallel:
        raise RuntimeError(
            f"not enough devices ({n_dev}) for model parallel "
            f"{model_parallel}")
    dp = n_dev // model_parallel
    # largest batch <= global_batch divisible by the new dp degree
    batch = (global_batch // dp) * dp
    return ElasticPlan(n_hosts=len(alive_hosts), data_parallel=dp,
                       drop_batch=global_batch - batch,
                       restore_step=latest_ckpt)
