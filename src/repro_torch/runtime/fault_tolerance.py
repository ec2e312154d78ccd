"""Fault-tolerance policy for large deployments (plain Python, no device).

The counterpart of `repro/runtime/fault_tolerance.py`, kept as its own copy
so that the port imports nothing of the JAX package.  The failure model:
hosts heartbeat to a coordinator; a missed heartbeat or a crashed step
triggers (a) a restart in place from the latest checkpoint when the host
pool is intact, or (b) an elastic re-mesh onto the surviving hosts.
Straggler mitigation watches per-step wall times and flags hosts whose EWMA
deviates from the fleet median (usually a throttled or failing device; the
mitigation is to checkpoint and evict).

These classes carry the *policy* logic, deterministic and unit-tested.  In
the port the serving front-end (serve/frontend.py) uses `HeartbeatMonitor`
for tenant liveness; the trainer that wires the rest to real steps is
ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks host liveness from heartbeat timestamps."""

    n_hosts: int
    timeout_s: float = 60.0
    _last: dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host_id: int, now: Optional[float] = None) -> None:
        # deliberately time.time(), not perf_counter(): heartbeats are
        # compared against deadlines that must be meaningful *across*
        # processes and hosts (the coordinator and the beating host are not
        # the same machine), and perf_counter's epoch is process-local.
        # Duration measurements elsewhere use perf_counter; liveness
        # deadlines use wall-clock by design.  (The lint's allowlist names
        # the reference's copy of this module; this copy says so inline.)
        # genielint: ignore[wall-clock] -- cross-host liveness deadline
        self._last[host_id] = time.time() if now is None else now

    def alive(self, now: Optional[float] = None) -> list[int]:
        # genielint: ignore[wall-clock] -- cross-host liveness deadline
        now = time.time() if now is None else now
        return [h for h in range(self.n_hosts)
                if now - self._last.get(h, -math.inf) <= self.timeout_s]

    def dead(self, now: Optional[float] = None) -> list[int]:
        alive = set(self.alive(now))
        return [h for h in range(self.n_hosts) if h not in alive]


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time tracking; flags hosts slower than `ratio` x fleet median."""

    n_hosts: int
    alpha: float = 0.2
    ratio: float = 1.5
    min_samples: int = 5
    _ewma: dict[int, float] = dataclasses.field(default_factory=dict)
    _count: dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, host_id: int, step_seconds: float) -> None:
        prev = self._ewma.get(host_id)
        self._ewma[host_id] = (
            step_seconds if prev is None else self.alpha * step_seconds + (1 - self.alpha) * prev
        )
        self._count[host_id] = self._count.get(host_id, 0) + 1

    def median(self) -> float:
        vals = sorted(self._ewma.values())
        if not vals:
            return 0.0
        mid = len(vals) // 2
        return vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return [
            h for h, v in self._ewma.items()
            if self._count.get(h, 0) >= self.min_samples and v > self.ratio * med
        ]


@dataclasses.dataclass
class RestartPolicy:
    """Bounded restarts with exponential backoff."""

    max_restarts: int = 10
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 300.0
    restarts: int = 0

    def on_failure(self) -> float:
        """Returns backoff seconds; raises when the budget is exhausted."""
        if self.restarts >= self.max_restarts:
            raise RuntimeError(f"restart budget exhausted ({self.max_restarts})")
        delay = min(self.backoff_base_s * (2.0 ** self.restarts), self.backoff_cap_s)
        self.restarts += 1
        return delay

    def on_success_window(self) -> None:
        """Call after a healthy window to forgive old failures."""
        self.restarts = max(0, self.restarts - 1)


def elastic_mesh_shape(alive_hosts: int, chips_per_host: int, model_parallel: int,
                       pod_size_chips: int = 256) -> tuple[int, ...]:
    """Propose a (pod, data, model) mesh for the surviving fleet.

    Keeps `model_parallel` fixed (TP degree is architecture-bound), shrinks
    the data axis to the largest multiple that fits, and re-forms pods of
    `pod_size_chips`.  Returns () when nothing trainable remains.
    """
    chips = alive_hosts * chips_per_host
    if chips < model_parallel:
        return ()
    data = chips // model_parallel
    pods = max(chips // pod_size_chips, 1)
    data_per_pod = data // pods
    while pods > 1 and data_per_pod == 0:
        pods -= 1
        data_per_pod = data // pods
    if pods > 1:
        return (pods, data_per_pod, model_parallel)
    return (data, model_parallel)
