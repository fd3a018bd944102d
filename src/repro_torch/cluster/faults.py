"""Declarative, seeded fault injection for cluster scenarios (DESIGN.md §18).

EcoShift's control loop assumes a perfect world: every cap the allocator
emits is applied instantly and exactly, every telemetry record arrives
intact, and the controller's warm state lives forever.  This module makes
the imperfect world *declarative*: fault events compose into any
:class:`~repro_torch.cluster.scenario.Scenario` via ``with_faults`` /
``with_fault_storm`` and the engine's :class:`FaultInjector` resolves them
per round against three channels:

 * **telemetry** — whole-round batch drops, delayed delivery, stale
   repeats of an earlier round's batch, and seeded record corruption
   (NaN / inf / outlier / negative runtimes);
 * **actuation** — cap-apply NACKs (a node keeps its previously applied
   caps), partial application (the actuator moves only a fraction of the
   way from its current state to the command) and one-round delayed
   application (the command lands next round, displacing that round's);
 * **controller** — a crash that wipes all warm state mid-run, optionally
   restored from the last end-of-round ``Controller.snapshot()``.

Fault events are plain frozen dataclasses: a scenario with faults is
still a pure value, replayable bit-for-bit under any controller.  All
randomness (storm sampling, corruption targets, fraction-based actuation
targets) flows from explicit seeds — the same seed always produces the
same storm.

The recovery machinery lives on the other side: the engine's PowerGuard
watchdog (``cluster/sim.py``), controller NACK pinning and
snapshot/restore (``cluster/controller.py``), and the robust telemetry
ingest (``cluster/predictor.py``).

A port of ``repro.cluster.faults``: the same events, the same seeded
draws in the same order, so a storm's event tuple and every corrupted
batch equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np

#: recognized record-corruption modes (TelemetryCorrupt.mode)
CORRUPT_MODES = ("nan", "inf", "outlier", "negative")

#: multiplicative runtime blow-up of the "outlier" corruption mode —
#: finite and positive, so only physical-plausibility checks catch it
OUTLIER_FACTOR = 1e3


# ---------------------------------------------------------------------------
# Fault events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetryDrop:
    """The whole telemetry batch of ``round`` is lost in transit."""

    round: int


@dataclasses.dataclass(frozen=True)
class TelemetryDelay:
    """The batch of ``round`` arrives ``rounds`` rounds late (delivered
    alongside that later round's own telemetry)."""

    round: int
    rounds: int = 1


@dataclasses.dataclass(frozen=True)
class TelemetryCorrupt:
    """A seeded ``fraction`` of ``round``'s records is corrupted.

    Modes: ``"nan"`` / ``"inf"`` poison the measured runtimes with
    non-finite values, ``"outlier"`` blows the allocated-caps runtime up
    by :data:`OUTLIER_FACTOR` (finite but physically impossible), and
    ``"negative"`` flips it negative.  The ``improvement`` column is
    recomputed from the corrupted runtimes, so the corruption is
    internally consistent — exactly what a broken meter produces.
    """

    round: int
    fraction: float = 0.25
    mode: str = "nan"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TelemetryStale:
    """Round ``round``'s batch is displaced by a stale repeat of the batch
    measured ``age`` rounds earlier (this round's real batch is lost)."""

    round: int
    age: int = 1


@dataclasses.dataclass(frozen=True)
class ActuationNack:
    """Cap-apply NACK: the targeted receivers keep their previously
    applied caps this round.  Targets are explicit ``node_ids`` or a
    seeded ``fraction`` of the round's receivers."""

    round: int
    node_ids: tuple[int, ...] = ()
    fraction: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ActuationPartial:
    """Partial application: the actuator moves only ``applied_fraction``
    of the way from its current caps toward the commanded caps."""

    round: int
    node_ids: tuple[int, ...] = ()
    fraction: float = 0.0
    seed: int = 0
    applied_fraction: float = 0.5


@dataclasses.dataclass(frozen=True)
class ActuationDelay:
    """One-round delayed application: nothing lands this round; the
    command lands next round, displacing that round's own command for the
    targeted receivers."""

    round: int
    node_ids: tuple[int, ...] = ()
    fraction: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ControllerCrash:
    """The controller process dies at the start of ``round``: every piece
    of warm state (caches, grouping, fused banks, pins, online-learned
    predictor state) is wiped.  With ``restore`` the replacement process
    restores the last end-of-round snapshot before taking over."""

    round: int
    restore: bool = True


FaultEvent = Union[
    TelemetryDrop,
    TelemetryDelay,
    TelemetryCorrupt,
    TelemetryStale,
    ActuationNack,
    ActuationPartial,
    ActuationDelay,
    ControllerCrash,
]

_TELEMETRY = (TelemetryDrop, TelemetryDelay, TelemetryCorrupt, TelemetryStale)
_ACTUATION = (ActuationNack, ActuationPartial, ActuationDelay)


def validate_faults(faults: Sequence, n_rounds: int) -> None:
    """Build-time fail-fast for ``Scenario.with_faults``."""
    for ev in faults:
        if not isinstance(ev, FaultEvent.__args__):
            known = ", ".join(c.__name__ for c in FaultEvent.__args__)
            raise TypeError(
                f"unknown fault event type {type(ev).__name__!r} "
                f"(expected one of: {known})"
            )
        if not 0 <= ev.round < n_rounds:
            raise ValueError(
                f"{type(ev).__name__} round {ev.round} outside "
                f"[0, {n_rounds})"
            )
        if isinstance(ev, TelemetryCorrupt):
            if ev.mode not in CORRUPT_MODES:
                raise ValueError(
                    f"unknown corruption mode {ev.mode!r} "
                    f"(expected one of {CORRUPT_MODES})"
                )
            if not 0.0 < ev.fraction <= 1.0:
                raise ValueError(
                    f"corrupt fraction {ev.fraction} outside (0, 1]"
                )
        if isinstance(ev, _ACTUATION):
            if not 0.0 <= ev.fraction <= 1.0:
                raise ValueError(
                    f"actuation fraction {ev.fraction} outside [0, 1]"
                )
            if not ev.node_ids and ev.fraction == 0.0:
                raise ValueError(
                    f"{type(ev).__name__} at round {ev.round} targets "
                    f"nothing: pass node_ids or fraction > 0"
                )
        if isinstance(ev, ActuationPartial) and not (
            0.0 <= ev.applied_fraction <= 1.0
        ):
            raise ValueError(
                f"applied_fraction {ev.applied_fraction} outside [0, 1]"
            )
        if isinstance(ev, TelemetryDelay) and ev.rounds < 1:
            raise ValueError("telemetry delay must be >= 1 round")
        if isinstance(ev, TelemetryStale) and ev.age < 1:
            raise ValueError("stale age must be >= 1 round")


def fault_storm(
    n_rounds: int,
    seed: int = 0,
    *,
    telemetry_drop: float = 0.0,
    telemetry_delay: float = 0.0,
    telemetry_corrupt: float = 0.0,
    corrupt_fraction: float = 0.25,
    telemetry_stale: float = 0.0,
    actuation_nack: float = 0.0,
    actuation_partial: float = 0.0,
    actuation_delay: float = 0.0,
    node_fraction: float = 0.2,
    crash_rounds: Sequence[int] = (),
    restore: bool = True,
    start_round: int = 1,
) -> tuple:
    """Sample a randomized fault storm: per round, each channel fires
    independently with its given probability.  Fully determined by
    ``seed`` — the same seed always yields the same event list.

    Rate arguments are per-round probabilities; ``corrupt_fraction`` /
    ``node_fraction`` size each fired event.  ``start_round`` keeps the
    first round(s) clean so the run establishes a healthy baseline.
    Explicit ``crash_rounds`` add :class:`ControllerCrash` events.
    """
    rng = np.random.default_rng(seed)
    events: list = []
    modes = CORRUPT_MODES
    for r in range(start_round, n_rounds):
        u = rng.random(6)
        sub = int(rng.integers(0, 2**31 - 1))
        if u[0] < telemetry_drop:
            events.append(TelemetryDrop(round=r))
        if u[1] < telemetry_delay and r + 1 < n_rounds:
            events.append(TelemetryDelay(round=r, rounds=1))
        if u[2] < telemetry_corrupt:
            mode = modes[int(rng.integers(0, len(modes)))]
            events.append(
                TelemetryCorrupt(
                    round=r, fraction=corrupt_fraction, mode=mode, seed=sub
                )
            )
        if u[3] < telemetry_stale and r >= start_round + 1:
            events.append(TelemetryStale(round=r, age=1))
        if u[4] < actuation_nack:
            events.append(
                ActuationNack(round=r, fraction=node_fraction, seed=sub + 1)
            )
        if u[5] < actuation_partial:
            events.append(
                ActuationPartial(
                    round=r, fraction=node_fraction, seed=sub + 2
                )
            )
        if actuation_delay > 0 and rng.random() < actuation_delay:
            events.append(
                ActuationDelay(round=r, fraction=node_fraction, seed=sub + 3)
            )
    for r in crash_rounds:
        if not 0 <= r < n_rounds:
            raise ValueError(f"crash round {r} outside [0, {n_rounds})")
        events.append(ControllerCrash(round=int(r), restore=restore))
    events.sort(key=lambda e: e.round)
    return tuple(events)


# ---------------------------------------------------------------------------
# Telemetry corruption
# ---------------------------------------------------------------------------


def corrupt_batch(batch, ev: TelemetryCorrupt):
    """Corrupt a seeded subset of a TelemetryBatch's records (copy-on-
    write: the engine's true measurement arrays are never mutated)."""
    n = len(batch)
    if n == 0:
        return batch
    rng = np.random.default_rng(ev.seed)
    k = max(1, int(round(ev.fraction * n)))
    idx = rng.choice(n, size=min(k, n), replace=False)
    t0 = np.array(batch.t_baseline, dtype=np.float64, copy=True)
    t1 = np.array(batch.t_allocated, dtype=np.float64, copy=True)
    if ev.mode == "nan":
        t1[idx] = np.nan
    elif ev.mode == "inf":
        t0[idx] = np.inf
    elif ev.mode == "outlier":
        t1[idx] = t1[idx] * OUTLIER_FACTOR
    elif ev.mode == "negative":
        t1[idx] = -np.abs(t1[idx]) - 1.0
    else:  # pragma: no cover - validated at build time
        raise ValueError(f"unknown corruption mode {ev.mode!r}")
    with np.errstate(invalid="ignore", divide="ignore"):
        imp = np.array(batch.improvement, dtype=np.float64, copy=True)
        imp[idx] = (t0[idx] - t1[idx]) / t0[idx]
    return dataclasses.replace(
        batch, t_baseline=t0, t_allocated=t1, improvement=imp
    )


# ---------------------------------------------------------------------------
# Engine-side resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ActuationReport:
    """What the actuation layer tells the controller after a round:
    receivers whose applied caps match the command (``acked``), receivers
    that deviated (``nacked``) with the caps that actually hold
    (``applied`` — the controller's "last-confirmed" values, PowerGuard
    derates included)."""

    round: int
    acked: tuple[str, ...]
    nacked: tuple[str, ...]
    applied: dict


class FaultInjector:
    """Per-run resolution of a scenario's fault events.

    Owned by one ``ClusterSim.run`` call; carries the cross-round fault
    state (delayed telemetry queue, stale-repeat history, the rolling
    controller snapshot crash-restores pull from).
    """

    def __init__(self, faults: Sequence):
        self._by_round: dict[int, list] = {}
        for ev in faults:
            self._by_round.setdefault(ev.round, []).append(ev)
        #: (deliver_round, batch) queue of delayed batches
        self._delayed: list = []
        #: round -> true batch, kept only as far back as stale events reach
        self._history: dict[int, object] = {}
        self._hist_keep = max(
            (e.age for evs in self._by_round.values() for e in evs
             if isinstance(e, TelemetryStale)),
            default=0,
        )
        self._want_snapshots = any(
            isinstance(e, ControllerCrash) and e.restore
            for evs in self._by_round.values()
            for e in evs
        )
        #: last end-of-round controller snapshot (crash-restore source)
        self.snapshot = None
        #: ControllerCrash events fired so far (round, restored) for tooling
        self.crashes: list[tuple[int, bool]] = []

    def faults_at(self, r: int) -> list:
        return self._by_round.get(r, [])

    # -- controller channel --------------------------------------------------

    def maybe_crash(self, r: int, controller) -> bool:
        """Fire any ControllerCrash scheduled at round ``r``: wipe all
        warm state (crash_reset) and, when the event says so and a
        snapshot exists, restore it — the checkpointed-failover path."""
        crashed = False
        for ev in self.faults_at(r):
            if not isinstance(ev, ControllerCrash):
                continue
            controller.crash_reset()
            restored = False
            if ev.restore and self.snapshot is not None:
                controller.restore(self.snapshot)
                restored = True
            self.crashes.append((r, restored))
            crashed = True
        return crashed

    def end_round(self, r: int, controller) -> None:
        """Roll the restore point forward: snapshot after the round's
        telemetry has been ingested, so a crash at round r+1 restores
        exactly the state the uninterrupted controller carries into it."""
        if self._want_snapshots:
            self.snapshot = controller.snapshot()

    # -- actuation channel ---------------------------------------------------

    def _targets(self, ev, names: Sequence[str], node_ids) -> list[str]:
        if ev.node_ids:
            wanted = set(int(i) for i in ev.node_ids)
            return [
                nm for nm, nid in zip(names, node_ids) if int(nid) in wanted
            ]
        if ev.fraction > 0.0 and len(names):
            rng = np.random.default_rng(ev.seed)
            k = max(1, int(round(ev.fraction * len(names))))
            idx = rng.choice(len(names), size=min(k, len(names)), replace=False)
            return [names[i] for i in sorted(int(i) for i in idx)]
        return []

    def actuation_plan(
        self, r: int, names: Sequence[str], node_ids
    ) -> dict[str, tuple[str, float]]:
        """name -> (kind, param) for this round's actuation faults.  The
        first fault claiming a receiver wins (events compose across
        disjoint target sets)."""
        plan: dict[str, tuple[str, float]] = {}
        for ev in self.faults_at(r):
            if isinstance(ev, ActuationNack):
                kind, param = "nack", 0.0
            elif isinstance(ev, ActuationPartial):
                kind, param = "partial", float(ev.applied_fraction)
            elif isinstance(ev, ActuationDelay):
                kind, param = "delay", 0.0
            else:
                continue
            for nm in self._targets(ev, names, node_ids):
                plan.setdefault(nm, (kind, param))
        return plan

    def has_actuation(self, r: int) -> bool:
        return any(isinstance(e, _ACTUATION) for e in self.faults_at(r))

    # -- telemetry channel ---------------------------------------------------

    def deliver(self, r: int, batch) -> tuple[list, tuple[str, ...]]:
        """Route round ``r``'s true batch through the telemetry faults.

        Returns (batches to ingest this round, applied fault kinds).  Due
        delayed batches from earlier rounds are delivered first; the
        current batch is corrupted, displaced by a stale repeat, dropped
        or queued for later delivery per this round's events.
        """
        out: list = []
        kinds: list[str] = []
        due = [b for (rr, b) in self._delayed if rr <= r]
        if due:
            kinds.append("delayed_delivery")
        self._delayed = [(rr, b) for rr, b in self._delayed if rr > r]
        out.extend(due)

        if self._hist_keep:
            self._history[r] = batch
            self._history.pop(r - self._hist_keep - 1, None)

        cur = batch
        evs = self.faults_at(r)
        for ev in evs:
            if isinstance(ev, TelemetryCorrupt) and cur is not None:
                cur = corrupt_batch(cur, ev)
                kinds.append(f"corrupt:{ev.mode}")
        for ev in evs:
            if isinstance(ev, TelemetryStale):
                cur = self._history.get(r - ev.age)
                kinds.append("stale")
                break
        for ev in evs:
            if isinstance(ev, TelemetryDrop):
                cur = None
                kinds.append("drop")
                break
        if cur is not None:
            for ev in evs:
                if isinstance(ev, TelemetryDelay):
                    self._delayed.append((r + ev.rounds, cur))
                    cur = None
                    kinds.append("delay")
                    break
        if cur is not None:
            out.append(cur)
        return out, tuple(kinds)
