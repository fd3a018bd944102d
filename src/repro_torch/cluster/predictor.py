"""Round telemetry emitted by the cluster engine.

The port's part of ``repro.cluster.predictor``: the telemetry records and
their columnar batch.  The online NCF predictor that consumes them comes
with the NCF slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TelemetryRecord:
    """One receiver's noisy measurement from one redistribution round.

    ``t_baseline`` / ``t_allocated`` are the mean measured runtimes at the
    baseline and allocated cap pairs; ``improvement`` is derived from
    exactly those two numbers and equals the engine's reported improvement.
    """

    round: int
    instance: str
    base_app: str
    baseline_caps: tuple[float, float]
    allocated_caps: tuple[float, float]
    t_baseline: float
    t_allocated: float
    improvement: float


@dataclasses.dataclass(frozen=True, eq=False)
class TelemetryBatch:
    """One round's telemetry as columns; iterating or indexing a batch
    materializes :class:`TelemetryRecord` views lazily."""

    round: int
    inst_gids: np.ndarray  # [n] int32 into ``strings`` (instance names)
    app_gids: np.ndarray  # [n] int32 into ``strings`` (base-app names)
    strings: list  # shared interned string table (append-only)
    baseline_caps: np.ndarray  # [n, 2]
    allocated_caps: np.ndarray  # [n, 2]
    t_baseline: np.ndarray  # [n]
    t_allocated: np.ndarray  # [n]
    improvement: np.ndarray  # [n]

    def __len__(self) -> int:
        return len(self.inst_gids)

    def record(self, i: int) -> TelemetryRecord:
        return TelemetryRecord(
            round=self.round,
            instance=self.strings[self.inst_gids[i]],
            base_app=self.strings[self.app_gids[i]],
            baseline_caps=(
                float(self.baseline_caps[i, 0]),
                float(self.baseline_caps[i, 1]),
            ),
            allocated_caps=(
                float(self.allocated_caps[i, 0]),
                float(self.allocated_caps[i, 1]),
            ),
            t_baseline=float(self.t_baseline[i]),
            t_allocated=float(self.t_allocated[i]),
            improvement=float(self.improvement[i]),
        )

    def __getitem__(self, i: int) -> TelemetryRecord:
        return self.record(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self.record(i)

    @property
    def instances(self) -> list[str]:
        return [self.strings[g] for g in self.inst_gids]
