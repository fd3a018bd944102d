"""Telemetry-driven online performance prediction (paper §3.1, closed loop).

The port of ``repro.cluster.predictor``:

 1. each round the :class:`~repro_torch.cluster.sim.ClusterSim` engine
    packages its noisy measurements into a :class:`TelemetryBatch`
    (bit-identical to the improvements it reports);
 2. an :class:`OnlinePredictor` ingests them into per-(app, instance)
    observation buffers, runs the NCF online phase for apps whose telemetry
    says their surface is wrong (batched across apps via
    ``NCFPredictor.update_apps``, on the predictor's device), and
 3. swaps an app's :class:`~repro_torch.core.surfaces.TabulatedSurface` —
    invalidating controllers' identity-keyed option-table caches — only
    when the refreshed surface moved beyond a tolerance.

The predictor sees only noisy measured runtimes, never true surfaces.
Per-instance buffers are normalized by each instance's fastest observed
runtime before pooling, so stragglers pool cleanly.  An arriving app with
no served surface is allocated from the population prior (the geometric
mean of the served ratio tables) until its telemetry supports a fit.
Records that are non-finite, non-positive or physically impossible are
rejected, and a meter that keeps lying is quarantined.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.ncf import NCFPredictor
from repro_torch.core.surfaces import PowerSurface, TabulatedSurface


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


# ---------------------------------------------------------------------------
# Online predictor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnlinePredictorConfig:
    #: distinct observed grid cells an app needs before its first online fit
    min_cells: int = 3
    #: relative surface move (max |new/old - 1| over the grid) above which
    #: the refreshed surface replaces the served one (and caches invalidate)
    tol: float = 0.01
    #: re-fit a *known* app only when its running |predicted - measured|
    #: improvement error exceeds this (cold apps always re-fit); this is the
    #: drift detector that keeps well-predicted apps off the refit path
    err_threshold: float = 0.03
    #: EMA factor for the per-app prediction-error tracker
    err_ema: float = 0.5
    #: per-(app, instance) observation buffer bound (distinct cells)
    max_cells: int = 64
    #: physical-plausibility bound on one record's runtime ratio: reject
    #: records where t_allocated / t_baseline (either direction) exceeds
    #: this — cap changes on this hardware never slow/speed a job 10x, so
    #: such a record is a broken meter, not a measurement
    max_slowdown: float = 10.0
    #: rejected records from one instance before it is quarantined
    quarantine_after: int = 3
    #: rounds a quarantined instance's telemetry is dropped wholesale
    quarantine_rounds: int = 32


class OnlinePredictor:
    """Stateful wrapper turning streaming telemetry into refreshed surfaces.

    Wraps an offline-trained :class:`~repro_torch.core.ncf.NCFPredictor` (shared
    config embeddings / MLP stay frozen — the paper's online phase) and
    maintains:

     * per-(base_app, instance) observation buffers of mean measured
       runtime per grid cell (off-grid caps snap to the nearest cell: the
       cap grid is the controller's action space, so telemetry lands at
       most half a grid step away);
     * the served surface per app (``surfaces``), swapped only on
       tolerance-exceeding moves so controllers' identity-keyed option
       caches stay warm while predictions are stable;
     * a per-app prediction-error EMA (``prediction_error``) comparing the
       served surface's predicted improvement against the measured one —
       the drift signal that triggers re-fits for already-known apps.
    """

    def __init__(
        self,
        predictor: NCFPredictor,
        cfg: OnlinePredictorConfig = OnlinePredictorConfig(),
    ):
        self.ncf = predictor
        self.system = predictor.system
        self.cfg = cfg
        #: (base_app, instance) -> {cell: [runtime_sum, count]}
        self._buffers: dict[tuple[str, str], dict[tuple[float, float], list]] = {}
        #: instance -> base_app, learned from telemetry (survives phase
        #: changes where an AppSpec's surface_id may lag the true binding)
        self._app_of_instance: dict[str, str] = {}
        self._dirty: set[str] = set()
        #: served predicted surfaces keyed by base app name
        self.surfaces: dict[str, TabulatedSurface] = {}
        #: per-app |predicted - measured| improvement EMA
        self.prediction_error: dict[str, float] = {}
        #: per-app relative move of the last refreshed surface
        self.last_moves: dict[str, float] = {}
        self.n_refits = 0
        self._prior: TabulatedSurface | None = None
        #: robust-ingest counters (DESIGN.md §18): records rejected as
        #: non-finite / non-positive / physically impossible, and records
        #: dropped because their instance is quarantined
        self.n_rejected = 0
        self.n_quarantine_dropped = 0
        #: instance -> consecutive-corruption count since last quarantine
        self._corrupt: dict[str, int] = {}
        #: instance -> round its quarantine expires
        self._quarantined_until: dict[str, int] = {}
        #: construction-time artifacts a crash wipe restores to (the
        #: offline model and offline-seeded surfaces survive a process
        #: crash on disk; everything learned online does not)
        self._initial_ncf = predictor
        self._seeded: dict[str, TabulatedSurface] = {}

    # -- surface source ------------------------------------------------------

    def prior_surface(self) -> TabulatedSurface:
        """Population prior for cold-start apps: the geometric mean of the
        *served* predicted ratio tables (seeded offline surfaces and
        telemetry-fitted refreshes).  A cold app is by definition not
        served, so its own prediction can never leak into its prior.
        Before anything is served, falls back to the wrapped predictor's
        offline apps; flat (no predicted benefit from extra watts) when
        none exist."""
        if self._prior is None:
            grid = self.system.grid
            n_c, n_g = len(grid.cpu_levels), len(grid.gpu_levels)
            if self.surfaces:
                logs = np.stack(
                    [
                        np.log(self.surfaces[n].table)
                        for n in sorted(self.surfaces)
                    ]
                )
                table = np.exp(logs.mean(axis=0))
            elif self.ncf.app_index:
                logs = np.stack(
                    [
                        self.ncf.predict_log_ratios(n)
                        for n in sorted(self.ncf.app_index)
                    ]
                )
                table = np.exp(logs.mean(axis=0)).reshape(n_c, n_g)
            else:
                table = np.ones((n_c, n_g))
            self._prior = TabulatedSurface(
                cpu_levels=grid.cpu_levels,
                gpu_levels=grid.gpu_levels,
                table=table,
            )
        return self._prior

    def seed_surfaces(
        self, predicted: Mapping[str, TabulatedSurface]
    ) -> None:
        """Adopt offline-predicted surfaces as the served starting point
        (apps not listed stay cold-start)."""
        self.surfaces.update(predicted)
        self._seeded.update(predicted)

    def surface_for(self, instance: str, surface_id: str) -> PowerSurface:
        """Served surface for one receiver instance (prior when cold)."""
        app = self._app_of_instance.get(instance, surface_id)
        return self.surfaces.get(app) or self.prior_surface()

    def is_cold(self, app: str) -> bool:
        return app not in self.surfaces

    # -- telemetry ingestion -------------------------------------------------

    def _snap(self, caps: tuple[float, float]) -> tuple[float, float]:
        grid = self.system.grid
        c = grid.cpu_levels[np.argmin(np.abs(grid.cpu_levels - caps[0]))]
        g = grid.gpu_levels[np.argmin(np.abs(grid.gpu_levels - caps[1]))]
        return float(c), float(g)

    def _push(self, app: str, instance: str, caps, t: float) -> None:
        buf = self._buffers.setdefault((app, instance), {})
        cell = self._snap(caps)
        if cell not in buf and len(buf) >= self.cfg.max_cells:
            return
        slot = buf.setdefault(cell, [0.0, 0])
        slot[0] += t
        slot[1] += 1

    def _record_ok(self, t0: float, t1: float) -> bool:
        """Physical plausibility of one record's runtimes: finite, strictly
        positive, and within ``max_slowdown`` of each other in either
        direction (a cap change can't make a job 1000x slower — that's a
        broken meter)."""
        if not (np.isfinite(t0) and np.isfinite(t1)):
            return False
        if t0 <= 0.0 or t1 <= 0.0:
            return False
        m = self.cfg.max_slowdown
        return t1 <= m * t0 and t0 <= m * t1

    def _admit(self, instance: str, rnd: int, t0: float, t1: float) -> bool:
        """Gate one record into the buffers: quarantined instances are
        dropped wholesale, implausible records are rejected and counted,
        and ``quarantine_after`` rejections quarantine the instance for
        ``quarantine_rounds`` rounds (a meter that keeps lying gets
        unplugged instead of re-probed every round)."""
        q = self._quarantined_until.get(instance)
        if q is not None and rnd < q:
            self.n_quarantine_dropped += 1
            return False
        if self._record_ok(t0, t1):
            return True
        self.n_rejected += 1
        c = self._corrupt.get(instance, 0) + 1
        if c >= self.cfg.quarantine_after:
            self._quarantined_until[instance] = rnd + self.cfg.quarantine_rounds
            self._corrupt[instance] = 0
        else:
            self._corrupt[instance] = c
        return False

    def observe(self, records: "Iterable[TelemetryRecord] | TelemetryBatch") -> None:
        """Ingest one round of telemetry: buffer both measurement points of
        every record and update the per-app prediction-error EMA.

        A :class:`TelemetryBatch` takes the columnar fast path — one
        vectorized grid snap for all caps and one served-surface evaluation
        per app over its records — bit-identical to the record loop."""
        if isinstance(records, TelemetryBatch):
            self._observe_batch(records)
            return
        for r in records:
            if not self._admit(r.instance, r.round, r.t_baseline, r.t_allocated):
                continue
            self._app_of_instance[r.instance] = r.base_app
            self._push(r.base_app, r.instance, r.baseline_caps, r.t_baseline)
            self._push(r.base_app, r.instance, r.allocated_caps, r.t_allocated)
            self._dirty.add(r.base_app)
            served = self.surfaces.get(r.base_app)
            if served is not None:
                pred = float(
                    served.improvement(r.baseline_caps, *r.allocated_caps)
                )
                err = abs(pred - r.improvement)
                prev = self.prediction_error.get(r.base_app)
                a = self.cfg.err_ema
                self.prediction_error[r.base_app] = (
                    err if prev is None else a * err + (1 - a) * prev
                )

    def _observe_batch(self, batch: TelemetryBatch) -> None:
        """Columnar ingest over the batch's interned id tables.

        Cell snapping is one vectorized nearest-level lookup for all 2n
        measurement points, and the served surface evaluates once per app
        across its records (the drift EMA folds in record order, exactly
        like the sequential path).  Buffer pushes replay the interleaved
        [baseline, allocated] stream so cell admission under ``max_cells``
        is order-identical to :meth:`observe` on the record views."""
        n = len(batch)
        if n == 0:
            return
        strings = batch.strings
        grid = self.system.grid

        def snap_cols(caps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            ci = np.argmin(
                np.abs(grid.cpu_levels[None, :] - caps[:, 0][:, None]), axis=1
            )
            gi = np.argmin(
                np.abs(grid.gpu_levels[None, :] - caps[:, 1][:, None]), axis=1
            )
            return grid.cpu_levels[ci], grid.gpu_levels[gi]

        bc, bg = snap_cols(batch.baseline_caps)
        ac, ag = snap_cols(batch.allocated_caps)
        max_cells = self.cfg.max_cells
        use = np.zeros(n, dtype=bool)
        for i in range(n):
            inst = strings[batch.inst_gids[i]]
            if not self._admit(
                inst,
                batch.round,
                float(batch.t_baseline[i]),
                float(batch.t_allocated[i]),
            ):
                continue
            use[i] = True
            app = strings[batch.app_gids[i]]
            self._app_of_instance[inst] = app
            buf = self._buffers.setdefault((app, inst), {})
            for cell, t in (
                ((float(bc[i]), float(bg[i])), float(batch.t_baseline[i])),
                ((float(ac[i]), float(ag[i])), float(batch.t_allocated[i])),
            ):
                if cell not in buf and len(buf) >= max_cells:
                    continue
                slot = buf.setdefault(cell, [0.0, 0])
                slot[0] += t
                slot[1] += 1

        by_app: dict[int, list[int]] = {}
        for i in range(n):
            if not use[i]:
                continue
            by_app.setdefault(int(batch.app_gids[i]), []).append(i)
        a = self.cfg.err_ema
        for gid, idx in by_app.items():
            app = strings[gid]
            self._dirty.add(app)
            served = self.surfaces.get(app)
            if served is None:
                continue
            ii = np.asarray(idx)
            t0 = np.asarray(
                served.runtime(
                    batch.baseline_caps[ii, 0], batch.baseline_caps[ii, 1]
                ),
                np.float64,
            )
            tn = np.asarray(
                served.runtime(
                    batch.allocated_caps[ii, 0], batch.allocated_caps[ii, 1]
                ),
                np.float64,
            )
            preds = (t0 - tn) / t0
            prev = self.prediction_error.get(app)
            for k, i in enumerate(idx):
                err = abs(float(preds[k]) - float(batch.improvement[i]))
                prev = err if prev is None else a * err + (1 - a) * prev
            self.prediction_error[app] = prev

    def _pooled_samples(self, app: str) -> dict[tuple[float, float], float]:
        """Pool an app's instance buffers into one {cell: runtime-ratio}.

        Each instance normalizes by its own fastest observed mean runtime,
        making observations comparable across slowdown factors; duplicate
        cells average across instances."""
        cells: dict[tuple[float, float], list[float]] = {}
        for (a, _inst), buf in self._buffers.items():
            if a != app or not buf:
                continue
            means = {cell: s / n for cell, (s, n) in buf.items()}
            ref = min(means.values())
            for cell, t in means.items():
                cells.setdefault(cell, []).append(t / ref)
        return {cell: float(np.mean(v)) for cell, v in cells.items()}

    # -- refresh -------------------------------------------------------------

    def refresh(self) -> list[str]:
        """Run the online phase for apps whose telemetry warrants it and
        return the apps whose *served* surface actually moved (> tol) —
        exactly the set whose warm controller caches must invalidate.

        An app re-fits when it is dirty (new telemetry), has at least
        ``min_cells`` distinct observed cells, and is either cold (no
        served surface) or drifting (prediction-error EMA above
        ``err_threshold``)."""
        ready: dict[str, dict] = {}
        for app in sorted(self._dirty):
            cold = self.is_cold(app)
            drifting = (
                self.prediction_error.get(app, 0.0) > self.cfg.err_threshold
            )
            if not (cold or drifting):
                self._dirty.discard(app)
                continue
            pooled = self._pooled_samples(app)
            if len(pooled) >= self.cfg.min_cells:
                ready[app] = pooled
        if not ready:
            return []
        self.ncf = self.ncf.update_apps(ready)
        self.n_refits += len(ready)
        changed = []
        for app in ready:
            self._dirty.discard(app)
            new = self.ncf.predict_surface(app)
            old = self.surfaces.get(app)
            if old is None:
                move = np.inf
            else:
                move = float(np.max(np.abs(new.table / old.table - 1.0)))
            self.last_moves[app] = move
            if move > self.cfg.tol:
                self.surfaces[app] = new
                changed.append(app)
            # restart the drift EMA after *every* refit: a swap invalidates
            # the stale readings, and a no-move refit means the served
            # surface is as good as the model can do on this buffer — only
            # freshly re-accumulated error should trigger another fit
            self.prediction_error[app] = 0.0
        return changed

    # -- crash / restore (DESIGN.md §18) --------------------------------------

    @staticmethod
    def _encode_surface(s: TabulatedSurface) -> dict:
        return {
            "cpu_levels": np.asarray(s.cpu_levels),
            "gpu_levels": np.asarray(s.gpu_levels),
            "table": np.asarray(s.table),
            "natural_cpu": float(s.natural_cpu),
            "natural_gpu": float(s.natural_gpu),
        }

    @staticmethod
    def _decode_surface(d: dict) -> TabulatedSurface:
        return TabulatedSurface(
            cpu_levels=np.asarray(d["cpu_levels"]),
            gpu_levels=np.asarray(d["gpu_levels"]),
            table=np.asarray(d["table"]),
            natural_cpu=float(d["natural_cpu"]),
            natural_gpu=float(d["natural_gpu"]),
        )

    @staticmethod
    def _tree_np(x):
        """Copy a param pytree to host numpy (dict/tuple structure kept)."""
        if isinstance(x, dict):
            return {k: OnlinePredictor._tree_np(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(OnlinePredictor._tree_np(v) for v in x)
        if isinstance(x, list):
            return [OnlinePredictor._tree_np(v) for v in x]
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def state_dict(self) -> dict:
        """Everything learned online, as plain numpy/python values.

        Buffers and cell keys are list-encoded (msgpack has no tuple keys);
        the wrapped NCF serializes params/app_index/cfg_feats (its frozen
        system/config come from the live replacement process).  The lazy
        ``_prior`` is derived state and is recomputed on demand after load.
        """
        return {
            "buffers": [
                [app, inst, [[list(c), s, n] for c, (s, n) in buf.items()]]
                for (app, inst), buf in self._buffers.items()
            ],
            "app_of_instance": dict(self._app_of_instance),
            "dirty": sorted(self._dirty),
            "surfaces": {
                a: self._encode_surface(s) for a, s in self.surfaces.items()
            },
            "prediction_error": dict(self.prediction_error),
            "last_moves": dict(self.last_moves),
            "n_refits": int(self.n_refits),
            "n_rejected": int(self.n_rejected),
            "n_quarantine_dropped": int(self.n_quarantine_dropped),
            "corrupt": dict(self._corrupt),
            "quarantined_until": dict(self._quarantined_until),
            "ncf": {
                "params": self._tree_np(self.ncf.params),
                "app_index": dict(self.ncf.app_index),
                "cfg_feats": np.asarray(self.ncf.cfg_feats),
            },
        }

    def load_state_dict(self, state: Mapping) -> None:
        self._buffers = {
            (app, inst): {
                (float(c[0]), float(c[1])): [float(s), int(n)]
                for c, s, n in cells
            }
            for app, inst, cells in state["buffers"]
        }
        self._app_of_instance = dict(state["app_of_instance"])
        self._dirty = set(state["dirty"])
        self.surfaces = {
            a: self._decode_surface(d) for a, d in state["surfaces"].items()
        }
        self.prediction_error = dict(state["prediction_error"])
        self.last_moves = dict(state["last_moves"])
        self.n_refits = int(state["n_refits"])
        self.n_rejected = int(state["n_rejected"])
        self.n_quarantine_dropped = int(state["n_quarantine_dropped"])
        self._corrupt = {k: int(v) for k, v in state["corrupt"].items()}
        self._quarantined_until = {
            k: int(v) for k, v in state["quarantined_until"].items()
        }
        self.ncf = NCFPredictor(
            system=self.system,
            cfg=self.ncf.cfg,
            params=state["ncf"]["params"],
            app_index=dict(state["ncf"]["app_index"]),
            cfg_feats=np.asarray(state["ncf"]["cfg_feats"]),
            device=self.ncf.device,
            embedding_init=self.ncf.embedding_init,
        )
        self._prior = None

    def wipe(self) -> None:
        """Simulate a process crash: everything learned online is gone;
        only construction-time artifacts (the offline-trained NCF and the
        offline-seeded surfaces — both on disk in a real deployment)
        survive."""
        self.ncf = self._initial_ncf
        self._buffers = {}
        self._app_of_instance = {}
        self._dirty = set()
        self.surfaces = dict(self._seeded)
        self.prediction_error = {}
        self.last_moves = {}
        self.n_refits = 0
        self.n_rejected = 0
        self.n_quarantine_dropped = 0
        self._corrupt = {}
        self._quarantined_until = {}
        self._prior = None
