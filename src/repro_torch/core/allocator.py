"""EcoShift end-to-end allocator: profile -> predict -> DP (paper Fig. 3).

The port of ``repro.core.allocator``:

 1. offline: train the NCF predictor on historical applications
    (``train_offline``) on ``device``;
 2. online: for each unseen receiver, run the brief profiling phase and fit
    its embeddings (``onboard``);
 3. per redistribution round: predict surfaces for all receivers and solve
    the MCKP DP (``allocate``; ``solver="pallas"`` runs the dense DP on the
    predictor's device).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import ncf, policies, profiler
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import Allocation, AppSpec, SystemSpec


@dataclasses.dataclass
class EcoShiftAllocator:
    system: SystemSpec
    predictor: ncf.NCFPredictor
    #: per-app predicted surfaces, populated by onboard()
    predicted: dict[str, PowerSurface] = dataclasses.field(default_factory=dict)
    n_online_samples: int = 8

    @staticmethod
    def train_offline(
        system: SystemSpec,
        historical: Mapping[str, PowerSurface],
        cfg: ncf.NCFConfig = ncf.NCFConfig(),
        *,
        observed_fraction: float = 1.0,
        seed: int = 0,
        device: str | torch.device | None = None,
        init_params: dict | None = None,
        indices=None,
    ) -> "EcoShiftAllocator":
        """Train the predictor on full/partial sweeps of historical apps
        (``init_params``/``indices`` as in :meth:`NCFPredictor.fit`)."""
        rng = np.random.default_rng(seed)
        observations: dict[str, dict[tuple[float, float], float]] = {}
        for name, surf in historical.items():
            obs = profiler.dense_profile(surf, system, rng=rng)
            if observed_fraction < 1.0:
                keys = list(obs)
                keep = rng.choice(
                    len(keys),
                    size=max(4, int(observed_fraction * len(keys))),
                    replace=False,
                )
                obs = {keys[i]: obs[keys[i]] for i in keep}
            observations[name] = obs
        predictor = ncf.NCFPredictor.fit(
            system, observations, cfg, device=device,
            init_params=init_params, indices=indices,
        )
        return EcoShiftAllocator(system=system, predictor=predictor)

    def onboard(self, name: str, true_surface: PowerSurface, *, seed: int = 0) -> None:
        """Online phase for an unseen app: profile K cells, fit embeddings,
        cache the predicted surface for subsequent allocation rounds."""
        samples = profiler.profile_app(
            true_surface, self.system, n_samples=self.n_online_samples, seed=seed
        )
        self.predictor = self.predictor.infer_app(name, samples)
        self.predicted[name] = self.predictor.predict_surface(name)

    def onboard_known(self, name: str) -> None:
        """Reuse a historical app's learned surface (repeat submission)."""
        self.predicted[name] = self.predictor.predict_surface(name)

    def allocate(
        self,
        receivers: Sequence[AppSpec],
        baselines: Mapping[str, tuple[float, float]],
        budget: float,
        *,
        solver: str = "sparse",
        surface_of: Mapping[str, str] | None = None,
    ) -> Allocation:
        """Solve one redistribution round on the *predicted* surfaces.

        ``surface_of`` maps receiver instance names to predictor app names
        (cluster emulation runs many instances of each app).
        """
        surface_of = surface_of or {a.name: a.name for a in receivers}
        surfaces = {a.name: self.predicted[surface_of[a.name]] for a in receivers}
        return policies.ecoshift(
            receivers, baselines, budget, self.system, surfaces,
            solver=solver, device=self.predictor.device,
        )
