"""Emulation-based cluster evaluation (paper §5.4) — single-round facade.

One ``ClusterEmulator`` is one ``ClusterSim`` plus the legacy
``run_round(policy_name, ...)`` calling convention: a fresh stateless
controller per call, measurement RNG seeded exactly as before.
Multi-round studies should use :class:`repro_torch.cluster.sim.ClusterSim`
with a :class:`~repro_torch.cluster.scenario.Scenario` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.cluster.sim import ClusterSim, NodeState
from repro_torch.core import policies as policies_mod
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import AppSpec, EmulationResult, SystemSpec
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ClusterEmulator:
    system: SystemSpec
    nodes: list[NodeState]
    #: true surfaces keyed by *base* app name
    surfaces: Mapping[str, PowerSurface]
    n_repeats: int = 5
    seed: int = 0
    #: where controllers solve (None = the CUDA card)
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def build(
        system: SystemSpec,
        apps: Sequence[AppSpec],
        surfaces: Mapping[str, PowerSurface],
        *,
        n_nodes: int = 100,
        seed: int = 0,
        initial_caps: tuple[float, float] | None = None,
        device: str | torch.device | None = None,
    ) -> "ClusterEmulator":
        """Place ``n_nodes`` instances by cycling a shuffled app list."""
        sim = ClusterSim.build(
            system,
            apps,
            surfaces,
            n_nodes=n_nodes,
            seed=seed,
            initial_caps=initial_caps,
            device=device,
        )
        return ClusterEmulator(
            system=system, nodes=sim.nodes, surfaces=surfaces, seed=seed,
            device=sim.device,
        )

    def _sim(self) -> ClusterSim:
        """Engine view sharing this emulator's node list."""
        return ClusterSim(
            system=self.system,
            nodes=self.nodes,
            surfaces=self.surfaces,
            n_repeats=self.n_repeats,
            seed=self.seed,
            device=self.device,
        )

    def _surface(self, node: NodeState) -> PowerSurface:
        return self._sim()._surface(node)

    def partition(self) -> tuple[list[NodeState], list[NodeState], float]:
        """(donors, receivers, reclaimed_pool) — see ClusterSim.partition."""
        return self._sim().partition()

    def run_round(
        self,
        policy: str,
        budget: float | None = None,
        *,
        policy_surfaces: Mapping[str, PowerSurface] | None = None,
        solver: str = "sparse",
        receivers: Sequence[NodeState] | None = None,
    ) -> EmulationResult:
        """Apply ``policy`` and measure improvements on true surfaces.

        ``policy_surfaces`` is what the policy sees (defaults to true
        surfaces keyed per instance).  ``budget`` defaults to the
        donor-derived reclaimed pool.  ``solver`` as in
        :class:`~repro_torch.cluster.controller.EcoShiftController`.
        """
        kwargs = {"solver": solver} if policy == "ecoshift" else {}
        controller = policies_mod.get_controller(
            policy, self.system, device=self.device, **kwargs
        )
        return self._sim().run_round(
            controller,
            budget=budget,
            policy_surfaces=policy_surfaces,
            receivers=receivers,
        )

    def fail_nodes(self, node_ids: Sequence[int]) -> None:
        """Kill nodes; their power returns to the pool on the next round."""
        ids = set(node_ids)
        self.nodes = [
            dataclasses.replace(n, alive=False) if n.node_id in ids else n
            for n in self.nodes
        ]

    def add_straggler(self, node_id: int, slowdown: float) -> None:
        self.nodes = [
            dataclasses.replace(n, slowdown=slowdown) if n.node_id == node_id else n
            for n in self.nodes
        ]

    def alive_nodes(self) -> list[NodeState]:
        return [n for n in self.nodes if n.alive]
