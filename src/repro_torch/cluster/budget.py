"""Budget providers: what the budget is at round ``r``, and over the next
H rounds.

 * :class:`BudgetProvider` — the protocol: ``budget_at(round)`` and
   ``forecast(round, horizon)``, the outlook the receding-horizon planner
   (``repro_torch.core.mckp.plan_horizon``) plans over;
 * :class:`ConstantProvider` / :class:`TraceReplayProvider` — static and
   trace-replay sources (scalar, per-round sequence holding its last
   value, or callable);
 * :class:`ScaledProvider` / :class:`MinProvider` — composition: derate a
   feed by a factor, or cap one feed by another;
 * :class:`StepOverrideProvider` / :class:`OverrideBook` — piecewise steps
   active from their round on; the book is the engine's routing target for
   ``DomainCapChange`` events.

Every pathway coerces through :func:`as_watts`.  The day-scale signal
fixtures (CO2 intensity, spot price, solar output; 96 points, 15-minute
resolution) ship under ``fixtures/`` and load via :func:`load_fixture` /
:func:`fixture_trace`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Protocol, Sequence, Union, runtime_checkable

#: legacy trace union: scalar (constant), per-round sequence (holds its
#: last value), or callable ``round -> value``; None = "no signal"
Trace = Union[None, float, Sequence, Callable[[int], object]]


def as_watts(value) -> float | None:
    """The one scalar coercion every budget pathway shares."""
    if value is None:
        return None
    return float(value)


def trace_at(trace: Trace, r: int):
    """Resolve a legacy trace at round ``r`` (scalars are constant,
    sequences hold their last value, empty sequences and None yield None,
    callables are invoked)."""
    if trace is None or isinstance(trace, (int, float)):
        return trace
    if callable(trace):
        return trace(r)
    if len(trace) == 0:
        return None
    return trace[min(r, len(trace) - 1)]


@runtime_checkable
class BudgetProvider(Protocol):
    """What every budget source answers: now, and the next H rounds."""

    def budget_at(self, r: int) -> float | None:
        """Budget (watts / signal units) at round ``r``; None = unset."""
        ...

    def forecast(self, r: int, horizon: int) -> tuple:
        """Values for rounds ``r .. r+horizon-1``."""
        ...


class _ProviderBase:
    """Shared forecast/composition plumbing for concrete providers."""

    def budget_at(self, r: int) -> float | None:  # pragma: no cover
        raise NotImplementedError

    def forecast(self, r: int, horizon: int) -> tuple:
        return tuple(self.budget_at(r + i) for i in range(int(horizon)))

    def scaled(self, factor: float) -> "ScaledProvider":
        return ScaledProvider(self, factor)

    def min_with(self, other) -> "MinProvider":
        return MinProvider(self, other)


class ConstantProvider(_ProviderBase):
    """The same value every round (``None`` = every round unset)."""

    def __init__(self, value: float | None):
        self.value = as_watts(value)

    def budget_at(self, r: int) -> float | None:
        return self.value

    def __repr__(self) -> str:
        return f"ConstantProvider({self.value!r})"


class TraceReplayProvider(_ProviderBase):
    """Replay a recorded trace with the scenario trace semantics; the shim
    target for raw ``Scenario`` traces (``budget_at`` returns exactly
    ``float(trace value)``)."""

    def __init__(self, trace: Trace):
        if isinstance(trace, TraceReplayProvider):
            trace = trace.trace
        if not (
            trace is None
            or isinstance(trace, (int, float))
            or callable(trace)
            or hasattr(trace, "__len__")
        ):
            raise TypeError(
                f"trace must be None, scalar, sequence or callable, "
                f"got {type(trace).__name__}"
            )
        self.trace = trace

    def budget_at(self, r: int) -> float | None:
        return as_watts(trace_at(self.trace, r))

    def __repr__(self) -> str:
        return f"TraceReplayProvider({self.trace!r})"


class ScaledProvider(_ProviderBase):
    """``factor * base`` — per-domain derating, unit conversion (a
    normalized solar fraction to watts), or eco-mode shaving."""

    def __init__(self, base, factor: float):
        self.base = as_provider(base)
        self.factor = float(factor)

    def budget_at(self, r: int) -> float | None:
        b = None if self.base is None else self.base.budget_at(r)
        return None if b is None else b * self.factor

    def __repr__(self) -> str:
        return f"ScaledProvider({self.base!r}, {self.factor!r})"


class MinProvider(_ProviderBase):
    """Pointwise minimum of several providers (unset members ignored;
    all-unset rounds stay None)."""

    def __init__(self, *providers):
        if not providers:
            raise ValueError("MinProvider needs at least one provider")
        self.providers = tuple(as_provider(p) for p in providers)

    def budget_at(self, r: int) -> float | None:
        vals = [
            v
            for p in self.providers
            if p is not None
            for v in (p.budget_at(r),)
            if v is not None
        ]
        return min(vals) if vals else None

    def __repr__(self) -> str:
        return f"MinProvider{self.providers!r}"


class StepOverrideProvider(_ProviderBase):
    """A base provider with piecewise step overrides: each ``(round,
    value)`` step applies from its round on (inclusive) until a later step
    supersedes it — the ``DomainCapChange`` contract."""

    def __init__(self, base, steps):
        self.base = as_provider(base)
        items = steps.items() if hasattr(steps, "items") else steps
        self.steps = tuple(
            sorted((int(rr), as_watts(v)) for rr, v in items)
        )

    def budget_at(self, r: int) -> float | None:
        v = None if self.base is None else self.base.budget_at(r)
        for rr, val in self.steps:
            if rr <= r:
                v = val
        return v

    def __repr__(self) -> str:
        return f"StepOverrideProvider({self.base!r}, {self.steps!r})"


def as_provider(trace) -> BudgetProvider | None:
    """Normalize anything budget-like into a provider: None stays None, an
    object with ``budget_at`` passes through, raw traces are wrapped."""
    if trace is None:
        return None
    if hasattr(trace, "budget_at"):
        return trace
    return TraceReplayProvider(trace)


class OverrideBook:
    """Mutable registry of per-domain cap-change steps (the engine's
    ``DomainCapChange`` routing target).

    Each domain id accumulates ``(round, cap)`` steps; :meth:`active`
    resolves which override (if any) binds each domain at a given round —
    a step applies from its round on, the latest applicable step wins.
    Resolution shares :func:`as_watts` with the budget providers, and a
    headroom query for a round before a change's round does not see the
    future cap.
    """

    def __init__(self):
        self._steps: dict[int, list[tuple[int, float]]] = {}

    def set(self, domain_id: int, round: int, cap) -> None:
        """Record: ``domain_id``'s cap becomes ``cap`` from ``round`` on."""
        steps = self._steps.setdefault(int(domain_id), [])
        steps.append((int(round), as_watts(cap)))
        steps.sort(key=lambda s: s[0])

    def active(self, r: int) -> dict[int, float]:
        """domain id -> overriding cap binding at round ``r``."""
        out: dict[int, float] = {}
        for dom, steps in self._steps.items():
            for rr, cap in steps:
                if rr <= r:
                    out[dom] = cap
        return out

    def provider_for(self, domain_id: int, base=None) -> StepOverrideProvider:
        """This domain's cap timeline as a provider (base = its cap trace)."""
        return StepOverrideProvider(
            base, self._steps.get(int(domain_id), ())
        )

    def clear(self) -> None:
        self._steps.clear()

    def __len__(self) -> int:
        return len(self._steps)

    def __bool__(self) -> bool:
        return bool(self._steps)


# ---------------------------------------------------------------------------
# Day-scale signal fixtures
# ---------------------------------------------------------------------------

_FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")

#: shipped day-scale signal fixtures (96 points = 15-minute resolution)
FIXTURES = ("co2_day", "price_day", "solar_day")


def load_fixture(name: str) -> dict:
    """Load a shipped signal fixture (or a path to one) as its raw dict:
    ``{"name", "units", "resolution_minutes", "values"}``."""
    path = (
        name
        if os.path.sep in name or name.endswith(".json")
        else os.path.join(_FIXTURE_DIR, f"{name}.json")
    )
    with open(path) as f:
        return json.load(f)


def fixture_trace(name: str, n_rounds: int | None = None) -> tuple:
    """A fixture's value sequence, resampled to ``n_rounds`` points by
    nearest-index lookup (None = native resolution)."""
    values = load_fixture(name)["values"]
    if n_rounds is None or n_rounds == len(values):
        return tuple(float(v) for v in values)
    n = len(values)
    return tuple(
        float(values[min(int(i * n / n_rounds), n - 1)])
        for i in range(int(n_rounds))
    )


def fixture_provider(name: str, n_rounds: int | None = None) -> TraceReplayProvider:
    """A shipped fixture as a replayable provider."""
    return TraceReplayProvider(fixture_trace(name, n_rounds))


def solar_budget(
    peak_watts: float,
    floor_watts: float = 0.0,
    n_rounds: int | None = None,
) -> BudgetProvider:
    """Day-scale solar-following budget: the shipped normalized solar curve
    scaled to ``peak_watts``, never below ``floor_watts`` (grid backstop)."""
    solar = ScaledProvider(fixture_provider("solar_day", n_rounds), peak_watts)

    class _Floor(_ProviderBase):
        def budget_at(self, r: int) -> float | None:
            v = solar.budget_at(r)
            return None if v is None else max(v, float(floor_watts))

    return _Floor()
