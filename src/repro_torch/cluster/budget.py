"""Budget providers: what the budget is at round ``r``.

The provider classes ``Scenario`` normalizes its budget, price and carbon
signals into, and the step-override book the engine routes
``DomainCapChange`` events to.  The composed providers (scaled, min) and
the day-scale signal fixtures of the carbon-aware scenarios come with the
MPC slice (ROADMAP.md, queue 1, item 5).
"""

from __future__ import annotations

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
    """Shared forecast plumbing for concrete providers."""

    def budget_at(self, r: int) -> float | None:  # pragma: no cover
        raise NotImplementedError

    def forecast(self, r: int, horizon: int) -> tuple:
        return tuple(self.budget_at(r + i) for i in range(int(horizon)))


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

    def clear(self) -> None:
        self._steps.clear()

    def __len__(self) -> int:
        return len(self._steps)

    def __bool__(self) -> bool:
        return bool(self._steps)
