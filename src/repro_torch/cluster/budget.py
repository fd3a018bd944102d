"""Budget providers: what the budget is at round ``r``.

The provider classes ``Scenario`` normalizes its budget, price and carbon
signals into.  The composed providers (scaled, min), the step-override
book of the topology path and the day-scale signal fixtures of the
carbon-aware scenarios come with the topology and MPC slice (ROADMAP.md,
queue 1, item 5).
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
