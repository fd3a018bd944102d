"""Carrying state into the port.

The port's state is the cluster and its option tables, not model weights:

 * a node table read from the JAX package's ``NodeTable`` columns (as
   numpy arrays) becomes the port's ``NodeTable``, so a port sim can
   continue a reference sim's cluster;
 * behaviour classes read from the JAX package's ``GroupedOptions``
   (option ``costs``, ``values``, ``caps`` as numpy arrays, member names as
   strings) become the port's ``OptionTable``s and ``GroupedOptions``, so
   one set of groups feeds both packages' solvers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.cluster.sim import NodeTable
from repro_torch.core.curves import OptionTable
from repro_torch.core.mckp import GroupedOptions

#: column name -> dtype of every numeric NodeTable column
COLUMNS = {
    "node_ids": np.int64,
    "caps": np.float64,
    "alive": bool,
    "slowdown": np.float64,
    "base_gid": np.int32,
    "sid_gid": np.int32,
    "name_gid": np.int32,
    "sclass_gid": np.int32,
    "domain_id": np.int32,
}


def node_table_from_columns(
    columns: dict[str, np.ndarray], strings: list[str]
) -> NodeTable:
    """Build a :class:`NodeTable` from ``columns`` (every key of
    :data:`COLUMNS`) and the shared interned string table ``strings``.
    Instance names come from ``name_gid``; the arrays are copied."""
    missing = COLUMNS.keys() - columns.keys()
    if missing:
        raise KeyError(f"missing NodeTable columns: {sorted(missing)}")
    t = NodeTable()
    for s in strings:
        t.interner.intern(s)
    if len(t.strings) != len(strings):
        raise ValueError("strings must be unique")
    for name, dtype in COLUMNS.items():
        setattr(t, name, np.array(columns[name], dtype=dtype))
    n = len(t.node_ids)
    if any(len(getattr(t, name)) != n for name in COLUMNS):
        raise ValueError("NodeTable columns must have equal length")
    if t.caps.shape != (n, 2):
        raise ValueError(f"caps must be [n, 2], got {t.caps.shape}")
    t.names = [t.strings[g] for g in t.name_gid]
    return t


def option_table_from_arrays(
    name: str, costs: np.ndarray, values: np.ndarray, caps: np.ndarray
) -> OptionTable:
    """An :class:`OptionTable` from a reference table's arrays (copied as
    float64: the reference's tables are float64, so digests stay equal)."""
    costs = np.array(costs, dtype=np.float64)
    values = np.array(values, dtype=np.float64)
    caps = np.array(caps, dtype=np.float64)
    if costs.ndim != 1 or values.shape != costs.shape or caps.shape != (len(costs), 2):
        raise ValueError(
            f"costs/values must be [K] and caps [K, 2], got {costs.shape} "
            f"{values.shape} {caps.shape}"
        )
    if not len(costs) or costs[0] != 0.0:
        raise ValueError("an option table starts with the zero-cost option")
    return OptionTable(name=name, costs=costs, values=values, caps=caps)


def grouped_options_from_arrays(
    groups: Sequence[tuple[str, np.ndarray, np.ndarray, np.ndarray, Sequence[str]]],
) -> list[GroupedOptions]:
    """:class:`GroupedOptions` from ``(table name, costs, values, caps,
    members)`` tuples — e.g. ``(g.table.name, g.table.costs,
    g.table.values, g.table.caps, g.members)`` of each reference group."""
    return [
        GroupedOptions(
            table=option_table_from_arrays(name, costs, values, caps),
            members=tuple(str(m) for m in members),
        )
        for name, costs, values, caps, members in groups
    ]
