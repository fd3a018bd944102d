"""Carrying cluster state into the port.

This slice's state is the cluster, not model weights: a node table read
from the JAX package's ``NodeTable`` columns (as numpy arrays) becomes the
port's ``NodeTable``, so a port sim can continue a reference sim's cluster.
"""

from __future__ import annotations

import numpy as np

from repro_torch.cluster.sim import NodeTable

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
