"""Carrying state into the port.

 * a node table read from the JAX package's ``NodeTable`` columns (as
   numpy arrays) becomes the port's ``NodeTable``, so a port sim can
   continue a reference sim's cluster;
 * a power-domain tree read from the JAX package's ``PowerTopology``
   (each domain's ``name``, ``cap`` trace, ``nodes`` ranges and
   ``children``, as plain Python attributes) becomes the port's
   ``PowerTopology``, so one topology feeds both packages' sims;
 * behaviour classes read from the JAX package's ``GroupedOptions``
   (option ``costs``, ``values``, ``caps`` as numpy arrays, member names as
   strings) become the port's ``OptionTable``s and ``GroupedOptions``, so
   one set of groups feeds both packages' solvers;
 * a JAX ``Model.init`` parameter tree (numpy leaves) becomes the port
   ``Model``'s state, and a JAX prefill/decode cache tree the port's cache
   dict: the stacked ``[n_units, ...]`` scan leaves are unstacked into one
   entry per layer, every other layout (``[d, h, k]``, ``[h, k, d]``, ...)
   is kept, so one set of weights serves both packages;
 * a JAX ``NCFPredictor``'s parts (``params`` as numpy, ``app_index``,
   ``cfg_feats``, ``cfg``) become the port's ``NCFPredictor`` on a device;
   around it, the port's ``OnlinePredictor.load_state_dict`` takes a JAX
   ``OnlinePredictor.state_dict()`` as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.cluster.sim import NodeTable
from repro_torch.core.ncf import NCFConfig, NCFPredictor
from repro_torch.core.curves import OptionTable
from repro_torch.core.mckp import GroupedOptions
from repro_torch.core.topology import PowerDomain, PowerTopology

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


def topology_from_parts(topology) -> PowerTopology:
    """The port's :class:`PowerTopology` from a reference one, read through
    plain attributes: its ``root`` and ``n_nodes`` (the coverage check),
    and each domain's ``name``, ``cap`` (a cap trace, passed on as is),
    ``nodes`` (half-open ``(lo, hi)`` ranges, leaves only) and
    ``children``.  Preorder, names and node ranges come out the same, so
    domain ids agree between the packages."""

    def build(d) -> PowerDomain:
        return PowerDomain(
            name=str(d.name),
            cap=d.cap,
            children=tuple(build(c) for c in d.children),
            nodes=tuple((int(lo), int(hi)) for lo, hi in d.nodes),
        )

    return PowerTopology(build(topology.root), n_nodes=topology.n_nodes)


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


# ---------------------------------------------------------------------------
# NCF predictors
# ---------------------------------------------------------------------------


def ncf_predictor_from_parts(
    system,
    cfg,
    params: Mapping[str, Any],
    app_index: Mapping[str, int],
    cfg_feats: np.ndarray,
    *,
    device: str | torch.device | None = None,
    embedding_init: Callable[[str], Mapping] | None = None,
) -> NCFPredictor:
    """The port's :class:`NCFPredictor` on ``device`` (None = the CUDA card)
    from a reference predictor's parts: ``params`` (the parameter tree as
    numpy, same names), ``app_index``, ``cfg_feats`` and ``cfg`` (any object
    with :class:`NCFConfig`'s fields, read field by field).  ``system`` is
    the port's :class:`~repro_torch.core.types.SystemSpec`."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(NCFConfig)}
    fields["mlp_hidden"] = tuple(fields["mlp_hidden"])
    return NCFPredictor(
        system=system,
        cfg=NCFConfig(**fields),
        params=params,
        app_index=dict(app_index),
        cfg_feats=np.array(cfg_feats, dtype=np.float32),
        device=device,
        embedding_init=embedding_init,
    )


# ---------------------------------------------------------------------------
# Model weights and KV caches
# ---------------------------------------------------------------------------


def _flatten(tree: dict[str, Any], prefix: str) -> dict[str, Any]:
    out = {}
    for key, leaf in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(leaf, dict):
            out.update(_flatten(leaf, name))
        elif leaf is not None:
            out[name] = leaf
    return out


def _unstack(stack: dict[str, Any], cfg) -> dict[str, np.ndarray]:
    """``{"units": {"l{i}": ...[n_units, ...]}, "tail": {"t{i}": ...}}`` ->
    ``layers.{j}.<path>``, layer ``j = r * len(unit) + i`` for unit ``r``
    and ``n_units * len(unit) + i`` for tail layer ``i``."""
    unit, n_units, _ = cfg.scan_pattern()
    out = {}
    for name, leaf in _flatten(stack.get("units", {}), "").items():
        li, path = name.split(".", 1)
        for r in range(n_units):
            out[f"layers.{r * len(unit) + int(li[1:])}.{path}"] = np.array(leaf[r])
    for name, leaf in _flatten(stack.get("tail", {}), "").items():
        ti, path = name.split(".", 1)
        out[f"layers.{n_units * len(unit) + int(ti[1:])}.{path}"] = np.array(leaf)
    return out


def model_state_from_tree(tree: dict[str, Any], cfg) -> dict[str, np.ndarray]:
    """A JAX ``Model.init`` tree (numpy leaves) -> the port ``Model``'s
    state-dict names and arrays (copied)."""
    if "shared_attn" in tree["stack"]:
        raise NotImplementedError("zamba2's shared attention block (ROADMAP.md §1 item 7)")
    state = _unstack(tree["stack"], cfg)
    for part in ("embed", "final_ln"):
        state.update({k: np.array(v) for k, v in _flatten(tree[part], part).items()})
    return state


def tree_from_model_state(state: dict[str, Any], cfg) -> dict[str, Any]:
    """The inverse of :func:`model_state_from_tree`: the port's state (numpy
    arrays or tensors) -> the JAX ``Model.init`` tree layout, scan leaves
    stacked again."""
    unit, n_units, tail = cfg.scan_pattern()
    arrays = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for k, v in state.items()}

    def nest(names: dict[str, np.ndarray]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, leaf in names.items():
            *path, last = name.split(".")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf
        return out

    def layer(j: int) -> dict[str, np.ndarray]:
        pre = f"layers.{j}."
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    stack: dict[str, Any] = {"tail": {}}
    if n_units:
        stack["units"] = {}
        for i in range(len(unit)):
            rows = [layer(r * len(unit) + i) for r in range(n_units)]
            stack["units"][f"l{i}"] = nest({k: np.stack([r[k] for r in rows]) for k in rows[0]})
    for i in range(len(tail)):
        stack["tail"][f"t{i}"] = nest(layer(n_units * len(unit) + i))
    top = nest({k: v for k, v in arrays.items() if not k.startswith("layers.")})
    return {"stack": stack, **top}


def load_model_params(model, tree: dict[str, Any]) -> None:
    """Copy a JAX ``Model.init`` tree (numpy leaves) into ``model`` (every
    parameter must be present)."""
    state = model_state_from_tree(tree, model.cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)


def cache_from_tree(cache: dict[str, Any], cfg) -> dict[str, np.ndarray]:
    """A JAX prefill/decode cache tree (numpy leaves) -> the port's cache
    names (``layers.{i}.k`` / ``.v``) and arrays."""
    return _unstack(cache, cfg)
