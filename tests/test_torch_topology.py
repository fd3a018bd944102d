"""The port's power-domain topology, its cap-override book and the
scenario/engine topology contracts against the JAX package.

Both packages build the same trees (``repro_torch.interop.topology_from_parts``
carries a reference ``PowerTopology`` over by its plain attributes) on the
shapes of tests/test_topology.py.  Topologies are numpy in both packages,
so every comparison is exact: preorder names, parents, leaf ids, interned
domain ids, caps and aggregates compare as arrays with ``==``, and errors
by type and message.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import Scenario as JScenario
from repro.cluster import budget as jbudget
from repro.cluster import scenario as jscenario
from repro.core import surfaces as jsurfaces
from repro.core import topology as jtopology
from repro.core import types as jtypes
from repro_torch import interop
from repro_torch.cluster import ClusterSim, DomainCapChange, NodeArrival, Scenario
from repro_torch.cluster import budget as tbudget
from repro_torch.core import surfaces, topology, types

torch.set_num_threads(1)
CPU = "cpu"


def _two_racks(mod):
    return mod.PowerTopology(
        mod.PowerDomain(
            name="site",
            cap=1000.0,
            children=(
                mod.PowerDomain(name="rack0", cap=400.0, nodes=((0, 4),)),
                mod.PowerDomain(name="rack1", cap=400.0, nodes=((4, 8),)),
            ),
        )
    )


def _assert_topology_equal(got, want):
    assert got.names == want.names
    assert got.index == want.index
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_array_equal(got.leaf_ids, want.leaf_ids)
    assert [d.nodes for d in got.domains] == [d.nodes for d in want.domains]
    assert got.n_nodes == want.n_nodes


def _builders():
    """(name, build(topology module)) pairs on tests/test_topology.py's
    shapes, cap traces of every form."""
    return [
        ("two_racks", _two_racks),
        ("single_root", lambda m: m.PowerTopology.single_root(12, cap=500.0)),
        ("uniform_racks", lambda m: m.PowerTopology.uniform_racks(
            10, 3, rack_cap=[300.0, 250.0], site_cap=lambda r: 900.0 - r)),
        ("uniform_tree", lambda m: m.PowerTopology.uniform_tree(
            100, (2, 3, 2), [1e18, 4000.0, 1500.0, 700.0])),
        ("uniform_tree_named", lambda m: m.PowerTopology.uniform_tree(
            7, (3,), [100.0, 40.0], name="room", level_names=("bay",))),
        ("multi_range_leaf", lambda m: m.PowerTopology(
            m.PowerDomain(name="l", cap=10.0, nodes=((0, 2), (5, 7))))),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _builders()])
def test_builders_match_reference(name):
    build = dict(_builders())[name]
    want, got = build(jtopology), build(topology)
    _assert_topology_equal(got, want)
    ids = np.arange(0, 12) % max(1, (want.n_nodes or 7))
    ids = np.array([i for i in ids if want.owns(int(i))])
    np.testing.assert_array_equal(got.leaf_of(ids), want.leaf_of(ids))
    for r in (0, 1, 5):
        np.testing.assert_array_equal(got.cap_at(r), want.cap_at(r))
        over = {len(want) - 1: 30.0, 0: 77.0}
        np.testing.assert_array_equal(got.cap_at(r, over), want.cap_at(r, over))
    rng = np.random.default_rng(len(name))
    leaf_vals = rng.uniform(0, 100, len(want))
    np.testing.assert_array_equal(
        got.aggregate_leaves(leaf_vals), want.aggregate_leaves(leaf_vals)
    )
    spend = want.aggregate_leaves(leaf_vals)
    allowed = spend * rng.uniform(0.5, 1.5, len(want))
    np.testing.assert_array_equal(
        got.derate_factors(spend, allowed), want.derate_factors(spend, allowed)
    )
    _assert_topology_equal(interop.topology_from_parts(want), want)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.PowerDomain(name="bad", cap=10.0),
        lambda m: m.PowerDomain(name="x", cap=10.0, nodes=((3, 3),)),
        lambda m: m.PowerDomain(name="x", cap=0.0, nodes=((0, 1),)),
        lambda m: m.PowerTopology(m.PowerDomain(name="a", cap=10.0, children=(
            m.PowerDomain(name="a", cap=5.0, nodes=((0, 1),)),))),
        lambda m: m.PowerTopology(m.PowerDomain(name="s", cap=10.0, children=(
            m.PowerDomain(name="r0", cap=5.0, nodes=((0, 4),)),
            m.PowerDomain(name="r1", cap=5.0, nodes=((3, 6),))))),
        # coverage: a gap, a short tail, a late start, a zero node count
        lambda m: m.PowerTopology(m.PowerDomain(name="s", cap=10.0, children=(
            m.PowerDomain(name="r0", cap=5.0, nodes=((0, 3),)),
            m.PowerDomain(name="r1", cap=5.0, nodes=((4, 6),)))), n_nodes=6),
        lambda m: m.PowerTopology(
            m.PowerDomain(name="l", cap=5.0, nodes=((0, 5),)), n_nodes=6),
        lambda m: m.PowerTopology(
            m.PowerDomain(name="l", cap=5.0, nodes=((1, 6),)), n_nodes=6),
        lambda m: m.PowerTopology(
            m.PowerDomain(name="l", cap=5.0, nodes=((0, 6),)), n_nodes=0),
        lambda m: m.PowerTopology.uniform_tree(10, (), [1.0]),
        lambda m: m.PowerTopology.uniform_tree(10, (2, 0), [1.0, 1.0, 1.0]),
        lambda m: m.PowerTopology.uniform_tree(10, (2, 2), [1.0, 1.0]),
        lambda m: m.PowerTopology.uniform_tree(3, (2, 2), [1.0, 1.0, 1.0]),
        lambda m: m.PowerTopology.uniform_tree(8, (2,), [1.0, 1.0], level_names=()),
        lambda m: m.PowerTopology.uniform_racks(3, 4, rack_cap=1.0),
        lambda m: _two_racks(m).leaf_of([0, 8]),
        lambda m: _two_racks(m).require_leaf("site"),
        lambda m: _two_racks(m).require_leaf("nope"),
    ],
)
def test_validation_errors_match_reference(make):
    with pytest.raises(ValueError) as want:
        make(jtopology)
    with pytest.raises(ValueError) as got:
        make(topology)
    assert str(got.value) == str(want.value)


def test_provider_cap_traces_and_override_book_match_reference():
    jprov = jbudget.TraceReplayProvider([500.0, 400.0, 300.0])
    tprov = tbudget.TraceReplayProvider([500.0, 400.0, 300.0])
    for r in range(5):
        assert topology.cap_trace_at(tprov, r) == jtopology.cap_trace_at(jprov, r)
    jb, tb = jbudget.OverrideBook(), tbudget.OverrideBook()
    for book in (jb, tb):
        book.set(2, 3, 250.0)
        book.set(2, 1, 300)
        book.set(0, 4, 10.0)
    for r in range(6):
        assert tb.active(r) == jb.active(r)
    assert len(tb) == len(jb) == 2 and bool(tb)
    tb.clear()
    assert not tb and tb.active(9) == {}


# ---------------------------------------------------------------------------
# Scenario fail-fast and engine attachment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_1),
        surfaces.build_paper_suite(types.SYSTEM_1),
    )


@pytest.mark.parametrize(
    "build",
    [
        lambda sc, topo, app: sc.with_topology(topo).with_failure(1, 3, 9),
        lambda sc, topo, app: sc.with_topology(topo).with_straggler(1, 8, 1.5),
        lambda sc, topo, app: sc.with_topology(topo).with_phase_change(1, 12, "x"),
        lambda sc, topo, app: sc.with_failure(1, 8).with_topology(topo),
        lambda sc, topo, app: sc.with_topology(topo).with_domain_cap(1, "rack9", 10.0),
        lambda sc, topo, app: sc.with_topology(topo).with_domain_cap(1, "rack0", 0.0),
        lambda sc, topo, app: sc.with_topology(topo).with_arrival(1, app, domain="site"),
        lambda sc, topo, app: sc.with_topology(topo).with_arrival(1, app, domain="rackX"),
    ],
)
def test_scenario_fail_fast_matches_reference(suites, build):
    (japps, _), (apps, _) = suites
    with pytest.raises(ValueError) as want:
        build(JScenario.constant(3), _two_racks(jtopology), japps[0])
    with pytest.raises(ValueError) as got:
        build(Scenario.constant(3), _two_racks(topology), apps[0])
    assert str(got.value) == str(want.value)


def test_valid_topology_scenario_builds(suites):
    _, (apps, _) = suites
    topo = _two_racks(topology)
    sc = (
        Scenario.constant(4, budget=100.0)
        .with_failure(1, 2)
        .with_topology(topo)
        .with_straggler(2, 7, 1.4)
        .with_domain_cap(3, "rack1", 300.0)
        .with_arrival(3, apps[0], domain="rack0")
    )
    assert sc.topology is topo
    assert isinstance(sc.events_at(3)[0], DomainCapChange)
    assert isinstance(sc.events_at(3)[1], NodeArrival)
    assert sc.events_at(3)[1].domain == "rack0"


def test_engine_attachment_matches_reference(suites):
    """Interned domain ids, per-domain headroom with a cap override, the
    nodes setter's interning, arrival placement and the errors of a node
    no leaf owns and a mismatched topology."""
    (japps, jsurfs), (apps, surfs) = suites
    jtopo = jtopology.PowerTopology.uniform_tree(
        20, (2, 2), [1e18, 6000.0, 3200.0]
    )
    topo = interop.topology_from_parts(jtopo)
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=20, seed=4, topology=jtopo)
    sim = ClusterSim.build(
        types.SYSTEM_1, apps, surfs, n_nodes=20, seed=4, topology=topo, device=CPU
    )
    np.testing.assert_array_equal(sim.table.domain_id, jsim.table.domain_id)
    jsim.apply_events([jscenario.DomainCapChange(round=2, domain="row1", cap=2900.0)])
    sim.apply_events([DomainCapChange(round=2, domain="row1", cap=2900.0)])
    for r in (0, 1, 2, 3):
        for got, want in zip(sim.domain_headroom(r), jsim.domain_headroom(r)):
            np.testing.assert_array_equal(got, want)
    d = sim.partition_rows()[0][:2]
    for got, want in zip(sim.domain_headroom(2, d), jsim.domain_headroom(2, d)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sim._committed_draw(d), jsim._committed_draw(d))
    # an arrival needs a leaf: node id 20 is outside every range
    with pytest.raises(ValueError, match="no leaf domain owns") as err:
        sim.apply_events([NodeArrival(round=3, app=apps[0])])
    with pytest.raises(ValueError) as jerr:
        jsim.apply_events([jscenario.NodeArrival(round=3, app=japps[0])])
    assert str(err.value) == str(jerr.value)
    sim.apply_events([NodeArrival(round=3, app=apps[0], domain="pdu3")])
    jsim.apply_events([jscenario.NodeArrival(round=3, app=japps[0], domain="pdu3")])
    np.testing.assert_array_equal(sim.table.domain_id, jsim.table.domain_id)
    assert sim.table.domain_id[-1] == topo.index["pdu3"]
    # the nodes setter interns before swapping the table in
    sim.nodes = sim.nodes[:10]
    np.testing.assert_array_equal(sim.table.domain_id, jsim.table.domain_id[:10])
    with pytest.raises(ValueError, match="outside every leaf"):
        sim.nodes = [dataclasses.replace(sim.nodes[0], node_id=99)]
    assert len(sim.table) == 10
    scen = Scenario.constant(1, budget=100.0).with_topology(_two_racks(topology))
    with pytest.raises(ValueError, match="differs"):
        sim.run(scen, "ecoshift_hier")
    bare = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=4, seed=0, device=CPU)
    with pytest.raises(ValueError, match="requires an attached PowerTopology"):
        bare.apply_events([DomainCapChange(round=0, domain="site", cap=5.0)])
    with pytest.raises(ValueError, match="outside every leaf"):
        ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=9, seed=0, device=CPU,
                         topology=_two_racks(topology))

