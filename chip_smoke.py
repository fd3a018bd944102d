#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of EcoShift on one NVIDIA GPU and check it.

Run from the root of a copy of the repository (no build step, no network):

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure before the last line:

 1. the card (``nvidia-smi`` name and power limit) and the versions;
 2. build of the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
    ``nvcc`` per source started together (the ``-Xptxas -v`` summaries);
 3. the dense (max,+) convolution kernel against its plain PyTorch version
    on the card, bitwise, at the dense main path's shapes, with times,
    bounds, the kernel's work items and its launches a call;
 4. the dense main path: a 256-node SYSTEM_2 cluster for 4 rounds (pool
    budget, one failure, one straggler) through ``ClusterSim.run`` under
    ``solver="pallas"`` (the kernel) and ``solver="jax"`` (the plain
    version), bitwise equal round by round, with the kernel's launch count
    equal to the DP stages run, and round 0 held against the float64 numpy
    DP; then the device busy share of one round from ``torch.profiler``
    and the dense kernel's share of it;
 5. one ungrouped round and one ``allocate_batch`` budget sweep, each held
    against its plain-version run;
 6. the sparse-option (max,+) stage kernel against its plain version on
    the card, bitwise on values and backpointers, through both entries:
    the single-stage one at the fused main path's stage shape (float64)
    and a ragged one (float64 and float32), and the multi-stage one (all
    stages of a fused round in one launch, masked) at the fused main path's
    40 stages, ragged rows and an NB beyond shared memory, with its launch
    plan (route, grid blocks, shared memory), times and bound;
 7. the fused main path: the same scenario at 2048 nodes (the widest flat
    grid the fused round takes) under the default EcoShift controller with
    ``fused=True`` and with the default host sparse solver, bitwise equal
    round by round, every solved round on the device with no fallback, and
    the multi-stage kernel launched once per fused round (the single-stage
    entry never); then the device busy share of one fused round, the
    kernel's share of it and ``dispatch_s``, and the kernel timed on the
    round's resident banks;
 8. the hierarchical power-domain path at benchmarks/hier_alloc.py's
    settings: the stage kernel at the tree kinds' combine-wave shapes
    (float64, S = 1, masked at a cap cut; rows 1-40 by offsets 16-128 at
    NB = 128, and the widest wave, NB = K = 4096) against its plain
    version bitwise, with times and bounds; the deep tier (100 000
    SYSTEM_1 nodes under a 4-level site -> row -> PDU -> chassis tree of
    125 domains, an 8 kW budget, 5 rounds with 1 000 failures (one whole
    chassis outside one PDU), 100 stragglers, that PDU derated below its
    draw and 20 replacement arrivals) through ``ClusterSim.run`` under
    ``ecoshift_hier`` with ``fused=True`` and on the host, equal in every
    record and every round's ``last_domain_spent``, every round fused
    with no fallback and 1 + (its 8 waves) launches of kernel 2.1, every
    domain under its cap and every ancestor its children's sum, the
    derating cutting the PDU's draw to within one lattice pitch of its new
    cap, then the busy share of one profiled event round; and the 16-rack
    tier at 10 000 nodes on the dense solver,
    ``solver="pallas"`` (kernel 2.2, one launch a leaf-scan stage over
    every rack) against ``"jax"``, equal, the launches equal to the
    leaf-scan stages, every rack under its cap and the derated rack's cap
    cutting its draw;
 9. the policy comparison at the benchmarks' settings: NCF trained on
    the card on 28 of the 40 apps (2000 steps), two card fits of one
    500-step stream bitwise equal and the card's fit against the host's on
    that stream, the 12 held-out apps onboarded online and their accuracy held
    above ACC_BOUND; then the 256-node cluster over a four-budget sweep
    under uniform, DPS, MixedAdaptive, EcoShift on predicted surfaces (the
    dense kernel), the Oracle (sparse DP) and ``ecoshift_online``, with
    every round's average improvement, Jain index and spend (never above
    the budget) and each policy's gap to the Oracle; the Oracle's brute
    force against its sparse DP at 8 receivers, bitwise; and the online
    loop at benchmarks/online_adaptation.py's settings (30 nodes of the 28
    known apps, 16 rounds) with a held-out app arriving cold, on the kernel
    and on the plain version, bitwise equal, the cold app fit from its own
    telemetry, with refits, invalidations, refresh seconds and the cold
    app's gap to the Oracle a round;
10. the serving kernels (RMSNorm, flash attention, flash decode) against
    their plain PyTorch versions on the card, in bf16 and float32, at the
    serving path's shapes, a sliding-window and a softcap shape, ragged
    decode lengths that include 1, a long decode cache (8192 slots) and
    prefill attention at head dim 80 (zamba2-2.7b's and hubert-xlarge's
    heads, zero-padded to the D = 128 kernel, with the padding copy's
    time), each with its time, the plain version's, its bound and one
    library call's (``torch.nn.functional.rms_norm``,
    ``scaled_dot_product_attention``; the port never calls them);
11. the serving path: granite-3-2b at its full config (40 layers, bf16
    compute, float32 weights drawn from a seed) through
    ``ServeEngine.generate`` for 8 requests of 512 prompt tokens and 32
    greedy tokens (cache padded to 1024), with prefill seconds, decode
    seconds per token, tokens/s and the kernels' launch counts against what
    the path implies; then the same prompts on the plain route on the card,
    teacher-forced with the kernel route's tokens, logits held within
    LOGIT_REL_TOL, and the share of greedy tokens the two routes agree on;
    then the device busy share of one prefill and one decode step, with
    the attention kernels' shares;
12. faults and receding-horizon (MPC) planning, at the benchmarks' own
    settings: benchmarks/budget_horizon.py's CO2-day tier (256 SYSTEM_1
    nodes, 96 rounds, horizon 12, eco 0.7; myopic, reactive and mpc fused
    on the card, mpc on the host: fused == host bitwise with every
    planned budget, spend within every budget, mpc's perf per CO2 above
    myopic's, 0 fallbacks) and its solar tier (128 nodes, 8 racks,
    ``ecoshift_hier``: fused == host bitwise with ``last_domain_spent``,
    every rack under its cap); the deep tree under explicit faults (NACK,
    NaN telemetry, partial and delayed actuation, a dropped and a stale
    batch, a restored crash at round 5) fused against the host, every
    domain's settled draw under its cap, no domain over in two rounds in
    a row, at least three fused rounds after the crash; the fused main
    path's 2048 nodes under benchmarks/fault_storm.py's rate-0.30 storm
    (fused == host, no settled overdraw) and its crash_restore tier (the
    restored run, its snapshots through ``save_snapshot`` /
    ``load_snapshot`` on disk, equal to the uninterrupted one); and the
    dense main path's 256 nodes under the same storm, ``pallas`` against
    ``jax`` with kernel 2.2 in the pinned rounds;
13. one JSON line listing each ported kernel (the dense kernel's launches
    summed over the dense main path, the rack tier, phase 9's kernel
    paths and the dense storm; the stage kernel's over the fused main
    path, the deep tier and phase 12's fused runs), then the result line.

It exits 2 without printing a result when no CUDA card is present or when
the port's sources are not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_NODES = 256
N_ROUNDS = 4
N_BUDGETS = 8  # budgets of the allocate_batch sweep
N_NODES_FUSED = 2048  # the fused main path: S, K, NB pads 40, 1024, 4096
# NVIDIA H100 SXM data sheet at its 700 W limit: float32 and float64
# outside the tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12
# round 0 of the kernel path against the float64 numpy DP: the float32 DP
# sums ~200 values below 1, so its total may differ by ~200 ulp(100)
REL_TOL_F64 = 1e-4
# the serving path: granite-3-2b at its full config, 8 requests of 512
# prompt tokens, 32 greedy tokens each, the cache padded to 1024 slots
SERVE_ARCH = "granite-3-2b"
SERVE_BATCH = 8
SERVE_PROMPT = 512
SERVE_GEN = 32
SERVE_S_MAX = 1024
PEAK_BF16_OPS = 989e12  # H100 SXM tensor cores, dense
# the hierarchical path at benchmarks/hier_alloc.py's settings: its deep
# tier (100 000 SYSTEM_1 nodes under a 4-level site -> row -> PDU ->
# chassis tree, 125 domains) fused on the card, and
# its 16-rack tier at 10 000 nodes on the dense solver; 8 kW budgets
DEEP_NODES = 100_000
DEEP_FANOUTS = (4, 5, 5)
DEEP_LEVEL_FRACS = (0.9, 0.75, 0.6)
DEEP_BUDGET = 8000.0
DEEP_ROUNDS = 5
RACK_NODES = 10_000
RACK_COUNT = 16
RACK_BUDGET = 8000.0
RACK_ROUNDS = 4
# faults and MPC: benchmarks/budget_horizon.py's and benchmarks/fault_storm.py's
# full settings
MPC_NODES = 256
MPC_HIER_NODES = 128
MPC_HIER_RACKS = 8
MPC_ROUNDS = 96
MPC_HORIZON = 12
MPC_ECO = 0.7
STORM_ROUNDS = 24
# a quarter of 8, 5, 9, 4, 8, 6, 9, 5, 8, 7 kW, then 6 and 9 kW: every round's
# budget under the ~2.5 kW the deep tree's chassis caps let it spend, so each
# round binds and a NACKed receiver's stale caps differ from its command; the
# last two clean rounds outlast the NACK backoff of the storm's pins (to 8)
DEEP_STORM_BUDGETS = (2000.0, 1250.0, 2250.0, 1000.0, 2000.0, 1500.0, 2250.0, 1250.0,
                      2000.0, 1750.0, 1500.0, 2250.0)
# the policy comparison at the benchmarks' own settings (benchmarks/
# common.py): the 40-app suite with the last 12 held out of the offline fit
# and onboarded online, the benchmark-grade NCF config, a budget sweep
# across the donor pool
N_HELDOUT = 12
NCF_TRAIN_STEPS = 2000
NCF_ONLINE_STEPS = 400
ACC_BOUND = 0.90  # held-out prediction accuracy (tests/test_ncf.py)
POOL_FRACTIONS = (0.25, 0.5, 0.75, 1.0)
# the card's fit against the host's on one injected init and index stream,
# as the largest |parameter difference|: cuBLAS and the host's BLAS sum in
# other orders (the JAX package and the port on one host stay below 4e-7
# after 500 steps)
NCF_HOST_STEPS = 500
NCF_HOST_TOL = 1e-5
# the Oracle's exhaustive search against its sparse DP (<= 10 receivers)
ORACLE_BRUTE_N = 8
ORACLE_BRUTE_BUDGET = 300.0
# the online loop at benchmarks/online_adaptation.py's own settings: the
# first held-out C/G/B app of the mixed group arrives cold at round 2 on a
# 30-node cluster (seed 11) of the 28 known apps, 16 rounds of budgets
# 700 + 350 * ((3 r) % 5) W, the predictor's default config
ONLINE_NODES = 30
ONLINE_SEED = 11
N_ONLINE_ROUNDS = 16
ONLINE_ARRIVAL = 2
NCF_PROFILE_STEPS = 50  # the profiled fit
# serving kernels against their plain versions, elementwise rtol = atol =
# tol (tests/test_kernels.py's): float32 sums in another order (~1e-6);
# bf16 may round the float32 result to the neighbouring value (2^-8)
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# kernel route against the plain route on the card, teacher-forced, as
# max |logit difference| / max |logit| per step: the routes differ only by
# the kernels' float32 summation order, which moves a bf16 activation by one
# rounding (2^-8) now and then; 40 layers carry that to the bf16 logits,
# whose own rounding is 2^-8 of the largest, so a few such steps show.
LOGIT_REL_TOL = 5e-2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _bits_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int32 if a.dtype in (torch.float32, torch.int32) else a.dtype
    return bool(torch.equal(a.contiguous().view(view), b.contiguous().view(view)))


def _max_abs_err(a, b) -> float:
    import torch

    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def _cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card, timed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device milliseconds of one call of ``fn``: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times and timed by CUDA events,
    so the host's work per call is out of the time (inputs L2-warm, as in
    :func:`_cuda_ms`).  Capturing also proves the call capturable."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on a side stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def _host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return, with no
    synchronise between calls (the enqueue cost; ``fn`` warmed up)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _times(fn, iters: int, prefix: str = "") -> dict:
    """Back-to-back ``ms`` (CUDA events), ``device_ms`` (CUDA graph) and
    ``host_us`` of ``fn``, the keys prefixed with ``prefix``."""
    return {f"{prefix}ms": _cuda_ms(fn, iters=iters), f"{prefix}device_ms": _graph_ms(fn),
            f"{prefix}host_us": _host_us(fn)}


def _ptxas_summary(log: str) -> list[str]:
    """One line a kernel from nvcc's ``-Xptxas -v`` output: registers,
    spill stores and loads, shared memory."""
    import re

    lines, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            lines.append(f"{name}: {m.group(1)} registers, {spills}, static smem "
                         f"{smem.group(1) if smem else 0} B")
            name, spills = None, ""
    return lines


def _bound_ms(rows: int, nb: int) -> tuple[float, str]:
    """Least time for one stage: every candidate is one add and one compare
    on float32; each input read once, each output written once."""
    ops = 2.0 * rows * nb * (nb + 1) / 2
    nbytes = 4.0 * rows * nb * 4  # dp, f in; out, arg out
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _stage_inputs(rows: int, nb: int, seed: int, dev):
    """Seeded dp, f [rows, nb] float32 on a 1/8 lattice (many exact ties)
    with some -inf curve entries."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dp = np.round(rng.uniform(0, 100, (rows, nb)) * 8) / 8
    f = np.round(rng.uniform(0, 4, (rows, nb)) * 8) / 8
    f[rng.random((rows, nb)) < 0.1] = -np.inf
    f[:, 0] = 0.0
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return as_t(dp), as_t(f)


def kernel_phase(dev, nb_main: int) -> dict:
    """Phase 3: each wrapper against the plain version at the main path's
    shapes; returns the measured stats of the two ported kernels."""
    from repro_torch.kernels import mckp_dp, ref

    cases = [
        ("batched R=1 (grouped main-path stage)", mckp_dp.maxplus_conv_batched, 1, nb_main),
        ("batched R=8 (budget sweep stage)", mckp_dp.maxplus_conv_batched, N_BUDGETS, nb_main),
        ("batched R=3, NB not a multiple of 128", mckp_dp.maxplus_conv_batched, 3, 1000 + 37),
        ("single row (ungrouped stage)", mckp_dp.maxplus_conv, 1, nb_main),
        ("batched R=1, NB past the main path", mckp_dp.maxplus_conv_batched, 1, 16384),
        ("batched R=8, NB past the main path", mckp_dp.maxplus_conv_batched, N_BUDGETS, 16384),
        ("batched R=1, NB = 65536", mckp_dp.maxplus_conv_batched, 1, 65536),
    ]
    stats = {}
    for i, (label, fn, rows, nb) in enumerate(cases):
        dp, f = _stage_inputs(rows, nb, SEED + i, dev)
        if fn is mckp_dp.maxplus_conv:
            dp, f = dp[0], f[0]
            plain = ref.maxplus_conv
        else:
            plain = ref.maxplus_conv_batched
        counter = fn.__name__
        before = mckp_dp.launches[counter]
        out, arg = fn(dp, f)
        per_call = mckp_dp.launches[counter] - before
        want_out, want_arg = plain(dp, f)
        check(
            _bits_equal(out, want_out) and _bits_equal(arg, want_arg),
            f"kernel != plain version for {label}",
        )
        check(per_call == 1, f"{label}: {per_call} launches a call")
        err = _max_abs_err(out, want_out)
        t = _times(lambda: fn(dp, f), iters=20)
        ms = t["ms"]
        plain_ms = _cuda_ms(lambda: plain(dp, f), iters=2, warmup=1)
        bound_ms, bound_by = _bound_ms(rows, nb)
        print(
            f"kernel {label}: rows={rows} nb={nb} bitwise out+arg ok, "
            f"work_items={mckp_dp.work_items(rows, nb)} launches_per_call={per_call} "
            f"max_abs_err={err} ms={ms:.6f} device_ms={t['device_ms']:.6f} "
            f"host_us={t['host_us']:.2f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.6f} ({bound_by}, f32 {PEAK_F32_OPS:.3g} op/s) "
            f"roofline_share={bound_ms / ms:.4f} plain_over_kernel={plain_ms / ms:.1f} "
            f"library_ms=null (no single PyTorch call computes a (max,+) convolution)"
        )
        if rows == 1 and nb == nb_main:
            stats[fn.__name__] = {
                "max_abs_err": err, **t, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
    return stats


def _records_equal(a, b) -> bool:
    for ra, rb in zip(a.records, b.records, strict=True):
        aa, ab = ra.result.allocation, rb.result.allocation
        if (
            dict(aa.caps) != dict(ab.caps)
            or aa.spent != ab.spent
            or aa.predicted_improvement != ab.predicted_improvement
            or ra.result.improvements != rb.result.improvements
        ):
            return False
    return True


def _run(sim, scen, dev, solver: str, **kw):
    """One scenario under a fresh controller; returns (result, seconds)."""
    import torch

    from repro_torch.cluster import make_controller
    from repro_torch.core import types

    ctrl = make_controller("ecoshift", types.SYSTEM_2, solver=solver, device=dev, **kw)
    t0 = time.perf_counter()
    res = sim.run(scen, ctrl)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _stages(res) -> int:
    return sum(len(r.result.improvements) for r in res.records)


def main_path_phase(dev, fresh_sim, scen) -> int:
    """Phase 4; returns the batched kernel's launches on the main path."""
    from repro_torch.kernels import mckp_dp

    mckp_dp.reset_launches()
    res_k, wall_k = _run(fresh_sim(), scen, dev, "pallas")
    launches = dict(mckp_dp.launches)
    res_p, wall_p = _run(fresh_sim(), scen, dev, "jax")
    stages = _stages(res_k)
    print(
        f"main path: {N_NODES} nodes, {N_ROUNDS} rounds, launches={launches} "
        f"dp_stages={stages} wall_s pallas={wall_k:.4f} jax={wall_p:.4f}"
    )
    check(launches["maxplus_conv_batched"] == stages, "launches != DP stages")
    check(launches["maxplus_conv"] == 0, "grouped path launched the single-row entry")
    check(_records_equal(res_k, res_p), "pallas and jax rounds differ")
    for rk, rp in zip(res_k.records, res_p.records):
        alloc = rk.result.allocation
        budget = rk.result.budget
        check(alloc.spent <= budget + 1e-9, f"round {rk.round} overspends")
        imps = list(rk.result.improvements.values())
        check(all(abs(x) < 1.0 for x in imps), f"round {rk.round}: bad improvement")
        sk, sp = rk.seconds, rp.seconds
        print(
            f"round {rk.round}: receivers={len(imps)} nb={int(budget) + 1} "
            f"budget={budget!r} spent={alloc.spent!r} "
            f"avg_improvement={alloc.predicted_improvement!r} "
            f"pallas round_s={sum(sk.values()):.4f} (allocate_s="
            f"{sk['allocate_s']:.4f}) jax round_s={sum(sp.values()):.4f} "
            f"(allocate_s={sp['allocate_s']:.4f})"
        )
    # round 0 against the float64 numpy DP on the same cluster
    from repro_torch.cluster import Scenario

    res_d, _ = _run(fresh_sim(), Scenario.constant(1), dev, "dense")
    got = res_k.records[0].result.allocation.predicted_improvement
    want = res_d.records[0].result.allocation.predicted_improvement
    rel = abs(got - want) / abs(want)
    print(f"round 0 vs float64 numpy DP: avg_improvement {got!r} vs {want!r} rel={rel:.3g}")
    check(rel <= REL_TOL_F64, "round 0 far from the float64 DP")
    return launches["maxplus_conv_batched"]


def _kernel_share(by_kernel: dict, kernel: str, wall: float) -> str:
    """``kernel``'s summed device time (µs) and its share of ``wall`` (s),
    over every profiled name that holds it."""
    us = sum(v for k, v in by_kernel.items() if kernel in k)
    return f"{kernel}_us={us:.1f} {kernel}_share={us / 1e6 / wall:.4f}"


def busy_share_phase(dev, fresh_sim) -> None:
    """Device busy share of one kernel-path round, from torch.profiler:
    the summed durations of the device-side events (kernels and copies on
    the one stream the round uses, so they do not overlap) over the round's
    host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster import Scenario

    sim = fresh_sim()
    _run(sim, Scenario.constant(1), dev, "pallas")  # loads the kernel library
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _run(sim, Scenario.constant(1), dev, "pallas")
    by_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_s = sum(by_kernel.values()) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    if device_s:
        print(
            f"profiled round: wall_s={wall:.4f} device_busy_s={device_s:.4f} "
            f"busy_share={device_s / wall:.4f} "
            f"{_kernel_share(by_kernel, 'maxplus_conv_kernel', wall)} top_device_us_and_share="
            + json.dumps(
                {k[:60]: [round(v, 1), round(v / 1e6 / wall, 4)] for k, v in top}
            )
        )
    else:
        print(f"profiled round: wall_s={wall:.4f} busy_share=not measured "
              "(the profiler recorded no device time)")


def variants_phase(dev, fresh_sim) -> int:
    """Phase 5; returns the single-row kernel's launches on the ungrouped
    round."""
    from repro_torch.cluster import Scenario, make_controller
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    scen = Scenario.constant(1)
    mckp_dp.reset_launches()
    res_k, wall_k = _run(fresh_sim(), scen, dev, "pallas", grouped=False)
    launches = dict(mckp_dp.launches)
    res_p, wall_p = _run(fresh_sim(), scen, dev, "jax", grouped=False)
    print(
        f"ungrouped round: launches={launches} dp_stages={_stages(res_k)} "
        f"wall_s pallas={wall_k:.4f} jax={wall_p:.4f}"
    )
    check(launches["maxplus_conv"] == _stages(res_k), "ungrouped launches != stages")
    check(_records_equal(res_k, res_p), "ungrouped pallas and jax differ")

    sim = fresh_sim()
    _, recv, pool = sim.partition()
    apps = [n.app for n in recv]
    baselines = {n.app.name: n.caps for n in recv}
    seen = {n.app.name: sim._surface(n) for n in recv}
    budgets = [pool * (i + 1) / N_BUDGETS for i in range(N_BUDGETS)]
    sols = {}
    for solver in ("pallas", "jax"):
        ctrl = make_controller("ecoshift", types.SYSTEM_2, solver=solver, device=dev)
        mckp_dp.reset_launches()
        t0 = time.perf_counter()
        sols[solver] = ctrl.allocate_batch(apps, baselines, budgets, seen)
        wall = time.perf_counter() - t0
        print(f"allocate_batch {solver}: {len(budgets)} budgets, "
              f"launches={dict(mckp_dp.launches)} wall_s={wall:.4f}")
        if solver == "pallas":
            check(
                mckp_dp.launches["maxplus_conv_batched"] == len(recv),
                "allocate_batch launches != stages",
            )
    for a, b, budget in zip(sols["pallas"], sols["jax"], budgets):
        check(dict(a.caps) == dict(b.caps) and a.spent == b.spent,
              f"allocate_batch differs at budget {budget}")
        check(a.spent <= budget + 1e-9, "allocate_batch overspends")
    return launches["maxplus_conv"]


def _stage_bound_ms(rows: int, nb: int, k: int, itemsize: int) -> tuple[float, str]:
    """Least time for one sparse-option stage: every (b, j) candidate is one
    add and one compare in the stage's type; dp, kb, vb read once, out and
    arg written once."""
    ops = 2.0 * rows * nb * k
    nbytes = rows * (itemsize * nb + (4 + itemsize) * k + (itemsize + 4) * nb)
    peak = PEAK_F64_OPS if itemsize == 8 else PEAK_F32_OPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _sparse_stage_inputs(rows: int, nb: int, k: int, dtype, seed: int, dev):
    """Seeded dp [rows, nb] on a 1/4 lattice (exact ties) with -inf holes
    (an all -inf row when rows > 1); kb [rows, k] int32 descending in
    [0, nb] (so kb > b occurs, and kb = nb); vb [rows, k] with -inf padded
    option tails (kb = 0 there), as the fused round pads its banks."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dp = np.round(rng.uniform(0, 20, (rows, nb)) * 4) / 4
    dp[rng.random((rows, nb)) < 0.2] = -np.inf
    if rows > 1:
        dp[1] = -np.inf
    kb = np.sort(rng.integers(0, nb + 1, (rows, k)), axis=1)[:, ::-1].astype(np.int32)
    kb[:, 0] = nb
    vb = np.round(rng.uniform(0, 3, (rows, k)) * 4) / 4
    vb[:, k - max(1, k // 5):] = -np.inf
    kb[:, k - max(1, k // 5):] = 0
    return (
        torch.as_tensor(dp, dtype=dtype, device=dev),
        torch.as_tensor(kb.copy(), device=dev),
        torch.as_tensor(vb, dtype=dtype, device=dev),
    )


def _stages_bound_ms(kb, vb, nb: int, itemsize: int) -> tuple[float, str, float]:
    """Least time for S sparse-option stages over kb, vb [S, R, K]: the
    (b, j) candidates this data needs (vb > -inf and 0 <= b - kb < nb),
    one add and one compare each in the stages' type; dp0, kb, vb and tmax
    read once, out and wins written once.  Also returns the share of all
    S * R * NB * K candidates that the data needs."""
    import torch

    stages, rows, k = kb.shape
    kbl = kb.long()
    span = (torch.clamp(nb + kbl, max=nb) - kbl.clamp(min=0)).clamp(min=0)
    needed = float((span * (vb > -torch.inf)).sum())
    ops = 2.0 * needed
    nbytes = rows * (2 * itemsize * nb + 4) + stages * rows * ((4 + itemsize) * k + 4 * nb)
    peak = PEAK_F64_OPS if itemsize == 8 else PEAK_F32_OPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            needed / (stages * rows * nb * k))


def _sparse_stages_inputs(stages: int, rows: int, nb: int, k: int, dtype, seed: int, dev):
    """dp0 [rows, nb] and tmax [rows] int32 (in [nb / 2, nb]), and kb, vb
    [stages, rows, k] made stage by stage as :func:`_sparse_stage_inputs`
    makes them."""
    import numpy as np
    import torch

    dp0, _, _ = _sparse_stage_inputs(rows, nb, k, dtype, seed, dev)
    banks = [_sparse_stage_inputs(rows, nb, k, dtype, seed + 1 + s, dev)[1:]
             for s in range(stages)]
    tmax = np.random.default_rng(seed).integers(nb // 2, nb + 1, rows).astype(np.int32)
    return (dp0, torch.stack([b[0] for b in banks]), torch.stack([b[1] for b in banks]),
            torch.as_tensor(tmax, device=dev))


def stage_kernel_phase(dev) -> dict:
    """Phase 6: the sparse-option stage kernel against its plain version,
    bitwise on values and backpointers, through the single-stage and the
    multi-stage entry; returns the measured stats of the multi-stage
    launch at the fused main path's shape."""
    import torch

    from repro_torch.kernels import mckp_dp, ref

    cases = [
        ("fused main path stage, 2048 nodes", 1, 4096, 1024, torch.float64),
        ("fused round stage at 256 nodes", 1, 512, 128, torch.float64),
        ("ragged, ties, -inf padding", 3, 1037, 37, torch.float64),
        ("ragged, ties, -inf padding", 3, 1037, 37, torch.float32),
    ]
    for i, (label, rows, nb, k, dtype) in enumerate(cases):
        dp, kb, vb = _sparse_stage_inputs(rows, nb, k, dtype, SEED + 10 + i, dev)
        out, arg = mckp_dp.maxplus_stage_batched(dp, kb, vb)
        want_out, want_arg = ref.maxplus_stage_batched(dp, kb, vb)
        check(
            _bits_equal(out, want_out) and _bits_equal(arg, want_arg),
            f"stage kernel != plain version for {label} {dtype}",
        )
        err = _max_abs_err(out, want_out)
        t = _times(lambda: mckp_dp.maxplus_stage_batched(dp, kb, vb), iters=50)
        ms = t["ms"]
        plain_ms = _cuda_ms(lambda: ref.maxplus_stage_batched(dp, kb, vb), iters=5, warmup=1)
        bound_ms, bound_by = _stage_bound_ms(rows, nb, k, dp.element_size())
        resident, blocks, smem = mckp_dp.stages_plan(dev.index or 0, rows, nb, dp.element_size())
        print(
            f"stage kernel {label}: rows={rows} nb={nb} k={k} {dtype} bitwise "
            f"out+arg ok, max_abs_err={err} ms={ms:.6f} device_ms={t['device_ms']:.6f} "
            f"host_us={t['host_us']:.2f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.6f} ({bound_by}, every candidate) "
            f"roofline_share={bound_ms / t['device_ms']:.4f} "
            f"plain_over_kernel={plain_ms / ms:.1f} resident={resident} blocks={blocks} "
            f"smem={smem} library_ms=null (no PyTorch call computes a sparse-option "
            f"(max,+) stage)"
        )

    multi = [
        ("fused main path, 2048 nodes", 40, 1, 4096, 1024, torch.float64),
        ("ragged rows", 7, 3, 1037, 37, torch.float64),
        ("ragged rows", 7, 3, 1037, 37, torch.float32),
        ("dp beyond shared memory", 3, 2, 32768, 64, torch.float64),
        ("dp beyond shared memory", 3, 2, 65536, 64, torch.float32),
    ]
    stats = {}
    for i, (label, stages, rows, nb, k, dtype) in enumerate(multi):
        dp0, kb, vb, tmax = _sparse_stages_inputs(stages, rows, nb, k, dtype, SEED + 30 + i, dev)
        mckp_dp.reset_launches()
        got_dp, got_wins = mckp_dp.maxplus_stages_batched(dp0, kb, vb, tmax)
        check(mckp_dp.launches["maxplus_stages_batched"] == 1
              and mckp_dp.launches["maxplus_stage_batched"] == 0,
              f"multi-stage call launched {dict(mckp_dp.launches)}")
        want_dp, want_wins = ref.maxplus_stages_batched(dp0, kb, vb, tmax)
        check(
            _bits_equal(got_dp, want_dp) and _bits_equal(got_wins, want_wins),
            f"multi-stage kernel != plain version for {label} {dtype}",
        )
        err = _max_abs_err(got_dp, want_dp)
        t = _times(lambda: mckp_dp.maxplus_stages_batched(dp0, kb, vb, tmax), iters=20)
        plain_ms = _cuda_ms(lambda: ref.maxplus_stages_batched(dp0, kb, vb, tmax),
                            iters=3, warmup=1)
        bound_ms, bound_by, needed = _stages_bound_ms(kb, vb, nb, dp0.element_size())
        dense_ms = stages * _stage_bound_ms(rows, nb, k, dp0.element_size())[0]
        resident, blocks, smem = mckp_dp.stages_plan(
            dev.index or 0, rows, nb, dp0.element_size())
        print(
            f"stages kernel {label}: stages={stages} rows={rows} nb={nb} k={k} {dtype} "
            f"bitwise dp+wins ok, max_abs_err={err} launches_a_call=1 ms={t['ms']:.6f} "
            f"device_ms={t['device_ms']:.6f} host_us={t['host_us']:.2f} "
            f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}, the "
            f"{needed:.4f} of candidates this data needs) "
            f"roofline_share={bound_ms / t['device_ms']:.4f} "
            f"dense_bound_ms={dense_ms:.6f} (S x the stage bound) "
            f"dense_roofline_share={dense_ms / t['device_ms']:.4f} "
            f"resident={resident} blocks={blocks} smem={smem} library_ms=null"
        )
        if i == 0:
            stats = {
                "max_abs_err": err, **t, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            # a stage's fixed cost (barrier, row reload, merge): the same
            # launch with 32 options a stage; the rest is the option scan
            few = _sparse_stages_inputs(stages, rows, nb, 32, dtype, SEED + 30, dev)
            fixed = _graph_ms(lambda: mckp_dp.maxplus_stages_batched(*few)) / stages * 1e3
            print(f"stages kernel split: {stages} stages, k=32 device_ms/stage="
                  f"{fixed / 1e3:.6f} (fixed_us={fixed:.2f}), k={k} scan_us/stage="
                  f"{t['device_ms'] / stages * 1e3 - fixed:.2f}")
    return stats


def _run_sparse(sim, scen, dev, fused: bool):
    """One scenario under a fresh EcoShift controller on the default sparse
    solver; returns (result, per-round log, controller, seconds).  The log
    holds each round's last_solver and, for fused rounds, the bank pads,
    the counters and the segments."""
    import torch

    from repro_torch.cluster import make_controller
    from repro_torch.core import types

    ctrl = make_controller("ecoshift", types.SYSTEM_2, fused=fused, device=dev)
    log = []
    inner = ctrl.allocate_grouped

    def allocate_grouped(batch, budget):
        alloc = inner(batch, budget)
        entry = {"solver": ctrl.last_solver, "reason": ctrl.last_fallback_reason}
        if ctrl.last_solver == "fused":
            fs = ctrl._fused_state
            s_pad, _, k_pad = fs.kb_dev.shape
            entry.update(
                s_pad=s_pad, k_pad=k_pad, nb_pad=fs.shape[4],
                stats=ctrl.fused_stats(), segments=ctrl.fused_segments(),
                device_s=ctrl.last_device_s,
            )
        log.append(entry)
        return alloc

    ctrl.allocate_grouped = allocate_grouped
    t0 = time.perf_counter()
    res = sim.run(scen, ctrl)
    torch.cuda.synchronize()
    return res, log, ctrl, time.perf_counter() - t0


def fused_main_path_phase(dev, fresh_sim, scen) -> int:
    """Phase 7; returns the multi-stage kernel's launches on the fused main
    path."""
    from repro_torch.kernels import mckp_dp

    mckp_dp.reset_launches()
    res_f, log_f, ctrl, wall_f = _run_sparse(fresh_sim(), scen, dev, fused=True)
    launches = dict(mckp_dp.launches)
    res_h, log_h, _, wall_h = _run_sparse(fresh_sim(), scen, dev, fused=False)
    stats = ctrl.fused_stats()
    pads = [e["s_pad"] for e in log_f if e["solver"] == "fused"]
    print(
        f"fused main path: {N_NODES_FUSED} nodes, {N_ROUNDS} rounds, "
        f"launches={launches} fused_rounds={len(pads)} s_pads={pads} "
        f"wall_s fused={wall_f:.4f} host={wall_h:.4f}"
    )
    check(_records_equal(res_f, res_h), "fused and host sparse rounds differ")
    check(stats.fallbacks == 0, f"fused fallbacks: {stats}")
    check(pads, "no round ran fused")
    for e in log_f:
        check(
            e["solver"] in ("fused", "cache"),
            f"a main-path round ran on {e['solver']!r} ({e['reason']!r})",
        )
    check(
        launches["maxplus_stages_batched"] == len(pads)
        and launches["maxplus_stage_batched"] == 0,
        "multi-stage launches != fused rounds, or a single-stage launch",
    )
    check(launches["maxplus_conv_batched"] == launches["maxplus_conv"] == 0,
          "the fused path launched a dense kernel")
    for rf, rh, ef, eh in zip(res_f.records, res_h.records, log_f, log_h):
        alloc = rf.result.allocation
        budget = rf.result.budget
        check(alloc.spent <= budget + 1e-9, f"fused round {rf.round} overspends")
        imps = list(rf.result.improvements.values())
        check(all(abs(x) < 1.0 for x in imps), f"fused round {rf.round}: bad improvement")
        line = (
            f"fused round {rf.round}: receivers={len(imps)} budget={budget!r} "
            f"spent={alloc.spent!r} avg_improvement={alloc.predicted_improvement!r} "
            f"solver={ef['solver']} host_solver={eh['solver']} "
            f"fused round_s={sum(rf.seconds.values()):.4f} (allocate_s="
            f"{rf.seconds['allocate_s']:.4f}) host round_s="
            f"{sum(rh.seconds.values()):.4f} (allocate_s={rh.seconds['allocate_s']:.4f})"
        )
        if ef["solver"] == "fused":
            st = ef["stats"]
            line += (
                f" pads S={ef['s_pad']} K={ef['k_pad']} NB={ef['nb_pad']} "
                f"device_s={ef['device_s']:.6f} rebuilds={st.rebuilds} "
                f"compactions={st.compactions} row_uploads={st.row_uploads} "
                f"short_circuits={st.short_circuits} "
                f"slack_utilization={st.slack_utilization:.4f} segments="
                + json.dumps({k: round(v, 6) for k, v in ef["segments"].items()})
            )
        print(line)
    print(f"fused stats: {stats}")
    return launches["maxplus_stages_batched"]


def fused_busy_share_phase(dev, fresh_sim) -> None:
    """Device busy share of one warm fused round (banks resident, budget
    moved by 25 W so the round solves), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster import make_controller
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    sim = fresh_sim()
    ctrl = make_controller("ecoshift", types.SYSTEM_2, fused=True, device=dev)
    _, _, pool = sim.partition_rows()
    sim.run_round(ctrl, budget=pool, round_index=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(ctrl, budget=pool - 25.0, round_index=1)
        wall = time.perf_counter() - t0
    check(ctrl.last_solver == "fused", f"profiled round ran on {ctrl.last_solver!r}")
    by_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_s = sum(by_kernel.values()) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    segs = json.dumps({k: round(v, 6) for k, v in ctrl.fused_segments().items()})
    if device_s:
        print(
            f"profiled fused round: wall_s={wall:.4f} device_busy_s={device_s:.6f} "
            f"busy_share={device_s / wall:.4f} "
            f"{_kernel_share(by_kernel, 'maxplus_stages_kernel', wall)} "
            f"kernel_share_of_busy="
            f"{sum(v for k, v in by_kernel.items() if 'maxplus_stages_kernel' in k) / 1e6 / device_s:.4f} "
            f"dispatch_s={ctrl.fused_segments()['dispatch_s']:.6f} segments={segs} "
            f"round_seconds={json.dumps({k: round(v, 6) for k, v in sim.last_round_seconds.items()})} "
            f"top_device_us_and_share="
            + json.dumps(
                {k[:60]: [round(v, 1), round(v / 1e6 / wall, 4)] for k, v in top}
            )
        )
    else:
        print(f"profiled fused round: wall_s={wall:.4f} busy_share=not measured "
              "(the profiler recorded no device time)")
    # the kernel alone on the round's resident banks (the mask moves no work)
    fs = ctrl._fused_state
    kb, vb = fs.kb_dev, fs.vb_dev
    nb = fs.shape[4]
    dp0 = torch.full((kb.shape[1], nb), -torch.inf, dtype=vb.dtype, device=vb.device)
    dp0[:, 0] = 0.0
    t = _times(lambda: mckp_dp.maxplus_stages_batched(dp0, kb, vb), iters=20)
    bound_ms, bound_by, needed = _stages_bound_ms(kb, vb, nb, vb.element_size())
    print(
        f"stages kernel on the fused round's banks: S={kb.shape[0]} L={kb.shape[1]} "
        f"K={kb.shape[2]} NB={nb} ms={t['ms']:.6f} device_ms={t['device_ms']:.6f} "
        f"host_us={t['host_us']:.2f} bound_ms={bound_ms:.6f} ({bound_by}, the "
        f"{needed:.4f} of candidates these banks need) "
        f"roofline_share={bound_ms / t['device_ms']:.4f}"
    )


# ---------------------------------------------------------------------------
# The hierarchical power-domain path: tree waves, the deep fused tree, the
# dense rack tier
# ---------------------------------------------------------------------------


def _wave_inputs(rows: int, nb: int, k: int, seed: int, dev):
    """One combine wave's launch inputs, built as the fused round builds
    them (float64): left and right frontier rows [rows, nb] on a 1/4
    lattice with -inf tails past a random support, the descending offset
    row k - 1 .. 0 and the right rows' first k states reversed as options
    ([1, rows, k]), and a cap cut tmax [rows] in [nb / 2, nb)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def frontier():
        x = np.round(rng.uniform(0, 20, (rows, nb)) * 4) / 4
        x[rng.random((rows, nb)) < 0.2] = -np.inf
        x[:, 0] = 0.0
        x[np.arange(nb)[None, :] > rng.integers(1, nb, rows)[:, None]] = -np.inf
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    left, right = frontier(), frontier()
    ckb = torch.arange(k - 1, -1, -1, dtype=torch.int32, device=dev)
    ckb = ckb[None, None, :].expand(1, rows, k).contiguous()
    cvb = torch.flip(right[:, :k], (1,))[None].contiguous()
    tc = torch.as_tensor(rng.integers(nb // 2, nb, rows).astype(np.int32), device=dev)
    return left, ckb, cvb, tc


def tree_wave_kernel_phase(dev) -> None:
    """Kernel 2.1 at the tree kinds' combine-wave shapes: S = 1, masked at
    the cap cut, float64, against its plain version bit for bit (values and
    backpointers), at the 100 000-node deep tree's waves (rows x offsets,
    NB = NBT = 128) and at the widest wave the fused tree admits
    (NB = NBT = K = 4096)."""
    from repro_torch.kernels import mckp_dp, ref

    cases = [(r, 128, k) for r in (40, 20, 8, 1) for k in (16, 31, 76, 128)]
    cases.append((40, 4096, 4096))
    for i, (rows, nb, k) in enumerate(cases):
        left, ckb, cvb, tc = _wave_inputs(rows, nb, k, SEED + 60 + i, dev)
        mckp_dp.reset_launches()
        out, arg = mckp_dp.maxplus_stages_batched(left, ckb, cvb, tc)
        check(mckp_dp.launches["maxplus_stages_batched"] == 1,
              f"tree wave R={rows} K={k}: {dict(mckp_dp.launches)}")
        want_out, want_arg = ref.maxplus_stages_batched(left, ckb, cvb, tc)
        check(_bits_equal(out, want_out) and _bits_equal(arg, want_arg),
              f"stage kernel != plain version at tree wave R={rows} NB={nb} K={k}")
        err = _max_abs_err(out, want_out)
        t = _times(lambda: mckp_dp.maxplus_stages_batched(left, ckb, cvb, tc), iters=20)
        plain_ms = _cuda_ms(lambda: ref.maxplus_stages_batched(left, ckb, cvb, tc),
                            iters=3, warmup=1)
        ops = 2.0 * rows * nb * k
        nbytes = rows * (8 * nb + 12 * k + 4 + 12 * nb)
        t_ops, t_bytes = ops / PEAK_F64_OPS, nbytes / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        resident, blocks, smem = mckp_dp.stages_plan(dev.index or 0, rows, nb, 8)
        print(
            f"tree wave kernel: rows={rows} nb={nb} k={k} float64 masked S=1 bitwise "
            f"out+arg ok, max_abs_err={err} ms={t['ms']:.6f} "
            f"device_ms={t['device_ms']:.6f} host_us={t['host_us']:.2f} "
            f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}, 2 R NB K add-compares "
            f"at f64 {PEAK_F64_OPS:.3g} op/s) "
            f"roofline_share={bound_ms / t['device_ms']:.4f} resident={resident} "
            f"blocks={blocks} smem={smem} library_ms=null"
        )


def _node_counts(dom, index, out) -> int:
    i = index[dom.name]
    if dom.children:
        out[i] = sum(_node_counts(c, index, out) for c in dom.children)
    else:
        out[i] = sum(hi - lo for lo, hi in dom.nodes)
    return out[i]


def _deep_topology(system, apps, surfs, dev):
    """benchmarks/hier_alloc.py's deep tier: a 4-level site -> row -> PDU ->
    chassis tree over DEEP_NODES nodes, the root at 1e18 W and every row,
    PDU and chassis at its committed draw plus 0.9, 0.75 or 0.6 of its
    node-proportional share of the budget.  Returns the topology, the
    probe sim's node table and each domain's committed draw."""
    from repro_torch.cluster import ClusterSim, PowerDomain, PowerTopology

    n = DEEP_NODES
    probe = ClusterSim.build(
        system, apps, surfs, n_nodes=n, seed=SEED, initial_caps=(150.0, 150.0),
        topology=PowerTopology.uniform_tree(n, DEEP_FANOUTS, [1e15] * 4), device=dev,
    )
    _, committed, _ = probe.domain_headroom(0)
    index = probe.topology.index
    counts: dict[int, int] = {}
    _node_counts(probe.topology.domains[0], index, counts)

    def recap(dom, depth):
        i = index[dom.name]
        if depth == 0:
            cap = 1e18
        else:
            frac = DEEP_LEVEL_FRACS[min(depth - 1, len(DEEP_LEVEL_FRACS) - 1)]
            cap = float(committed[i]) + frac * DEEP_BUDGET * counts[i] / n
        return PowerDomain(name=dom.name, cap=cap, nodes=dom.nodes,
                           children=tuple(recap(c, depth + 1) for c in dom.children))

    topo = PowerTopology(recap(probe.topology.domains[0], 0), n_nodes=n)
    return topo, probe.table, committed


def _hier_events(scen, table, topo, committed, apps, rounds: int, seed: int,
                 whole_leaves: bool):
    """One event kind a round from round 1 on ``table``'s cluster under
    ``topo`` (``committed``: each domain's committed draw at round 0):
    seeded node failures (1 % of the nodes) outside one PDU's subtree (or,
    in a two-level tree, one rack's), filling whole leaves in a seeded
    order when ``whole_leaves`` (a chassis outage in the deep tree), else
    spread over those leaves at random; a x1.6 straggler on 0.1 % of the
    nodes; that PDU derated at round 3 to its committed draw plus half the
    headroom of its leaves; and 20 arrivals (at round 4, or with the
    derating when the scenario is four rounds long).  The PDU keeps every
    node, so its leaves stay at their caps and the derating cuts into what
    they drew: its cap binds.  Each arrival replaces one failed node: the
    same app at the same caps, placed on that node's leaf, so the draw it
    commits is the draw the failure freed there.  Returns the scenario and
    the derated domain's id."""
    import numpy as np

    from repro_torch.cluster import NodeArrival, StragglerOnset

    t = table
    n = len(t)
    rng = np.random.default_rng(seed)
    mid = [i for i, d in enumerate(topo.domains) if d.children and topo.depth[i] == 2]
    mid = mid or list(topo.leaf_ids)
    di = int(mid[int(rng.integers(0, len(mid)))])
    under = np.zeros(len(topo), dtype=bool)  # the leaves in di's subtree
    for leaf in topo.leaf_ids:
        j = int(leaf)
        while j >= 0 and j != di:
            j = int(topo.parent[j])
        under[leaf] = j == di
    caps = topo.cap_at(0)
    leaf_room = float(np.sum((caps - committed)[under]))
    derated_cap = float(committed[di]) + 0.5 * leaf_room
    if whole_leaves:  # leaf by leaf in a seeded order, then node by node
        failed = np.concatenate([
            rng.permutation(np.flatnonzero(t.domain_id == leaf))
            for leaf in rng.permutation(topo.leaf_ids[~under[topo.leaf_ids]])
        ])[: n // 100]
    else:
        failed = rng.choice(np.flatnonzero(~under[t.domain_id]), size=n // 100,
                            replace=False)
    scen = scen.with_failure(1, *failed.tolist())
    scen = scen.with_events([
        StragglerOnset(round=2, node_id=int(i), slowdown=1.6)
        for i in rng.choice(n, size=max(1, n // 1000), replace=False)
    ])
    scen = scen.with_domain_cap(3, topo.domains[di].name, derated_cap)
    by_name = {a.name: a for a in apps}
    scen = scen.with_events([
        NodeArrival(
            round=min(4, rounds - 1), app=by_name[t.strings[t.base_gid[i]]],
            caps=(float(t.caps[i, 0]), float(t.caps[i, 1])),
            domain=topo.domains[int(t.domain_id[i])].name,
        )
        for i in rng.choice(failed, size=min(20, len(failed)), replace=False)
    ])
    return scen, di


def _run_hier(sim, scen, dev, on_round=None, **kw):
    """One scenario under a fresh ecoshift_hier controller; returns
    (result, per-round log, controller, seconds).  The log holds each
    round's last_solver, last_domain_spent, the fused segments and pads,
    the receivers of the fullest leaf and the widest leaf's dense grid
    (1 W units)."""
    import numpy as np
    import torch

    from repro_torch.cluster import make_controller
    from repro_torch.core import types

    from repro_torch.core import mckp
    from repro_torch.kernels import mckp_dp

    ctrl = make_controller("ecoshift_hier", types.SYSTEM_1, device=dev, **kw)
    log = []
    inner = ctrl.allocate_hierarchical

    def allocate_hierarchical(batch, budget, domain_extra):
        before = mckp_dp.launches["maxplus_stages_batched"]
        alloc = inner(batch, budget, domain_extra)
        topo = sim.topology
        eff = np.empty(len(topo))  # mckp._domain_eff cascaded down the tree
        for i in range(len(topo)):
            up = budget if topo.parent[i] < 0 else eff[topo.parent[i]]
            eff[i] = max(0.0, min(float(domain_extra[i]), up))
        busy = np.unique(batch.domain_ids)
        entry = {
            "solver": ctrl.last_solver, "reason": ctrl.last_fallback_reason,
            "domain_spent": ctrl.last_domain_spent,
            "leaf_max": int(np.bincount(batch.domain_ids).max()) if len(batch) else 0,
            "leaf_nb": int(np.floor(eff[busy].max() + 1e-9)) + 1 if len(batch) else 0,
        }
        if ctrl.last_solver == "fused":
            fs = ctrl._fused_state
            kind, L, _, _, nb_pad, nbt_pad, tree_sig = fs.shape
            waves = 0
            if kind == "tree":  # the round's static combine schedule
                waves = len(mckp._tree_waves(*mckp._tree_ops(tree_sig, L)[:3], nb_pad, nbt_pad))
            entry.update(shape=fs.shape[:6], pitch_w=fs.g / 1e6,
                         segments=ctrl.fused_segments(),
                         device_s=ctrl.last_device_s, stats=ctrl.fused_stats(), waves=waves,
                         launches=mckp_dp.launches["maxplus_stages_batched"] - before)
        log.append(entry)
        if on_round is not None:
            on_round()
        return alloc

    ctrl.allocate_hierarchical = allocate_hierarchical
    t0 = time.perf_counter()
    res = sim.run(scen, ctrl)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return res, log, ctrl, time.perf_counter() - t0


def _check_domains(rec, topo, label: str) -> dict:
    """Every domain at or under its cap + 1e-6 W and every ancestor's draw
    its children's sum (to 1e-6 W); returns the least cap slack of each
    level of the tree (0 = the root)."""
    slack: dict[int, float] = {}
    for i, dom in enumerate(topo.domains):
        s = rec.domain_caps[dom.name] - rec.domain_draw[dom.name]
        level = int(topo.depth[i])
        slack[level] = min(slack.get(level, float("inf")), s)
        if dom.children:
            kids = sum(rec.domain_draw[c.name] for c in dom.children)
            check(abs(rec.domain_draw[dom.name] - kids) <= 1e-6,
                  f"{label} round {rec.round}: {dom.name} draw != its children's sum")
    least = min(slack.values())
    check(least >= -1e-6, f"{label} round {rec.round}: a domain over its cap by {-least} W")
    return slack


def _check_derating(res, topo, di: int, label: str, pitch: float | None = None) -> str:
    """The round-3 derating binds: the derated domain's new cap lies below
    what it drew in round 2, and its draw falls to or under that cap (and,
    given the fused lattice ``pitch``, within one pitch of it)."""
    name = topo.domains[di].name
    before, at = res.records[2], res.records[3]
    cap = at.domain_caps[name]
    check(cap < before.domain_draw[name],
          f"{label}: {name}'s derated cap {cap} W does not cut its round-2 draw "
          f"{before.domain_draw[name]} W")
    check(at.domain_draw[name] <= cap + 1e-6, f"{label}: {name} over its derated cap")
    if pitch is not None:
        check(cap - at.domain_draw[name] < pitch,
              f"{label}: {name} left {cap - at.domain_draw[name]} W of its derated cap, "
              f"a {pitch} W pitch or more")
    return (f"derated {name}: round-2 draw {before.domain_draw[name]!r} W, round-3 cap "
            f"{cap!r} W, round-3 draw {at.domain_draw[name]!r} W")


def _hier_records_equal(a, b) -> bool:
    return _records_equal(a, b) and all(
        ra.domain_draw == rb.domain_draw and ra.domain_caps == rb.domain_caps
        for ra, rb in zip(a.records, b.records, strict=True)
    )


def deep_tree_phase(dev, apps, surfs) -> int:
    """The hierarchical main path: ClusterSim.run on the 100 000-node,
    125-domain deep tree under ecoshift_hier with fused=True on the card,
    against the host solver, five rounds with an event in each after the
    first.  Returns kernel 2.1's launches on the fused run."""
    from repro_torch.cluster import ClusterSim, Scenario
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_1
    t0 = time.perf_counter()
    topo, table, committed = _deep_topology(system, apps, surfs, dev)

    def fresh():
        return ClusterSim.build(system, apps, surfs, n_nodes=DEEP_NODES, seed=SEED,
                                initial_caps=(150.0, 150.0), topology=topo, device=dev)

    scen, derated = _hier_events(
        Scenario.constant(DEEP_ROUNDS, budget=DEEP_BUDGET).with_topology(topo),
        table, topo, committed, apps, DEEP_ROUNDS, SEED, whole_leaves=True,
    )

    print(f"deep tree: {DEEP_NODES} nodes, {len(topo)} domains, "
          f"{len(topo.leaf_ids)} leaves, fanouts {DEEP_FANOUTS}, budget {DEEP_BUDGET} W, "
          f"{DEEP_ROUNDS} rounds, derated {topo.domains[derated].name}, "
          f"setup_s={time.perf_counter() - t0:.2f}")
    mckp_dp.reset_launches()
    sim_f = fresh()
    res_f, log_f, ctrl, wall_f = _run_hier(sim_f, scen, dev, fused=True)
    launches = dict(mckp_dp.launches)
    res_h, log_h, _, wall_h = _run_hier(fresh(), scen, dev)
    check(_hier_records_equal(res_f, res_h), "deep tree: fused and host records differ")
    stats = ctrl.fused_stats()
    check(stats.fallbacks == 0, f"deep tree fused fallbacks: {stats}")
    for rf, rh, ef, eh in zip(res_f.records, res_h.records, log_f, log_h):
        check(ef["solver"] == "fused", f"deep round {rf.round} ran on {ef['solver']!r} "
              f"({ef['reason']!r})")
        check(ef["domain_spent"] == eh["domain_spent"],
              f"deep round {rf.round}: last_domain_spent differs")
        check(ef["launches"] == 1 + ef["waves"] and ef["waves"] > 0,
              f"deep round {rf.round}: {ef['launches']} stage-kernel launches, "
              f"not 1 leaf scan + {ef['waves']} waves")
        slack = _check_domains(rf, topo, "deep tree")
        alloc = rf.result.allocation
        check(alloc.spent <= rf.result.budget + 1e-9, f"deep round {rf.round} overspends")
        kind, L, s_pad, k_pad, nb_pad, nbt_pad = ef["shape"]
        print(
            f"deep round {rf.round}: receivers={len(rf.result.improvements)} "
            f"spent={alloc.spent!r} avg_improvement={alloc.predicted_improvement!r} "
            f"least_cap_slack_w_by_level={json.dumps(slack)} pitch_w={ef['pitch_w']!r} "
            f"solver={ef['solver']} "
            f"pads L={L} S={s_pad} K={k_pad} NB={nb_pad} NBT={nbt_pad} "
            f"stage_kernel_launches={ef['launches']} (1 leaf scan + {ef['waves']} waves) "
            f"fused allocate_s={rf.seconds['allocate_s']:.4f} "
            f"device_s={ef['device_s']:.6f} host allocate_s={rh.seconds['allocate_s']:.4f} "
            f"fused round_s={sum(rf.seconds.values()):.4f} "
            f"host round_s={sum(rh.seconds.values()):.4f} segments="
            + json.dumps({k: round(v, 6) for k, v in ef["segments"].items()})
        )
    check(launches["maxplus_stages_batched"] == sum(e["launches"] for e in log_f)
          and launches["maxplus_stage_batched"] == 0
          and launches["maxplus_conv_batched"] == launches["maxplus_conv"] == 0,
          f"deep tree launches {launches} outside its fused rounds")
    pitch = log_f[3]["pitch_w"]
    print(f"deep tree: {_check_derating(res_f, topo, derated, 'deep tree', pitch)}")
    print(f"deep tree: launches={launches} wall_s fused={wall_f:.4f} host={wall_h:.4f} "
          f"stats={stats}")
    _deep_busy_share(sim_f, ctrl)
    return launches["maxplus_stages_batched"]


def _deep_busy_share(sim, ctrl) -> None:
    """Device busy share of one more event round of the deep tree's fused
    run (a straggler on its warm sim and controller), from torch.profiler
    (launches made here are outside the counted run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster import StragglerOnset

    touched = sim.apply_events(
        [StragglerOnset(round=DEEP_ROUNDS, node_id=7, slowdown=1.3)]
    )
    ctrl.invalidate(touched)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(ctrl, budget=DEEP_BUDGET, round_index=DEEP_ROUNDS)
        wall = time.perf_counter() - t0
    check(ctrl.last_solver == "fused", f"profiled deep round ran on {ctrl.last_solver!r}")
    by_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_s = sum(by_kernel.values()) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    secs = json.dumps({k: round(v, 6) for k, v in sim.last_round_seconds.items()})
    segs = json.dumps({k: round(v, 6) for k, v in ctrl.fused_segments().items()})
    if device_s:
        print(
            f"profiled deep event round: wall_s={wall:.4f} device_busy_s={device_s:.6f} "
            f"busy_share={device_s / wall:.4f} "
            f"{_kernel_share(by_kernel, 'maxplus_stages_kernel', wall)} "
            f"round_seconds={secs} segments={segs} top_device_us_and_share="
            + json.dumps({k[:60]: [round(v, 1), round(v / 1e6 / wall, 4)] for k, v in top})
        )
    else:
        print(f"profiled deep event round: wall_s={wall:.4f} busy_share=not measured "
              f"(the profiler recorded no device time) round_seconds={secs}")


def _rack_topology(system, apps, surfs, dev):
    """benchmarks/hier_alloc.py's rack tier: RACK_NODES nodes in RACK_COUNT
    racks under an unconstrained site, each rack at its committed draw
    plus 0.6 of its even share of the budget.  Returns the topology, the
    probe sim's node table and each domain's committed draw."""
    from repro_torch.cluster import ClusterSim, PowerDomain, PowerTopology

    probe = ClusterSim.build(
        system, apps, surfs, n_nodes=RACK_NODES, seed=SEED, initial_caps=(150.0, 150.0),
        topology=PowerTopology.uniform_racks(RACK_NODES, RACK_COUNT, rack_cap=1e15),
        device=dev,
    )
    _, committed, _ = probe.domain_headroom(0)
    extra = 0.6 * RACK_BUDGET / RACK_COUNT
    racks = tuple(
        PowerDomain(name=probe.topology.domains[i].name, cap=float(committed[i]) + extra,
                    nodes=probe.topology.domains[i].nodes)
        for i in probe.topology.leaf_ids
    )
    topo = PowerTopology(PowerDomain(name="site", cap=1e18, children=racks))
    return topo, probe.table, committed


def rack_tier_phase(dev, apps, surfs) -> int:
    """The dense hierarchical path: the 16-rack tier under ecoshift_hier
    with solver="pallas" (kernel 2.2, one launch a leaf-scan stage over
    every rack) against solver="jax" (its plain version on the card), four
    rounds with an event in each after the first.  Returns kernel 2.2's
    launches on the pallas run."""
    from repro_torch.cluster import ClusterSim, Scenario
    from repro_torch.core import mckp, types
    from repro_torch.kernels import mckp_dp, ref

    system = types.SYSTEM_1
    topo, table, committed = _rack_topology(system, apps, surfs, dev)

    def fresh():
        return ClusterSim.build(system, apps, surfs, n_nodes=RACK_NODES, seed=SEED,
                                initial_caps=(150.0, 150.0), topology=topo, device=dev)

    scen, derated = _hier_events(
        Scenario.constant(RACK_ROUNDS, budget=RACK_BUDGET).with_topology(topo),
        table, topo, committed, apps, RACK_ROUNDS, SEED + 1, whole_leaves=False,
    )

    # the dense round's split: seconds in the batched leaf scan (on the
    # card, to its copy back) and in the numpy frontier combine, a round
    split = {"leaf_scan_s": 0.0, "combine_s": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[name] += time.perf_counter() - t
        return run

    scan, conv = mckp._scan_batched, mckp._conv_full
    mckp._scan_batched, mckp._conv_full = timed("leaf_scan_s", scan), timed("combine_s", conv)
    splits = []
    try:
        mckp_dp.reset_launches()
        res_k, log_k, _, wall_k = _run_hier(fresh(), scen, dev, solver="pallas",
                                            on_round=lambda: splits.append(dict(split)))
        launches = dict(mckp_dp.launches)
    finally:
        mckp._scan_batched, mckp._conv_full = scan, conv
    res_p, log_p, _, wall_p = _run_hier(fresh(), scen, dev, solver="jax")
    check(_hier_records_equal(res_k, res_p), "rack tier: pallas and jax records differ")
    stages = sum(e["leaf_max"] for e in log_k)
    check(launches["maxplus_conv_batched"] == stages and launches["maxplus_conv"] == 0
          and launches["maxplus_stages_batched"] == 0,
          f"rack tier launches {launches} != {stages} leaf-scan stages")
    print(f"rack tier: {RACK_NODES} nodes, {RACK_COUNT} racks, budget {RACK_BUDGET} W, "
          f"{RACK_ROUNDS} rounds, {_check_derating(res_k, topo, derated, 'rack tier')}, "
          f"launches={launches} "
          f"leaf_scan_stages={stages} wall_s pallas={wall_k:.4f} jax={wall_p:.4f}")
    prev = {"leaf_scan_s": 0.0, "combine_s": 0.0}
    for rk, rp, ek, ep, sp in zip(res_k.records, res_p.records, log_k, log_p, splits):
        ek["split"] = {k: sp[k] - prev[k] for k in sp}
        prev = sp
        check(ek["domain_spent"] == ep["domain_spent"],
              f"rack round {rk.round}: last_domain_spent differs")
        slack = _check_domains(rk, topo, "rack tier")
        alloc = rk.result.allocation
        print(
            f"rack round {rk.round}: receivers={len(rk.result.improvements)} "
            f"fullest_rack={ek['leaf_max']} spent={alloc.spent!r} "
            f"avg_improvement={alloc.predicted_improvement!r} "
            f"leaf_nb={ek['leaf_nb']} least_cap_slack_w_by_level={json.dumps(slack)} "
            f"pallas allocate_s={rk.seconds['allocate_s']:.4f} "
            f"(leaf_scan_s={ek['split']['leaf_scan_s']:.4f} "
            f"combine_s={ek['split']['combine_s']:.4f}) "
            f"round_s={sum(rk.seconds.values()):.4f} jax allocate_s="
            f"{rp.seconds['allocate_s']:.4f} round_s={sum(rp.seconds.values()):.4f}"
        )
    # kernel 2.2 alone at the tier's leaf-scan stage shapes
    for nb in sorted({e["leaf_nb"] for e in log_k}):
        dp, f = _stage_inputs(RACK_COUNT, nb, SEED + 80 + nb, dev)
        out, arg = mckp_dp.maxplus_conv_batched(dp, f)
        want_out, want_arg = ref.maxplus_conv_batched(dp, f)
        check(_bits_equal(out, want_out) and _bits_equal(arg, want_arg),
              f"dense kernel != plain version at R={RACK_COUNT} NB={nb}")
        t = _times(lambda: mckp_dp.maxplus_conv_batched(dp, f), iters=20)
        plain_ms = _cuda_ms(lambda: ref.maxplus_conv_batched(dp, f), iters=3, warmup=1)
        bound_ms, bound_by = _bound_ms(RACK_COUNT, nb)
        print(
            f"rack tier kernel: rows={RACK_COUNT} nb={nb} bitwise out+arg ok "
            f"ms={t['ms']:.6f} device_ms={t['device_ms']:.6f} host_us={t['host_us']:.2f} "
            f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"roofline_share={bound_ms / t['device_ms']:.4f} library_ms=null"
        )
    return launches["maxplus_conv_batched"]


# ---------------------------------------------------------------------------
# Faults and receding-horizon (MPC) planning
# ---------------------------------------------------------------------------


def _run_logged(sim, scen, ctrl):
    """sim.run under ``ctrl`` with each engine round logged: last_solver,
    fallback reason, last_domain_spent, the planned budget, the planner's
    host seconds and the launches each kernel made in the round.  Calls a
    pinned round makes for its free receivers (``_skip_pins``) are not
    rounds.  Returns (result, log, seconds)."""
    import torch

    from repro_torch.kernels import mckp_dp

    log = []
    method = ("allocate_hierarchical" if getattr(ctrl, "supports_hierarchical", False)
              else "allocate_grouped")
    inner = getattr(ctrl, method)
    plan_s = [0.0]

    def call(*a, **kw):
        before = dict(mckp_dp.launches)
        plan_s[0] = 0.0
        out = inner(*a, **kw)
        if not kw.get("_skip_pins"):
            log.append({
                "solver": ctrl.last_solver, "reason": ctrl.last_fallback_reason,
                "domain_spent": getattr(ctrl, "last_domain_spent", None),
                "planned": getattr(ctrl, "last_planned_budget", None),
                "plan": getattr(ctrl, "last_plan", None),
                "plan_s": plan_s[0],
                "launches": {k: v - before.get(k, 0) for k, v in mckp_dp.launches.items()},
            })
        return out

    setattr(ctrl, method, call)
    if hasattr(ctrl, "_plan_budget"):
        inner_plan = ctrl._plan_budget

        def timed_plan(budget, frontier_fn):
            t = time.perf_counter()
            out = inner_plan(budget, frontier_fn)
            plan_s[0] += time.perf_counter() - t
            return out

        ctrl._plan_budget = timed_plan
    t0 = time.perf_counter()
    res = sim.run(scen, ctrl)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    return res, log, time.perf_counter() - t0


def _fault_records_equal(a, b) -> bool:
    """_hier_records_equal plus the PowerGuard columns, the telemetry fault
    kinds and the settled telemetry (bitwise, NaN where corruption put
    one)."""
    import numpy as np

    if not _records_equal(a, b):
        return False
    for ra, rb in zip(a.records, b.records, strict=True):
        if (ra.domain_draw != rb.domain_draw or ra.domain_caps != rb.domain_caps
                or ra.result.budget != rb.result.budget):
            return False
        for f in ("overdraw_w", "derate_w", "excursion_domains", "nacked", "telemetry_faults"):
            if getattr(ra, f) != getattr(rb, f):
                return False
        for f in ("allocated_caps", "t_baseline", "t_allocated", "improvement"):
            if (np.asarray(getattr(ra.telemetry, f)).tobytes()
                    != np.asarray(getattr(rb.telemetry, f)).tobytes()):
                return False
    return True


def _scores(res) -> dict:
    """benchmarks/budget_horizon.py's totals: measured value, grams CO2
    (intensity x spent watts a round), dollars, and perf per CO2 and per
    dollar; fails if a round spends past its budget."""
    value = grams = dollars = 0.0
    for rec in res.records:
        spent = rec.result.allocation.spent
        check(spent <= rec.result.budget + 1e-6,
              f"round {rec.round}: spent {spent!r} W over the budget {rec.result.budget!r} W")
        value += rec.avg_improvement
        if rec.carbon_intensity is not None:
            grams += rec.carbon_intensity * spent
        if rec.power_price is not None:
            dollars += rec.power_price * spent
    return {"value": value, "co2_g": grams, "dollars": dollars,
            "perf_per_co2": value / grams if grams > 0 else None,
            "perf_per_dollar": value / dollars if dollars > 0 else None}


def _budget_trace(n_rounds: int, nominal: float) -> list:
    """benchmarks/fault_storm.py's varying budget (NACKs are invisible on a
    constant one)."""
    import numpy as np

    t = np.arange(n_rounds)
    return (nominal * (1.0 + 0.5 * np.sin(2.0 * np.pi * t / 7.0))).tolist()


def _storm(scen, rate: float, seed: int, crash_rounds=()):
    """benchmarks/fault_storm.py's storm at ``rate``."""
    return scen.with_fault_storm(
        seed=seed, telemetry_drop=rate / 2, telemetry_delay=rate / 2,
        telemetry_corrupt=rate, telemetry_stale=rate / 2, actuation_nack=rate,
        actuation_partial=rate, actuation_delay=rate / 2, node_fraction=0.3,
        crash_rounds=crash_rounds,
    )


def _safety(res) -> dict:
    """benchmarks/fault_storm.py's settled-draw counters: rounds whose
    settled draw (the telemetry's applied caps) passed the budget or a
    domain cap, the longest run of them, the worst pre-derate excursion,
    the watts derated and the rounds with a NACK."""
    import numpy as np

    out = {"overdraw_rounds": 0, "max_consecutive_overdraw": 0, "max_excursion_w": 0.0,
           "derate_total_w": 0.0, "nack_rounds": 0}
    run = 0
    for rec in res.records:
        t = rec.telemetry
        extra = float(np.sum(t.allocated_caps) - np.sum(t.baseline_caps))
        bad = extra > rec.result.budget + 1e-6 or any(
            w > rec.domain_caps[d] + 1e-6 for d, w in (rec.domain_draw or {}).items()
        )
        run = run + 1 if bad else 0
        out["overdraw_rounds"] += bad
        out["max_consecutive_overdraw"] = max(out["max_consecutive_overdraw"], run)
        out["max_excursion_w"] = max(out["max_excursion_w"], rec.overdraw_w)
        out["derate_total_w"] += rec.derate_w
        out["nack_rounds"] += bool(rec.nacked)
    return out


def _solver_counts(log) -> dict:
    out: dict = {}
    for e in log:
        out[e["solver"]] = out.get(e["solver"], 0) + 1
    return out


def mpc_flat_phase(dev, apps, surfs) -> int:
    """benchmarks/budget_horizon.py's CO2-day tier at its full settings:
    MPC_NODES SYSTEM_1 nodes for MPC_ROUNDS rounds on a constant 2 W/node
    site budget with the co2_day / price_day fixtures; myopic, reactive
    (the budget scaled by MPC_ECO) and mpc (horizon MPC_HORIZON,
    eco_factor MPC_ECO) as ecoshift with fused=True on the card, and mpc on
    the host sparse solver.  Returns kernel 2.1's launches on the fused
    runs."""
    from repro_torch.cluster import ClusterSim, ConstantProvider, Scenario, ScaledProvider
    from repro_torch.cluster import make_controller
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_1
    n = MPC_NODES
    budget = 2.0 * n
    scen = Scenario.carbon_aware(MPC_ROUNDS, ConstantProvider(budget))
    cases = [
        ("myopic", scen, {"fused": True}),
        ("reactive", scen.with_budget_provider(
            ScaledProvider(ConstantProvider(budget), MPC_ECO)), {"fused": True}),
        ("mpc", scen, {"fused": True, "horizon": MPC_HORIZON, "eco_factor": MPC_ECO}),
        ("mpc_host", scen, {"horizon": MPC_HORIZON, "eco_factor": MPC_ECO}),
    ]
    runs = {}
    launches = 0
    for name, s, kw in cases:
        sim = ClusterSim.build(system, apps, surfs, n_nodes=n, seed=SEED,
                               initial_caps=(150.0, 150.0), device=dev)
        ctrl = make_controller("ecoshift", system, device=dev, **kw)
        mckp_dp.reset_launches()
        res, log, wall = _run_logged(sim, s, ctrl)
        launches += mckp_dp.launches["maxplus_stages_batched"]
        runs[name] = (res, log, wall, ctrl, _scores(res))
        if kw.get("fused"):
            st = ctrl.fused_stats()
            check(st.fallbacks == 0, f"mpc flat {name}: fused fallbacks {st}")
            fused_rounds = sum(e["solver"] == "fused" for e in log)
            check(mckp_dp.launches["maxplus_stages_batched"] == fused_rounds > 0,
                  f"mpc flat {name}: {mckp_dp.launches} launches, {fused_rounds} fused rounds")
        print(f"mpc flat {name}: {n} nodes, {MPC_ROUNDS} rounds, wall_s={wall:.4f} "
              f"round_s={wall / MPC_ROUNDS:.6f} solvers={_solver_counts(log)} "
              f"launches={dict(mckp_dp.launches)} scores={json.dumps(runs[name][4])}")
    res_f, log_f, _, ctrl_f, sc_f = runs["mpc"]
    res_h, log_h, _, _, _ = runs["mpc_host"]
    check(_records_equal(res_f, res_h), "mpc flat: fused and host records differ")
    check([(e["planned"], e["plan"]) for e in log_f] == [(e["planned"], e["plan"]) for e in log_h],
          "mpc flat: fused and host planned budgets differ")
    restricted = sum(e["planned"] is not None for e in log_f)
    check(restricted > 0, "mpc flat: the plan never restricted a round")
    ppc = {k: v[4]["perf_per_co2"] for k, v in runs.items()}
    check(ppc["mpc"] > ppc["myopic"],
          f"mpc flat: perf per CO2 {ppc['mpc']!r} does not beat myopic {ppc['myopic']!r}")
    for rf, rh, ef, eh in zip(res_f.records, res_h.records, log_f, log_h):
        print(f"mpc flat round {rf.round}: budget={rf.result.budget!r} "
              f"planned={ef['planned']!r} spent={rf.result.allocation.spent!r} "
              f"co2={rf.carbon_intensity!r} avg_improvement={rf.avg_improvement!r} "
              f"solver={ef['solver']} host_solver={eh['solver']} "
              f"launches={ef['launches']['maxplus_stages_batched']} "
              f"fused allocate_s={rf.seconds['allocate_s']:.6f} plan_s={ef['plan_s']:.6f} "
              f"host allocate_s={rh.seconds['allocate_s']:.6f} plan_s={eh['plan_s']:.6f}")
    print(f"mpc flat: restricted_rounds={restricted} ppc_gain_vs_myopic="
          f"{ppc['mpc'] / ppc['myopic']!r} ppc_gain_vs_reactive="
          f"{ppc['mpc'] / ppc['reactive']!r} plan_s_mean fused="
          f"{sum(e['plan_s'] for e in log_f) / len(log_f):.6f} host="
          f"{sum(e['plan_s'] for e in log_h) / len(log_h):.6f} stats={ctrl_f.fused_stats()}")
    return launches


def mpc_hier_phase(dev, apps, surfs) -> int:
    """benchmarks/budget_horizon.py's solar tier at its full settings:
    MPC_HIER_NODES SYSTEM_1 nodes in MPC_HIER_RACKS racks (320 W a node
    plus an eighth of the peak each), a solar-following budget (peak 2.5
    W/node, grid floor 0.5 W/node) with the co2_day / price_day fixtures;
    ecoshift_hier myopic and mpc with fused=True, and mpc on the host.
    Returns kernel 2.1's launches on the fused runs."""
    from repro_torch.cluster import ClusterSim, PowerTopology, Scenario, make_controller
    from repro_torch.cluster import fixture_trace, solar_budget
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_1
    n, racks, rounds = MPC_HIER_NODES, MPC_HIER_RACKS, MPC_ROUNDS
    peak, floor = 2.5 * n, 0.5 * n
    topo = PowerTopology.uniform_racks(n, racks, rack_cap=320.0 * (n // racks) + peak / racks)
    scen = Scenario(
        n_rounds=rounds, budget=solar_budget(peak, floor_watts=floor, n_rounds=rounds),
        carbon=fixture_trace("co2_day", rounds), power_price=fixture_trace("price_day", rounds),
    ).with_topology(topo)
    runs = {}
    launches = 0
    for name, kw in (("myopic", {"fused": True}),
                     ("mpc", {"fused": True, "horizon": MPC_HORIZON, "eco_factor": MPC_ECO}),
                     ("mpc_host", {"horizon": MPC_HORIZON, "eco_factor": MPC_ECO})):
        sim = ClusterSim.build(system, apps, surfs, n_nodes=n, seed=SEED,
                               initial_caps=(150.0, 150.0), topology=topo, device=dev)
        ctrl = make_controller("ecoshift_hier", system, device=dev, **kw)
        mckp_dp.reset_launches()
        res, log, wall = _run_logged(sim, scen, ctrl)
        launches += mckp_dp.launches["maxplus_stages_batched"]
        runs[name] = (res, log, wall, ctrl, _scores(res))
        for rec in res.records:
            _check_domains(rec, topo, f"mpc hier {name}")
        if kw.get("fused"):
            st = ctrl.fused_stats()
            check(st.fallbacks == 0, f"mpc hier {name}: fused fallbacks {st}")
        print(f"mpc hier {name}: {n} nodes, {racks} racks, {rounds} rounds, wall_s={wall:.4f} "
              f"round_s={wall / rounds:.6f} solvers={_solver_counts(log)} "
              f"launches={dict(mckp_dp.launches)} scores={json.dumps(runs[name][4])}")
    res_f, log_f, _, ctrl_f, _ = runs["mpc"]
    res_h, log_h, _, _, _ = runs["mpc_host"]
    check(_hier_records_equal(res_f, res_h), "mpc hier: fused and host records differ")
    for key in ("domain_spent", "planned", "plan"):
        check([e[key] for e in log_f] == [e[key] for e in log_h],
              f"mpc hier: fused and host {key} differ")
    restricted = sum(e["planned"] is not None for e in log_f)
    check(restricted > 0, "mpc hier: the plan never restricted a round")
    ppc = {k: v[4]["perf_per_co2"] for k, v in runs.items()}
    check(ppc["mpc"] > ppc["myopic"],
          f"mpc hier: perf per CO2 {ppc['mpc']!r} does not beat myopic {ppc['myopic']!r}")
    for rf, rh, ef, eh in zip(res_f.records, res_h.records, log_f, log_h):
        slack = min(rf.domain_caps[d] - w for d, w in rf.domain_draw.items())
        print(f"mpc hier round {rf.round}: budget={rf.result.budget!r} "
              f"planned={ef['planned']!r} spent={rf.result.allocation.spent!r} "
              f"least_rack_slack_w={slack!r} solver={ef['solver']} host_solver={eh['solver']} "
              f"launches={ef['launches']['maxplus_stages_batched']} "
              f"fused allocate_s={rf.seconds['allocate_s']:.6f} plan_s={ef['plan_s']:.6f} "
              f"host allocate_s={rh.seconds['allocate_s']:.6f} plan_s={eh['plan_s']:.6f}")
    print(f"mpc hier: restricted_rounds={restricted} ppc_gain_vs_myopic="
          f"{ppc['mpc'] / ppc['myopic']!r} stats={ctrl_f.fused_stats()}")
    return launches


def _check_storm_domains(res, label: str) -> None:
    """Every domain's settled draw at or under its cap every round, and no
    domain excursing (before PowerGuard's derate) in two rounds in a row."""
    prev: set = set()
    for rec in res.records:
        for d, w in rec.domain_draw.items():
            check(w <= rec.domain_caps[d] + 1e-6,
                  f"{label} round {rec.round}: {d} settled at {w!r} W over its "
                  f"{rec.domain_caps[d]!r} W cap")
        cur = set(rec.excursion_domains)
        check(not (cur & prev), f"{label} round {rec.round}: {sorted(cur & prev)} over "
              f"their caps two rounds in a row")
        check(rec.overdraw_w == 0.0 or rec.derate_w > 0.0,
              f"{label} round {rec.round}: an excursion PowerGuard did not derate")
        prev = cur


def deep_storm_phase(dev, apps, surfs) -> int:
    """The deep tree (DEEP_NODES nodes, 125 domains) under explicit faults:
    DEEP_STORM_BUDGETS, NACK + NaN telemetry at round 1, partial actuation
    + a dropped batch at 2, delayed actuation + a stale batch at 3, a
    restored controller crash at 5, the rounds after it clean;
    ecoshift_hier with fused=True against the host.  Returns kernel 2.1's launches on the
    fused run."""
    from repro_torch.cluster import (ActuationDelay, ActuationNack, ActuationPartial,
                                     ClusterSim, ControllerCrash, Scenario,
                                     TelemetryCorrupt, TelemetryDrop, TelemetryStale,
                                     make_controller)
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_1
    t0 = time.perf_counter()
    topo, _, _ = _deep_topology(system, apps, surfs, dev)
    rounds = len(DEEP_STORM_BUDGETS)
    scen = Scenario(rounds, budget=list(DEEP_STORM_BUDGETS)).with_topology(topo).with_faults([
        ActuationNack(round=1, fraction=0.3, seed=SEED + 1),
        TelemetryCorrupt(round=1, fraction=0.25, mode="nan", seed=SEED + 2),
        ActuationPartial(round=2, fraction=0.3, seed=SEED + 3),
        TelemetryDrop(round=2),
        ActuationDelay(round=3, fraction=0.3, seed=SEED + 4),
        TelemetryStale(round=3, age=1),
        ControllerCrash(round=5, restore=True),
    ])
    print(f"deep storm: {DEEP_NODES} nodes, {len(topo)} domains, {rounds} rounds, budgets "
          f"{list(DEEP_STORM_BUDGETS)}, setup_s={time.perf_counter() - t0:.2f}")
    out = {}
    for fused in (True, False):
        sim = ClusterSim.build(system, apps, surfs, n_nodes=DEEP_NODES, seed=SEED,
                               initial_caps=(150.0, 150.0), topology=topo, device=dev)
        ctrl = make_controller("ecoshift_hier", system, device=dev, fused=fused)
        mckp_dp.reset_launches()
        res, log, wall = _run_logged(sim, scen, ctrl)
        out[fused] = (res, log, wall, ctrl, dict(mckp_dp.launches))
    res_f, log_f, wall_f, ctrl, launches = out[True]
    res_h, log_h, wall_h, _, _ = out[False]
    for rf, rh, ef, eh in zip(res_f.records, res_h.records, log_f, log_h):
        print(f"deep storm round {rf.round}: budget={rf.result.budget!r} "
              f"spent={rf.result.allocation.spent!r} nacked={len(rf.nacked)} "
              f"overdraw_w={rf.overdraw_w!r} derate_w={rf.derate_w!r} "
              f"excursions={len(rf.excursion_domains)} telemetry_faults={list(rf.telemetry_faults)} "
              f"solver={ef['solver']} host_solver={eh['solver']} "
              f"launches={ef['launches']['maxplus_stages_batched']} "
              f"fused allocate_s={rf.seconds['allocate_s']:.4f} actuate_s="
              f"{rf.seconds['actuate_s']:.4f} round_s={sum(rf.seconds.values()):.4f} "
              f"host allocate_s={rh.seconds['allocate_s']:.4f} "
              f"round_s={sum(rh.seconds.values()):.4f}")
    check(_fault_records_equal(res_f, res_h), "deep storm: fused and host records differ")
    check([e["domain_spent"] for e in log_f] == [e["domain_spent"] for e in log_h],
          "deep storm: fused and host last_domain_spent differ")
    _check_storm_domains(res_f, "deep storm")
    st = ctrl.fused_stats()
    check(st.fallbacks == 0, f"deep storm: fused fallbacks {st}")
    after = sum(e["solver"] == "fused" for e in log_f[5:])
    check(after >= 3, f"deep storm: {after} fused rounds after the crash (want >= 3)")
    check(st.rebuilds >= 2, f"deep storm: the banks were not rebuilt after the crash ({st})")
    check(any(r.nacked for r in res_f.records), "deep storm: no NACK round")
    print(f"deep storm: launches={launches} fused_after_crash={after} wall_s "
          f"fused={wall_f:.4f} host={wall_h:.4f} safety={json.dumps(_safety(res_f))} stats={st}")
    return launches["maxplus_stages_batched"]


def flat_storm_phase(dev, apps, surfs) -> int:
    """The fused main path's 2048 SYSTEM_2 nodes under
    benchmarks/fault_storm.py's rate-0.30 storm (seed 17) on its 24-round
    sinusoidal budget (40 W a node nominal): ecoshift with fused=True
    against the host; then its crash_restore tier (a crash at round 12,
    restored through a snapshot file, and cold) against the uninterrupted
    run.  Returns kernel 2.1's launches on the fused storm run."""
    import os
    import tempfile

    from repro_torch.cluster import (ClusterSim, ControllerCrash, Scenario, load_snapshot,
                                     make_controller, save_snapshot)
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_2
    n = N_NODES_FUSED
    rounds = STORM_ROUNDS
    clean = Scenario(rounds, budget=_budget_trace(rounds, 40.0 * n))

    def play(scen, fused, wrap=None):
        sim = ClusterSim.build(system, apps, surfs, n_nodes=n, seed=SEED, device=dev)
        ctrl = make_controller("ecoshift", system, device=dev, fused=fused)
        if wrap is not None:
            wrap(ctrl)
        mckp_dp.reset_launches()
        res, log, wall = _run_logged(sim, scen, ctrl)
        return res, log, wall, ctrl, dict(mckp_dp.launches)

    storm = _storm(clean, 0.30, seed=17)
    res_f, log_f, wall_f, ctrl, launches = play(storm, True)
    res_h, log_h, wall_h, _, _ = play(storm, False)
    check(_fault_records_equal(res_f, res_h), "flat storm: fused and host records differ")
    safety = _safety(res_f)
    check(safety["overdraw_rounds"] == 0,
          f"flat storm: settled draw over the budget in {safety['overdraw_rounds']} rounds")
    check(safety["nack_rounds"] > 0, "flat storm: no NACK round")
    for rf, rh, ef, eh in zip(res_f.records, res_h.records, log_f, log_h):
        print(f"flat storm round {rf.round}: budget={rf.result.budget!r} "
              f"spent={rf.result.allocation.spent!r} nacked={len(rf.nacked)} "
              f"overdraw_w={rf.overdraw_w!r} derate_w={rf.derate_w!r} "
              f"telemetry_faults={list(rf.telemetry_faults)} solver={ef['solver']} "
              f"reason={ef['reason']!r} host_solver={eh['solver']} "
              f"launches={ef['launches']['maxplus_stages_batched']} "
              f"fused allocate_s={rf.seconds['allocate_s']:.4f} actuate_s="
              f"{rf.seconds['actuate_s']:.4f} host allocate_s={rh.seconds['allocate_s']:.4f}")
    print(f"flat storm: {n} nodes, {rounds} rounds, {len(storm.faults)} fault events, "
          f"solvers={_solver_counts(log_f)} host_solvers={_solver_counts(log_h)} "
          f"launches={launches} wall_s fused={wall_f:.4f} host={wall_h:.4f} "
          f"safety={json.dumps(safety)} stats={ctrl.fused_stats()}")

    crash_at = rounds // 2
    ref, _, _, _, _ = play(clean, True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "controller.snap")
        sizes = []

        def via_file(ctrl):
            inner = ctrl.snapshot

            def snapshot():
                save_snapshot(path, inner())
                sizes.append(os.path.getsize(path))
                return load_snapshot(path)

            ctrl.snapshot = snapshot

        for name, restore in (("restore", True), ("cold", False)):
            scen = clean.with_faults([ControllerCrash(round=crash_at, restore=restore)])
            res, log, wall, c, _ = play(scen, True, via_file if restore else None)
            recovery = sum(
                dict(a.result.allocation.caps) != dict(b.result.allocation.caps)
                or a.result.improvements != b.result.improvements
                for a, b in zip(ref.records[crash_at:], res.records[crash_at:])
            )
            if restore:
                check(recovery == 0, f"crash restore: {recovery} rounds differ from the "
                      f"uninterrupted run")
                check(sizes, "crash restore: no snapshot went through the file")
            st = c.fused_stats()
            print(f"crash {name}: crash at round {crash_at}, recovery_rounds={recovery} "
                  f"solvers={_solver_counts(log)} snapshot_bytes={sizes[-1] if sizes else 0} "
                  f"snapshots_through_file={len(sizes) if restore else 0} rebuilds={st.rebuilds} "
                  f"fallbacks={st.fallbacks} wall_s={wall:.4f}")
    return launches["maxplus_stages_batched"]


def dense_storm_phase(dev, apps, surfs) -> int:
    """The dense main path's 256 SYSTEM_2 nodes under the rate-0.30 storm
    (seed 17) on the sinusoidal budget: solver="pallas" (kernel 2.2)
    against "jax", with kernel 2.2 launched in the pinned rounds too.
    Returns kernel 2.2's launches on the pallas run."""
    from repro_torch.cluster import ClusterSim, Scenario, make_controller
    from repro_torch.core import types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_2
    rounds = STORM_ROUNDS
    scen = _storm(Scenario(rounds, budget=_budget_trace(rounds, 40.0 * N_NODES)), 0.30, seed=17)
    out = {}
    for solver in ("pallas", "jax"):
        sim = ClusterSim.build(system, apps, surfs, n_nodes=N_NODES, seed=SEED, device=dev)
        ctrl = make_controller("ecoshift", system, device=dev, solver=solver)
        mckp_dp.reset_launches()
        res, log, wall = _run_logged(sim, scen, ctrl)
        out[solver] = (res, log, wall, dict(mckp_dp.launches))
    res_k, log_k, wall_k, launches = out["pallas"]
    res_p, log_p, wall_p, _ = out["jax"]
    check(_fault_records_equal(res_k, res_p), "dense storm: pallas and jax records differ")
    safety = _safety(res_k)
    check(safety["overdraw_rounds"] == 0, "dense storm: settled draw over the budget")
    pinned = [e for e in log_k if e["solver"] == "pinned"]
    check(pinned and all(e["launches"]["maxplus_conv_batched"] > 0 for e in pinned),
          "dense storm: no pinned round, or one without a kernel 2.2 launch")
    for rk, rp, ek in zip(res_k.records, res_p.records, log_k):
        print(f"dense storm round {rk.round}: budget={rk.result.budget!r} "
              f"spent={rk.result.allocation.spent!r} nacked={len(rk.nacked)} "
              f"solver={ek['solver']} launches={ek['launches']['maxplus_conv_batched']} "
              f"pallas allocate_s={rk.seconds['allocate_s']:.4f} "
              f"jax allocate_s={rp.seconds['allocate_s']:.4f}")
    print(f"dense storm: {N_NODES} nodes, {rounds} rounds, pinned_rounds={len(pinned)} "
          f"launches={launches} wall_s pallas={wall_k:.4f} jax={wall_p:.4f} "
          f"safety={json.dumps(safety)}")
    return launches["maxplus_conv_batched"]


# ---------------------------------------------------------------------------
# The policy comparison: NCF, the baselines, the Oracle, the online loop
# ---------------------------------------------------------------------------


def _leaves_equal(a: dict, b: dict) -> bool:
    import torch

    from repro_torch.train import optimizer as opt

    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _accuracy(system, pred_surface, true_surface) -> float:
    """Mean per-cell prediction accuracy of the speedup over the initial
    caps (tests/test_ncf.py's measure)."""
    import numpy as np

    from repro_torch.core import metrics

    base = (system.init_cpu, system.init_gpu)
    cc, gg = np.meshgrid(system.grid.cpu_levels, system.grid.gpu_levels, indexing="ij")
    p_true = true_surface.runtime(*base) / true_surface.runtime(cc, gg)
    p_pred = pred_surface.runtime(*base) / pred_surface.runtime(cc, gg)
    return float(np.mean(metrics.prediction_accuracy(p_true.ravel(), p_pred.ravel())))


def ncf_phase(dev, apps, surfs, cfg, host_steps: int):
    """The NCF part of phase 8: offline fit, two card fits of one seeded
    stream (bitwise, at ``host_steps``), the card's fit against the host's
    on that stream,
    onboarding, and the held-out apps' accuracy.  Returns the allocator."""
    import torch

    from repro_torch.core import ncf, types
    from repro_torch.core.allocator import EcoShiftAllocator
    from repro_torch.train import optimizer as opt

    system = types.SYSTEM_2
    train_apps, heldout = apps[: len(apps) - N_HELDOUT], apps[len(apps) - N_HELDOUT :]
    hist = {a.name: surfs[a.name] for a in train_apps}

    def fit(device, c=cfg, **kw):
        t0 = time.perf_counter()
        alloc = EcoShiftAllocator.train_offline(system, hist, c, device=device, **kw)
        _sync(alloc.predictor.device)
        return alloc, time.perf_counter() - t0

    alloc, fit_s = fit(dev)
    n_obs = len(hist) * len(system.grid.pairs())
    short = dataclasses.replace(cfg, train_steps=host_steps)
    init = ncf._init_params(torch.Generator().manual_seed(SEED), len(hist),
                            len(system.grid.pairs()), short)
    idx = torch.randint(0, n_obs, (host_steps, short.batch_size),
                        generator=torch.Generator().manual_seed(SEED + 1))
    card, card_s = fit(dev, short, init_params=init, indices=idx)
    again, again_s = fit(dev, short, init_params=init, indices=idx)
    check(_leaves_equal(card.predictor.params, again.predictor.params),
          "two card fits of one stream differ")
    host, host_s = fit("cpu", short, init_params=init, indices=idx)
    err = max(
        float((x.cpu() - y).abs().max())
        for x, y in zip(opt.tree_leaves(card.predictor.params),
                        opt.tree_leaves(host.predictor.params))
    )
    print(
        f"ncf fit: {len(hist)} apps x {len(system.grid.pairs())} cells, "
        f"{cfg.train_steps} steps of {cfg.batch_size}, embed {cfg.embed_dim}, "
        f"mlp {list(cfg.mlp_hidden)}: fit_s={fit_s:.3f} ({fit_s / cfg.train_steps * 1e3:.3f} "
        f"ms a step); at {host_steps} steps on one injected stream: a second card "
        f"fit bitwise equal, card vs host max_abs_err={err:.3g} (tol {NCF_HOST_TOL}) "
        f"card_s={card_s:.3f} again_s={again_s:.3f} host_s={host_s:.3f}"
    )
    check(err <= NCF_HOST_TOL, "the card's fit is far from the host's")
    ncf_profile(dev, hist, dataclasses.replace(cfg, train_steps=NCF_PROFILE_STEPS))

    t0 = time.perf_counter()
    for a in train_apps:
        alloc.onboard_known(a.name)
    for i, a in enumerate(heldout):
        alloc.onboard(a.name, surfs[a.name], seed=i)
    onboard_s = time.perf_counter() - t0
    accs = [_accuracy(system, alloc.predicted[a.name], surfs[a.name]) for a in heldout]
    acc = sum(accs) / len(accs)
    print(
        f"ncf onboarding: {len(heldout)} held-out apps x {cfg.online_steps} online "
        f"steps + {len(train_apps)} known: onboard_s={onboard_s:.3f}; held-out "
        f"accuracy mean={acc:.4f} min={min(accs):.4f} (bound > {ACC_BOUND})"
    )
    check(acc > ACC_BOUND, "held-out prediction accuracy below the bound")
    return alloc, [a.name for a in heldout]


def ncf_profile(dev, hist, cfg) -> None:
    """Where a fit step's time goes: the device busy share of a short fit
    (torch.profiler), its device events and dispatched operations a step,
    and the top device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import types
    from repro_torch.core.allocator import EcoShiftAllocator

    def fit():
        EcoShiftAllocator.train_offline(types.SYSTEM_2, hist, cfg, device=dev)
        _sync(dev)

    fit()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        wall = time.perf_counter() - t0
    with _CountOps() as ops_count:
        fit()
    by_kernel: dict[str, float] = {}
    n_device = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_device += 1
    busy = sum(by_kernel.values()) / 1e6
    steps = cfg.train_steps
    share = f"{busy / wall:.4f}" if busy else "not measured"
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    print(
        f"profiled ncf fit ({steps} steps): wall_s={wall:.4f} ({wall / steps * 1e3:.3f} ms "
        f"a step) device_busy_s={busy:.5f} busy_share={share} device_events_a_step="
        f"{n_device / steps:.1f} operations_a_step={ops_count.n / steps:.1f} "
        "top_device_us_and_share="
        + json.dumps({k[:60]: [round(v, 1), round(v / 1e6 / wall, 4)] for k, v in top})
        + " top_host_self_us_a_step="
        + json.dumps({a.key[:50]: round(a.self_cpu_time_total / steps, 1) for a in host})
    )


def _refresh_log(pred) -> list:
    """Wrap ``pred.refresh`` to log (seconds, apps refit, surfaces swapped)
    for every call; the engine calls it once a round."""
    log = []
    inner = pred.refresh

    def refresh():
        n0 = pred.n_refits
        t0 = time.perf_counter()
        changed = inner()
        _sync(pred.ncf.device)
        log.append((time.perf_counter() - t0, pred.n_refits - n0, len(changed)))
        return changed

    pred.refresh = refresh
    return log


def policy_comparison_phase(dev, apps, surfs, alloc, unseen, n_nodes: int) -> int:
    """Phase 8's policy runs; returns the dense kernel's launches on its
    two kernel paths (EcoShift on predicted surfaces and the online loop)."""
    from repro_torch.cluster import (
        ClusterSim,
        OnlinePredictor,
        OnlinePredictorConfig,
        Scenario,
        make_controller,
    )
    from repro_torch.core import policies, surfaces, types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_2
    mixed = surfaces.workload_group(apps, "mixed")

    def fresh(cluster_apps):
        return ClusterSim.build(system, cluster_apps, surfs, n_nodes=n_nodes,
                                seed=SEED, device=dev)

    _, recv, pool = fresh(mixed).partition()
    budgets = tuple(pool * f for f in POOL_FRACTIONS)
    scen = Scenario(n_rounds=len(budgets), budget=budgets)
    print(f"policy comparison: {n_nodes} nodes, {len(recv)} receivers, pool {pool!r} W, "
          f"budgets {[round(b, 3) for b in budgets]}")

    def online_ctrl(solver, seed_surfaces, **pred_cfg):
        pred = OnlinePredictor(alloc.predictor, OnlinePredictorConfig(**pred_cfg))
        pred.seed_surfaces(seed_surfaces)
        return make_controller("ecoshift_online", system, predictor=pred,
                               solver=solver, device=dev)

    launches = 0
    results = {}
    for name in ("uniform", "dps", "mixed_adaptive", "ecoshift", "oracle",
                 "ecoshift_online"):
        sim = fresh(mixed)
        seen = None
        if name == "ecoshift":
            ctrl = make_controller("ecoshift", system, solver="pallas", device=dev)
            seen = {n.app.name: alloc.predicted[n.base_app] for n in sim.nodes}
        elif name == "ecoshift_online":
            ctrl = online_ctrl("pallas", alloc.predicted)
        else:
            ctrl = make_controller(name, system, device=dev)
        mckp_dp.reset_launches()
        t0 = time.perf_counter()
        res = sim.run(scen, ctrl, policy_surfaces=seen)
        _sync(dev)
        wall = time.perf_counter() - t0
        if name.startswith("ecoshift"):
            launches += mckp_dp.launches["maxplus_conv_batched"]
            check(mckp_dp.launches["maxplus_conv_batched"] == _stages(res),
                  f"{name}: dense kernel launches != DP stages")
        results[name] = res
        for rec in res.records:
            r = rec.result
            check(r.allocation.spent <= r.budget + 1e-9,
                  f"{name} round {rec.round} overspends")
            check(all(abs(x) < 1.0 for x in r.improvements.values()),
                  f"{name} round {rec.round}: bad improvement")
        refits = f" refits={ctrl.predictor.n_refits}" if name == "ecoshift_online" else ""
        print(
            f"policy {name}: wall_s={wall:.4f}{refits} launches={dict(mckp_dp.launches)} rounds "
            + json.dumps([
                {"budget": rec.result.budget, "spent": rec.result.allocation.spent,
                 "avg_improvement": rec.result.avg_improvement,
                 "jain": rec.result.jain_index}
                for rec in res.records
            ])
        )
    orc = results["oracle"].improvement_trace
    for name, res in results.items():
        gap = orc - res.improvement_trace
        print(f"policy {name}: mean avg_improvement={float(res.improvement_trace.mean())!r} "
              f"oracle_gap_pp mean={float(gap.mean()) * 100:.4f} "
              f"max={float(gap.max()) * 100:.4f}")

    # the Oracle's brute force against its sparse DP at <= 10 receivers
    sim = fresh(mixed)
    few = sim.partition()[1][:ORACLE_BRUTE_N]
    fapps = [n.app for n in few]
    base = {n.app.name: n.caps for n in few}
    true = {n.app.name: sim._surface(n) for n in few}
    t0 = time.perf_counter()
    brute = policies.oracle(fapps, base, ORACLE_BRUTE_BUDGET, system, true, exhaustive=True)
    brute_s = time.perf_counter() - t0
    dp = policies.oracle(fapps, base, ORACLE_BRUTE_BUDGET, system, true, exhaustive=False)
    print(f"oracle brute force: {len(few)} receivers, budget {ORACLE_BRUTE_BUDGET} W, "
          f"brute_s={brute_s:.4f} spent={brute.spent!r} "
          f"avg_improvement={brute.predicted_improvement!r}")
    check(
        dict(brute.caps) == dict(dp.caps) and brute.spent == dp.spent
        and brute.predicted_improvement == dp.predicted_improvement,
        "the Oracle's brute force differs from its sparse DP",
    )

    return launches


def online_loop_phase(dev, apps, surfs, alloc, unseen) -> int:
    """Phase 8's online loop on the kernel: ``ecoshift_online`` with a cold
    held-out arrival under ``pallas`` and ``jax`` (bitwise), the cold app
    fit from its own telemetry, the Oracle's replay for its gap.  Returns
    the dense kernel's launches."""
    import numpy as np

    from repro_torch.cluster import (
        ClusterSim,
        OnlinePredictor,
        OnlinePredictorConfig,
        Scenario,
        make_controller,
    )
    from repro_torch.core import surfaces, types
    from repro_torch.kernels import mckp_dp

    system = types.SYSTEM_2
    mixed = surfaces.workload_group(apps, "mixed")
    known = [a for a in mixed if a.name not in unseen]
    cold = next(a for a in mixed if a.name in unseen and a.sclass in ("C", "G", "B"))
    budgets = tuple(700.0 + 350.0 * ((3 * r) % 5) for r in range(N_ONLINE_ROUNDS))
    scen = Scenario(n_rounds=N_ONLINE_ROUNDS, budget=budgets).with_arrival(
        ONLINE_ARRIVAL, cold)
    inst = f"{cold.name}#n{ONLINE_NODES}"

    def fresh():
        return ClusterSim.build(system, known, surfs, n_nodes=ONLINE_NODES,
                                seed=ONLINE_SEED, device=dev)

    launches = 0
    runs = {}
    for solver in ("pallas", "jax"):
        pred = OnlinePredictor(alloc.predictor, OnlinePredictorConfig())
        pred.seed_surfaces({n: s for n, s in alloc.predicted.items() if n != cold.name})
        ctrl = make_controller("ecoshift_online", system, predictor=pred,
                               solver=solver, device=dev)
        log = _refresh_log(pred)
        sim = fresh()
        mckp_dp.reset_launches()
        t0 = time.perf_counter()
        res = sim.run(scen, ctrl)
        _sync(dev)
        wall = time.perf_counter() - t0
        if solver == "pallas":
            n = mckp_dp.launches["maxplus_conv_batched"]
            check(n == _stages(res) and n > 0,
                  "online loop: dense kernel launches != DP stages")
            launches += n
        runs[solver] = (res, log, pred)
        print(f"online loop {solver}: {ONLINE_NODES} nodes of {len(known)} known apps, "
              f"{N_ONLINE_ROUNDS} rounds, cold arrival {cold.name} at round "
              f"{ONLINE_ARRIVAL}, wall_s={wall:.4f} launches={dict(mckp_dp.launches)} "
              f"refits={pred.n_refits}")
    check(_records_equal(runs["pallas"][0], runs["jax"][0]),
          "online loop: pallas and jax records differ")
    res, log, pred = runs["pallas"]
    oracle = fresh().run(scen, "oracle")
    gap = oracle.improvements_of(inst) - res.improvements_of(inst)
    for rec, (sec, refits, swaps), g in zip(res.records, log, gap):
        r = rec.result
        check(r.allocation.spent <= r.budget + 1e-9, f"online round {rec.round} overspends")
        print(
            f"online round {rec.round}: budget={r.budget!r} spent={r.allocation.spent!r} "
            f"avg_improvement={r.avg_improvement!r} jain={r.jain_index!r} "
            f"cold_improvement={r.improvements.get(inst, float('nan'))!r} "
            f"cold_oracle_gap_pp={float(g) * 100:.4f} "
            f"refits={refits} invalidations={swaps} refresh_s={sec:.4f}"
        )
    post = gap[ONLINE_ARRIVAL:]
    half = len(post) // 2
    fitted = not pred.is_cold(cold.name)
    print(f"online loop: {cold.name} fit from telemetry={fitted} "
          f"prediction_error={pred.prediction_error.get(cold.name, float('nan'))!r} "
          f"refits={pred.n_refits} rejected={pred.n_rejected} "
          f"early_gap_pp={float(np.mean(post[:half])) * 100:.4f} "
          f"late_gap_pp={float(np.mean(post[half:])) * 100:.4f}")
    check(fitted, f"online loop: {cold.name} was never fit from its telemetry")
    check(pred.n_refits > 0, "online loop: no refit")
    return launches


# ---------------------------------------------------------------------------
# The serving path: granite-3-2b prefill + greedy decode
# ---------------------------------------------------------------------------


def _tol_ok(got, want, tol: float) -> tuple[bool, float]:
    """Elementwise |got - want| <= tol + tol * |want| (rtol = atol = tol, as
    tests/test_kernels.py states them), and the max absolute error."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return bool((diff <= tol + tol * w.abs()).all()), float(diff.max())


def _attn_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs that the causal bound and the window let through,
    for one (sequence, head)."""
    import numpy as np

    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), dtype=bool)
    if causal:
        ok &= i >= j
    if window is not None:
        ok &= i - j < window
    return int(ok.sum())


def _peak_ops(dtype) -> float:
    import torch

    return PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS


def _bound(ops: float, nbytes: float, peak_ops: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def serving_kernel_phase(dev) -> dict:
    """Serving phase (a): the RMSNorm, flash attention and flash decode
    kernels against their plain versions on the card, in bf16 and float32,
    at the serving path's shapes, a head dim of 128, a sliding-window shape,
    a softcap shape and ragged decode lengths that include 1; each with its
    back-to-back, device (CUDA graph) and host times, the plain version's
    time, its bound and one library call's times as a yardstick.  Returns
    the bf16 stats at the path's shapes (prefill for RMSNorm)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        kernel_head_dim,
        pad_head_dim,
    )
    from repro_torch.kernels.rmsnorm import rmsnorm

    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    d, hq, hkv, hd = 2048, 32, 8, 64  # granite-3-2b
    b, p, s_max = SERVE_BATCH, SERVE_PROMPT, SERVE_S_MAX
    stats = {}

    def report(kind, label, dtype, ok, err, tol, kern, plain, iters, lib, lib_err, ops,
               nbytes, peak_ops, rate, extra=""):
        """Time kern, plain and lib, print one kernel line (ending in
        ``extra``), return its stats.  ``rate`` names the achieved rate
        printed: "tflops" or "gbs"."""
        check(ok, f"{kind} kernel != plain version for {label} {dtype} (max_abs_err={err})")
        t = _times(kern, iters)
        plain_ms = _cuda_ms(plain, iters=5)
        bound_ms, bound_by = _bound(ops, nbytes, peak_ops)
        lt = _times(lib, iters, "library_") if lib is not None else {"library_ms": None}
        achieved = (f"achieved_tflops={ops / t['device_ms'] / 1e9:.1f}" if rate == "tflops"
                    else f"achieved_gbs={nbytes / t['device_ms'] / 1e6:.1f}")
        lib_txt = (
            f"library_ms={lt['library_ms']:.6f} library_device_ms="
            f"{lt['library_device_ms']:.6f} library_host_us={lt['library_host_us']:.2f} "
            f"library_max_abs_err={lib_err} device_over_library="
            f"{t['device_ms'] / lt['library_device_ms']:.2f}"
            if lib is not None else
            "library_ms=null (no library call takes this window or softcap)")
        print(
            f"{kind} kernel {label} {dtype}: max_abs_err={err} (tol rtol=atol={tol}) "
            f"ms={t['ms']:.6f} device_ms={t['device_ms']:.6f} host_us={t['host_us']:.2f} "
            f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"roofline_share={bound_ms / t['device_ms']:.4f} {achieved} "
            f"plain_over_kernel={plain_ms / t['ms']:.2f} {lib_txt}{extra}"
        )
        return {"max_abs_err": err, **t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, **lt}

    for dtype in (torch.bfloat16, torch.float32):
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        isz = torch.empty((), dtype=dtype).element_size()
        # RMSNorm: prefill rows, decode rows, a width that is no multiple of 8
        for label, shape in (("prefill [8*512, 2048]", (b * p, d)),
                             ("decode [8, 1, 2048]", (b, 1, d)),
                             ("ragged [3, 100]", (3, 100))):
            x = randn(*shape, dtype=dtype)
            scale = 0.1 * torch.randn(shape[-1], generator=g, device=dev)
            ok, err = _tol_ok(rmsnorm(x, scale), ref.rmsnorm(x, scale), tol)
            w = (1.0 + scale).to(dtype)
            lib_err = _max_abs_err(F.rms_norm(x, (shape[-1],), w, 1e-6).float(),
                                   ref.rmsnorm(x, scale).float())
            n = x.numel()
            st = report(
                "rmsnorm", label, dtype, ok, err, tol,
                lambda: rmsnorm(x, scale), lambda: ref.rmsnorm(x, scale), 50,
                lambda: F.rms_norm(x, (shape[-1],), w, 1e-6), lib_err,
                4.0 * n, 2.0 * isz * n + 4.0 * shape[-1], PEAK_F32_OPS, "gbs",
            )
            if dtype == torch.bfloat16 and label.startswith("prefill"):
                stats["rmsnorm"] = st
        # flash attention: the prefill shape, head dim 128, a window, a
        # softcap, and head dim 80 (zero-padded to the D = 128 kernel)
        for label, bb, nq, nkv, dh, causal, window, cap in (
            ("prefill q [8, 512, 32, 64]", b, hq, hkv, hd, True, None, None),
            ("head dim 128, q [2, 512, 32, 128]", 2, hq, hkv, 128, True, None, None),
            ("window 128, q [2, 512, 32, 64]", 2, hq, hkv, hd, True, 128, None),
            ("softcap 30, q [2, 512, 32, 64]", 2, hq, hkv, hd, True, None, 30.0),
            ("zamba2-2.7b head dim 80, q [2, 512, 32, 80] causal", 2, 32, 32, 80, True, None,
             None),
            ("hubert-xlarge head dim 80, q [2, 512, 16, 80] bidirectional", 2, 16, 16, 80, False,
             None, None),
        ):
            q = randn(bb, p, nq, dh, dtype=dtype)
            k = randn(bb, p, nkv, dh, dtype=dtype)
            v = randn(bb, p, nkv, dh, dtype=dtype)

            def kern():
                return flash_attention(q, k, v, causal=causal, window=window, softcap=cap)

            def plain():
                return ref.mha_reference(q, k, v, causal=causal, window=window,
                                         logit_softcap=cap)

            want = plain()
            ok, err = _tol_ok(kern(), want, tol)
            lib = lib_err = None
            if window is None and cap is None:
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

                def lib():
                    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                          enable_gqa=True)

                lib_err = _max_abs_err(lib().transpose(1, 2).float(), want.float())
            extra = ""
            dk = kernel_head_dim(dh)
            if dk != dh:  # the padded copy of q, k and v the wrapper makes a call
                def pad():
                    return [pad_head_dim(x, dk) for x in (q, k, v)]

                pt = _times(pad, 20, "pad_")
                extra = (f" pad_to={dk} pad_ms={pt['pad_ms']:.6f} pad_device_ms="
                         f"{pt['pad_device_ms']:.6f} pad_host_us={pt['pad_host_us']:.2f}")
            pairs = _attn_pairs(p, p, causal, window)
            st = report(
                "flash_attention", label, dtype, ok, err, tol, kern, plain, 20, lib, lib_err,
                4.0 * bb * nq * dh * pairs, isz * (2 * q.numel() + k.numel() + v.numel()),
                _peak_ops(dtype), "tflops", extra,
            )
            if dtype == torch.bfloat16 and label.startswith("prefill"):
                stats["flash_attention"] = st
        # flash decode: the decode shape, ragged lengths with 1 under a
        # window and under a softcap, a long cache
        for label, slots, lens, window, cap in (
            ("decode q [8, 32, 64], cache [8, 1024, 8, 64], lengths 513-543", s_max,
             np.linspace(p + 1, p + SERVE_GEN - 1, b).round().astype(int), None, None),
            ("window 128, ragged lengths with 1", s_max,
             [1, 2, 100, 129, 512, 700, 1023, 1024], 128, None),
            ("softcap 30, ragged lengths with 1", s_max,
             [1, 3, 64, 200, 513, 600, 900, 1024], None, 30.0),
            ("long cache q [8, 32, 64], cache [8, 8192, 8, 64], lengths 4000-8192", 8192,
             np.linspace(4000, 8192, b).round().astype(int), None, None),
        ):
            q = randn(b, hq, hd, dtype=dtype)
            kc = randn(b, slots, hkv, hd, dtype=dtype)
            vc = randn(b, slots, hkv, hd, dtype=dtype)
            lengths = torch.tensor(list(lens), dtype=torch.int32, device=dev)

            def kern():
                return decode_attention(q, kc, vc, lengths, window=window, softcap=cap)

            def plain():
                return ref.decode_attention_reference(q, kc, vc, lengths, window=window,
                                                      softcap=cap)

            want = plain()
            ok, err = _tol_ok(kern(), want, tol)
            lib = lib_err = None
            if window is None and cap is None:
                qt = q[:, :, None, :].contiguous()
                kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
                mask = (torch.arange(slots, device=dev)[None, :] < lengths[:, None])[:, None, None]

                def lib():
                    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          enable_gqa=True)

                lib_err = _max_abs_err(lib()[:, :, 0].float(), want.float())
            valid = sum(min(int(n), slots) - (max(0, int(n) - window) if window else 0)
                        for n in lens)
            st = report(
                "decode_attention", label, dtype, ok, err, tol, kern, plain, 50, lib, lib_err,
                4.0 * hq * hd * valid, isz * (2 * q.numel() + 2 * hkv * hd * valid) + 4 * b,
                _peak_ops(dtype), "gbs",
            )
            if dtype == torch.bfloat16 and label.startswith("decode"):
                stats["decode_attention"] = st
    return stats


class _PlainRoute:
    """Within this block the model's RMSNorm and attention take their plain
    PyTorch versions on the card: the serving path's kernel wrappers in
    ``repro_torch.kernels.ops`` are swapped for ``ref``'s functions."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self._saved = {n: getattr(ops, n) for n in
                       ("rmsnorm", "flash_attention", "decode_attention")}
        ops.rmsnorm = lambda x, scale, *, eps=1e-6: ref.rmsnorm(x, scale, eps)
        ops.flash_attention = lambda q, k, v, *, causal=True, window=None, softcap=None: (
            ref.mha_reference(q, k, v, causal=causal, window=window, logit_softcap=softcap))
        ops.decode_attention = ref.decode_attention_reference
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for n, fn in self._saved.items():
            setattr(ops, n, fn)


def serving_main_path_phase(dev, cfg, *, batch: int, prompt: int, gen: int,
                            s_max: int) -> dict:
    """Serving phase (b): ``cfg`` through ``ServeEngine.generate`` with
    seeded weights, ``batch`` random prompts of ``prompt`` tokens, ``gen``
    greedy tokens; launch counts against what the path implies; then the
    same prompts on the plain route on the card, teacher-forced with the
    kernel route's tokens, logits held within LOGIT_REL_TOL.  Returns the
    serving kernels' launches on the kernel route."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.serving import ServeEngine, pad_cache_to

    gen_ = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(gen_)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen_, device=dev)
    _sync(dev)
    n_params = sum(t.numel() for t in model.parameters())
    print(f"serving model {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, ff {cfg.d_ff}, "
          f"vocab {cfg.vocab} (padded {cfg.padded_vocab}), {n_params} parameters in "
          f"{cfg.param_dtype}, compute {cfg.dtype}; init_s={time.perf_counter() - t0:.3f}")
    engine = ServeEngine(model=model, s_max=s_max)
    engine.generate({"tokens": tokens[:, :16]}, n_steps=2)  # warm-up: weight casts, libraries
    _sync(dev)

    captured = {"steps": []}
    inner_prefill, inner_decode = model.prefill, model.decode_step

    def prefill(b):
        _sync(dev)
        t = time.perf_counter()
        lg, cache = inner_prefill(b)
        _sync(dev)
        captured["prefill_s"] = time.perf_counter() - t
        captured["prefill"] = lg.clone()
        return lg, cache

    def decode_step(b, cache, lengths):
        lg, cache = inner_decode(b, cache, lengths)
        captured["steps"].append(lg.clone())
        return lg, cache

    model.prefill, model.decode_step = prefill, decode_step
    try:
        build.reset_launches()
        t = time.perf_counter()
        out = engine.generate({"tokens": tokens}, n_steps=gen)
        _sync(dev)
        total_s = time.perf_counter() - t
        launches = dict(build.launches)
    finally:
        del model.prefill, model.decode_step
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    decode_s = total_s - captured["prefill_s"]
    n = cfg.n_layers
    want = {"rmsnorm": (2 * n + 1) * gen, "flash_attention": n,
            "decode_attention": n * (gen - 1)}
    print(
        f"serving main path: {batch} x {prompt} prompt tokens, {gen} generated, s_max {s_max}: "
        f"prefill_s={captured['prefill_s']:.4f} decode_s_per_token="
        f"{decode_s / (gen - 1):.5f} total_s={total_s:.4f} "
        f"tokens_per_s={batch * gen / total_s:.1f} decode_tokens_per_s="
        f"{batch * (gen - 1) / decode_s:.1f} peak_memory_gb={peak_gb:.2f} launches={launches}"
    )
    for name, count in want.items():
        check(launches[name] == count, f"{name} launches {launches[name]} != {count}")
    check(all(launches[name] == 0 for name in launches if name not in want),
          "the serving path launched a (max,+) kernel")
    check(out.shape == (batch, gen), f"generated shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()), "token out of range")
    lgs = [captured["prefill"], *captured["steps"]]
    check(len(lgs) == gen, "one logits row per generated token")
    check(all(bool(torch.isfinite(lg).all()) for lg in lgs), "non-finite logits")

    # the plain route, teacher-forced with the kernel route's tokens
    agree = 0
    build.reset_launches()
    with _PlainRoute():
        lg, cache = model.prefill({"tokens": tokens})
        cache = pad_cache_to(cache, model.cache_shapes(batch, s_max))
        lengths = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
        rels = []
        for step in range(gen):
            if step:
                lg, cache = model.decode_step({"tokens": out[:, step - 1 : step]}, cache,
                                              lengths)
                lengths = lengths + 1
            want_lg = lg.float()
            rel = float((lgs[step].float() - want_lg).abs().max() / want_lg.abs().max())
            rels.append(rel)
            agree += int((want_lg.argmax(-1) == out[:, step]).sum())
    _sync(dev)
    check(all(v == 0 for v in build.launches.values()), "the plain route launched a kernel")
    worst = max(rels)
    print(
        f"serving plain route, teacher-forced: logits rel err prefill={rels[0]:.3e} "
        f"decode max={max(rels[1:]):.3e} mean={sum(rels[1:]) / (gen - 1):.3e} "
        f"(tol {LOGIT_REL_TOL}) greedy_token_agreement={agree / (batch * gen):.4f} "
        f"({agree}/{batch * gen})"
    )
    check(worst <= LOGIT_REL_TOL, f"kernel route logits differ from the plain route: {worst}")
    if dev.type == "cuda":
        serving_profile(dev, model, tokens, s_max)
    return {name: launches[name] for name in want}


def serving_profile(dev, model, tokens, s_max: int) -> None:
    """Device busy share and the top device kernels of one prefill and one
    decode step of the kernel route, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import pad_cache_to

    batch, prompt = tokens.shape

    def show(label, prof, wall, want):
        by_kernel: dict[str, float] = {}
        n_device = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
                n_device += 1
        busy = sum(by_kernel.values()) / 1e6
        if not busy:
            print(f"profiled {label}: wall_s={wall:.5f} busy_share=not measured "
                  "(the profiler recorded no device time)")
            return
        check(any(want in name for name in by_kernel), f"{label} did not run {want}")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        print(
            f"profiled {label}: wall_s={wall:.5f} device_busy_s={busy:.5f} "
            f"busy_share={busy / wall:.4f} device_events={n_device} "
            f"{_kernel_share(by_kernel, want, wall)} top_device_us_and_share="
            + json.dumps({k[:70]: [round(v, 1), round(v / 1e6 / wall, 4)] for k, v in top})
        )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    show(f"prefill ({batch} x {prompt})", prof, wall, want="flash_attention_wgmma_kernel")
    cache = pad_cache_to(cache, model.cache_shapes(batch, s_max))
    lengths = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
    nxt = lg.argmax(-1)[:, None]
    model.decode_step({"tokens": nxt}, cache, lengths)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.decode_step({"tokens": nxt}, cache, lengths + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    show(f"decode step (batch {batch}, lengths {prompt + 1})", prof, wall,
         want="decode_attention_kernel")
    with _CountOps() as ops_count:
        model.decode_step({"tokens": nxt}, cache, lengths + 2)
    print(f"decode step: {ops_count.n} PyTorch operations dispatched "
          f"({ops_count.n / len(model.layers):.1f} a layer)")


class _CountOps:
    """Counts the ATen operations PyTorch dispatches inside the block (the
    host work of a step; a kernel wrapper's ctypes call is not one)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources are not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.cluster import ClusterSim, Scenario
    from repro_torch.core import ncf, surfaces, types
    from repro_torch.kernels import mckp_dp

    dev = torch.device("cuda")
    marks = [("start", time.perf_counter())]

    def lap(name: str) -> None:
        marks.append((name, time.perf_counter()))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = mckp_dp.build()
    print(f"build {len(logs)} sources in parallel: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"{mckp_dp.SOURCES[name].relative_to(ROOT)}:\n{log.strip()}")
    for name, log in logs.items():
        for line in _ptxas_summary(log):
            print(f"ptxas {name}: {line}")
    lap("build")

    apps, surfs = surfaces.build_paper_suite(types.SYSTEM_2)

    def fresh_sim():
        return ClusterSim.build(
            types.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=SEED, device=dev
        )

    _, recv, pool = fresh_sim().partition()
    nb_main = int(pool) + 1
    print(f"cluster: {N_NODES} nodes, {len(recv)} receivers, pool {pool!r} W, NB {nb_main}")
    stats = kernel_phase(dev, nb_main)
    lap("dense_kernel")

    scen = (
        Scenario.constant(N_ROUNDS)
        .with_failure(1, recv[0].node_id)
        .with_straggler(2, recv[1].node_id, 1.8)
    )
    conv_main = main_path_phase(dev, fresh_sim, scen)
    busy_share_phase(dev, fresh_sim)
    launches = {}
    lap("dense_main_path")
    launches["maxplus_conv"] = variants_phase(dev, fresh_sim)
    lap("dense_variants")

    stats["maxplus_stages_batched"] = stage_kernel_phase(dev)
    lap("stage_kernel")

    def fresh_fused_sim():
        return ClusterSim.build(
            types.SYSTEM_2, apps, surfs, n_nodes=N_NODES_FUSED, seed=SEED, device=dev
        )

    _, recv_f, pool_f = fresh_fused_sim().partition()
    print(f"fused cluster: {N_NODES_FUSED} nodes, {len(recv_f)} receivers, pool {pool_f!r} W")
    scen_f = (
        Scenario.constant(N_ROUNDS)
        .with_failure(1, recv_f[0].node_id)
        .with_straggler(2, recv_f[1].node_id, 1.8)
    )
    launches["maxplus_stages_batched"] = fused_main_path_phase(dev, fresh_fused_sim, scen_f)
    fused_busy_share_phase(dev, fresh_fused_sim)
    lap("fused")

    tree_wave_kernel_phase(dev)
    lap("tree_waves")
    apps1, surfs1 = surfaces.build_paper_suite(types.SYSTEM_1)
    launches["maxplus_stages_batched"] += deep_tree_phase(dev, apps1, surfs1)
    lap("deep_tree")
    launches["maxplus_conv_batched"] = rack_tier_phase(dev, apps1, surfs1)
    lap("rack_tier")
    launches["maxplus_stages_batched"] += mpc_flat_phase(dev, apps1, surfs1)
    lap("mpc_flat")
    launches["maxplus_stages_batched"] += mpc_hier_phase(dev, apps1, surfs1)
    lap("mpc_hier")
    launches["maxplus_stages_batched"] += deep_storm_phase(dev, apps1, surfs1)
    lap("deep_storm")
    launches["maxplus_stages_batched"] += flat_storm_phase(dev, apps, surfs)
    lap("flat_storm")
    launches["maxplus_conv_batched"] += dense_storm_phase(dev, apps, surfs)
    lap("dense_storm")

    ncf_cfg = ncf.NCFConfig(train_steps=NCF_TRAIN_STEPS, online_steps=NCF_ONLINE_STEPS)
    alloc, unseen = ncf_phase(dev, apps, surfs, ncf_cfg, NCF_HOST_STEPS)
    lap("ncf")
    launches["maxplus_conv_batched"] += conv_main + policy_comparison_phase(
        dev, apps, surfs, alloc, unseen, N_NODES
    )
    lap("policies")
    launches["maxplus_conv_batched"] += online_loop_phase(dev, apps, surfs, alloc, unseen)
    lap("online_loop")

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    stats.update(serving_kernel_phase(dev))
    lap("serving_kernels")
    launches.update(serving_main_path_phase(
        dev, configs.get_config(SERVE_ARCH), batch=SERVE_BATCH, prompt=SERVE_PROMPT,
        gen=SERVE_GEN, s_max=SERVE_S_MAX,
    ))
    lap("serving")
    print("phase_seconds=" + json.dumps(
        {name: round(t - marks[i][1], 3) for i, (name, t) in enumerate(marks[1:])}
        | {"total": round(marks[-1][1] - marks[0][1], 3)}
    ))

    sources = {
        "maxplus_conv_batched": "maxplus_conv",
        "maxplus_conv": "maxplus_conv",
        "maxplus_stages_batched": "maxplus_stage",
        "rmsnorm": "rmsnorm",
        "flash_attention": "flash_attention",
        "decode_attention": "decode_attention",
    }
    replaces = {
        "maxplus_conv_batched": "src/repro/kernels/mckp_dp.py:194",
        "maxplus_conv": "src/repro/kernels/mckp_dp.py:247",
        "maxplus_stages_batched": "src/repro/kernels/mckp_dp.py:126",
        "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
        "flash_attention": "src/repro/kernels/flash_attention.py:114",
        "decode_attention": "src/repro/kernels/decode_attention.py:96",
    }
    kernels = []
    for name in replaces:
        check(launches[name] > 0, f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(mckp_dp.SOURCES[sources[name]].relative_to(ROOT)),
            "replaces": replaces[name], "launches": launches[name],
            "library_ms": None, **stats[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
