"""The program's own spans and counters (``utils.profiling``) on the
treecode's hierarchical and flat paths.

On the CPU a program of the run is called directly and a phase boundary is
a host record, so the span tree, the counters and the exporter are tested
here; the card's stamps (a kernel inside each replayed graph) are held to
the device trace by the ``cuda`` case at the end:

    python -m pytest tests/test_torch_tracing.py -m cuda -q --noconftest

This file imports no JAX.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch.ops import treecode
from n_body_problem_tpu_torch.ops.registry import tree_path
from n_body_problem_tpu_torch.render import OrbitCamera
from n_body_problem_tpu_torch.render.splat import render_state
from n_body_problem_tpu_torch.utils import profiling
from nbody_bench import peaks

N = 2048
R = 2                 # tree_rebuild_every
STEPS = 2 * R + 1     # two whole chunks and a remainder
PATHS = ["hier", "flat"]
FORCE = ["force.operands", "force.near", "force.far", "force.vip", "update"]


def _cfg(path: str, **kw) -> tnb.SimConfig:
    """A treecode config that takes ``path`` on the CPU, its capacities
    pinned as tests/test_torch_graphs.py pins them unless ``kw`` says."""
    base = dict(solver="treecode", tree_rebuild_every=R, tree_vip_tiles=8, tree_src_tile=32,
                tree_max_near=64)
    if path == "hier":
        base.update(tree_hier=True, tree_tile=128, tree_flat_cap=16 * 64 * 8,
                    tree_far_cap=16 * 64 * 8)
    else:
        base.update(tree_flat_cap=64 * 64)
    base.update(kw)
    return tnb.SimConfig(**base)


def _sim(path: str, seed: int = 3, n: int = N, **kw) -> tnb.Simulation:
    sim = tnb.Simulation(_cfg(path, **kw), tnb.models.plummer(n, seed=seed), device="cpu")
    assert tree_path(sim.cfg) == path
    return sim


def _traced(sim: tnb.Simulation, steps: int) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(steps)
    return profiling.spans(_events(prof))


def _events(prof) -> list:
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _children(found, parent) -> list:
    return [s for s in found if s.parent == parent.id]


def _planned(path: str, n: int) -> dict:
    """The capacities the planner gives the config's ``n`` bodies (as
    ``registry.plan_tree`` plans them for ``Simulation`` on the card)."""
    sim = _sim(path, n=n)
    state, cfg = sim.state, sim.cfg
    sel = dict(tile=cfg.tree_tile, theta=cfg.tree_theta, vip_tiles=cfg.tree_vip_tiles,
               eps2=cfg.eps2, compensate=cfg.compensate, src_tile=cfg.tree_src_tile)
    if path == "hier":
        caps = treecode.suggest_hier(state.pos, state.mass, slack=cfg.tree_near_slack,
                                     mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
                                     union_coarse=cfg.tree_hier_union, **sel)
        return dict(tree_max_near=caps["max_near"], tree_flat_cap=caps["flat_cap"],
                    tree_far_max=caps["far_max"], tree_far_cap=caps["far_cap"])
    return dict(tree_max_near=treecode.suggest_max_near(state.pos, state.mass,
                                                        mac_tau=cfg.tree_mac_tau, **sel),
                tree_flat_cap=treecode.suggest_flat_cap(state.pos, state.mass,
                                                        slack=cfg.tree_near_slack,
                                                        mac_tau=cfg.tree_mac_tau, **sel))


@pytest.mark.parametrize("path", PATHS)
def test_a_traced_run_yields_the_span_tree(path):
    sim = _sim(path)
    found = _traced(sim, STEPS)
    roots = [s for s in found if s.parent is None]
    assert [s.name for s in roots] == ["sim.run"]
    run = roots[0]
    assert run.attrs == {"steps": STEPS, "solver": "treecode"}
    assert all(s.call == run.id for s in found)
    programs = [s.name for s in _children(found, run)]
    builds = [s for s in _children(found, run) if s.name == "treecode.build"]
    steps = [s for s in _children(found, run) if s.name == "treecode.step"]
    assert len(builds) == math.ceil(STEPS / R) and len(steps) == STEPS
    assert programs == ["treecode.resort", "treecode.build", "treecode.step",
                        "treecode.step"] * 2 + ["treecode.resort", "treecode.build",
                                                "treecode.step"]
    levels = len(treecode._level_plan(N // sim.cfg.tree_src_tile)) if path == "hier" else 1
    for b in builds:
        kids = _children(found, b)
        assert [s.name for s in kids] == ["build.levels", "build.open", "build.lists"]
        dists = _children(found, kids[1])
        assert [s.name for s in dists] == ["build.min_dist"] * levels
        assert set(kids[2].counters) == set(profiling.COUNTERS)
        # The row selections of the compaction: the near lists' and, on the
        # hierarchical path, the far lists'.
        selects = _children(found, kids[2])
        assert [s.name for s in selects] == ["build.select"] * (2 if path == "hier" else 1)
        for s in kids + dists + selects:   # a host record's clock on the CPU
            assert b.host_start <= s.device_start <= s.device_end <= b.host_end
    for st in steps:
        assert [s.name for s in _children(found, st)] == FORCE
    for r in (s for s in _children(found, run) if s.name == "treecode.resort"):
        kids = _children(found, r)
        assert [s.name for s in kids] == ["resort.order"]
        assert set(kids[0].counters) <= {"tied_bodies"}
        assert r.host_start <= kids[0].device_start <= kids[0].device_end <= r.host_end
    assert not any(_children(found, s) for s in found
                   if s.name in ("resort.order", "build.levels", "build.select", *FORCE))


@pytest.mark.parametrize("path", PATHS)
def test_the_resort_counts_its_tied_bodies(path):
    """``tied_bodies``: the real bodies that share their 30-bit key with the
    body before them, which a galaxy's crowded centre makes many of."""
    from n_body_problem_tpu_torch.models.agora import agora_disk
    from n_body_problem_tpu_torch.utils.morton import morton_keys_cols

    sim = tnb.Simulation(_cfg(path), agora_disk(N, seed=1), device="cpu")
    s = sim.state
    keys = morton_keys_cols(*s.pos.unbind(1), s.n_real)[:s.n_real]
    tied = s.n_real - torch.unique(keys).numel()
    found = _traced(sim, R)    # one resort, on these positions
    order = [x for x in found if x.name == "resort.order"]
    assert len(order) == 1 and tied > 100
    assert order[0].counters == {"tied_bodies": tied}
    host = profiling.Span(0, "treecode.resort", None, 0)
    code = 2 * list(profiling.PHASES).index("resort.order")
    out = profiling._phases([(code, 1.0, []), (code + 1, 2.0, [7] + [0] * 9)], host, 1)
    assert [(x.name, x.counters) for x in out] == [("resort.order", {"tied_bodies": 7})]


@pytest.mark.parametrize("path", PATHS)
def test_a_run_with_no_profiler_records_no_span(path):
    sim = _sim(path)
    before = _traced(sim, 1)
    hosts = list(profiling.TRACER.hosts)
    assert not profiling.TRACER.active()
    sim.run(3)
    assert profiling.TRACER.hosts == hosts
    assert profiling.spans() == profiling.spans(None) and len(profiling.spans()) == len(before)


@pytest.mark.parametrize("path", PATHS)
def test_states_are_bitwise_equal_with_tracing_on_and_off(path):
    plain, traced = _sim(path, seed=5), _sim(path, seed=5)
    plain.run(STEPS)
    _traced(traced, STEPS)
    for f in ("pos", "vel", "acc", "time", "step"):
        assert torch.equal(getattr(plain.state, f), getattr(traced.state, f)), f
    assert (plain.sort_perm == traced.sort_perm).all()
    for a, b in zip(plain.tree_lists, traced.tree_lists):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", PATHS)
def test_counters_are_the_work_of_the_lists(path):
    sim = _sim(path)
    found = _traced(sim, R)     # one build, R steps on its lists
    counters = next(s.counters for s in found if s.name == "build.lists")
    lists = sim.tree_lists
    n, tile, src = sim.state.n, sim.cfg.tree_tile, sim.cfg.tree_src_tile
    assert counters["near_pairs"] == peaks.near_pairs(lists[0], lists[1], n, tile, src)
    assert counters["near_pairs"] == counters["near_kept"] * tile * src
    if path == "hier":
        far = peaks.far_terms(lists[2], lists[3], n, tile, src)
    else:   # every level-0 node outside a row's near mask
        far = (lists[2].numel() - int(lists[2].sum())) * tile
    assert counters["far_terms"] == far == counters["far_kept"] * tile
    vip = int(lists[-1].sum())
    assert counters["vip_bodies"] == vip > 0 and counters["vip_pairs"] == n * vip
    total = profiling.work(found)
    assert total["steps"] == R and total["builds"] == 1
    assert total["near_pairs"] == R * counters["near_pairs"]


@pytest.mark.parametrize("path", PATHS)
def test_shed_entries_are_counted(path):
    # 4,096 bodies: 128 source tiles, two chunks' worth, so that a row can
    # ask for more than one chunk.
    n = 2 * N
    caps = _planned(path, n)
    planned = _traced(_sim(path, n=n, **caps), 1)
    counters = next(s.counters for s in planned if s.name == "build.lists")
    assert counters["near_shed"] == counters["far_shed"] == 0
    # One chunk a target row, the least the lists take: rows that open
    # more source tiles shed them.
    k_t = n // (128 if path == "hier" else 32)
    caps["tree_flat_cap"] = k_t * treecode.CHUNK_LANES // 32
    small = _traced(_sim(path, n=n, **caps), 1)
    counters = next(s.counters for s in small if s.name == "build.lists")
    assert counters["near_shed"] > 0 and counters["near_kept"] > 0


@pytest.mark.parametrize("path", PATHS)
def test_the_trace_holds_the_spans_on_its_clock(tmp_path, path):
    sim = _sim(path)
    with profiling.trace(tmp_path):
        sim.run(R)
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    pid = next(e["pid"] for e in events
               if e.get("ph") == "M" and e.get("args", {}).get("name") == "program spans")
    track = [e for e in events if e.get("pid") == pid and e.get("ph") == "X"]
    names = [e["name"] for e in track]
    assert names.count("treecode.step") == R and names.count("build.lists") == 1
    lists = next(e for e in track if e["name"] == "build.lists")
    assert lists["tid"] == 1 and lists["args"]["near_kept"] > 0
    label = next(e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "sim.run")
    run = next(e for e in track if e["name"] == "sim.run")
    # The anchor: the span and its label, midpoints matched.
    assert abs((run["ts"] + run["dur"] / 2) - (label["ts"] + label["dur"] / 2)) < 1.0
    assert label["ts"] - 1e3 <= run["ts"] and run["ts"] + run["dur"] <= label["ts"] + label[
        "dur"] + 1e3


def test_render_spans():
    state = tnb.models.plummer(512, seed=1)
    cam = OrbitCamera(theta_deg=0.0, phi_deg=20.0, distance=1.0, aspect=4 / 3)
    with profile(activities=[ProfilerActivity.CPU]):
        frame = render_state(state, cam, width=64, height=48)
    found = profiling.spans()
    assert frame.shape == (48, 64, 3)
    assert [s.name for s in found] == ["render", "render.project", "render.scatter",
                                       "render.sprites"]
    assert all(s.parent == found[0].id for s in found[1:])


def test_phases_nest_close_and_carry_counters():
    host = profiling.Span(0, "treecode.build", None, 0)
    code = {name: 2 * i for i, name in enumerate(profiling.PHASES)}
    recs = [(code["build.levels"], 1.0, []), (code["build.open"], 2.0, []),
            (code["build.min_dist"], 3.0, []), (code["build.min_dist"] + 1, 4.0, []),
            (code["build.min_dist"], 5.0, []), (code["build.min_dist"] + 1, 6.0, []),
            (code["build.lists"], 7.0, []),
            (code["build.select"], 7.5, []), (code["build.select"] + 1, 8.0, []),
            (code["build.lists"] + 1, 9.0, list(range(1, 9)) + [0, 0])]
    out = profiling._phases(recs, host, 10)
    assert [(s.id, s.name, s.parent, s.device_start, s.device_end) for s in out] == [
        (10, "build.levels", 0, 1.0, 2.0), (11, "build.open", 0, 2.0, 7.0),
        (12, "build.min_dist", 11, 3.0, 4.0), (13, "build.min_dist", 11, 5.0, 6.0),
        (14, "build.lists", 0, 7.0, 9.0), (15, "build.select", 14, 7.5, 8.0)]
    assert out[4].counters == dict(zip(profiling.COUNTERS, range(1, 9)))
    ends = profiling._phases([(code["force.near"], 1.0, []), (code["force.far"], 2.0, []),
                              (-1, 3.0, [])], host, 0)
    assert [(s.name, s.device_start, s.device_end) for s in ends] == [
        ("force.near", 1.0, 2.0), ("force.far", 2.0, 3.0)]


def test_offsets_match_in_order_or_by_the_nearest():
    assert profiling._median_offset([10.0, 20.0, 30.0], [1.0, 11.0, 21.5]) == 9.0
    # A reference entry the own times lack: matched by the nearest.
    assert profiling._median_offset([10.0, 15.0, 20.0, 30.0], [1.0, 11.0, 21.0]) == 9.0
    assert profiling._median_offset([], [1.0]) == 0.0


# ------------------------------------------------------------------ the card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run on the card with -m cuda")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_stamps_agree_with_the_device_trace(cuda):
    """At 262,144 bodies (the defaults: hierarchical, rebuild every 8), one
    replayed build: its phases add up to the device time under the
    ``treecode.build`` label within 3 %, and every stamp lies within 2 µs
    of one of the stamp kernel's entries in the trace once calibrated. The
    graphs are the same with tracing on and off: a traced and an untraced
    run of the same bodies end bitwise equal."""
    from nbody_bench.trace import Trace

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode"), tnb.models.plummer(262144, seed=1),
                         device=cuda)
    twin = tnb.Simulation(tnb.SimConfig(solver="treecode"), tnb.models.plummer(262144, seed=1),
                          device=cuda)
    sim.run(8)      # the capture
    twin.run(8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run(8)
    twin.run(8)
    for f in ("pos", "vel", "acc"):
        assert torch.equal(getattr(sim.state, f), getattr(twin.state, f)), f
    events = _events(prof)
    found = profiling.spans(events)
    build = [s for s in found if s.name == "treecode.build"]
    assert len(build) == 1
    phases = sum(s.device_us for s in _children(found, build[0]))
    trace = Trace(events, 0.0)
    under = sum(o[1] for o in trace.device if o[4] == "treecode.build")
    assert abs(phases - under) / under < 0.03, (phases, under)
    kernels = sorted((o[0], o[0] + o[1]) for o in trace.device
                     if profiling.STAMP_KERNEL in o[2])
    stamps = sorted({t for s in found if s.parent is not None and s.host_start is None
                     for t in (s.device_start, s.device_end)})
    # The resort: 2; the build: 4, two a level and two a row selection (near
    # and far); a step: 7 (tree_parts.step and the force).
    assert len(kernels) == 2 + 4 + 2 * len(treecode._level_plan(262144 // 64)) + 2 * 2 + 8 * 7
    for t in stamps:
        assert min(max(a - t, t - b, 0.0) for a, b in kernels) <= 2.0, t
    counters = next(s.counters for s in found if s.name == "build.lists")
    lists = sim.tree_lists
    assert counters["near_pairs"] == peaks.near_pairs(lists[0], lists[1], sim.state.n,
                                                      sim.cfg.tree_tile, sim.cfg.tree_src_tile)
    assert counters["near_shed"] == counters["far_shed"] == 0
