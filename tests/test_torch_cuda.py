"""The CUDA kernels on the card (marked ``cuda``; they skip without a GPU).

Run them on a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
need not have; this file needs only torch.)

Each kernel is held against its plain PyTorch version on the same inputs on
the card, within rtol=1e-4, atol=2e-6 (the JAX package's bounds for these
kernels against the direct oracle, tests/test_pallas_symmetric.py:27).
"""

import pytest
import torch

import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
from n_body_problem_tpu_torch.state import pad_state_to

pytestmark = pytest.mark.cuda

PHYS = dict(eps2=1e-6, compensate=0.1, G=1.0)
TOL = dict(rtol=1e-4, atol=2e-6)
SIZES = [(128, 128), (896, 896), (1024, 934)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run on the card with -m cuda")
    return torch.device("cuda", 0)


def _bodies(n, n_real, seed, device):
    s = pad_state_to(tnb.models.plummer(n_real, seed=seed), n).to(device)
    return s.pos, s.mass


@pytest.mark.parametrize("n,n_real", SIZES)
def test_allpairs_kernel_matches_plain(cuda, n, n_real):
    pos, mass = _bodies(n, n_real, 1, cuda)
    rows = _bodies(384, 384, 2, cuda)[0] + 0.5
    for pi in (pos, rows):
        got = cuda_force.block_acc(pi, pos, mass, tile_i=128, tile_j=128, **PHYS)
        torch.testing.assert_close(got, cuda_force.block_acc_plain(pi, pos, mass, **PHYS), **TOL)
        again = cuda_force.block_acc(pi, pos, mass, tile_i=128, tile_j=128, **PHYS)
        assert torch.equal(got, again)   # fixed loop order, no atomics


@pytest.mark.parametrize("n,n_real", SIZES)
def test_symmetric_kernel_matches_plain(cuda, n, n_real):
    pos, mass = _bodies(n, n_real, 3, cuda)
    got = cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    want = cuda_symmetric.symmetric_acc_plain(pos, mass, tile=128, **PHYS)
    torch.testing.assert_close(got, want, **TOL)
    assert float((mass[:, None] * got).sum(0).abs().max()) < 1e-6


def test_wrappers_count_launches(cuda):
    pos, mass = _bodies(256, 256, 4, cuda)
    a0, s0 = cuda_force.block_acc.launches, cuda_symmetric.symmetric_acc.launches
    cuda_force.allpairs_acc(pos, mass, tile_i=128, tile_j=128, **PHYS)
    cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    torch.cuda.synchronize()
    assert (cuda_force.block_acc.launches - a0, cuda_symmetric.symmetric_acc.launches - s0) == (1, 1)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pos, mass = _bodies(256, 256, 5, cuda)
    with pytest.raises(TypeError):
        cuda_force.allpairs_acc(pos.double(), mass.double(), tile_i=128, tile_j=128, **PHYS)
    with pytest.raises(ValueError):
        cuda_force.block_acc(pos, pos, mass.cpu(), tile_i=128, tile_j=128, **PHYS)
    p64, m64 = _bodies(192, 192, 6, cuda)
    with pytest.raises(ValueError, match="128"):
        cuda_symmetric.symmetric_acc(p64, m64, tile=64, **PHYS)


def test_simulation_on_card_matches_cpu(cuda):
    # Same bodies and steps; the card's sums run in another order (and with
    # atomics for the symmetric kernel), so positions agree to float32
    # rounding grown over 5 steps.
    for solver in ("pallas", "pallas_symmetric"):
        cfg = tnb.SimConfig(solver=solver, pallas_tile_i=128, pallas_tile_j=128,
                            pallas_sym_tile=128)
        gpu = tnb.Simulation(cfg, tnb.models.plummer(500, seed=7), device=cuda)
        cpu = tnb.Simulation(cfg, tnb.models.plummer(500, seed=7), device="cpu")
        gpu.run(5)
        cpu.run(5)
        torch.testing.assert_close(gpu.state.pos.cpu(), cpu.state.pos, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ treecode kernels
# (N, overrides): the default source tile (64 bodies, 32 entries a near
# chunk) and the tuned small-N one (32 bodies, 64 entries).
TREE_CASES = [(8192, {}), (20480, tnb.config.tuned_tree_overrides(20480))]


def _tree_case(device, n, overrides):
    """The hierarchical path's kernels' arguments, as the main path builds them
    (Morton sort, padding, planned capacities, the port's lists)."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_kwargs

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                         tnb.models.plummer(n, seed=3), device=device)
    cfg, s = sim.cfg, sim.state
    build_kw, _ = tree_kwargs(cfg)
    aux = treecode.build_tree_hier_cols(*s.pos.unbind(1), s.mass, **build_kw)
    st = treecode._hier_static(s.n, cfg.tree_tile, cfg.tree_src_tile, cfg.tree_theta,
                               cfg.tree_max_near, cfg.tree_vip_tiles,
                               cfg.tree_far_max, treecode.HIER_BRANCH)
    ops = treecode.kernel_operands(s.pos, s.mass, aux[4], src_tile=cfg.tree_src_tile,
                                   vip_src=st[4], plan=st[5])
    c2 = PHYS["compensate"] ** 2
    return {
        "near": ((ops["bodies"], aux[0], aux[1]),
                 dict(n=s.n, tile=cfg.tree_tile, src_tile=cfg.tree_src_tile,
                      entries=st[2], eps2=PHYS["eps2"], c2=c2)),
        "far": ((ops["bodies"], ops["summ"], aux[2], aux[3]),
                dict(n=s.n, tile=cfg.tree_tile, eps2=PHYS["eps2"], c2=c2, G=1.0)),
        "vip": ((ops["rows"], ops["panel"]), dict(eps2=PHYS["eps2"], c2=c2)),
    }


def _tree_fns():
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    return {"near": (ct.near_field, ct.near_field_plain),
            "far": (ct.far_field_hier, ct.far_field_hier_plain),
            "vip": (ct.vip_both, ct.vip_both_plain)}


@pytest.mark.parametrize("kernel", ["near", "far", "vip"])
@pytest.mark.parametrize("n,overrides", TREE_CASES)
def test_tree_kernel_matches_plain(cuda, kernel, n, overrides):
    args, kw = _tree_case(cuda, n, overrides)[kernel]
    fn, plain = _tree_fns()[kernel]
    got, again, want = fn(*args, **kw), fn(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    got, again, want = ((x,) if kernel != "vip" else x for x in (got, again, want))
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, **TOL)
        assert torch.equal(g, a)   # fixed order, no atomics: bitwise repeatable


def test_tree_wrappers_count_launches(cuda):
    case = _tree_case(cuda, 8192, {})
    before = {k: fn.launches for k, (fn, _) in _tree_fns().items()}
    for k, (fn, _) in _tree_fns().items():
        fn(*case[k][0], **case[k][1])
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k] for k, (fn, _) in _tree_fns().items()} == \
        {"near": 1, "far": 1, "vip": 2}   # the VIP sweep is two kernels


def test_treecode_simulation_on_card_matches_cpu(cuda):
    # The hierarchical path with its capacities pinned, so that the CPU run
    # takes it too; the card then runs the same ones.
    cfg = tnb.SimConfig(solver="treecode", tree_flat_cap=64 * 32 * 4,
                        tree_far_cap=32 * 64 * 8, tree_vip_tiles=8, tree_rebuild_every=4)
    gpu = tnb.Simulation(cfg, tnb.models.plummer(4096, seed=11), device=cuda)
    cpu = tnb.Simulation(cfg, tnb.models.plummer(4096, seed=11), device="cpu")
    gpu.run(8)
    cpu.run(8)
    assert (gpu.sort_perm == cpu.sort_perm).mean() > 0.99
    back = lambda s: s.state.pos.cpu()[:4096][torch.from_numpy(s.sort_perm).argsort()]  # noqa: E731
    torch.testing.assert_close(back(gpu), back(cpu), rtol=0, atol=1e-4)


def test_treecode_run_never_waits_for_the_host(cuda):
    """The run loop (resort, acceptance build, forces, update) enqueues
    without one host synchronisation: capacity overflow is a torch.where."""
    sim = tnb.Simulation(tnb.SimConfig(solver="treecode"), tnb.models.plummer(8192, seed=1),
                         device=cuda)
    sim.run(2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, ids, _ = sim._tree_run(sim.state, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(state.pos).all() and int(state.step) == 12


# ------------------------------------- single-level flat and dense paths
# (label, N, overrides, path): the flat path by tree_hier=False and by N
# alone (below the hierarchy's 4,096 bodies), the dense path with a far
# field (tree_flat_cap=-1) and without one (1,024 bodies: every tile near).
SINGLE_CASES = [("flat", 8192, dict(tree_hier=False), "flat"),
                ("flat by N", 3072, {}, "flat"),
                ("dense", 20480, dict(tree_flat_cap=-1), "dense"),
                ("dense exact", 1024, {}, "dense")]


def _single_case(device, n, overrides):
    """Kernels 3, 4, 5 and 7's arguments on the lists of the path a
    ``Simulation`` takes: (sim, {kernel: (args, kw)})."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                         tnb.models.plummer(n, seed=3), device=device)
    cfg, s = sim.cfg, sim.state
    aux = tree_fns(cfg)[0](s.pos, s.mass)
    c2 = PHYS["compensate"] ** 2
    phys = dict(eps2=PHYS["eps2"], c2=c2)
    tile = cfg.tree_tile
    if tree_path(cfg) == "flat":
        st = treecode._flat_static(s.n, tile, cfg.tree_src_tile, cfg.tree_theta,
                                   cfg.tree_max_near, cfg.tree_vip_tiles)
        ops = treecode.kernel_operands(s.pos, s.mass, aux[3], src_tile=cfg.tree_src_tile,
                                       vip_src=st[4], plan=(st[1],))
        return sim, {
            "near": ((ops["bodies"], aux[0], aux[1]),
                     dict(n=s.n, tile=tile, src_tile=cfg.tree_src_tile, entries=st[2],
                          **phys)),
            "far_single": ((ops["bodies"], ops["summ"], aux[2]),
                           dict(n=s.n, tile=tile, G=1.0, **phys))}
    k, max_near, vip = treecode._static_args(s.n, tile, cfg.tree_theta, cfg.tree_max_near,
                                             cfg.tree_vip_tiles)
    ops = treecode.kernel_operands(s.pos, s.mass, aux[2], src_tile=tile, vip_src=vip,
                                   plan=(k,))
    panels = ct.gather_panels_plain(ops["bodies"], aux[0], tile=tile)
    cases = {"gather": ((ops["bodies"], aux[0]), dict(tile=tile)),
             "near_panel": ((ops["bodies"], panels), dict(tile=tile, **phys))}
    if max_near < k:
        cases["far_single"] = ((ops["bodies"], ops["summ"], aux[1]),
                               dict(n=s.n, tile=tile, G=1.0, **phys))
    return sim, cases


def _single_fns():
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    return {"near": (ct.near_field, ct.near_field_plain),
            "far_single": (ct.far_field_single, ct.far_field_single_plain),
            "gather": (ct.gather_panels, ct.gather_panels_plain),
            "near_panel": (ct.near_panel, ct.near_panel_plain)}


@pytest.mark.parametrize("label,n,overrides,path", SINGLE_CASES)
def test_single_level_kernels_match_plain(cuda, label, n, overrides, path):
    """Kernels 3 (far_single), 4 (gather, exactly), 5 (near_panel) and 7 at
    32-body rows against their twins, bitwise repeatable."""
    from n_body_problem_tpu_torch.ops.registry import tree_path

    sim, cases = _single_case(cuda, n, overrides)
    assert tree_path(sim.cfg) == path
    assert ("far_single" in cases) == (label != "dense exact")
    for name, (args, kw) in cases.items():
        fn, plain = _single_fns()[name]
        got, again, want = fn(*args, **kw), fn(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "gather":
            assert torch.equal(got, want), name
        else:
            torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again), name


def test_single_level_wrappers_count_launches(cuda):
    _, cases = _single_case(cuda, 20480, dict(tree_flat_cap=-1))
    fns = _single_fns()
    before = {k: fns[k][0].launches for k in cases}
    for k, (args, kw) in cases.items():
        fns[k][0](*args, **kw)
    torch.cuda.synchronize()
    assert {k: fns[k][0].launches - before[k] for k in cases} == {k: 1 for k in cases}


@pytest.mark.parametrize("overrides", [dict(tree_hier=False), dict(tree_flat_cap=-1)])
def test_single_level_simulation_on_card_matches_cpu(cuda, overrides):
    """The same path and capacities on both devices (the CPU run pins the
    flat capacity the card planned), the same bodies, 8 steps."""
    from n_body_problem_tpu_torch.ops.registry import tree_path

    cfg = tnb.SimConfig(solver="treecode", tree_vip_tiles=8, tree_rebuild_every=4,
                        **overrides)
    gpu = tnb.Simulation(cfg, tnb.models.plummer(4096, seed=11), device=cuda)
    pinned = cfg.replace(tree_flat_cap=gpu.cfg.tree_flat_cap,
                         tree_max_near=gpu.cfg.tree_max_near)
    cpu = tnb.Simulation(pinned, tnb.models.plummer(4096, seed=11), device="cpu")
    assert tree_path(gpu.cfg) == tree_path(cpu.cfg)
    gpu.run(8)
    cpu.run(8)
    assert (gpu.sort_perm == cpu.sort_perm).mean() > 0.99
    back = lambda s: s.state.pos.cpu()[:4096][torch.from_numpy(s.sort_perm).argsort()]  # noqa: E731
    torch.testing.assert_close(back(gpu), back(cpu), rtol=0, atol=1e-4)


@pytest.mark.parametrize("overrides", [dict(tree_hier=False), dict(tree_flat_cap=-1)])
def test_single_level_run_never_waits_for_the_host(cuda, overrides):
    """10 flat and 10 dense steps (resort, build, forces, update) under
    ``set_sync_debug_mode("error")``: no host sync in the new build or force
    code."""
    sim = tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                         tnb.models.plummer(8192, seed=1), device=cuda)
    sim.run(2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, ids, _ = sim._tree_run(sim.state, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(state.pos).all() and int(state.step) == 12
