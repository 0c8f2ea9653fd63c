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
from n_body_problem_tpu_torch.kernel_compare import allpairs_sweep
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


# (Ni, Nj): one row, the probe's and a ring step's shapes (cut to a size whose
# twin is quick), a ragged Ni and Nj, a square case, and more rows than
# columns. Each runs at the split allpairs_split chooses and at every other
# split of kernel_compare.allpairs_sweep: one piece and several, every parts.
ALLPAIRS_SHAPES = [(1, 256), (384, 65536), (2048, 131072), (1000, 2500), (8192, 8192),
                   (40000, 4096)]


@pytest.mark.parametrize("ni,nj", ALLPAIRS_SHAPES)
def test_allpairs_kernel_matches_plain_at_every_split(cuda, monkeypatch, ni, nj):
    """Whatever the rows a block, the parts and the column pieces: the twin's
    force within tolerance, the same bits twice, and one launch for one piece,
    two (the pair kernel and the kernel that adds the pieces) for several."""
    pos, mass = _bodies(nj, nj, 15, cuda)
    rows = _bodies(ni, ni, 16, cuda)[0] + 0.25
    kw = dict(tile_i=1, tile_j=1, **PHYS)
    want = cuda_force.block_acc_plain(rows, pos, mass, **PHYS)
    chosen = cuda_force.allpairs_split(ni, nj)
    splits = [chosen] + [s for s in allpairs_sweep(ni, nj) if s != chosen]
    assert any(s[2] > 1 for s in splits) or nj <= cuda_force.ALLPAIRS_STAGE
    for split in splits:
        monkeypatch.setattr(cuda_force, "allpairs_split", lambda *_, split=split: split)
        before = cuda_force.block_acc.launches
        got = cuda_force.block_acc(rows, pos, mass, **kw)
        assert cuda_force.block_acc.launches - before == (2 if split[2] > 1 else 1), split
        again = cuda_force.block_acc(rows, pos, mass, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again), split   # fixed orders, no atomics


def test_allpairs_kernel_takes_no_rows_and_no_columns(cuda):
    pos, mass = _bodies(256, 256, 17, cuda)
    before = cuda_force.block_acc.launches
    tiles = dict(tile_i=128, tile_j=128)
    assert cuda_force.block_acc(pos[:0], pos, mass, **tiles, **PHYS).shape == (0, 3)
    assert cuda_force.block_acc.launches == before
    none = cuda_force.block_acc(pos, pos[:0], mass[:0], **tiles, **PHYS)
    torch.cuda.synchronize()
    assert none.shape == (256, 3) and not none.any()


@pytest.mark.parametrize("n,n_real", SIZES)
def test_symmetric_kernel_matches_plain(cuda, n, n_real):
    pos, mass = _bodies(n, n_real, 3, cuda)
    got = cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    want = cuda_symmetric.symmetric_acc_plain(pos, mass, tile=128, **PHYS)
    torch.testing.assert_close(got, want, **TOL)
    assert float((mass[:, None] * got).sum(0).abs().max()) < 1e-6


# (N, real N) at the kernel's own 512-body tile: K = 1 (the triangle alone),
# K = 2 (the even-K last diagonal, rows i < K/2 only), K = 3, odd K = 5 with
# padding bodies, even K = 8.
SYM_TILE_SIZES = [(512, 512), (1024, 1024), (1536, 1536), (2560, 2500), (4096, 4096)]


@pytest.mark.parametrize("n,n_real", SYM_TILE_SIZES)
def test_symmetric_kernel_matches_plain_at_its_tile(cuda, n, n_real):
    pos, mass = _bodies(n, n_real, 12, cuda)
    assert n % cuda_symmetric.KERNEL_TILE == 0
    want = cuda_symmetric.symmetric_acc_plain(pos, mass, tile=512, **PHYS)
    got = cuda_symmetric.symmetric_acc(pos, mass, tile=512, **PHYS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert float((mass[:, None] * got).sum(0).abs().max()) < 1e-6


# The bare rsqrt instruction of every pair and term kernel (all-pairs, the
# two symmetric, near, VIP, far, single-level far, near-panel) flushes
# denormals, so their wrappers take a normal float32 softening only; at
# 1e-24, the smallest at which a coincident pair's 1 / eps^3 is still finite
# in float32, they agree with their twins as at any other.


def _single_level_inputs(device):
    """The single-level far field's arguments on the flat path N chooses
    (3,072 bodies) and the near-panel kernel's on the dense one (1,024)."""
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    return {"far_single": kernel_inputs(3072, device, seed=3)["kernels"]["far_single"],
            "near_panel": kernel_inputs(1024, device, seed=3)["kernels"]["near_panel"]}


@pytest.mark.parametrize("eps2", [0.0, 1e-39])
def test_pair_kernels_reject_a_denormal_softening(cuda, eps2):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    pos, mass = _bodies(512, 512, 13, cuda)
    with pytest.raises(ValueError, match="eps2"):
        cuda_symmetric.symmetric_acc(pos, mass, eps2=eps2, compensate=0.1)
    with pytest.raises(ValueError, match="eps2"):
        cuda_force.block_acc(pos, pos, mass, eps2=eps2, compensate=0.1, tile_i=128, tile_j=128)
    for precision in ("bf16x3", "mixed"):
        with pytest.raises(ValueError, match="eps2"):
            cuda_symmetric.symmetric_acc_bf16x3(pos, mass, eps2=eps2, compensate=0.1,
                                                tile=64, precision=precision)
    tree = {**kernel_inputs(8192, cuda, seed=3)["kernels"], **_single_level_inputs(cuda)}
    for key, fn in (("near", ct.near_field), ("vip", ct.vip_both), ("far", ct.far_field_hier),
                    ("far_single", ct.far_field_single), ("near_panel", ct.near_panel)):
        args, kw = tree[key]
        with pytest.raises(ValueError, match="eps2"):
            fn(*args, **{**kw, "eps2": eps2})


def test_pair_kernels_match_plain_at_a_tiny_softening(cuda):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    pos, mass = _bodies(1024, 1024, 14, cuda)
    kw = dict(eps2=1e-24, compensate=0.1, tile=512)
    got = cuda_symmetric.symmetric_acc(pos, mass, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, cuda_symmetric.symmetric_acc_plain(pos, mass, **kw), **TOL)
    soft = dict(eps2=1e-24, compensate=0.1)
    got = cuda_force.block_acc(pos, pos, mass, **soft)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, cuda_force.block_acc_plain(pos, pos, mass, **soft), **TOL)
    f32_twin = cuda_symmetric.symmetric_acc_plain(pos, mass, tile=64, **soft)
    for precision in ("bf16x3", "mixed"):
        fast = dict(tile=64, precision=precision, **soft)
        got = cuda_symmetric.symmetric_acc_bf16x3(pos, mass, **fast)
        twin = cuda_symmetric.symmetric_acc_plain(pos, mass, **fast)
        assert torch.isfinite(got).all()
        assert float((got - twin).norm() / (twin - f32_twin).norm()) <= 0.3
    tree = {**kernel_inputs(8192, cuda, seed=3)["kernels"], **_single_level_inputs(cuda)}
    for key, fn, plain in (("near", ct.near_field, ct.near_field_plain),
                           ("vip", ct.vip_both, ct.vip_both_plain),
                           ("far", ct.far_field_hier, ct.far_field_hier_plain),
                           ("far_single", ct.far_field_single, ct.far_field_single_plain),
                           ("near_panel", ct.near_panel, ct.near_panel_plain)):
        args, kw = tree[key]
        kw = {**kw, "eps2": 1e-24}
        got, want = fn(*args, **kw), plain(*args, **kw)
        for g, w in zip(*((x,) if key != "vip" else x for x in (got, want))):
            assert torch.isfinite(g).all(), key
            torch.testing.assert_close(g, w, **TOL)


def test_wrappers_count_launches(cuda):
    pos, mass = _bodies(256, 256, 4, cuda)
    fns = (cuda_force.block_acc, cuda_symmetric.symmetric_acc,
           cuda_symmetric.symmetric_acc_bf16x3)
    before = [f.launches for f in fns]
    cuda_force.allpairs_acc(pos, mass, tile_i=128, tile_j=128, **PHYS)
    cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    cuda_symmetric.symmetric_acc(pos, mass, tile=128, precision="mixed", **PHYS)
    cuda_symmetric.symmetric_acc(pos, mass, tile=128, precision="bf16x3", **PHYS)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 2]


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pos, mass = _bodies(256, 256, 5, cuda)
    with pytest.raises(TypeError):
        cuda_force.allpairs_acc(pos.double(), mass.double(), tile_i=128, tile_j=128, **PHYS)
    with pytest.raises(ValueError):
        cuda_force.block_acc(pos, pos, mass.cpu(), tile_i=128, tile_j=128, **PHYS)
    p32, m32 = _bodies(192, 192, 6, cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_symmetric.symmetric_acc(p32, m32, tile=32, precision="bf16x3", **PHYS)


def test_symmetric_kernel_pads_to_its_tile(cuda):
    """N = 448 with tile 64 runs in the JAX package; the f32 kernel tiles by
    512, so its wrapper pads with zero-mass bodies and slices back."""
    pos, mass = _bodies(448, 448, 8, cuda)
    got = cuda_symmetric.symmetric_acc(pos, mass, tile=64, **PHYS)
    assert got.shape == (448, 3)
    torch.testing.assert_close(got, cuda_symmetric.symmetric_acc_plain(pos, mass, tile=64, **PHYS),
                               **TOL)


# (N, real N, tile): even K = 8, odd K = 7, and padding at the production
# tile (K = 2: "mixed" runs no fast diagonal there).
FAST_SIZES = [(512, 512, 64), (448, 448, 64), (1024, 934, 512)]


@pytest.mark.parametrize("precision", ["bf16x3", "mixed"])
@pytest.mark.parametrize("n,n_real,tile", FAST_SIZES)
def test_bf16x3_kernel_matches_plain(cuda, n, n_real, tile, precision):
    """The tensor-core kernel against its twin: their distance at most 0.3
    of the twin's distance from the f32 twin (a faithful kernel differs by
    float32 summation order; a wrong role or centre by the whole fast-mode
    error). With K <= 3 "mixed" is the f32 mode and matches it within
    rtol=1e-4, atol=2e-6."""
    pos, mass = _bodies(n, n_real, 9, cuda)
    kw = dict(tile=tile, **PHYS)
    got = cuda_symmetric.symmetric_acc(pos, mass, precision=precision, **kw)
    want = cuda_symmetric.symmetric_acc_plain(pos, mass, precision=precision, **kw)
    f32 = cuda_symmetric.symmetric_acc_plain(pos, mass, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if precision == "mixed" and n // tile <= 3:
        torch.testing.assert_close(got, f32, **TOL)
    else:
        assert float((got - want).norm() / (want - f32).norm()) <= 0.3


def test_simulation_on_card_matches_cpu(cuda):
    # Same bodies and steps; the card's sums run in another order (and with
    # atomics for the symmetric kernels), so positions agree to float32
    # rounding grown over 5 steps.
    for solver, precision in (("pallas", "f32"), ("pallas_symmetric", "f32"),
                              ("pallas_symmetric", "bf16x3"), ("pallas_symmetric", "mixed"),
                              ("pair_matrix", "f32")):
        cfg = tnb.SimConfig(solver=solver, pallas_tile_i=128, pallas_tile_j=128,
                            pallas_sym_tile=128, pallas_sym_precision=precision)
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


# (label, N, overrides, tile, entries): the near kernel at each split of
# near_split: 32-body rows (flat path), 64, 128 and 256 (hierarchical; the
# last two cut into blocks of 64 targets), and the tuned 20,480 lists, whose
# chunks are 64 entries of 32 bodies.
NEAR_CASES = [("tile 32", 8192, dict(tree_hier=False), 32, 32),
              ("tile 64", 8192, dict(tree_tile=64), 64, 32),
              ("tile 128", 8192, {}, 128, 32),
              ("tile 256", 8192, dict(tree_tile=256), 256, 32),
              ("64 entries of 32", 20480, tnb.config.tuned_tree_overrides(20480), 128, 64)]


@pytest.mark.parametrize("label,n,overrides,tile,entries", NEAR_CASES)
def test_near_kernel_matches_plain_at_every_split(cuda, monkeypatch, label, n, overrides, tile,
                                                  entries):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    args, kw = kernel_inputs(n, cuda, seed=3, **overrides)["kernels"]["near"]
    assert (kw["tile"], kw["entries"]) == (tile, entries)
    before = ct.near_field.launches
    got, again = ct.near_field(*args, **kw), ct.near_field(*args, **kw)
    want = ct.near_field_plain(*args, **kw)
    torch.cuda.synchronize()
    assert ct.near_field.launches - before == 2
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)   # fixed split and order, no atomics
    # Other splits of the same work: other sums, the same force.
    for block, piece_bodies, targets in ((128, 2048, 32), (1024, 64, 1024), (256, 512, 128)):
        monkeypatch.setattr(ct, "NEAR_BLOCK", block)
        monkeypatch.setattr(ct, "NEAR_PIECE_BODIES", piece_bodies)
        monkeypatch.setattr(ct, "NEAR_TARGETS", targets)
        torch.testing.assert_close(ct.near_field(*args, **kw), want, **TOL)


def test_near_kernel_writes_zeros_for_a_row_without_chunks(cuda):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    (bodies, flat_src, chunk_tgt), kw = kernel_inputs(8192, cuda, seed=3)["kernels"]["near"]
    # Row 5's chunks go to row 6: still non-decreasing and contiguous.
    moved = torch.where(chunk_tgt == 5, 6, chunk_tgt).to(torch.int32)
    got = ct.near_field(bodies, flat_src, moved, **kw)
    torch.cuda.synchronize()
    assert not got[5 * kw["tile"]:6 * kw["tile"]].any()
    torch.testing.assert_close(got, ct.near_field_plain(bodies, flat_src, moved, **kw), **TOL)
    # No live chunk at all (every tag the sentinel): all zeros.
    none = torch.full_like(chunk_tgt, kw["n"] // kw["tile"])
    assert not ct.near_field(bodies, flat_src, none, **kw).any()


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


# ------------------------------------------------- VIP sweep and far field
def _vip_rows(device, n, w, seed):
    """N rows [x y z G c^3 m] of a Plummer sphere and a panel of W of them
    (VIP bodies are rows on the main path)."""
    pos, mass = _bodies(n, n, seed, device)
    rows = torch.cat([pos, (mass * 0.1 ** 3)[:, None]], 1)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return rows, rows[torch.randperm(n, generator=gen)[:w].to(device)].contiguous()


@pytest.mark.parametrize("n,overrides", TREE_CASES)
def test_vip_kernel_matches_plain_at_every_split(cuda, monkeypatch, n, overrides):
    """The sweep on the main path's lists at the split vip_split chooses,
    with one piece, and with the panel cut into sub-panels: the twin's
    action and reaction within tolerance, the same bits twice, two launches
    a sweep (the pair kernel and the summing kernel)."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    (rows, panel), kw = kernel_inputs(n, cuda, seed=3, **overrides)["kernels"]["vip"]
    want = ct.vip_both_plain(rows, panel, **kw)
    splits = set()
    for blocks in (ct.VIP_BLOCKS, 1, 64, 1 << 20):
        monkeypatch.setattr(ct, "VIP_BLOCKS", blocks)
        splits.add(ct.vip_split(rows.shape[0], panel.shape[0]))
        before = ct.vip_both.launches
        got, again = ct.vip_both(rows, panel, **kw), ct.vip_both(rows, panel, **kw)
        torch.cuda.synchronize()
        assert ct.vip_both.launches - before == 4
        for g, a, w in zip(got, again, want):
            torch.testing.assert_close(g, w, **TOL)
            assert torch.equal(g, a), blocks   # fixed orders, no atomics
    assert len(splits) >= 3 and any(s[1] == 1 for s in splits)


@pytest.mark.parametrize("n,w", [(1000, 100), (513, 33), (65, 300), (700, 0)])
def test_vip_kernel_at_ragged_shapes(cuda, n, w):
    """N no multiple of the 512-row group, W no multiple of a sub-panel,
    more VIPs than rows, and no VIP at all (one launch, zero action)."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    rows, panel = _vip_rows(cuda, max(n, w), w, seed=n + w)
    rows = rows[:n].contiguous()
    kw = dict(eps2=1e-6, c2=0.01)
    before = ct.vip_both.launches
    action, react = ct.vip_both(rows, panel, **kw)
    torch.cuda.synchronize()
    assert ct.vip_both.launches - before == (2 if w else 1)
    assert action.shape == (n, 3) and react.shape == (w, 3)
    want_a, want_r = ct.vip_both_plain(rows, panel, **kw)
    torch.testing.assert_close(action, want_a, **TOL)
    torch.testing.assert_close(react, want_r, **TOL)
    if w == 0:
        assert not action.any()


# (FAR_TARGETS, FAR_PARTS, FAR_STAGE_CHUNKS) settings of the far kernel, and
# the (sub, parts, stage_chunks) far_split makes of them for rows of 128
# bodies: (128, 4, 2) its own; (128, 2, 1) the fewest parts, as one chunk's
# staging needs two; (128, 8, 4) four-chunk stages; (64, 8, 2); (32, 8, 1)
# and (32, 6, 1) the fewest targets.
FAR_SETTINGS = [(128, 4, 2), (128, 1, 1), (128, 8, 4), (64, 8, 4), (32, 8, 2), (32, 4, 1)]


@pytest.mark.parametrize("n,overrides", TREE_CASES + [(8192, dict(tree_tile=64)),
                                                      (8192, dict(tree_tile=256))])
def test_far_kernel_matches_plain_at_every_split(cuda, monkeypatch, n, overrides):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    args, kw = kernel_inputs(n, cuda, seed=3, **overrides)["kernels"]["far"]
    want = ct.far_field_hier_plain(*args, **kw)
    for targets, parts, stage in FAR_SETTINGS:
        monkeypatch.setattr(ct, "FAR_TARGETS", targets)
        monkeypatch.setattr(ct, "FAR_PARTS", parts)
        monkeypatch.setattr(ct, "FAR_STAGE_CHUNKS", stage)
        before = ct.far_field_hier.launches
        got, again = ct.far_field_hier(*args, **kw), ct.far_field_hier(*args, **kw)
        torch.cuda.synchronize()
        assert ct.far_field_hier.launches - before == 2
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again), (targets, parts, stage)


def test_far_kernel_writes_zeros_for_a_row_without_chunks(cuda):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    (bodies, summ, far_src, far_tgt), kw = kernel_inputs(8192, cuda, seed=3)["kernels"]["far"]
    moved = torch.where(far_tgt == 5, 6, far_tgt).to(torch.int32)
    got = ct.far_field_hier(bodies, summ, far_src, moved, **kw)
    torch.cuda.synchronize()
    assert not got[5 * kw["tile"]:6 * kw["tile"]].any()
    torch.testing.assert_close(got, ct.far_field_hier_plain(bodies, summ, far_src, moved, **kw),
                               **TOL)
    none = torch.full_like(far_tgt, kw["n"] // kw["tile"])
    assert not ct.far_field_hier(bodies, summ, far_src, none, **kw).any()


# ------------------------------------- single-level far field and near panel
@pytest.mark.parametrize("label,n,overrides,path", SINGLE_CASES[:3])
def test_far_single_kernel_matches_plain_at_every_split(cuda, monkeypatch, label, n, overrides,
                                                        path):
    """Every (threads, mask entries a thread) setting of kernel_compare's
    sweep, on the flat and dense paths' lists: the twin within tolerance,
    the same bits twice, one launch a call."""
    from n_body_problem_tpu_torch.kernel_compare import SINGLE_SPLITS
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    _, cases = _single_case(cuda, n, overrides)
    args, kw = cases["far_single"]
    want = ct.far_field_single_plain(*args, **kw)
    splits = set()
    for threads, per in SINGLE_SPLITS:
        monkeypatch.setattr(ct, "SINGLE_THREADS", threads)
        monkeypatch.setattr(ct, "SINGLE_ENTRIES", per)
        splits.add(ct.single_split(kw["tile"]))
        before = ct.far_field_single.launches
        got, again = ct.far_field_single(*args, **kw), ct.far_field_single(*args, **kw)
        torch.cuda.synchronize()
        assert ct.far_field_single.launches - before == 2
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again), (threads, per)
    assert len(splits) == len(SINGLE_SPLITS)


@pytest.fixture(scope="module")
def flat64k(cuda):
    """The single-level far field's arguments on the 65,536-body flat path."""
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs

    return kernel_inputs(65536, cuda, seed=3, tree_hier=False)["kernels"]["far_single"]


# (tile, K_s): rows of 64 and 96 (no power of two) and 1,024 bodies, K_s no
# multiple of a stage, a single tile, and none.
@pytest.mark.parametrize("tile,k_s", [(64, 1000), (96, 777), (1024, 1024), (32, 1), (32, 0)])
def test_far_single_kernel_at_ragged_shapes(cuda, flat64k, tile, k_s):
    """The 65,536-body flat path's bodies and summaries, its first K_s
    source tiles, rows of ``tile`` bodies whose near mask is that of their
    32-body rows (a tile near one of them is near the row: the expansion is
    never taken inside a near tile), with more tiles masked at random and
    one row with every tile masked: the twin within tolerance, the same bits
    twice, and zero on every row with every tile masked (a massless tile,
    all VIP bodies, adds exactly zero as well)."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    (bodies, summ, mask32), kw = flat64k
    n = 65536 // tile * tile
    near = mask32.bool()[:n // 32, :k_s]
    if tile % 32 == 0 and tile > 32:
        near = near.reshape(n // tile, tile // 32, k_s).any(1)
    gen = torch.Generator(device="cpu").manual_seed(tile + k_s)
    mask = (near | (torch.rand(near.shape, generator=gen) < 0.3).to(cuda)).contiguous()
    mask[1] = True
    kw = {**kw, "n": n, "tile": tile}
    got = ct.far_field_single(bodies, summ, mask, **kw)
    again = ct.far_field_single(bodies, summ, mask, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ct.far_field_single_plain(bodies, summ, mask, **kw), **TOL)
    assert torch.equal(got, again)
    assert not got.reshape(n // tile, -1)[mask.all(1)].any()


@pytest.mark.parametrize("label,n,overrides", [("dense", 20480, dict(tree_flat_cap=-1)),
                                               ("dense exact", 1024, {})])
def test_near_panel_kernel_matches_plain_at_every_split(cuda, monkeypatch, label, n, overrides):
    """Every (threads, panel rows a stage) setting of kernel_compare's sweep
    on the dense path's panels: the twin within tolerance, the same bits
    twice, one launch a call."""
    from n_body_problem_tpu_torch.kernel_compare import PANEL_SPLITS
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    _, cases = _single_case(cuda, n, overrides)
    args, kw = cases["near_panel"]
    want = ct.near_panel_plain(*args, **kw)
    for threads, stage in PANEL_SPLITS:
        monkeypatch.setattr(ct, "PANEL_THREADS", threads)
        monkeypatch.setattr(ct, "PANEL_STAGE", stage)
        before = ct.near_panel.launches
        got, again = ct.near_panel(*args, **kw), ct.near_panel(*args, **kw)
        torch.cuda.synchronize()
        assert ct.near_panel.launches - before == 2
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again), (threads, stage)


# (tile, W): tiles of 64 and 96 (no power of two) and 1,024, W no multiple of
# a stage, one row, no panel.
@pytest.mark.parametrize("tile,width", [(64, 1000), (96, 4101), (1024, 2048), (32, 1),
                                        (32, 0)])
def test_near_panel_kernel_at_ragged_shapes(cuda, tile, width):
    """Rows [x y z G c^3 m] of a Plummer sphere as targets, and panels of
    its rows drawn at random, as the gather draws them from near tiles."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    k = 5
    rows, _ = _vip_rows(cuda, max(k * tile, width), 0, seed=tile + width)
    gen = torch.Generator(device="cpu").manual_seed(tile + width)
    bodies = rows[:k * tile].contiguous()
    panels = rows[torch.randint(0, rows.shape[0], (k, width), generator=gen).to(cuda)]
    kw = dict(tile=tile, eps2=1e-6, c2=0.01)
    got, again = ct.near_panel(bodies, panels, **kw), ct.near_panel(bodies, panels, **kw)
    torch.cuda.synchronize()
    assert got.shape == (k * tile, 3)
    torch.testing.assert_close(got, ct.near_panel_plain(bodies, panels, **kw), **TOL)
    assert torch.equal(got, again)
    if width == 0:
        assert not got.any()
