"""The CUDA kernels on the card (marked ``cuda``; they skip without a GPU).

Run them on a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
need not have; this file needs only torch.)

Each kernel is held against its plain PyTorch version on the same inputs on
the card, within rtol=1e-4, atol=2e-6 (the JAX package's bounds for these
kernels against the direct oracle, tests/test_pallas_symmetric.py:27).
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import pytest
import torch

import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch.kernel_compare import allpairs_sweep
from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, cuda_treecode
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
    again = cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    assert torch.equal(got, again)   # slots summed in slot order, no atomics


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
    assert torch.equal(got, cuda_symmetric.symmetric_acc(pos, mass, tile=512, **PHYS))


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
    # the symmetric kernels' calls: the pair kernel and the slots' sum each
    sym = cuda_symmetric.LAUNCHES_A_CALL
    assert [f.launches - b for f, b in zip(fns, before)] == [1, sym, 2 * sym]


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
    assert torch.equal(got, cuda_symmetric.symmetric_acc(pos, mass, precision=precision, **kw))


def test_simulation_on_card_matches_cpu(cuda):
    # Same bodies and steps; the card's sums run in another order, so
    # positions agree to float32 rounding grown over 5 steps.
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
        "near": ((ops["bodies"], ops["bodies"], aux[0], aux[1]),
                 dict(n=s.n, n_s=s.n, tile=cfg.tree_tile, src_tile=cfg.tree_src_tile,
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

    (bodies, _, flat_src, chunk_tgt), kw = kernel_inputs(8192, cuda, seed=3)["kernels"]["near"]
    # Row 5's chunks go to row 6: still non-decreasing and contiguous.
    moved = torch.where(chunk_tgt == 5, 6, chunk_tgt).to(torch.int32)
    got = ct.near_field(bodies, bodies, flat_src, moved, **kw)
    torch.cuda.synchronize()
    assert not got[5 * kw["tile"]:6 * kw["tile"]].any()
    torch.testing.assert_close(got, ct.near_field_plain(bodies, bodies, flat_src, moved, **kw),
                               **TOL)
    # No live chunk at all (every tag the sentinel): all zeros.
    none = torch.full_like(chunk_tgt, kw["n"] // kw["tile"])
    assert not ct.near_field(bodies, bodies, flat_src, none, **kw).any()


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
    """The eager run loop (resort, acceptance build, forces, update), the
    graphs' reference, enqueues without one host synchronisation: capacity
    overflow is a torch.where."""
    from n_body_problem_tpu_torch.simulation import make_treecode_run

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode"), tnb.models.plummer(8192, seed=1),
                         device=cuda)
    sim.run(2)
    run = make_treecode_run(sim.cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, ids, _ = run(sim.state, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(state.pos).all() and int(state.step) == 12


# ----------------------------------- the acceptance build's minimum distances
def _min_dist_columns(device, n, seed=2):
    """(x, y, z, mass) contiguous float32 columns of a Plummer sphere."""
    st = tnb.models.plummer(n, seed=seed).to(device)
    return (*(st.pos[:, i].contiguous() for i in range(3)), st.mass)


def _min_dist_cases():
    """(label, rows, centres level or count, tile): every level of the
    65,536 hierarchical plan (K_l 1,024 ... 16, 128-body rows), the flat
    path's 32-body rows against the 1,024 level-0 tiles, K_l that no block
    of nodes divides, and a sharded rank's rows (a quarter of the bodies)
    against every level-0 centre."""
    from n_body_problem_tpu_torch.ops import treecode

    plan = treecode._level_plan(65536 // 64, treecode.HIER_BRANCH)
    return ([(f"level {lvl} ({k})", "all", lvl, 128) for lvl, k in enumerate(plan)]
            + [("flat tile 32", "all", 0, 32), ("ragged 1,000", "all", 1000, 128),
               ("ragged 777 tile 32", "all", 777, 32), ("rank 1 of 4", "quarter", 0, 128)])


@pytest.fixture(scope="module")
def min_dist_inputs(cuda):
    from n_body_problem_tpu_torch.ops import treecode

    x, y, z, m = _min_dist_columns(cuda, 65536)
    plan = treecode._level_plan(65536 // 64, treecode.HIER_BRANCH)
    levels = treecode._level_summaries(x, y, z, m, 64, plan, treecode.HIER_BRANCH)
    return (x, y, z), [tuple(c.contiguous() for c in lv[:3]) for lv in levels]


@pytest.mark.parametrize("label,rows,centres,tile", _min_dist_cases(),
                         ids=[c[0] for c in _min_dist_cases()])
def test_min_dist_kernel_is_its_plain_twin_bitwise(cuda, min_dist_inputs, label, rows, centres,
                                                   tile):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    cols, levels = min_dist_inputs
    if rows == "quarter":   # rank 1's rows of 4, as parallel/stream.py passes them
        q = cols[0].shape[0] // 4
        cols = tuple(c[q:2 * q].contiguous() for c in cols)
    if centres < len(levels):
        cen = levels[centres]
    else:   # the first `centres` bodies as centres
        cen = tuple(c[:centres].contiguous() for c in min_dist_inputs[0])
    before = ct.min_tile_dist.launches
    got, again = ct.min_tile_dist(*cols, *cen, tile), ct.min_tile_dist(*cols, *cen, tile)
    want = ct.min_tile_dist_plain(*cols, *cen, tile)
    torch.cuda.synchronize()
    assert ct.min_tile_dist.launches - before == 2
    assert got.shape == want.shape == (cols[0].shape[0] // tile, cen[0].shape[0])
    assert torch.equal(got, want) and torch.equal(got, again)


def test_min_dist_kernel_carries_nans_as_its_twin(cuda, min_dist_inputs):
    """A NaN body makes its tile's row NaN, a NaN centre its column, an
    infinite one inf or NaN as the twin's arithmetic says; the rest stays
    bitwise the twin's."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    cols = [c.clone() for c in min_dist_inputs[0]]
    cen = [c.clone() for c in min_dist_inputs[1][0]]
    cols[1][7 * 128 + 5] = float("nan")
    cols[0][9 * 128] = float("inf")
    cen[2][33] = float("nan")
    cen[0][40] = float("-inf")
    cen[0][41] = float("inf")
    got = ct.min_tile_dist(*cols, *cen, 128)
    want = ct.min_tile_dist_plain(*cols, *cen, 128)
    torch.cuda.synchronize()
    assert torch.isnan(got[7]).all() and torch.isnan(got[:, 33]).all()
    assert torch.isnan(got[9, 41]) and torch.isinf(got[9, 40])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_min_dist_kernel_builds_the_twins_lists(cuda, monkeypatch):
    """The hierarchical build at 262,144 bodies on the card: the same lists,
    element for element, with the fused opening-test kernel and with its
    plain twin; one launch a level (``union_coarse``)."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_kwargs

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode"), tnb.models.plummer(262144, seed=5),
                         device=cuda)
    build_kw, _ = tree_kwargs(sim.cfg)
    cols = (*sim.state.pos.unbind(1), sim.state.mass)
    before = ct.min_dist_open.launches
    got = treecode.build_tree_hier_cols(*cols, **build_kw)
    launched = ct.min_dist_open.launches - before
    monkeypatch.setattr(ct, "min_dist_open", lambda *a, **k: ct.min_dist_open_plain(*a, **k))
    want = treecode.build_tree_hier_cols(*cols, **build_kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plan = treecode._level_plan(262144 // sim.cfg.tree_src_tile, treecode.HIER_BRANCH)
    assert launched == len(plan)


@pytest.mark.parametrize("overrides,per_build", [({}, None), (dict(tree_hier=False), 1),
                                                 (dict(tree_flat_cap=-1), 1),
                                                 (dict(tree_hier_union=False), 1)])
def test_min_dist_wrapper_counts_a_rebuilds_launches(cuda, overrides, per_build):
    """Eager rebuilds of each path: the hierarchical one launches the fused
    opening-test kernel (``min_dist_open``) once a level (every level while
    ``union_coarse``, level 0 alone without it) and the plain distances
    never; the flat and dense paths the distances' kernel once and the
    fused one never. Two rebuilds count twice as much as one."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                         tnb.models.plummer(8192, seed=3), device=cuda)
    before = ct.min_tile_dist.launches, ct.min_dist_open.launches
    for _ in range(2):
        tree_fns(sim.cfg)[0](sim.state.pos, sim.state.mass)
    torch.cuda.synchronize()
    if per_build is None:
        per_build = len(treecode._level_plan(8192 // sim.cfg.tree_src_tile, treecode.HIER_BRANCH))
    moved = ct.min_tile_dist.launches - before[0], ct.min_dist_open.launches - before[1]
    hier = tree_path(sim.cfg) == "hier"
    assert moved == ((0, 2 * per_build) if hier else (2 * per_build, 0))


def test_min_dist_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    x, y, z, _ = _min_dist_columns(cuda, 1024)
    cen = (x[:64], y[:64], z[:64])
    with pytest.raises(TypeError, match="float32"):
        ct.min_tile_dist(x.double(), y, z, *cen, 128)
    with pytest.raises(TypeError, match="float32"):
        ct.min_tile_dist(x, y, z, cen[0].double(), *cen[1:], 128)
    strided = torch.stack([x, y, z], 1)
    with pytest.raises(ValueError, match="contiguous"):
        ct.min_tile_dist(*strided.unbind(1), *cen, 128)
    with pytest.raises(ValueError, match="multiple of tile"):
        ct.min_tile_dist(x[:1000], y[:1000], z[:1000], *cen, 128)
    with pytest.raises(ValueError, match="is on"):
        ct.min_tile_dist(x, y, z, cen[0].cpu(), *cen[1:], 128)


# --------------------------------- the hierarchical build's opening test
# (label, level, mac, rows): the defaults' level 0 (flat MAC) and coarse
# levels (hierarchical MAC), the hierarchical MAC and the geometric test at
# level 0 and at a coarse level, and a sharded rank's rows (rank 1 of 4, its
# row offset) at level 0 and at a coarse level, of the 65,536-body plan.
OPEN_CASES = [("level 0 flat", 0, "flat", "all"), ("level 0 hier", 0, "hier", "all"),
              ("level 0 geometric", 0, "geometric", "all"), ("level 3 hier", 3, "hier", "all"),
              ("level 3 geometric", 3, "geometric", "all"),
              ("level 0 flat rank 1 of 4", 0, "flat", "quarter"),
              ("level 2 hier rank 1 of 4", 2, "hier", "quarter")]


@pytest.fixture(scope="module")
def open_inputs(cuda):
    """The columns, level summaries and MAC scale of 65,536 Plummer bodies,
    Morton-sorted as the build takes them (so that nodes open and close)."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.utils.morton import morton_argsort

    x, y, z, m = _min_dist_columns(cuda, 65536)
    perm = torch.as_tensor(morton_argsort(torch.stack([x, y, z], 1).cpu().numpy()), device=cuda)
    x, y, z, m = (a[perm].contiguous() for a in (x, y, z, m))
    plan = treecode._level_plan(65536 // 64, treecode.HIER_BRANCH)
    levels = treecode._level_summaries(x, y, z, m, 64, plan, treecode.HIER_BRANCH)
    a_med = torch.clamp(treecode._median_monopole_acc(x, y, z, *levels[0][:4], eps2=1e-6,
                                                      c2=0.01), min=1e-12)
    return (x, y, z), levels, a_med


def _open_args(open_inputs, level, mac, rows):
    """(columns, centres, keywords) of ``min_dist_open`` as the build passes
    them for one level."""
    from n_body_problem_tpu_torch.ops import treecode

    cols, levels, a_med = open_inputs
    row_offset = 0
    if rows == "quarter":
        q = cols[0].shape[0] // 4
        cols, row_offset = tuple(c[q:2 * q].contiguous() for c in cols), q // 128
    cx, cy, cz, m, radius, rms2, _ = levels[level]
    if mac == "flat":
        amp, thresh = treecode._flat_mac(m, radius, 2e-4)
    elif mac == "hier":
        amp, thresh = m * rms2 * radius, 0.01
    else:
        amp, thresh, a_med = None, 0.55, None
    kw = dict(mac=mac, thresh=thresh, amp=amp, radius=radius.contiguous(),
              mass=m.contiguous(), a_med=a_med, node_bodies=65536 // cx.shape[0],
              row_offset=row_offset, score=level == 0)
    return cols, tuple(c.contiguous() for c in (cx, cy, cz)), kw


def _same_floats(a, b):
    """float32 tensors equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.parametrize("label,level,mac,rows", OPEN_CASES, ids=[c[0] for c in OPEN_CASES])
def test_min_dist_open_kernel_is_its_plain_twin_bitwise(cuda, open_inputs, label, level, mac,
                                                        rows):
    """The fused kernel's opens, far keys and (level 0) scores: bitwise its
    plain twin's, and the same bits from two launches, one launch each."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    cols, cen, kw = _open_args(open_inputs, level, mac, rows)
    before = ct.min_dist_open.launches
    got, again = ct.min_dist_open(*cols, *cen, 128, **kw), ct.min_dist_open(*cols, *cen, 128, **kw)
    want = ct.min_dist_open_plain(*cols, *cen, 128, **kw)
    torch.cuda.synchronize()
    assert ct.min_dist_open.launches - before == 2
    shape = (cols[0].shape[0] // 128, cen[0].shape[0])
    for g in (got, again):
        assert g[0].dtype == torch.bool and g[0].shape == shape
        assert torch.equal(g[0], want[0]) and _same_floats(g[1], want[1])
        assert (g[2] is None) == (want[2] is None) == (level != 0)
        assert g[2] is None or _same_floats(g[2], want[2])
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("level,mac", [(0, "flat"), (2, "hier")])
def test_min_dist_open_kernel_carries_nans_as_its_twin(cuda, open_inputs, level, mac):
    """A NaN body, a NaN centre and infinite centres: NaN scores and far
    keys where the twin has them, closed nodes there, the rest bitwise."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    cols, cen, kw = _open_args(open_inputs, level, mac, "all")
    cols, cen = [c.clone() for c in cols], [c.clone() for c in cen]
    cols[1][7 * 128 + 5] = float("nan")
    cols[0][9 * 128] = float("inf")
    cen[2][3] = float("nan")
    cen[0][4] = float("-inf")
    cen[0][5] = float("inf")
    got = ct.min_dist_open(*cols, *cen, 128, **kw)
    want = ct.min_dist_open_plain(*cols, *cen, 128, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(want[1][7]).all() and torch.isnan(want[1][:, 3]).all()
    assert torch.equal(got[0], want[0]) and _same_floats(got[1], want[1])
    assert got[2] is None or _same_floats(got[2], want[2])


def test_min_dist_open_rejects_what_the_kernel_does_not_take(cuda, open_inputs):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    cols, cen, kw = _open_args(open_inputs, 0, "flat", "all")
    with pytest.raises(ValueError, match="mac="):
        ct.min_dist_open(*cols, *cen, 128, **dict(kw, mac="bh"))
    with pytest.raises(TypeError, match="a_med"):
        ct.min_dist_open(*cols, *cen, 128, **dict(kw, a_med=None))
    with pytest.raises(TypeError, match="float32"):
        ct.min_dist_open(*cols, *cen, 128, **dict(kw, mass=kw["mass"].double()))
    with pytest.raises(ValueError, match="shape"):
        ct.min_dist_open(*cols, *cen, 128, **dict(kw, amp=kw["amp"][:-1]))
    with pytest.raises(ValueError, match="multiple of tile"):
        ct.min_dist_open(*(c[:1000] for c in cols), *cen, 128, **kw)


# ---------------------------------------- the work lists' row selection
# (label, rows, cols, k): the 1,048,576 plan's near and far selections with
# the planner's k (seed 1), AGORA's at full width with its k (fewer rows),
# the VIP pick (one row), the dense path's square (k the whole row), one
# column, k = 1, and a k past the kernel's shared memory (its scratch).
TOP_K_SHAPES = [("1M near", 8192, 16384, 1024), ("1M far", 8192, 32752, 4736),
                ("AGORA near", 256, 33204, 2496), ("AGORA far", 256, 58107, 11456),
                ("VIP", 1, 16384, 64), ("dense", 64, 64, 64), ("one column", 5, 1, 1),
                ("k = 1", 100, 4097, 1), ("scratch", 3, 58107, 20000),
                ("whole row", 2, 58107, 58107)]


def _score_rows(device, rows, cols, live=0.05, seed=0):
    """Rows as the build's scores are: sentinels (-1.0), a +inf self-overlap
    every 97 columns, a share of live positive scores, some of them equal."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.full((rows, cols), -1.0, device=device)
    pick = torch.rand((rows, cols), generator=g, device=device) < live
    score = torch.rand((rows, cols), generator=g, device=device) * 10
    score = torch.where(torch.rand((rows, cols), generator=g, device=device) < 0.1,
                        torch.round(score), score)
    x = torch.where(pick, score, x)
    x[:, ::97] = float("inf")
    return x


def _same_bits(got, want) -> bool:
    return (torch.equal(got[0].view(torch.int32), want[0].contiguous().view(torch.int32))
            and torch.equal(got[1], want[1]))


@pytest.mark.parametrize("label,rows,cols,k", TOP_K_SHAPES, ids=[s[0] for s in TOP_K_SHAPES])
def test_top_k_kernel_is_its_plain_twin_bitwise(cuda, label, rows, cols, k):
    """Values and indices every bit the twin's (torch.sort on the card), at
    sentinel-heavy and live rows, and the same bits from two launches."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    for live in (0.02, 0.5):
        x = _score_rows(cuda, rows, cols, live=live)
        before = ct.top_k.launches
        got, again = ct.top_k(x, k), ct.top_k(x, k)
        want = ct.top_k_plain(x, k)
        torch.cuda.synchronize()
        assert ct.top_k.launches - before == 2
        assert got[0].shape == got[1].shape == (rows, k) and got[1].dtype == torch.int64
        assert _same_bits(got, want) and _same_bits(got, again), (label, live)


@pytest.mark.parametrize("cols", [16, 129, 4097, 40000])
def test_top_k_kernel_orders_special_values_as_its_twin(cuda, cols):
    """+-0.0 (tied, by column), +-inf, denormals and NaNs of either sign and
    several payloads (by their bits: a positive one first, a negative one
    last), scattered among sentinels: every k the same bits as the twin."""
    import numpy as np

    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    special = np.array([0x00000000, 0x80000000, 0x7fc00000, 0xffc00000, 0x7f800001,
                        0x7fffffff, 0x7f800000, 0xff800000, 0x00000001, 0x80000001,
                        0x007fffff, 0x3f800000, 0x00000000, 0x80000000, 0x7fc00001],
                       dtype=np.uint32)
    rng = np.random.default_rng(cols)
    bits = np.full((6, cols), 0xbf800000, np.uint32)
    for r in range(6):
        at = rng.choice(cols, size=min(cols, len(special)), replace=False)
        bits[r, at] = special[:len(at)]
    x = torch.from_numpy(bits.view(np.float32).copy()).to(cuda)
    for k in sorted({1, 5, min(cols, 15), cols}):
        got, want = ct.top_k(x, k), ct.top_k_plain(x, k)
        torch.cuda.synchronize()
        assert _same_bits(got, want), k


@pytest.mark.parametrize("n", [65536, 1048576])
def test_top_k_kernel_builds_the_twins_lists(cuda, monkeypatch, n):
    """The hierarchical build on the card: the same four lists and VIP mask,
    element for element, with the kernel and with the plain twin; three
    selections a rebuild (the VIP pick, the near and the far lists)."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_kwargs

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode"), tnb.models.plummer(n, seed=5),
                         device=cuda)
    build_kw, _ = tree_kwargs(sim.cfg)
    cols = (*sim.state.pos.unbind(1), sim.state.mass)
    before = ct.top_k.launches
    got = treecode.build_tree_hier_cols(*cols, **build_kw)
    launched = ct.top_k.launches - before
    monkeypatch.setattr(ct, "top_k", lambda x, k: ct.top_k_plain(x, k))
    want = treecode.build_tree_hier_cols(*cols, **build_kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launched == (3 if sim.cfg.tree_vip_tiles else 2)


@pytest.mark.parametrize("overrides,lists", [({}, 2), (dict(tree_hier=False), 1),
                                             (dict(tree_flat_cap=-1), 1)])
def test_top_k_wrapper_counts_a_rebuilds_launches(cuda, overrides, lists):
    """An eager rebuild selects once for the VIP pick and once a list: near
    and far on the hierarchical path, the near lists on the flat path, the
    dense path's near tiles."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops.registry import tree_fns

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                         tnb.models.plummer(8192, seed=3), device=cuda)
    before = ct.top_k.launches
    tree_fns(sim.cfg)[0](sim.state.pos, sim.state.mass)
    torch.cuda.synchronize()
    assert ct.top_k.launches - before == lists + (1 if sim.cfg.tree_vip_tiles else 0)


def test_top_k_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    x = _score_rows(cuda, 64, 1000)
    with pytest.raises(TypeError, match="float32"):
        ct.top_k(x.double(), 10)
    with pytest.raises(ValueError, match="row length"):
        ct.top_k(x, 0)
    with pytest.raises(ValueError, match="row length"):
        ct.top_k(x, 1001)
    with pytest.raises(ValueError, match="rows of x must be contiguous"):
        ct.top_k(x.t(), 10)
    with pytest.raises(ValueError, match="2-D"):
        ct.top_k(x[0], 10)
    # A column slice (rows apart, columns contiguous) is taken as it is.
    got = ct.top_k(x[:, 3:903], 10)
    assert _same_bits(got, ct.top_k_plain(x[:, 3:903], 10))


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
            "near": ((ops["bodies"], ops["bodies"], aux[0], aux[1]),
                     dict(n=s.n, n_s=s.n, tile=tile, src_tile=cfg.tree_src_tile,
                          entries=st[2], **phys)),
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
    from n_body_problem_tpu_torch.simulation import make_treecode_run

    sim = tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                         tnb.models.plummer(8192, seed=1), device=cuda)
    sim.run(2)
    run = make_treecode_run(sim.cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, ids, _ = run(sim.state, 10)
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


@pytest.mark.parametrize("width,height", [(1024, 1024), (640, 480)])
def test_splat_on_card_matches_cpu(cuda, width, height):
    """The card's frame (its depthwise sprite convolution, TF32 off) against
    the CPU's within rtol 1e-5 and atol 1e-5 x the frame's maximum; two
    card frames bitwise equal (the accumulation sorts its indices); no host
    sync when the camera and scales come as tensors on the card."""
    from n_body_problem_tpu_torch.render import OrbitCamera, splat_frame

    s = tnb.models.plummer(65536, seed=0)
    cam = OrbitCamera(distance=2.0, aspect=width / height)
    vp, sc = cam.view_projection(), torch.zeros(3)
    kw = dict(width=width, height=height)
    cpu = splat_frame(s.pos, s.mass, s.real_mask(), vp, sc, **kw)
    c = s.to(cuda)
    args = (c.pos, c.mass, c.real_mask(), torch.as_tensor(vp, device=cuda), sc.to(cuda))
    splat_frame(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = splat_frame(*args, **kw)
        again = splat_frame(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert card.device.type == "cuda" and card.shape == (height, width, 3)
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-5 * float(cpu.max()))
    assert torch.equal(card, again)


# ------------------------------------------------- kernel 7's local form
def _rank_near_calls(cuda, monkeypatch, overrides):
    """Four ranks' treecode forces at 65,536 bodies, rank by rank
    (``tree.treecode_acc_ranks``), with each near-kernel call's arguments
    recorded: each rank's rows are the targets, every body the sources."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.parallel import tree as ptree
    from n_body_problem_tpu_torch.parallel.sharded import plan_treecode

    calls, kernel = [], ct.near_field

    def recorder(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    recorder.launches = 0
    monkeypatch.setattr(ct, "near_field", recorder)
    cfg, st, _ = plan_treecode(tnb.SimConfig(solver="treecode", **overrides),
                               tnb.models.plummer(65536, seed=3).to(cuda), 4, "cuda")
    _, lists = ptree.treecode_acc_ranks(cfg, st.pos, st.mass, 4)
    monkeypatch.undo()
    return cfg, st, lists, calls


@pytest.mark.parametrize("overrides", [{}, dict(tree_hier=False)])
def test_near_local_form_matches_plain_at_four_ranks(cuda, monkeypatch, overrides):
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.parallel import tree as ptree

    cfg, st, lists, calls = _rank_near_calls(cuda, monkeypatch, overrides)
    assert len(calls) == 4
    for args, kw in calls:
        assert (kw["n"], kw["n_s"]) == (st.n // 4, st.n) and args[0] is not args[1]
        got, again = ct.near_field(*args, **kw), ct.near_field(*args, **kw)
        torch.testing.assert_close(got, ct.near_field_plain(*args, **kw), **TOL)
        assert torch.equal(got, again)
    # The ranks' rows are the rows of one call on their merged lists, bitwise.
    path = ptree.sharded_path(cfg)
    merged = ptree.merge_rank_lists(path, lists, st.n // 4 // cfg.tree_tile,
                                    treecode.CHUNK_LANES // cfg.tree_src_tile)
    bodies = calls[0][0][1]
    one = ct.near_field(bodies, bodies, merged[0], merged[1], **dict(calls[0][1], n=st.n))
    assert torch.equal(one, torch.cat([ct.near_field(*a, **k) for a, k in calls]))


def test_near_kernel_at_one_device_is_its_earlier_output(cuda):
    """The same array as targets and sources: bitwise the output the kernel
    gave before it took them apart (``kernel_compare.NEAR_GOLDEN_SHA256``)."""
    import hashlib

    from n_body_problem_tpu_torch.kernel_compare import NEAR_GOLDEN_SHA256, near_golden_case
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    args, kw = near_golden_case(cuda)
    out = ct.near_field(*args, **kw)
    assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() == NEAR_GOLDEN_SHA256


# ------------------------------------------------ CUDA graphs of the run
GRAPH_PATHS = [{}, dict(tree_hier=False), dict(tree_flat_cap=-1)]   # hier, flat, dense

# The kernels a rebuild launches (counted a call: each call restarts the
# cadence), not a step.
BUILD_WRAPPERS = (cuda_treecode.min_tile_dist, cuda_treecode.min_dist_open, cuda_treecode.top_k)


def _graph_sim(cuda, overrides, n=8192):
    return tnb.Simulation(tnb.SimConfig(solver="treecode", **overrides),
                          tnb.models.plummer(n, seed=1), device=cuda)


@pytest.mark.parametrize("overrides", GRAPH_PATHS)
def test_graph_run_is_the_eager_loop_bitwise(cuda, overrides):
    """``Simulation.run``'s replays against ``make_treecode_run`` on the same
    state, two whole chunks and a remainder, over two calls: the state and
    ``sort_perm`` bitwise (kernels 3-9 are bitwise repeatable)."""
    from n_body_problem_tpu_torch.graphs import clone_state
    from n_body_problem_tpu_torch.simulation import make_treecode_run

    sim = _graph_sim(cuda, overrides)
    ref = make_treecode_run(sim.cfg)
    steps = 2 * sim.cfg.tree_rebuild_every + 3
    state, perm = clone_state(sim.state), sim.sort_perm
    for _ in range(2):
        state, ids, aux = ref(state, steps)
        perm = perm[ids[: state.n_real].cpu().numpy()]
        got = sim.run(steps)
        for f in ("pos", "vel", "acc", "mass", "time", "step"):
            assert torch.equal(getattr(got, f), getattr(state, f)), f
        assert (sim.sort_perm == perm).all()
        assert all(torch.equal(a, b) for a, b in zip(sim.tree_lists, aux))
    assert sim.capture_seconds > 0
    assert all(p.graph is not None for p in sim._static._programs.values())


@pytest.mark.parametrize("overrides", GRAPH_PATHS)
def test_graph_replays_never_wait_for_the_host(cuda, overrides):
    """The replays of 10 steps (resort, build and step graphs) under
    ``set_sync_debug_mode("error")``."""
    sim = _graph_sim(cuda, overrides)
    sim.run(2)   # captures
    g, programs = sim._prepare(True, 10)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim._chunks(programs, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sim._unload_tree(10)
    torch.cuda.synchronize()
    assert torch.isfinite(sim.state.pos).all() and int(sim.state.step) == 12


@pytest.mark.parametrize("overrides", GRAPH_PATHS)
def test_graph_counters_count_replays(cuda, overrides):
    """Every replay adds the launches its capture recorded; the warm-up and
    the capture add none: the first run counts as the later ones do."""
    from n_body_problem_tpu_torch.graphs import counted

    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    sim = _graph_sim(cuda, overrides)
    wrappers = counted()
    moves = []
    for steps in (5, 5, 7):
        before = [w.launches for w in wrappers]
        sim.run(steps)
        # The step's kernels a step; the build's a call (one rebuild: each
        # call restarts the cadence of 8).
        moves.append([(w.launches - b) / (1 if w in BUILD_WRAPPERS else steps)
                      for w, b in zip(wrappers, before)])
    assert moves[0] == moves[1] == moves[2] and sum(moves[0]) >= 3
    assert (moves[0][wrappers.index(ct.min_tile_dist)]
            + moves[0][wrappers.index(ct.min_dist_open)]) >= 1
    assert moves[0][wrappers.index(ct.top_k)] >= 1


def test_exact_graph_run_matches_the_eager_loop(cuda):
    """Kernels 1 and 2 bitwise after 12 steps, the launches a step each
    call makes."""
    from n_body_problem_tpu_torch.graphs import clone_state
    from n_body_problem_tpu_torch.simulation import make_step_fn, run_steps

    for solver, steps, wrapper in (("pallas", 12, cuda_force.block_acc),
                                   ("pallas_symmetric", 12, cuda_symmetric.symmetric_acc)):
        sim = tnb.Simulation(tnb.SimConfig(solver=solver), tnb.models.plummer(4096, seed=2),
                             device=cuda)
        want = run_steps(clone_state(sim.state), make_step_fn(sim.cfg, "cuda", sim.state.n),
                         steps)
        before = wrapper.launches
        got = sim.run(steps)
        a_step = (2 if cuda_force.allpairs_split(sim.state.n, sim.state.n)[2] > 1 else 1
                  ) if solver == "pallas" else cuda_symmetric.LAUNCHES_A_CALL
        assert wrapper.launches - before == steps * a_step
        assert torch.equal(got.pos, want.pos) and torch.equal(got.acc, want.acc)
        assert torch.equal(got.vel, want.vel)


# (label, config, N, steps): the default solver at the JAX determinism
# test's shape and a leapfrog run at 65,536, in each precision; the foil.
REPEAT_RUNS = [(f"{solver} {precision} {n}", dict(solver=solver, pallas_sym_precision=precision,
                                                  integrator=integ), n, steps)
               for solver in ("auto", "pallas_symmetric")
               for precision in ("f32", "bf16x3", "mixed")
               for n, steps, integ in ((128, 25, "semi_implicit_euler"),
                                       (65536, 200, "leapfrog"))] + [
    ("pair_matrix 128", dict(solver="pair_matrix"), 128, 25),
    ("pair_matrix 4096", dict(solver="pair_matrix", integrator="leapfrog"), 4096, 20)]


@pytest.mark.parametrize("label,overrides,n,steps", REPEAT_RUNS, ids=[r[0] for r in REPEAT_RUNS])
def test_runs_repeat_bitwise(cuda, label, overrides, n, steps):
    """tests/test_determinism.py on the card: two runs from one state end
    bitwise equal (the symmetric kernels sum their slots in slot order, the
    foil sorts before it adds)."""
    ends = []
    for _ in range(2):
        sim = tnb.Simulation(tnb.SimConfig(**overrides), tnb.models.plummer(n, seed=0),
                             device=cuda)
        sim.run(steps)
        torch.cuda.synchronize()
        ends.append((sim.state.pos.clone(), sim.state.vel.clone(), sim.solver))
    assert ends[0][2] == ("pair_matrix" if "pair_matrix" in label else "pallas_symmetric")
    assert torch.isfinite(ends[0][0]).all()
    assert torch.equal(ends[0][0], ends[1][0]) and torch.equal(ends[0][1], ends[1][1])


def test_graph_memory_is_released_with_its_simulation(cuda):
    """A simulation's static buffers and graph pool go with it."""
    import gc

    for _ in range(2):   # the first round leaves what a process keeps
        sim = _graph_sim(cuda, {})
        sim.run(4)
        del sim
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
    sim = _graph_sim(cuda, {})
    sim.run(4)
    assert torch.cuda.memory_allocated(cuda) > base
    del sim
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == base


# ------------------------------------------ the frames and the sharded run
@pytest.mark.parametrize("overrides", GRAPH_PATHS)
def test_graph_frames_are_the_eager_frame_loop_bitwise(cuda, overrides):
    """``movie`` (two cameras and scales, the second replaying the graphs
    the first captured) and ``trajectory``, two frames of three steps, on
    the hierarchical, flat and dense paths: the frames, the state and
    ``sort_perm`` bitwise the eager frame loop's from the same state."""
    from n_body_problem_tpu_torch.render import OrbitCamera
    from n_body_problem_tpu_torch.simulation import eager_movie, eager_trajectory

    sim = _graph_sim(cuda, overrides)
    kw = dict(width=256, height=192)
    cams = ((OrbitCamera(distance=2.0), (0.0, 0.0, 0.0)),
            (OrbitCamera(theta_deg=30.0, distance=2.5), (0.5, 0.5, 0.5)))
    for i, (cam, scale) in enumerate(cams):
        want, state, perm = eager_movie(sim, 6, 3, cam, scale, **kw)
        got = sim.movie(6, 3, cam, scale, **kw)
        if i == 0:
            captured, programs = sim.capture_seconds, len(sim._static._programs)
        assert torch.equal(got, want) and float(got.max()) > 0
        assert torch.equal(sim.state.pos, state.pos) and (sim.sort_perm == perm).all()
    assert sim.capture_seconds == captured and len(sim._static._programs) == programs
    want, state, perm = eager_trajectory(sim, 6, save_every=3)
    got = sim.trajectory(6, save_every=3)
    assert torch.equal(got, want) and torch.equal(sim.state.vel, state.vel)
    assert (sim.sort_perm == perm).all()


@pytest.mark.parametrize("method", ["movie", "trajectory"])
def test_graph_frames_never_wait_for_the_host(cuda, method):
    """The replays of a movie's or a trajectory's spans and frames (four
    frames of two steps, hierarchical path) under
    ``set_sync_debug_mode("error")``."""
    from n_body_problem_tpu_torch.render import OrbitCamera

    sim = _graph_sim(cuda, {})
    key = "movie 128x96" if method == "movie" else "trajectory"
    if method == "movie":
        sim.movie(8, 2, OrbitCamera(distance=2.0), width=128, height=96)   # captures
    else:
        sim.trajectory(8, save_every=2)
    g, programs = sim._prepare(True, 8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = sim._replay_frames(programs, g._programs[key], key, 8, 2, "every")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sim._unload_tree(8)
    torch.cuda.synchronize()
    assert frames.shape[0] == 4 and torch.isfinite(frames).all() and int(sim.state.step) == 16


def test_graph_frame_counters_count_replays(cuda):
    """A movie counts the kernels of its steps, replays counted, the same on
    its first (capturing) call as on the next, and as ``run`` of as many
    steps (the frame launches no kernel of the port)."""
    from n_body_problem_tpu_torch.graphs import counted
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.render import OrbitCamera

    sim = _graph_sim(cuda, {})
    wrappers = counted()
    moves = []
    for call in ("movie", "movie", "run"):
        before = [w.launches for w in wrappers]
        if call == "movie":
            sim.movie(8, 2, OrbitCamera(distance=2.0), width=128, height=96)
        else:
            sim.run(8)
        moves.append([w.launches - b for w, b in zip(wrappers, before)])
    # The build's kernels count rebuilds: each of the movie's four 2-step
    # frame spans starts a chunk, and run(8) is one chunk. The hierarchical
    # build's distances are the fused opening test's.
    for w in BUILD_WRAPPERS:
        at = wrappers.index(w)
        build = [m[at] for m in moves]
        assert build[0] == build[1] == 4 * build[2]
        assert (build[2] > 0) == (w is not ct.min_tile_dist)
    moves = [[v for i, v in enumerate(m) if wrappers[i] not in BUILD_WRAPPERS] for m in moves]
    assert moves[0] == moves[1] == moves[2] and sum(moves[0]) >= 3 * 8


@pytest.mark.parametrize("strategy", ["ring", "half_ring", "treecode", "treecode_staged"])
def test_nccl_world_of_one_replays_its_eager_loop_bitwise(cuda, tmp_path, strategy):
    """``ShardedSimulation`` in an NCCL world of one rank, in this process:
    two calls of ``run`` (replays of graphs captured on the first) bitwise
    its eager loop (``sharded.eager_run``) from the same state, state and
    ``sort_perm``. (A world of one rank issues no collective: this holds the
    programs, not a captured NCCL call.)"""
    import torch.distributed as dist

    from n_body_problem_tpu_torch.parallel import ShardedSimulation, eager_run, make_ring_mesh

    exact = strategy in ("ring", "half_ring")
    cfg = tnb.SimConfig(solver="pallas" if exact else "treecode", integrator="leapfrog")
    n = 4096 if exact else 16384
    dist.init_process_group("nccl", init_method=(tmp_path / "rendezvous").as_uri(),
                            world_size=1, rank=0)
    try:
        sim = ShardedSimulation(cfg, tnb.models.plummer(n, seed=3),
                                make_ring_mesh(1, device="cuda"), strategy=strategy)
        steps = 5 if exact else 2 * sim.cfg.tree_rebuild_every + 3
        for _ in range(2):
            want, perm = eager_run(sim, steps)
            got = sim.run(steps)
            for f in ("pos", "vel", "acc", "time", "step"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert perm is None if exact else (sim.sort_perm == perm).all()
        assert sim.capture_seconds > 0
    finally:
        dist.destroy_process_group()
