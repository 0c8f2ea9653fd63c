"""The schedules the all-pairs kernel, the symmetric kernels, the near
kernel, the VIP sweep, the far field, the single-level far field and the
near-panel kernel are launched with, on the CPU.

The CUDA kernels run only on the card; what a block does there is decided
by integers that Python computes (``cuda_force.allpairs_split``,
``allpairs_columns``; ``cuda_symmetric.symmetric_blocks``, ``block_tiles``,
``FAST_SHAPE``; ``cuda_treecode.near_split``, ``near_parts``, ``vip_split``,
``far_split``, ``far_parts``, ``single_split``, ``single_parts``,
``panel_split``). These tests
check those integers, and walk each schedule
block by block in plain PyTorch, as the kernel does, against the plain twins
and the JAX package's Pallas kernels in interpret mode, within rtol=1e-4,
atol=2e-6 (the bound the CUDA kernels are held to on the card).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu import models as jmodels
from n_body_problem_tpu.ops import treecode as jtc
from n_body_problem_tpu.ops.pallas_force import pallas_block_acc
from n_body_problem_tpu.ops.pallas_symmetric import symmetric_acc as jax_symmetric_acc
from n_body_problem_tpu.utils.morton import morton_argsort
from n_body_problem_tpu_torch.kernel_compare import allpairs_sweep
from n_body_problem_tpu_torch.ops import cuda_force as cf
from n_body_problem_tpu_torch.ops import cuda_symmetric as cs
from n_body_problem_tpu_torch.ops import cuda_treecode as ct
from n_body_problem_tpu_torch.ops import treecode as ttc
from n_body_problem_tpu_torch.state import pad_state_to

EPS2, COMP = 1e-6, 0.1
C2 = COMP * COMP
TOL = dict(rtol=1e-4, atol=2e-6)
T = cs.KERNEL_TILE


# ------------------------------------------------- the all-pairs schedule
def _check_allpairs_split(ni, nj, split):
    """Rows x parts x pieces take every (row, column) once, inside the
    kernel's limits."""
    rows, parts, pieces = split
    assert parts in cf.ALLPAIRS_PARTS and rows * parts == cf.ALLPAIRS_BLOCK_ROWS
    assert 1 <= pieces <= 65535
    per = cf.stages_a_piece(nj, pieces)
    assert pieces * per * cf.ALLPAIRS_STAGE >= nj            # the pieces reach Nj
    assert nj == 0 or (pieces - 1) * per * cf.ALLPAIRS_STAGE < nj   # and none is empty
    # Row blocks of `rows` bodies cover 0 .. Ni once.
    row_blocks = -(-ni // rows)
    assert (row_blocks - 1) * rows < ni <= row_blocks * rows or ni == 0
    columns = cf.allpairs_columns(nj, parts, pieces)
    assert len(columns) == pieces and all(len(piece) == parts for piece in columns)
    runs = sorted((r.start, r.stop) for piece in columns for part in piece for r in part
                  if len(r))
    at = 0
    for start, stop in runs:                                 # a partition of 0 .. Nj
        assert start == at
        at = stop
    assert at == nj
    for piece in columns:                                    # a part's runs in stage order
        for part in piece:
            assert [r.start for r in part] == sorted(r.start for r in part)
            assert all(len(r) <= cf.ALLPAIRS_STAGE // parts for r in part)
    # The parts' sums (three floats a row, parts - 1 of them) fit the stage
    # buffer they are handed over in.
    assert (parts - 1) * 3 * rows <= cf.ALLPAIRS_STAGE * 4


@pytest.mark.parametrize("nj", [256, 1000, 65536, 524288])
@pytest.mark.parametrize("ni", [1, 384, 2048, 8192, 65536])
def test_allpairs_split_covers_every_row_and_column_once(ni, nj):
    split = cf.allpairs_split(ni, nj)
    _check_allpairs_split(ni, nj, split)
    rows, parts, pieces = split
    # Enough blocks to fill the card (whole stages a piece can leave the
    # count short of the aim, never below half of it), unless the columns
    # are too few to cut.
    blocks = -(-ni // rows) * pieces
    assert (rows, parts) == (128, 8)
    assert (blocks >= cf.ALLPAIRS_MIN_BLOCKS if pieces == 1 and nj > cf.ALLPAIRS_STAGE else
            2 * blocks >= cf.ALLPAIRS_CUT_BLOCKS or pieces == -(-nj // cf.ALLPAIRS_STAGE))
    for other in allpairs_sweep(ni, nj):
        _check_allpairs_split(ni, nj, other)


def test_allpairs_split_on_the_main_paths():
    """Blocks of 128 rows in 8 parts everywhere. The exact step and ``auto``
    above 262,144 take one piece, so one launch a step; the error probe's
    2,048 sampled rows and a four-way ring's share of 65,536 are cut into
    column pieces, to about eight blocks a multiprocessor."""
    assert cf.allpairs_split(65536, 65536) == (128, 8, 1)
    assert cf.allpairs_split(262144, 262144) == (128, 8, 1)
    assert cf.allpairs_split(524288, 524288) == (128, 8, 1)
    assert cf.allpairs_split(1048576, 1048576) == (128, 8, 1)
    assert cf.allpairs_split(33792, 33792) == (128, 8, 1)    # 264 row blocks
    assert cf.allpairs_split(32768, 32768) == (128, 8, 5)
    assert cf.allpairs_split(2048, 524288) == (128, 8, 64)
    assert cf.allpairs_split(2048, 65536) == (128, 8, 64)
    assert cf.allpairs_split(16384, 65536) == (128, 8, 8)
    assert cf.allpairs_split(8192, 8192) == (128, 8, 8)      # no more pieces than stages
    assert cf.allpairs_split(0, 0) == (128, 8, 1)


def test_allpairs_split_rejects_nonsense():
    for ni, nj in ((-1, 4), (4, -1)):
        with pytest.raises(ValueError):
            cf.allpairs_split(ni, nj)


def _walk_allpairs(pos_i, pos_j, mass_j, split):
    """The all-pairs kernel's sums in its order: a part's columns stage by
    stage, the parts of a block in part order, the pieces in piece order."""
    cols = torch.cat([pos_j, (mass_j * (C2 * COMP))[:, None]], dim=1)
    _, parts, pieces = split
    out = None
    for piece in cf.allpairs_columns(pos_j.shape[0], parts, pieces):
        block = None
        for part in piece:
            acc = torch.zeros((pos_i.shape[0], 3))
            for run in part:
                src = cols[run.start:run.stop]
                d = src[None, :, :3] - pos_i[:, None, :]
                r2 = d[..., 2] * d[..., 2] + (d[..., 1] * d[..., 1] + d[..., 0] * d[..., 0])
                inv = torch.rsqrt(r2 * C2 + EPS2)
                acc = acc + ((src[None, :, 3] * (inv * inv * inv))[..., None] * d).sum(1)
            block = acc if block is None else block + acc
        out = block if out is None else out + block
    return out


@pytest.mark.parametrize("ni,nj,split", [(384, 4096, None), (384, 4096, (512, 2, 3)),
                                         (128, 2560, (1024, 1, 1)), (256, 2560, (256, 4, 2))])
def test_allpairs_walk_matches_plain_and_jax(ni, nj, split):
    """384 rows against 4,096 columns are cut into 4 pieces (one a stage) of
    8 parts by the rule itself; other splits of the same work give the same
    force."""
    rng = np.random.default_rng(17)
    pos_j = rng.normal(size=(nj, 3)).astype(np.float32)
    pos_i = (rng.normal(size=(ni, 3)) + 0.25).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, size=nj).astype(np.float32) / nj
    mass[-60:] = 0.0                                         # padding bodies
    ti, tj, tm = (torch.from_numpy(a.copy()) for a in (pos_i, pos_j, mass))
    if split is None:
        split = cf.allpairs_split(ni, nj)
        assert split == (128, 8, 4)
    got = _walk_allpairs(ti, tj, tm, split)
    plain = cf.block_acc_plain(ti, tj, tm, eps2=EPS2, compensate=COMP)
    torch.testing.assert_close(got, plain, **TOL)
    # The wrapper on the CPU: the twin.
    torch.testing.assert_close(cf.block_acc(ti, tj, tm, eps2=EPS2, compensate=COMP,
                                            tile_i=128, tile_j=256), plain, rtol=0, atol=0)
    want = np.asarray(pallas_block_acc(pos_i, pos_j, mass, eps2=EPS2, compensate=COMP,
                                       tile_i=128, tile_j=256, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------- the symmetric schedule
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 128, 129])
def test_symmetric_schedule_covers_every_tile_pair_once(k):
    """Every unordered pair of tiles in exactly one block, the tile with
    itself as diagonal 0 (the strict upper triangle); for even K the last
    diagonal on the rows i < K/2 only."""
    blocks = cs.symmetric_blocks(k)
    assert blocks == k * (k // 2 + 1)
    seen, idle = collections.Counter(), 0
    for b in range(blocks):
        tiles = cs.block_tiles(k, b)
        if tiles is None:
            idle += 1
            continue
        i, s, j = tiles
        assert i == b % k and s == b // k
        assert 0 <= s <= k // 2 and j == (i + s) % k
        assert (s == 0) == (i == j)
        if k % 2 == 0 and s == k // 2:
            assert i < k // 2
        seen[frozenset((i, j))] += 1
    assert len(seen) == k * (k + 1) // 2
    assert set(seen.values()) == {1}
    # Only the upper half of an even K's last diagonal does nothing.
    assert idle == (k // 2 if k % 2 == 0 else 0)


@pytest.mark.parametrize("k,want", [(1, 1), (2, 4), (3, 6), (16, 144), (128, 8320),
                                    (512, 131584)])
def test_symmetric_grid_is_one_block_a_tile_and_diagonal(k, want):
    """65,536 bodies are 128 tiles and 8,320 blocks, 262,144 are 512 and
    131,584: tens of blocks a multiprocessor at the sizes `auto` gives the
    kernel, and inside the grid's 2^31 - 1 limit far beyond them."""
    assert cs.symmetric_blocks(k) == want
    assert cs.symmetric_blocks(k) < 2 ** 31


def test_symmetric_schedule_rejects_nonsense():
    for k in (0, -1):
        with pytest.raises(ValueError):
            cs.symmetric_blocks(k)


def _walk_symmetric(body):
    """The f32 kernel's sums, block by block: each block adds its row tile's
    action and its column tile's reaction once."""
    k = body.shape[0] // T
    p, m = body[:, :3].reshape(k, T, 3), body[:, 3].reshape(k, T)
    out = torch.zeros((k, T, 3))
    rid = torch.arange(T)
    upper = (rid[None, :] > rid[:, None]).float()          # (row, col): col > row
    for b in range(cs.symmetric_blocks(k)):
        tiles = cs.block_tiles(k, b)
        if tiles is None:
            continue
        i, s, j = tiles
        d = p[j][None, :, :] - p[i][:, None, :]            # (row, col, 3)
        r2 = d[..., 2] * d[..., 2] + (d[..., 1] * d[..., 1] + d[..., 0] * d[..., 0])
        inv = torch.rsqrt(r2 * C2 + EPS2)
        u = inv * inv * inv
        if s == 0:
            u = u * upper
        out[i] += ((m[j][None, :] * u)[..., None] * d).sum(1)
        out[j] -= ((m[i][:, None] * u)[..., None] * d).sum(0)
    return out.reshape(-1, 3)


def _plummer(n_real, multiple, seed):
    st = jnb.pad_state(jmodels.plummer(n_real, seed=seed), multiple=multiple)
    pos, mass = np.asarray(st.pos), np.asarray(st.mass)
    return (pos, mass), (torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy()))


@pytest.mark.parametrize("n", [1024, 1536])
def test_symmetric_walk_matches_plain_and_jax(n):
    """K = 2 (the even-K last diagonal) and K = 3 (odd) of the kernel's
    512-body tile."""
    (pos, mass), (tpos, tmass) = _plummer(n, T, seed=21)
    body = cs.kernel_bodies(tpos, tmass, compensate=COMP, G=1.0)
    assert body.shape == (n, 4)
    plain = cs.symmetric_acc_plain(tpos, tmass, eps2=EPS2, compensate=COMP, tile=T)
    want = np.asarray(jax_symmetric_acc(pos, mass, eps2=EPS2, compensate=COMP, tile=T))
    got = _walk_symmetric(body)
    torch.testing.assert_close(got, plain, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    net = (tmass[:, None] * got).sum(0)
    np.testing.assert_allclose(net.numpy(), np.zeros(3), atol=1e-6)


@pytest.mark.parametrize("n_real,n,tile", [(448, 448, 64), (934, 934, None), (934, 1024, 512)])
def test_symmetric_wrapper_pads_to_the_kernel_tile(n_real, n, tile):
    """N = 448 (tile 64, which JAX takes) and N = 934 become 512 and 1,024
    rows with zero-mass bodies at the origin; the walk over the padded rows
    gives the real bodies the twin's force, and the direct sum's."""
    state = pad_state_to(tnb.models.plummer(n_real, seed=8), n)
    body = cs.kernel_bodies(state.pos, state.mass, compensate=COMP, G=1.0)
    n_pad = n + (-n % T)
    assert body.shape == (n_pad, 4) and n_pad % T == 0
    assert not body[n_real:].any()
    torch.testing.assert_close(body[:n, :3], state.pos, rtol=0, atol=0)
    torch.testing.assert_close(body[:n, 3], state.mass * (C2 * COMP), rtol=0, atol=0)
    got = _walk_symmetric(body)[:n]
    want = tnb.ops.direct_acc(state.pos, state.mass, eps2=EPS2, compensate=COMP)
    torch.testing.assert_close(got, want, **TOL)
    if tile:
        torch.testing.assert_close(got, cs.symmetric_acc_plain(
            state.pos, state.mass, eps2=EPS2, compensate=COMP, tile=tile), **TOL)
        # The wrapper on the CPU: the twin, at the caller's tile.
        torch.testing.assert_close(got, cs.symmetric_acc(
            state.pos, state.mass, eps2=EPS2, compensate=COMP, tile=tile), **TOL)


@pytest.mark.parametrize("tile", [64, 448, 512, 1024, 2048])
def test_fast_shape_fits_a_block(tile):
    """The bf16x3/mixed kernel's block: warps whose column sums fit shared
    memory beside the column tile at every tile the wrapper takes, whole
    steps of column strips (tiles are multiples of 64 bodies, 4 strips)."""
    for warps, step in cs.FAST_SHAPES:
        assert warps in range(1, 9) and step in (1, 2, 4)
    assert cs.FAST_SHAPE in cs.FAST_SHAPES
    warps, step = cs.FAST_SHAPE
    assert tile * 16 * (1 + warps) <= cs.FAST_MAX_SHARED
    assert tile % cs.FAST_TILE_MULTIPLE == 0 and (tile // 16) % step == 0


# ------------------------------------------------------ the near split
NEAR_SHAPES = [(32, 32), (32, 64), (128, 32), (256, 32), (1024, 2)]


@pytest.mark.parametrize("tile,entries", NEAR_SHAPES)
def test_near_split_puts_every_entry_in_one_part(tile, entries):
    src_tile = ct.NEAR_CHUNK_BODIES // entries
    sub, parts, piece = ct.near_split(tile, entries)
    assert (sub, parts, piece) == ct.near_split(tile, entries, src_tile)
    assert sub % 32 == 0 and tile % sub == 0            # whole warps, whole rows
    assert parts >= 1 and sub * parts <= 1024           # a block's threads
    assert parts <= piece <= entries and piece % parts == 0
    assert piece * src_tile <= ct.NEAR_CHUNK_BODIES      # a stage holds a chunk at most
    # Two stages and the parts' sums fit a block's shared memory on the card.
    assert 2 * piece * src_tile * 16 + 3 * sub * parts * 4 <= 227 * 1024
    for chunks in (0, 1, 2, 5, 13):
        split = ct.near_parts(chunks * entries, parts, piece)
        assert len(split) == parts
        flat = sorted(e for part in split for e in part)
        assert flat == list(range(chunks * entries))     # every (chunk, entry) once
        assert all(part == sorted(part) for part in split)
        sizes = [len(part) for part in split]
        assert max(sizes) - min(sizes) <= (0 if piece % parts == 0 and
                                           (chunks * entries) % piece % parts == 0 else 1)


def test_near_split_on_the_main_paths():
    """Flat rows of 32 take 32 parts; hierarchical rows of 128 are cut into
    blocks of 64 targets and 16 parts; two entries of 1,024 bodies keep the
    block full with 512 targets."""
    assert ct.near_split(32, 32) == (32, 32, 32)
    assert ct.near_split(128, 32) == (64, 16, 32)
    assert ct.near_split(128, 64) == (64, 16, 64)        # 20,480 tuned
    assert ct.near_split(256, 32) == (64, 16, 32)
    assert ct.near_split(1024, 2) == (512, 2, 2)


@pytest.mark.parametrize("tile,entries,src_tile", [(96, 32, 64), (128, 7, 64), (32, 1, 64),
                                                   (512, 64, 32), (128, 32, 16)])
def test_near_split_at_odd_shapes(tile, entries, src_tile):
    """Entries that no power of two divides, a single entry, rows that no
    block size divides: still a partition, still inside the kernel's limits."""
    sub, parts, piece = ct.near_split(tile, entries, src_tile)
    assert sub % 32 == 0 and tile % sub == 0
    assert sub * parts <= 1024 and 1 <= parts <= piece <= entries
    assert piece * src_tile <= ct.NEAR_CHUNK_BODIES
    split = ct.near_parts(3 * entries, parts, piece)
    assert sorted(e for part in split for e in part) == list(range(3 * entries))


def _walk_near(bodies, flat_src, chunk_tgt, *, n, tile, src_tile, entries, eps2, c2):
    """The near kernel's sums, block by block: a block is ``sub`` targets of
    one row, its parts sum their entries of the row's chunks and are added
    in part order; sentinel entries are skipped, a row with no chunk stays
    zero."""
    k_s = n // src_tile
    sub, parts, piece = ct.near_split(tile, entries, src_tile)
    tiles = bodies.reshape(k_s + 1, src_tile, 4)
    out = torch.zeros((n // sub, sub, 3))
    tgt = chunk_tgt.numpy()
    for g in range(n // sub):
        t = g * sub // tile
        c0, c1 = np.searchsorted(tgt, t, "left"), np.searchsorted(tgt, t + 1, "left")
        ids = flat_src[c0 * entries:c1 * entries]
        me = bodies[g * sub:(g + 1) * sub, :3]
        for part in ct.near_parts(len(ids), parts, piece):
            live = [e for e in part if ids[e] != k_s]
            if not live:
                continue
            src = tiles[ids[live].long()].reshape(-1, 4)
            d = src[None, :, :3] - me[:, None, :]
            inv = torch.rsqrt((d * d).sum(-1) * c2 + eps2)
            out[g] += ((src[None, :, 3] * inv * inv * inv)[..., None] * d).sum(1)
    return out.reshape(n, 3)


def _sorted_plummer(n, seed):
    st = jmodels.plummer(n, seed=seed)
    pos = np.asarray(st.pos)
    perm = morton_argsort(pos)
    return pos[perm], np.asarray(st.mass)[perm]


def _jax_near(pos, mass, is_vip, flat_src, chunk_tgt, n, tile):
    """The TPU near kernel on the same lists, in interpret mode
    (tests/test_torch_treecode.py:196-207)."""
    x, y, z = (jnp.asarray(pos[:, a]) for a in range(3))
    scaled = jnp.where(jnp.asarray(is_vip), 0.0, jnp.asarray(mass)) * (C2 * COMP)
    tiles = jnp.stack([a.reshape(n // 64, 64) for a in (x, y, z, scaled)], axis=1)
    tiles = jnp.concatenate([tiles, jnp.zeros((1, 4, 64), jnp.float32)])
    return np.asarray(jtc._near_field_flat_cols(
        x, y, z, tiles, jnp.asarray(flat_src), jnp.asarray(chunk_tgt),
        eps2=EPS2, c2=C2, tile=tile, src_tile=64, interpret=True))[:n, :3]


@pytest.mark.parametrize("path,n,tile", [("hier", 8192, 128), ("flat", 4096, 32)])
def test_near_walk_matches_plain_and_jax(path, n, tile):
    """The 8,192-body hierarchical lists of tests/test_torch_treecode.py
    and the 4,096-body flat lists of tests/test_torch_treecode_flat.py
    (Plummer seed 3, Morton-sorted), built by the port."""
    pos, mass = _sorted_plummer(n, seed=3)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    mac = dict(eps2=EPS2, compensate=COMP)
    if path == "hier":
        kw = dict(tile=128, src_tile=64, vip_tiles=128, mac_tau=jtc.DEFAULT_HIER_TAU,
                  mac_tau0=jtc.DEFAULT_MAC_TAU, **mac)
        caps = ttc.suggest_hier(tpos, tmass, **kw)
        aux = ttc.build_tree_hier_cols(*tpos.unbind(1), tmass, **caps, **kw)
        st = ttc._hier_static(n, 128, 64, 0.55, caps["max_near"], 128, caps["far_max"],
                              ttc.HIER_BRANCH)
        plan = st[5]
    else:
        kw = dict(tile=32, src_tile=64, vip_tiles=32, mac_tau=jtc.DEFAULT_MAC_TAU, **mac)
        max_near = ttc.suggest_max_near(tpos, tmass, **kw)
        aux = ttc.build_tree_flat(tpos, tmass, max_near=max_near,
                                  flat_cap=ttc.suggest_flat_cap(tpos, tmass, **kw), **kw)
        st = ttc._flat_static(n, 32, 64, 0.55, max_near, 32)
        plan = (n // 64,)
    ops = ttc.kernel_operands(tpos, tmass, aux[-1], compensate=COMP, src_tile=64,
                              vip_src=st[4], plan=plan)
    near_kw = dict(n=n, tile=tile, src_tile=64, entries=32, eps2=EPS2, c2=C2)
    got = _walk_near(ops["bodies"], aux[0], aux[1], **near_kw)
    plain = ct.near_field_plain(ops["bodies"], aux[0], aux[1], **near_kw)
    torch.testing.assert_close(got, plain, **TOL)
    want = _jax_near(pos, mass, aux[-1].numpy(), aux[0].numpy(), aux[1].numpy(), n, tile)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The lists leave rows' last chunks part sentinel, and the tail unused.
    assert (aux[0] == n // 64).any() and (aux[1] == n // tile).any()


def test_near_walk_leaves_a_row_without_chunks_zero():
    n, tile = 4096, 32
    pos, mass = _sorted_plummer(n, seed=5)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    kw = dict(tile=32, src_tile=64, vip_tiles=0, mac_tau=jtc.DEFAULT_MAC_TAU, eps2=EPS2,
              compensate=COMP)
    max_near = ttc.suggest_max_near(tpos, tmass, **kw)
    flat_src, chunk_tgt, _, is_vip = ttc.build_tree_flat(
        tpos, tmass, max_near=max_near, flat_cap=ttc.suggest_flat_cap(tpos, tmass, **kw), **kw)
    ops = ttc.kernel_operands(tpos, tmass, is_vip, compensate=COMP, src_tile=64, vip_src=0,
                              plan=(n // 64,))
    moved = torch.where(chunk_tgt == 5, 6, chunk_tgt).to(torch.int32)
    near_kw = dict(n=n, tile=tile, src_tile=64, entries=32, eps2=EPS2, c2=C2)
    got = _walk_near(ops["bodies"], flat_src, moved, **near_kw)
    assert not got[5 * tile:6 * tile].any()
    torch.testing.assert_close(got, ct.near_field_plain(ops["bodies"], flat_src, moved,
                                                        **near_kw), **TOL)


# ----------------------------------------------------- the VIP sweep's split
# (N, W): the main paths' sweeps (65,536 and 524,288 hierarchical, 20,480
# tuned) and ragged ones: N no multiple of the row group, W no multiple of a
# sub-panel, one row, no VIP.
VIP_SHAPES = [(65536, 1024), (524288, 4096), (20480, 512), (8192, 8192), (1000, 100),
              (513, 33), (1, 1), (4096, 0), (2560, 320)]


@pytest.mark.parametrize("n,w", VIP_SHAPES)
def test_vip_split_puts_every_pair_in_one_block(n, w):
    """Row groups of VIP_ROWS and pieces of whole sub-panels: each a
    partition, so every (row, VIP) pair lies in exactly one block."""
    groups, pieces, piece = ct.vip_split(n, w)
    assert (groups - 1) * ct.VIP_ROWS < max(n, 1) <= groups * ct.VIP_ROWS
    assert piece % 32 == 0 and piece >= 32 and 1 <= pieces <= 65535
    rows = collections.Counter(r for g in range(groups)
                               for r in range(g * ct.VIP_ROWS, min(n, (g + 1) * ct.VIP_ROWS)))
    vips = collections.Counter(v for q in range(pieces)
                               for v in range(q * piece, min(w, (q + 1) * piece)))
    assert sorted(rows) == list(range(n)) and set(rows.values()) <= {1}
    assert sorted(vips) == list(range(w)) and set(vips.values()) <= {1}
    assert all(q * piece < w for q in range(pieces)) or w == 0   # no empty piece
    # Pieces of at most VIP_MAX_PIECE VIPs, cut further only as far as the
    # grid needs to reach VIP_BLOCKS.
    assert piece <= max(32, ct.VIP_MAX_PIECE)
    assert (pieces == 1 or piece == 32 or groups * (pieces - 1) < ct.VIP_BLOCKS
            or (pieces - 1) * ct.VIP_MAX_PIECE < w)


def test_vip_split_on_the_main_paths():
    """524,288 bodies: 1,024 row groups, W = 4,096 in 8 pieces of 512;
    65,536 cut W = 1,024 into 16 pieces of 64 to reach 2,048 blocks; the
    tuned 20,480 into sub-panels of 32."""
    assert ct.vip_split(524288, 4096) == (1024, 8, 512)
    assert ct.vip_split(65536, 1024) == (128, 16, 64)
    assert ct.vip_split(20480, 512) == (40, 16, 32)
    assert ct.vip_split(4096, 0) == (8, 1, 32)
    for n, w in ((-1, 4), (4, -1)):
        with pytest.raises(ValueError):
            ct.vip_split(n, w)


def _walk_vip(rows, panel, *, eps2, c2):
    """The VIP kernels' sums in their order: a block's action over its piece,
    the pieces in piece order; a block's reaction a warp at a time (thread t
    holds rows t + 128 q), the four warps in order, then the row groups with
    eight warps each taking every eighth group, the warps in order."""
    n, w = rows.shape[0], panel.shape[0]
    groups, pieces, piece = ct.vip_split(n, w)
    size = ct.VIP_ROWS
    padded = torch.cat([rows, rows.new_zeros((groups * size - n, 4))])
    warp = torch.arange(size) % 128 // 32
    act = torch.zeros((pieces, groups * size, 3))
    part = torch.zeros((groups, w, 3))
    for g in range(groups):
        me = padded[g * size:(g + 1) * size]
        for q in range(pieces):
            vips = panel[q * piece:(q + 1) * piece]
            d = vips[None, :, :3] - me[:, None, :3]
            r2 = d[..., 2] * d[..., 2] + (d[..., 1] * d[..., 1] + d[..., 0] * d[..., 0])
            inv = torch.rsqrt(r2 * c2 + eps2)
            u = inv * inv * inv
            act[q, g * size:(g + 1) * size] = ((vips[None, :, 3] * u)[..., None] * d).sum(1)
            react = -(me[:, None, 3] * u)[..., None] * d
            by_warp = [react[warp == k].sum(0) for k in range(4)]
            part[g, q * piece:(q + 1) * piece] = ((by_warp[0] + by_warp[1]) + by_warp[2]) + by_warp[3]
    action = act[0]
    for q in range(1, pieces):
        action = action + act[q]
    sums = [torch.zeros((w, 3)) for _ in range(8)]
    for g in range(groups):
        sums[g % 8] = sums[g % 8] + part[g]
    react = sums[0]
    for k in range(1, 8):
        react = react + sums[k]
    return action[:n], react


@pytest.fixture(scope="module")
def hier8k():
    """The 8,192-body hierarchical lists of tests/test_torch_treecode.py
    (Plummer seed 3, Morton-sorted), built by the port, and the operands of
    one force evaluation on them."""
    n = 8192
    pos, mass = _sorted_plummer(n, seed=3)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    kw = dict(tile=128, src_tile=64, vip_tiles=128, mac_tau=jtc.DEFAULT_HIER_TAU,
              mac_tau0=jtc.DEFAULT_MAC_TAU, eps2=EPS2, compensate=COMP)
    caps = ttc.suggest_hier(tpos, tmass, **kw)
    aux = ttc.build_tree_hier_cols(*tpos.unbind(1), tmass, **caps, **kw)
    st = ttc._hier_static(n, 128, 64, 0.55, caps["max_near"], 128, caps["far_max"],
                          ttc.HIER_BRANCH)
    ops = ttc.kernel_operands(tpos, tmass, aux[-1], compensate=COMP, src_tile=64,
                              vip_src=st[4], plan=st[5])
    return dict(n=n, pos=pos, mass=mass, aux=aux, ops=ops, vip_src=st[4], plan=st[5])


def _jcols_of(pos):
    return tuple(jnp.asarray(pos[:, a]) for a in range(3))


@pytest.mark.parametrize("blocks", [None, 64, 100000])
def test_vip_walk_matches_plain_and_jax(hier8k, blocks, monkeypatch):
    """The 8,192-body sweep (W = 8,192: every tile a VIP at 128 VIP tiles of
    64) at the rule's split and at a coarser and a finer one."""
    if blocks is not None:
        monkeypatch.setattr(ct, "VIP_BLOCKS", blocks)
    ops = hier8k["ops"]
    n = hier8k["n"]
    got_a, got_r = _walk_vip(ops["rows"], ops["panel"], eps2=EPS2, c2=C2)
    want_a, want_r = ct.vip_both_plain(ops["rows"], ops["panel"], eps2=EPS2, c2=C2)
    torch.testing.assert_close(got_a, want_a, **TOL)
    torch.testing.assert_close(got_r, want_r, **TOL)
    if blocks is None:   # the JAX kernel once, at the rule's split
        idx = ops["vip_tile_idx"].numpy()
        scaled = hier8k["mass"] * (C2 * COMP)
        cols = _jcols_of(hier8k["pos"])
        vrow = [jnp.asarray(np.asarray(a).reshape(n // 64, 64)[idx].reshape(-1))
                for a in (*cols, scaled)]
        action, react = jtc._vip_both_pallas_cols(*cols, jnp.asarray(scaled), *vrow,
                                                  eps2=EPS2, c2=C2, interpret=True)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(action)[:, :3], **TOL)
        np.testing.assert_allclose(got_r.numpy(), np.asarray(react)[:3].T, **TOL)


@pytest.mark.parametrize("n,w", [(1000, 100), (513, 33), (700, 0)])
def test_vip_walk_at_ragged_shapes(n, w):
    """N no multiple of the row group, W no multiple of a sub-panel, no VIP:
    the padding rows and VIPs add nothing. The VIPs are rows, as on the
    main path (a body with itself adds exactly nothing)."""
    rng = np.random.default_rng(n + w)
    rows = torch.from_numpy(np.concatenate([rng.normal(size=(n, 3)),
                                            rng.uniform(0.5, 1.5, (n, 1)) / n], 1)
                            .astype(np.float32))
    panel = rows[rng.permutation(n)[:w]].clone()
    got_a, got_r = _walk_vip(rows, panel, eps2=EPS2, c2=C2)
    want_a, want_r = ct.vip_both_plain(rows, panel, eps2=EPS2, c2=C2)
    assert got_r.shape == (w, 3)
    torch.testing.assert_close(got_a, want_a, **TOL)
    torch.testing.assert_close(got_r, want_r, **TOL)
    if w == 0:
        assert not got_a.any()


# ------------------------------------------------------ the far field's split
@pytest.mark.parametrize("tile", [32, 64, 96, 128, 256, 512, 1024])
def test_far_split_fits_a_block(tile):
    """Whole warps of one row's targets, two a thread, times parts, at most
    512 threads; a stage's 192 node quads a chunk, two at most a thread; a
    partition of the row's entries whatever their number."""
    sub, parts, stage = ct.far_split(tile)
    threads = sub // 2 * parts                          # two targets a thread
    assert sub % 32 == 0 and tile % sub == 0 and sub <= max(32, ct.FAR_TARGETS)
    assert parts >= 1 and stage >= 1 and threads <= ct.FAR_MAX_THREADS
    assert threads % 32 == 0
    assert 3 * ct.FAR_ENTRIES * stage <= ct.FAR_SLOTS * threads
    # Two stages and the parts' sums in a block's shared memory on the card.
    assert 2 * 3 * ct.FAR_ENTRIES * stage * 16 + 6 * threads * 4 <= 227 * 1024
    for n_entries in (0, 64, 128, 5 * 64, 13 * 64):
        split = ct.far_parts(n_entries, parts, stage)
        assert len(split) == parts
        assert sorted(e for part in split for e in part) == list(range(n_entries))
        assert all(part == sorted(part) for part in split)


def test_far_split_on_the_main_paths():
    """Rows of 128 targets: 64 threads, two targets each, in 4 parts (256
    threads), two chunks a stage; rows of 256 in blocks of 128 targets;
    rows of 32 in 6 parts of 16 threads (the fewest that stage a chunk two
    node quads a thread), one chunk a stage."""
    assert ct.far_split(128) == (128, 4, 2)
    assert ct.far_split(256) == (128, 4, 2)
    assert ct.far_split(64) == (64, 4, 1)
    assert ct.far_split(96) == (96, 4, 2)
    assert ct.far_split(32) == (32, 6, 1)


@pytest.mark.parametrize("targets,parts,want", [
    ((128, 2, 1), None, (128, 2, 1)), ((64, 16, 4), None, (64, 16, 4)),
    ((32, 16, 2), None, (32, 16, 2)), ((32, 1, 1), None, (32, 6, 1)),
    ((96, 3, 4), None, (96, 4, 2)), ((128, 1, 1), None, (128, 2, 1))])
def test_far_split_follows_its_constants(targets, parts, want, monkeypatch):
    """Each setting the card's sweep times, and settings too small to stage
    a chunk (a part of 16 threads needs six parts) or that leave half a warp
    (three parts of 48 threads become four)."""
    for name, value in zip(("FAR_TARGETS", "FAR_PARTS", "FAR_STAGE_CHUNKS"), targets):
        monkeypatch.setattr(ct, name, value)
    assert ct.far_split(128 if targets[0] != 96 else 96) == want


def _walk_far(bodies, summ, far_src, far_tgt, *, n, tile, eps2, c2, G):
    """The far kernel's sums, row by row: the node constants scaled as the
    kernel stages them, each part's entries (far_parts) as u^3 (m' + u^2
    (tr' - 2.5 c^2 u^2 d'S'd)) d + u^5 S'd, the parts added in order; a row
    with no chunk stays zero."""
    _, parts, stage = ct.far_split(tile)   # a row's blocks share its order
    gc = G * np.sqrt(c2)
    c4 = c2 * c2
    s = summ.clone()
    s[:, 3] *= c2 * gc
    s[:, 4:10] *= -3.0 * c4 * gc
    s[:, 10] *= -1.5 * c4 * gc
    tgt = far_tgt.numpy()
    out = torch.zeros((n // tile, tile, 3))
    for t in range(n // tile):
        c0, c1 = np.searchsorted(tgt, t, "left"), np.searchsorted(tgt, t + 1, "left")
        ids = far_src[c0 * ct.FAR_ENTRIES:c1 * ct.FAR_ENTRIES].long()
        me = bodies[t * tile:(t + 1) * tile, :3]
        for part in ct.far_parts(len(ids), parts, stage):
            if not part:
                continue
            node = s[ids[part]][None]                                   # (1, E, 12)
            d = node[..., :3] - me[:, None, :]                          # (T, E, 3)
            u = torch.rsqrt(c2 * (d * d).sum(-1) + eps2)
            u2 = u * u
            sd = torch.stack([node[..., 4] * d[..., 0] + node[..., 7] * d[..., 1]
                              + node[..., 8] * d[..., 2],
                              node[..., 7] * d[..., 0] + node[..., 5] * d[..., 1]
                              + node[..., 9] * d[..., 2],
                              node[..., 8] * d[..., 0] + node[..., 9] * d[..., 1]
                              + node[..., 6] * d[..., 2]], -1)
            dsd = (d * sd).sum(-1)
            u3 = u2 * u
            wd = u3 * (node[..., 3] + u2 * (node[..., 10] + (-2.5 * c2) * u2 * dsd))
            out[t] += (wd[..., None] * d + (u3 * u2)[..., None] * sd).sum(1)
    return out.reshape(n, 3)


def test_far_walk_matches_plain_and_jax(hier8k):
    """The 8,192-body hierarchical far lists against the twin and the TPU
    kernel in interpret mode (tests/test_torch_treecode.py:216-234)."""
    aux, ops, n = hier8k["aux"], hier8k["ops"], hier8k["n"]
    kw = dict(n=n, tile=128, eps2=EPS2, c2=C2, G=1.0)
    got = _walk_far(ops["bodies"], ops["summ"], aux[2], aux[3], **kw)
    torch.testing.assert_close(got, ct.far_field_hier_plain(ops["bodies"], ops["summ"],
                                                            aux[2], aux[3], **kw), **TOL)
    cols = _jcols_of(hier8k["pos"])
    mass_tree = jnp.where(jnp.asarray(aux[-1].numpy()), 0.0, jnp.asarray(hier8k["mass"]))
    summ = jtc._summary_panel(jtc._level_summaries(*cols, mass_tree, 64, hier8k["plan"], 2))
    acc = np.asarray(jtc._far_field_hier_cols(
        *cols, summ, jnp.asarray(aux[2].numpy()), jnp.asarray(aux[3].numpy()),
        eps2=EPS2, c2=C2, G=1.0, tile=128, interpret=True))
    want = acc[:n // 128, :3, :].transpose(0, 2, 1).reshape(n, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The lists leave rows' last chunks part sentinel, and the tail unused.
    assert (aux[2] == ops["summ"].shape[0] - 1).any() and (aux[3] == n // 128).any()


@pytest.mark.parametrize("targets,parts,stage", [(128, 2, 1), (64, 16, 4), (32, 6, 1)])
def test_far_walk_at_other_splits(hier8k, targets, parts, stage, monkeypatch):
    for name, value in (("FAR_TARGETS", targets), ("FAR_PARTS", parts),
                        ("FAR_STAGE_CHUNKS", stage)):
        monkeypatch.setattr(ct, name, value)
    aux, ops, n = hier8k["aux"], hier8k["ops"], hier8k["n"]
    kw = dict(n=n, tile=128, eps2=EPS2, c2=C2, G=1.0)
    torch.testing.assert_close(_walk_far(ops["bodies"], ops["summ"], aux[2], aux[3], **kw),
                               ct.far_field_hier_plain(ops["bodies"], ops["summ"], aux[2],
                                                       aux[3], **kw), **TOL)


def test_far_walk_leaves_a_row_without_chunks_zero(hier8k):
    aux, ops, n = hier8k["aux"], hier8k["ops"], hier8k["n"]
    moved = torch.where(aux[3] == 5, 6, aux[3]).to(torch.int32)
    kw = dict(n=n, tile=128, eps2=EPS2, c2=C2, G=1.0)
    got = _walk_far(ops["bodies"], ops["summ"], aux[2], moved, **kw)
    assert not got[5 * 128:6 * 128].any() and got[6 * 128:7 * 128].any()
    torch.testing.assert_close(got, ct.far_field_hier_plain(ops["bodies"], ops["summ"],
                                                            aux[2], moved, **kw), **TOL)


# ------------------------------------------------ the near-panel kernel's split
# (tile, W): the dense path's 1,024 and 20,480 bodies (every tile near; 416
# near tiles of 32), and ragged ones: rows that no block size divides, the
# largest tile, W no multiple of the stage, no panel at all.
PANEL_SHAPES = [(32, 1024), (32, 13312), (64, 1000), (96, 4101), (1024, 2048), (32, 0),
                (128, 1)]


@pytest.mark.parametrize("tile,width", PANEL_SHAPES)
def test_panel_split_puts_every_pair_in_one_part(tile, width):
    """Four targets a thread cover the tile once; each panel row lies in
    exactly one part, so each (target, row) pair is summed once."""
    parts, stage = ct.panel_split(tile)
    group = tile // ct.PANEL_ROWS
    assert group * ct.PANEL_ROWS == tile and 1 <= parts
    assert group * parts <= ct.PANEL_MAX_THREADS
    assert sorted(g + q * group for g in range(group) for q in range(ct.PANEL_ROWS)) == \
        list(range(tile))
    # Two stages, or the parts' sums, in a block's shared memory on the card.
    assert max(2 * stage * 16, 3 * tile * parts * 4) <= 227 * 1024
    split = ct.near_parts(width, parts, stage)
    assert len(split) == parts
    assert sorted(j for part in split for j in part) == list(range(width))
    assert all(part == sorted(part) for part in split)
    for part_rows in split:   # a part's rows of one stage are `parts` apart
        for a, b in zip(part_rows, part_rows[1:]):
            assert b - a == parts or b // stage > a // stage


def test_panel_split_on_the_main_paths():
    """Tiles of 32 (the dense path): 8 threads of four targets in 64 parts,
    512 threads, 1,024 rows a stage; a tile of 1,024 is two parts of 256."""
    assert ct.panel_split(32) == (64, 1024)
    assert ct.panel_split(64) == (32, 1024)
    assert ct.panel_split(1024) == (2, 1024)


@pytest.mark.parametrize("threads,stage,want", [((128, 512), 32, (16, 512)),
                                                ((512, 2048), 32, (64, 2048)),
                                                ((64, 1024), 1024, (1, 1024))])
def test_panel_split_follows_its_constants(threads, stage, want, monkeypatch):
    monkeypatch.setattr(ct, "PANEL_THREADS", threads[0])
    monkeypatch.setattr(ct, "PANEL_STAGE", threads[1])
    assert ct.panel_split(stage) == want


def _walk_panel(bodies, panels, *, tile, eps2, c2):
    """The near-panel kernel's sums: every tile's parts (near_parts of
    panel_split) summed separately, then added in part order."""
    k, width = panels.shape[:2]
    parts, stage = ct.panel_split(tile)
    targets = bodies[:k * tile, :3].reshape(k, tile, 3)
    out = torch.zeros((k, tile, 3))
    for rows in ct.near_parts(width, parts, stage):
        if not rows:
            continue
        pan = panels[:, rows]                                         # (K, R, 4)
        d = pan[:, None, :, :3] - targets[:, :, None, :]               # (K, T, R, 3)
        r2 = d[..., 2] * d[..., 2] + (d[..., 1] * d[..., 1] + d[..., 0] * d[..., 0])
        inv = torch.rsqrt(r2 * c2 + eps2)
        out = out + ((pan[:, None, :, 3] * (inv * inv * inv))[..., None] * d).sum(2)
    return out.reshape(k * tile, 3)


def _dense_case(n, max_near):
    """Morton-sorted Plummer bodies (seed 3) through the port's dense
    build (tests/test_torch_treecode_dense.py), and the kernel operands."""
    pos, mass = _sorted_plummer(n, seed=3)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    kw = dict(tile=32, theta=0.5, max_near=max_near, vip_tiles=16)
    aux = ttc.build_tree(tpos, tmass, **kw)
    ops = ttc.kernel_operands(tpos, tmass, aux[2], compensate=COMP, src_tile=32, vip_src=16,
                              plan=(n // 32,))
    return pos, mass, aux, ops


@pytest.mark.parametrize("n,max_near", [(1024, 32), (2048, 48)])
def test_panel_walk_matches_plain_and_jax(n, max_near):
    """The dense path at 1,024 bodies (every tile near: W = 1,024) and at
    2,048 (48 near tiles: W = 1,536) against the twin and the TPU kernel
    ``_near_kernel`` (through ``_near_field_pallas``) in interpret mode."""
    pos, _, aux, ops = _dense_case(n, max_near)
    panels = ct.gather_panels_plain(ops["bodies"], aux[0], tile=32)
    assert panels.shape == (n // 32, max_near * 32, 4)
    got = _walk_panel(ops["bodies"], panels, tile=32, eps2=EPS2, c2=C2)
    torch.testing.assert_close(got, ct.near_panel_plain(ops["bodies"], panels, tile=32,
                                                        eps2=EPS2, c2=C2), **TOL)
    want = np.asarray(jtc._near_field_pallas(
        jnp.asarray(pos), jnp.asarray(panels.permute(2, 0, 1).numpy()), eps2=EPS2, c2=C2,
        tile=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("tile,width", [(64, 1000), (96, 4101), (32, 0)])
def test_panel_walk_at_ragged_shapes(tile, width):
    """Tiles that no block size divides, W no multiple of the stage, no
    panel (the sums stay zero). Rows [x y z G c^3 m] of a Plummer sphere as
    targets, and panels of its rows drawn at random, as the gather draws
    them from near tiles."""
    k = 3
    pos, mass = _sorted_plummer(max(k * tile, width, 1), seed=tile + width)
    rows = torch.from_numpy(np.concatenate([pos, mass[:, None] * COMP ** 3], 1))
    bodies = rows[:k * tile]
    idx = np.random.default_rng(tile + width).integers(0, rows.shape[0], (k, width))
    panels = rows[torch.from_numpy(idx)]
    got = _walk_panel(bodies, panels, tile=tile, eps2=EPS2, c2=C2)
    torch.testing.assert_close(got, ct.near_panel_plain(bodies, panels, tile=tile, eps2=EPS2,
                                                        c2=C2), **TOL)
    if width == 0:
        assert not got.any()


# ------------------------------------------ the single-level far field's split
@pytest.mark.parametrize("tile", [32, 64, 96, 128, 544, 1024])
def test_single_split_fits_a_block(tile):
    """tile / 2 threads of two targets times parts, whole warps, at most
    SINGLE_MAX_THREADS; a stage's entry counts fit one warp's scan; the
    staged rows hold the parts' sums."""
    parts, per, stage = ct.single_split(tile)
    half = tile // 2
    threads = -(-half * parts // 32) * 32
    assert parts >= 1 and 1 <= per <= ct.SINGLE_MAX_ENTRIES
    assert half * parts <= threads <= ct.SINGLE_MAX_THREADS and threads - half * parts < 32
    assert stage == per * threads and threads // 32 * per <= 32
    assert 3 * tile * parts * 4 <= per * threads * 48 <= 227 * 1024


def test_single_split_on_the_main_paths():
    """Rows of 32 (the flat and dense paths): 16 threads of two targets in
    16 parts, 256 threads reading two mask entries each, 512 a stage."""
    assert ct.single_split(32) == (16, 2, 512)
    assert ct.single_split(128) == (4, 2, 512)
    assert ct.single_split(96) == (5, 2, 512)    # 240 threads, 16 more that only stage
    assert ct.single_split(1024) == (1, 2, 1024)


@pytest.mark.parametrize("settings,want", [((128, 1), (8, 1, 128)), ((512, 2), (32, 2, 1024)),
                                           ((64, 2), (4, 2, 128)), ((8, 9), (1, 2, 64))])
def test_single_split_follows_its_constants(settings, want, monkeypatch):
    """Each setting the card's sweep times for rows of 32, and one below a
    part and above the kernel's entries a thread."""
    monkeypatch.setattr(ct, "SINGLE_THREADS", settings[0])
    monkeypatch.setattr(ct, "SINGLE_ENTRIES", settings[1])
    assert ct.single_split(32) == want


# (K_s, masked entries): the main paths' rows (1,024 source tiles at 65,536
# flat, 640 at 20,480 dense, 40 at 2,560), K_s no multiple of a stage, a row
# with every tile masked, a row with none, and no source tile.
SINGLE_ROWS = [(1024, 0.2), (640, 0.65), (40, 0.3), (1000, 0.5), (513, 1.0), (700, 0.0), (0, 0.0)]


@pytest.mark.parametrize("tile", [32, 64, 96, 1024])
@pytest.mark.parametrize("k_s,frac", SINGLE_ROWS)
def test_single_parts_put_every_unmasked_tile_in_one_part(tile, k_s, frac):
    parts, _, stage = ct.single_split(tile)
    masked = np.random.default_rng(k_s + tile).random(k_s) < frac
    split = ct.single_parts(masked, parts, stage)
    assert len(split) == parts
    assert sorted(e for part in split for e in part) == list(np.flatnonzero(~masked))
    assert all(part == sorted(part) for part in split)
    if frac == 1.0:
        assert not any(split)


def _walk_single(bodies, summ, near_mask, *, n, tile, eps2, c2, G):
    """The single-level far kernel's sums, row by row: the node constants
    scaled as the kernel stages them, each part's tiles (single_parts) as
    u^3 (m' + u^2 (tr' - 2.5 c^2 u^2 d'S'd)) d + u^5 S'd, the parts added in
    order; a row with every tile masked stays zero."""
    parts, _, stage = ct.single_split(tile)
    gc = G * np.sqrt(c2)
    c4 = c2 * c2
    s = summ[:near_mask.shape[1]].clone()
    s[:, 3] *= c2 * gc
    s[:, 4:10] *= -3.0 * c4 * gc
    s[:, 10] *= -1.5 * c4 * gc
    out = torch.zeros((n // tile, tile, 3))
    for t in range(n // tile):
        me = bodies[t * tile:(t + 1) * tile, :3]
        for part in ct.single_parts(near_mask[t].bool().tolist(), parts, stage):
            if not part:
                continue
            node = s[part][None]                                        # (1, E, 12)
            d = node[..., :3] - me[:, None, :]                          # (T, E, 3)
            u = torch.rsqrt(c2 * (d * d).sum(-1) + eps2)
            u2 = u * u
            sd = torch.stack([node[..., 4] * d[..., 0] + node[..., 7] * d[..., 1]
                              + node[..., 8] * d[..., 2],
                              node[..., 7] * d[..., 0] + node[..., 5] * d[..., 1]
                              + node[..., 9] * d[..., 2],
                              node[..., 8] * d[..., 0] + node[..., 9] * d[..., 1]
                              + node[..., 6] * d[..., 2]], -1)
            dsd = (d * sd).sum(-1)
            u3 = u2 * u
            wd = u3 * (node[..., 3] + u2 * (node[..., 10] + (-2.5 * c2) * u2 * dsd))
            out[t] = out[t] + (wd[..., None] * d + (u3 * u2)[..., None] * sd).sum(1)
    return out.reshape(n, 3)


def _flat_case(n):
    """The 4,096-body flat lists of tests/test_torch_treecode_flat.py
    (Plummer seed 3, Morton-sorted), built by the port."""
    pos, mass = _sorted_plummer(n, seed=3)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    kw = dict(tile=32, src_tile=64, vip_tiles=32, mac_tau=jtc.DEFAULT_MAC_TAU, eps2=EPS2,
              compensate=COMP)
    max_near = ttc.suggest_max_near(tpos, tmass, **kw)
    aux = ttc.build_tree_flat(tpos, tmass, max_near=max_near,
                              flat_cap=ttc.suggest_flat_cap(tpos, tmass, **kw), **kw)
    st = ttc._flat_static(n, 32, 64, 0.55, max_near, 32)
    ops = ttc.kernel_operands(tpos, tmass, aux[3], compensate=COMP, src_tile=64,
                              vip_src=st[4], plan=(n // 64,))
    return pos, mass, aux[2], aux[3], ops, 64


@pytest.mark.parametrize("path,n", [("dense", 2048), ("flat", 4096)])
def test_single_walk_matches_plain_and_jax(path, n):
    """The dense path at 2,048 bodies (48 of 64 tiles near) and the flat
    path at 4,096 against the twin and the TPU kernel ``_far_kernel``
    (through ``_far_field_pallas_cols``) in interpret mode."""
    if path == "dense":
        pos, mass, aux, ops = _dense_case(n, 48)
        mask, is_vip, src = aux[1], aux[2], 32
    else:
        pos, mass, mask, is_vip, ops, src = _flat_case(n)
    assert mask.any() and not mask.all()
    kw = dict(n=n, tile=32, eps2=EPS2, c2=C2, G=1.0)
    got = _walk_single(ops["bodies"], ops["summ"], mask, **kw)
    torch.testing.assert_close(got, ct.far_field_single_plain(ops["bodies"], ops["summ"], mask,
                                                              **kw), **TOL)
    cols = _jcols_of(pos)
    mass_tree = jnp.where(jnp.asarray(is_vip.numpy()), 0.0, jnp.asarray(mass))
    com, m_tot, _, quad = jtc.tile_summaries_cols(*cols, mass_tree, src)
    want = np.asarray(jtc._far_field_pallas_cols(
        *cols, com, m_tot, quad, jnp.asarray(mask.numpy()), eps2=EPS2, c2=C2, G=1.0, tile=32,
        interpret=True))[:, :3]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("threads,per", [(256, 2), (16, 1)])
def test_single_walk_leaves_a_fully_masked_row_zero(threads, per, monkeypatch):
    """A row whose every source tile is near adds no far term; another with
    none masked adds them all; at the rule's split (K_s = 64 in one stage)
    and at one warp of one part reading one entry a thread (two stages)."""
    monkeypatch.setattr(ct, "SINGLE_THREADS", threads)
    monkeypatch.setattr(ct, "SINGLE_ENTRIES", per)
    *_, mask, _, ops, _ = _flat_case(4096)
    assert -(-mask.shape[1] // ct.single_split(32)[2]) == (1 if per == 2 else 2)
    mask = mask.clone()
    mask[5] = True
    mask[6] = False
    kw = dict(n=4096, tile=32, eps2=EPS2, c2=C2, G=1.0)
    got = _walk_single(ops["bodies"], ops["summ"], mask, **kw)
    assert not got[5 * 32:6 * 32].any() and got[6 * 32:7 * 32].all()
    torch.testing.assert_close(got, ct.far_field_single_plain(ops["bodies"], ops["summ"], mask,
                                                              **kw), **TOL)
