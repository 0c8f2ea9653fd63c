"""The schedules the all-pairs kernel, the symmetric kernels and the near
kernel are launched with, on the CPU.

The CUDA kernels run only on the card; what a block does there is decided
by integers that Python computes (``cuda_force.allpairs_split``,
``allpairs_columns``; ``cuda_symmetric.symmetric_blocks``, ``block_tiles``,
``FAST_SHAPE``; ``cuda_treecode.near_split``, ``near_parts``). These tests
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
