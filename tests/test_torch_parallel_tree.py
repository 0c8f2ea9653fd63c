"""The port's sharded treecode (tests/test_parallel.py:198-304, 352-).

In this process, rank by rank at D = 4 (flat and hierarchical at 4,096
bodies): each rank's work lists from
``build_flat_local`` / ``build_hier_local`` equal the JAX package's element
for element, its ``flat_local_acc`` / ``hier_local_acc`` (acceleration and
partial VIP reaction) agree with the JAX package's (Pallas kernels in
interpret mode) within rtol=1e-4, atol=2e-6, the bound tests/test_torch_treecode.py
holds the port's single-device force to, and the sharded planners return
the JAX package's capacities. The ranks' forces, reactions added, equal the
single-device force on their merged lists: the check the smoke run makes
on the card. A ring of one rank is the single-device treecode to the bit,
its lists and its force.

One gloo world of 4 runs ``ShardedSimulation(strategy="treecode")`` for 8
steps (two resorts) on each path, held against the port's single-device
``Simulation`` through ``sort_perm`` within the JAX test's rtol=5e-4,
atol=5e-5. The hierarchical and dense cases take 4,096 bodies, the
smallest N at which the hierarchical path engages: the JAX tests' 8,192
(marked slow there) does not fit this suite's time.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
from n_body_problem_tpu.ops import treecode as jtc
from n_body_problem_tpu.state import to_numpy as jax_to_numpy
from n_body_problem_tpu.utils.morton import morton_argsort
from n_body_problem_tpu_torch import SimConfig, Simulation, from_numpy
from n_body_problem_tpu_torch.ops import treecode as ttc
from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path
from n_body_problem_tpu_torch.parallel import spawn_ring
from n_body_problem_tpu_torch.parallel import tree as ptree
from n_body_problem_tpu_torch.parallel.drive import run_cases

D = 4
TOL = dict(rtol=1e-4, atol=2e-6)
RUN_TOL = dict(rtol=5e-4, atol=5e-5)
N_FLAT = N_HIER = N_DENSE = 4096
MAC = dict(eps2=1e-6, compensate=0.1)


def _flat_cfg(n):
    return SimConfig(solver="treecode", tree_vip_tiles=8, tree_rebuild_every=4,
                     tree_src_tile=64, tree_max_near=64, tree_flat_cap=(n // 32) * 64)


def _hier_cfg(n):
    return SimConfig(solver="treecode", tree_vip_tiles=8, tree_rebuild_every=4,
                     tree_src_tile=64, tree_max_near=64, tree_flat_cap=(n // 128) * 64 * 8,
                     tree_far_cap=(n // 128) * jtc.FAR_ENTRIES * 8, tree_tile=128)


def _dense_cfg(max_near=0):
    return SimConfig(solver="treecode", tree_vip_tiles=8, tree_rebuild_every=4,
                     tree_flat_cap=-1, tree_max_near=max_near)


def _sorted_plummer(n, seed):
    st = jnb.models.plummer(n, seed=seed)
    pos = np.asarray(st.pos)
    perm = morton_argsort(pos)
    return pos[perm], np.asarray(st.mass)[perm]


# ------------------------------------------------------- rank by rank, D = 4
def _local_kw(path):
    """Build and force keywords of each path's rank, as the sharded run
    passes them (cfg.tree_flat_cap and tree_far_cap are one rank's)."""
    sel = dict(src_tile=64, theta=0.55, max_near=64, vip_tiles=8)
    if path == "flat":
        c = _flat_cfg(N_FLAT)
        build = dict(tile=32, slack=8, flat_cap=c.tree_flat_cap, mac_tau=c.tree_mac_tau,
                     **sel, **MAC)
        return N_FLAT, 43, build, dict(tile=32, G=1.0, **{k: v for k, v in sel.items()
                                                          if k != "theta"}, **MAC)
    c = _hier_cfg(N_HIER)
    pos, mass = _sorted_plummer(N_HIER, 61)
    far_max = ttc.suggest_hier_sharded(torch.from_numpy(pos), torch.from_numpy(mass), D,
                                       tile=128, src_tile=64, vip_tiles=8,
                                       mac_tau=c.tree_hier_tau,
                                       mac_tau0=c.tree_mac_tau, **MAC)["far_max"]
    build = dict(tile=128, slack=8, flat_cap=c.tree_flat_cap, far_max=far_max,
                 far_cap=c.tree_far_cap, mac_tau=c.tree_hier_tau, mac_tau0=c.tree_mac_tau,
                 union_coarse=True, **sel, **MAC)
    return N_HIER, 61, build, dict(tile=128, G=1.0, far_max=far_max, **sel, **MAC)


@pytest.fixture(scope="module", params=["flat", "hier"])
def ranks(request):
    """Each rank's lists and force through both packages."""
    path = request.param
    n, seed, build, acc = _local_kw(path)
    pos, mass = _sorted_plummer(n, seed)
    jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    jbuild = jax.jit(functools.partial(
        jtc.build_flat_local if path == "flat" else jtc.build_hier_local, **build))
    jacc_kw = {k: v for k, v in acc.items() if k != "theta"}
    jforce = jax.jit(functools.partial(
        jtc.flat_local_acc if path == "flat" else jtc.hier_local_acc, interpret=True,
        **jacc_kw))
    tbuild = ttc.build_flat_local if path == "flat" else ttc.build_hier_local
    tforce = ttc.flat_local_acc if path == "flat" else ttc.hier_local_acc
    b = n // D
    rows_a_rank = b // build["tile"]
    out = []
    for r in range(D):
        mine = slice(r * b, (r + 1) * b)
        jg, tg = (jpos[:, 0], jpos[:, 1], jpos[:, 2]), tpos.unbind(1)
        jl, tl = (jpos[mine, 0], jpos[mine, 1], jpos[mine, 2]), tpos[mine].unbind(1)
        jaux = jbuild(*jl, *jg, jmass, row_offset=r * rows_a_rank)
        taux = tbuild(*tl, *tg, tmass, row_offset=r * rows_a_rank, **build)
        jout = jforce(*jl, jmass[mine], *jg, jmass, jaux)
        tout = tforce(*tl, tmass[mine], *tg, tmass, taux, **acc)
        out.append(dict(jaux=[np.asarray(a) for a in jaux], taux=taux,
                        jout=[None if a is None else np.asarray(a) for a in jout],
                        tout=tout))
    return path, out


@pytest.mark.parametrize("rank", range(D))
def test_local_lists_equal_jax(ranks, rank):
    """flat_src, chunk_tgt, near_mask (flat) or far_src, far_tgt (hier), and
    is_vip_g, element for element."""
    _, out = ranks
    got, want = out[rank]["taux"], out[rank]["jaux"]
    assert len(got) == len(want)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("rank", range(D))
def test_local_forces_match_jax(ranks, rank):
    """The rank's acceleration and its partial pull on the VIP panel (the
    JAX package's reaction is (8, W), rows 0-2 the pull)."""
    _, out = ranks
    tax, tay, taz, treact, tidx = out[rank]["tout"]
    jax_, jay, jaz, jreact, jidx = out[rank]["jout"]
    np.testing.assert_allclose(torch.stack([tax, tay, taz], 1).numpy(),
                               np.stack([jax_, jay, jaz], 1), **TOL)
    np.testing.assert_allclose(treact.numpy(), jreact[:3].T, **TOL)
    np.testing.assert_array_equal(tidx.numpy(), jidx)


def test_sharded_planners_equal_jax():
    pos, mass = _sorted_plummer(N_FLAT, 43)
    kw = dict(tile=32, src_tile=64, vip_tiles=8, mac_tau=2e-4, **MAC)
    assert ttc.suggest_flat_cap_sharded(torch.from_numpy(pos), torch.from_numpy(mass), D,
                                        **kw) == \
        jtc.suggest_flat_cap_sharded(jnp.asarray(pos), jnp.asarray(mass), D, **kw)
    pos, mass = _sorted_plummer(N_HIER, 61)
    kw = dict(tile=128, src_tile=64, vip_tiles=8, mac_tau=0.01, mac_tau0=2e-4, **MAC)
    assert ttc.suggest_hier_sharded(torch.from_numpy(pos), torch.from_numpy(mass), D, **kw) \
        == jtc.suggest_hier_sharded(jnp.asarray(pos), jnp.asarray(mass), D, **kw)


def _resolved(cfg, n):
    """The config a ShardedSimulation of D ranks resolves on the CPU (the
    capacities pinned, so the path is the config's)."""
    if cfg.tree_tile == 0:
        cfg = cfg.replace(tree_tile=32)
    pos, mass = (torch.from_numpy(a.copy()) for a in _sorted_plummer(n, 0))
    if cfg.tree_max_near == 0:
        cfg = cfg.replace(tree_max_near=ttc.suggest_max_near(
            pos, mass, tile=cfg.tree_tile, vip_tiles=8, mac_tau=cfg.tree_mac_tau, **MAC))
    if cfg.tree_flat_cap > 0 and cfg.tree_far_cap > 0 and cfg.tree_far_max == 0:
        cfg = cfg.replace(tree_far_max=ttc.suggest_hier_sharded(
            pos, mass, D, tile=cfg.tree_tile, src_tile=cfg.tree_src_tile, vip_tiles=8,
            mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau, **MAC)["far_max"])
    return cfg


@pytest.mark.parametrize("path", ["flat", "hier", "dense"])
def test_rank_forces_equal_single_device_on_merged_lists(path):
    """``tree.treecode_acc_ranks`` (every rank in one process, reactions
    added over the ranks) against the single-device force on the ranks'
    merged lists. The dense lists keep 64 of the 128 tiles, so that the far
    field contributes."""
    n = {"flat": N_FLAT, "hier": N_HIER, "dense": N_DENSE}[path]
    cfg = _resolved({"flat": _flat_cfg(n), "hier": _hier_cfg(n),
                     "dense": _dense_cfg(max_near=64)}[path], n)
    assert ptree.sharded_path(cfg) == path
    pos, mass = (torch.from_numpy(a.copy()) for a in _sorted_plummer(n, 0))
    acc, lists = ptree.treecode_acc_ranks(cfg, pos, mass, D)
    rows = n // D // cfg.tree_tile
    merged = ptree.merge_rank_lists(path, lists, rows, ttc.CHUNK_LANES // cfg.tree_src_tile)
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, tile=cfg.tree_tile,
              theta=cfg.tree_theta, vip_tiles=cfg.tree_vip_tiles)
    if path == "dense":
        want = ttc.treecode_acc(pos, mass, merged, max_near=merged[0].shape[1], **kw)
    elif path == "flat":
        want = ttc.treecode_acc_flat(pos, mass, merged, src_tile=cfg.tree_src_tile,
                                     max_near=cfg.tree_max_near, **kw)
    else:
        want = ttc.treecode_acc_hier(pos, mass, merged, src_tile=cfg.tree_src_tile,
                                     max_near=cfg.tree_max_near, far_max=cfg.tree_far_max,
                                     **kw)
    torch.testing.assert_close(acc, want, **TOL)


@pytest.mark.parametrize("path", ["flat", "hier", "dense"])
def test_one_rank_is_the_single_device_treecode_bitwise(path):
    """A ring of one rank (``tree.treecode_acc_ranks`` at D = 1) against the
    single-device build and force of the same config (``registry.tree_fns``):
    the rank's lists element for element, its force to the bit. The dense
    capacity is a multiple of 4, which both paths' rules keep as it is."""
    n = {"flat": N_FLAT, "hier": N_HIER, "dense": N_DENSE}[path]
    cfg = _resolved({"flat": _flat_cfg(n), "hier": _hier_cfg(n),
                     "dense": _dense_cfg(max_near=64)}[path], n)
    assert ptree.sharded_path(cfg) == path == tree_path(cfg)
    pos, mass = (torch.from_numpy(a.copy()) for a in _sorted_plummer(n, 0))
    acc, (lists,) = ptree.treecode_acc_ranks(cfg, pos, mass, 1)
    build, force = tree_fns(cfg)
    want_lists = build(pos, mass)
    assert len(lists) == len(want_lists)
    for got, want in zip(lists, want_lists):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert torch.equal(acc, force(pos, mass, want_lists))


# ------------------------------------------------------- a gloo world of 4
RUNS = {"flat": (_flat_cfg(N_FLAT), N_FLAT, 43), "hier": (_hier_cfg(N_HIER), N_HIER, 61),
        "dense": (_dense_cfg(), N_DENSE, 43)}


# ShardedSimulation.run against its eager loop: a resort every 2 steps, 3
# steps a call (a chunk and a remainder); the hierarchical path twice, in
# leapfrog, the others once
REPLAYS = {path: dict(kind="replay", cfg=cfg.replace(tree_rebuild_every=2, integrator=integ),
                      state=jax_to_numpy(jnb.models.plummer(n, seed=seed + 1)), steps=3,
                      strategy="treecode", calls=calls)
           for (path, (cfg, n, seed)), integ, calls in zip(
               RUNS.items(), ("semi_implicit_euler", "leapfrog", "semi_implicit_euler"),
               (1, 2, 1))}


@pytest.fixture(scope="module")
def world4():
    cases = [dict(kind="sim", cfg=cfg, state=jax_to_numpy(jnb.models.plummer(n, seed=seed)),
                  steps=8, strategy="treecode") for cfg, n, seed in RUNS.values()]
    keys = list(RUNS) + [f"replay {p}" for p in REPLAYS]
    return dict(zip(keys, spawn_ring(run_cases, D, device_type="cpu",
                                     args=(cases + list(REPLAYS.values()),))))


@pytest.mark.parametrize("path", list(REPLAYS))
def test_sharded_treecode_run_is_its_eager_loop_bitwise(world4, path):
    """``ShardedSimulation.run`` (its resort, build and step programs,
    called directly on the CPU) against its eager loop (``sharded.eager_run``)
    from the same state: the gathered state and ``sort_perm``, to the bit."""
    calls = world4[f"replay {path}"]
    assert len(calls) == REPLAYS[path]["calls"]
    for call in calls:
        for k, want in call["eager"].items():
            np.testing.assert_array_equal(call["run"][k], want, err_msg=k)
    assert int(calls[-1]["run"]["step"]) == 3 * len(calls)


def _matches_single_device(got, path):
    cfg, n, seed = RUNS[path]
    ref = Simulation(cfg, from_numpy(jax_to_numpy(jnb.models.plummer(n, seed=seed))),
                     device="cpu")
    ref.run(8)
    a, b = got["pos"][:n], ref.state.pos[:n].numpy()
    inv_a = np.empty(n, int)
    inv_a[got["sort_perm"]] = np.arange(n)
    inv_b = np.empty(n, int)
    inv_b[ref.sort_perm] = np.arange(n)
    np.testing.assert_allclose(a[inv_a], b[inv_b], **RUN_TOL)
    assert np.isfinite(got["diag"]["energy"])
    return ref


def test_sharded_flat_treecode_matches_single_chip(world4):
    got = world4["flat"]
    assert ptree.sharded_path(got["cfg"]) == "flat"
    _matches_single_device(got, "flat")
    assert got["diag"]["overspeed"] == 0


def test_sharded_hier_treecode_matches_single_chip(world4):
    got = world4["hier"]
    assert got["cfg"].tree_far_max > 0 and ptree.sharded_path(got["cfg"]) == "hier"
    ref = _matches_single_device(got, "hier")
    vref = np.linalg.norm(ref.state.vel[:N_HIER].numpy(), axis=1)
    assert got["diag"]["overspeed"] == int((vref > 10.0).sum())


def test_sharded_treecode_matches_single_chip(world4):
    """The dense path (``tree_flat_cap=-1``; the planner keeps every tile
    near at this N, as at the JAX test's 8,192)."""
    got = world4["dense"]
    assert ptree.sharded_path(got["cfg"]) == "dense"
    _matches_single_device(got, "dense")
    assert got["diag"]["overspeed"] == 0
