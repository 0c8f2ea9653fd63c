"""The port's staged treecode (tests/test_stream.py, six tests, and more).

The staged strategy streams the near sources round the ring and gathers
only the source tiles' summaries. Its forces, through
``stream.staged_acc_ranks`` (every rank in this process, no world), are held
against the JAX package's ``make_staged_force`` on its fake CPU mesh
(Pallas kernels in interpret mode) and against the port's single device,
within the tolerances of the JAX test each mirrors: the exact limit (theta
-> 0, every tile near on both sides) within rtol 2e-5 / atol 2e-6 x max,
the production MAC (per-shard compaction promotes other borderline tiles
to exact work than one device's) within a per-body relative p99 of 8e-4
and a maximum of 8e-3. Each rank's lists equal the JAX package's
``_staged_build`` under ``shard_map`` element for element.

The JAX tests take 16,384 bodies at D = 8; here D = 4 and 8,192 bodies,
which keeps 2,048 bodies a shard, 16 source tiles of 128: as many as a
near chunk's entries (CHUNK_LANES / 128), so the per-shard guard holds.
One gloo world of 4 runs the collectives: ``ShardedSimulation(strategy=
"treecode_staged")`` for 8 steps against ``Simulation``, the exact-limit
force against the ranks in this process, and the undersized-shard
``ValueError`` (4,096 bodies of 64-body source tiles: 16 a shard, fewer
than 32 entries).
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import n_body_problem_tpu as jnb
from n_body_problem_tpu.ops import treecode as jtc
from n_body_problem_tpu.parallel import make_ring_mesh
from n_body_problem_tpu.parallel.mesh import RING_AXIS
from n_body_problem_tpu.parallel.stream import _staged_acc, _staged_build
from n_body_problem_tpu.parallel.stream import make_staged_force as jax_staged_force
from n_body_problem_tpu.state import to_numpy as jax_to_numpy
from n_body_problem_tpu.utils.morton import morton_argsort
from n_body_problem_tpu_torch import SimConfig, Simulation, from_numpy
from n_body_problem_tpu_torch.ops import treecode as ttc
from n_body_problem_tpu_torch.parallel import spawn_ring, stream
from n_body_problem_tpu_torch.parallel.drive import run_cases
from n_body_problem_tpu_torch.parallel.sharded import auto_tile, plan_treecode

D = 4
N = 8192
EXACT_TOL = dict(rtol=2e-5)          # and atol 2e-6 x max |a|
RUN_TOL = dict(rtol=5e-4, atol=5e-5)
K_T_L = N // D // 128


def _cfg(**kw):
    return dict(solver="treecode", tree_tile=128, tree_src_tile=128, **kw)


# (seed, config) of the JAX tests, at D = 4 and N = 8,192.
CASES = {
    "exact": (7, _cfg(tree_theta=1e-30, tree_mac_tau=0.0, tree_max_near=2048,
                      tree_near_slack=0, tree_vip_tiles=0, tree_flat_cap=16 * 128,
                      tree_hier=False)),
    "vip": (17, _cfg(tree_theta=1e-30, tree_mac_tau=0.0, tree_max_near=2048,
                     tree_near_slack=0, tree_vip_tiles=8, tree_flat_cap=16 * 128,
                     tree_hier=False)),
    "prod": (11, _cfg(tree_theta=0.55, tree_mac_tau=2e-4, tree_max_near=512,
                      tree_near_slack=4, tree_vip_tiles=0, tree_flat_cap=16 * 128,
                      tree_hier=False)),
    "hier": (29, _cfg(tree_theta=0.55, tree_mac_tau=2e-4, tree_max_near=512,
                      tree_near_slack=0, tree_vip_tiles=8, tree_flat_cap=16 * 128,
                      tree_hier=True, tree_far_max=64, tree_far_cap=K_T_L * 64)),
}
# The cases whose lists are also taken from the JAX package (the VIP exact
# limit's force from its public make_staged_force, theirs with the lists).
JAX_LISTS = ("prod", "hier")


def _sorted(seed, n=N):
    """(pos, mass) numpy of the JAX package's Plummer sphere, Morton-sorted
    (a host sort, as the JAX tests' ``device_resort``)."""
    st = jnb.models.plummer(n, seed=seed)
    pos, mass = np.asarray(st.pos), np.asarray(st.mass)
    perm = morton_argsort(pos)
    return pos[perm], mass[perm]


def _torch(pos, mass):
    return torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())


def _single_flat(cfg, pos, mass):
    """The port's single-device flat force, its capacity 8 x a stage's."""
    sel = dict(tile=cfg.tree_tile, src_tile=cfg.tree_src_tile, theta=cfg.tree_theta,
               max_near=cfg.tree_max_near, vip_tiles=cfg.tree_vip_tiles)
    aux = ttc.build_tree_flat(pos, mass, slack=cfg.tree_near_slack,
                              flat_cap=cfg.tree_flat_cap * 8, mac_tau=cfg.tree_mac_tau,
                              eps2=cfg.eps2, compensate=cfg.compensate, **sel)
    return ttc.treecode_acc_flat(pos, mass, aux, eps2=cfg.eps2, compensate=cfg.compensate,
                                 G=cfg.G, **sel)


def _single_hier(cfg, pos, mass):
    """The port's single-device hierarchical force, its capacities 8 x a
    stage's near capacity and 64 far entries a row."""
    sel = dict(tile=cfg.tree_tile, src_tile=cfg.tree_src_tile, theta=cfg.tree_theta,
               max_near=cfg.tree_max_near, vip_tiles=cfg.tree_vip_tiles)
    aux = ttc.build_tree_hier_cols(
        *pos.unbind(1), mass, slack=cfg.tree_near_slack, flat_cap=cfg.tree_flat_cap * 8,
        far_max=64, far_cap=(N // 128) * 64, mac_tau=cfg.tree_hier_tau,
        mac_tau0=cfg.tree_mac_tau, eps2=cfg.eps2, compensate=cfg.compensate,
        union_coarse=cfg.tree_hier_union, **sel)
    return ttc.treecode_acc_hier(pos, mass, aux, eps2=cfg.eps2, compensate=cfg.compensate,
                                 G=cfg.G, far_max=64, **sel)


def _jax_staged(cfg, pos, mass):
    """JAX's staged force and each rank's lists, from one ``shard_map``
    of ``_staged_build`` and ``_staged_acc`` (``make_staged_force``'s
    body, the lists kept)."""
    mesh = make_ring_mesh(D)

    def local(xl, yl, zl, ml):
        me = lax.axis_index(RING_AXIS)
        aux = _staged_build(cfg, xl, yl, zl, ml, me, D, RING_AXIS)
        acc = _staged_acc(cfg, xl, yl, zl, ml, me, aux, D, RING_AXIS, True)
        return acc, tuple(None if a is None else a[None] for a in aux)

    row = P(RING_AXIS)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(row,) * 4, out_specs=row,
                               check_vma=False))
    p = jnp.asarray(pos)
    acc, aux = fn(p[:, 0], p[:, 1], p[:, 2], jnp.asarray(mass))
    return (np.stack([np.asarray(a) for a in acc], 1),
            [None if a is None else np.asarray(a) for a in aux])


@pytest.fixture(scope="module")
def forces():
    """Each case through the port's ranks and single device, and all but
    the exact limit through the JAX package's staged force."""
    out = {}
    for name, (seed, kw) in CASES.items():
        npos, nmass = _sorted(seed)
        cfg = SimConfig(**kw)
        pos, mass = _torch(npos, nmass)
        acc, lists = stream.staged_acc_ranks(cfg, pos, mass, D)
        single = (_single_hier if cfg.tree_hier else _single_flat)(cfg, pos, mass)
        rec = dict(acc=acc.numpy(), lists=lists, single=single.numpy(), jax=None)
        jcfg = jnb.SimConfig(**kw)
        if name in JAX_LISTS:
            rec["jax"], rec["jax_lists"] = _jax_staged(jcfg, npos, nmass)
        elif name == "vip":
            rec["jax"] = np.asarray(jax.jit(jax_staged_force(jcfg, make_ring_mesh(D)))(
                jnp.asarray(npos), jnp.asarray(nmass)))
        out[name] = rec
    return out


def _exact(got, want):
    np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(want).max(), **EXACT_TOL)


def _production(got, want):
    rel = (np.linalg.norm(got - want, axis=1)
           / np.maximum(np.linalg.norm(want, axis=1), 1e-12))
    assert np.percentile(rel, 99) < 8e-4, np.percentile(rel, 99)
    assert rel.max() < 8e-3, rel.max()


def test_staged_exact_limit_matches_single_chip(forces):
    """theta -> 0: every tile near on both sides, no far field; the ring's
    stage sums equal one device's flat sum to rounding."""
    _exact(forces["exact"]["acc"], forces["exact"]["single"])


def test_staged_vip_exact_limit_matches_single_chip(forces):
    """VIPs in the exact limit: the global largest-radius tiles leave the
    tree, their panel is the ranks' summed picks and their rows the summed
    reactions; against one device and against JAX's staged force."""
    f = forces["vip"]
    _exact(f["acc"], f["single"])
    _exact(f["acc"], f["jax"])


def test_staged_production_tau_matches_single_chip(forces):
    """At the production MAC the per-shard compaction differs from one
    device's in borderline tiles only: within the JAX test's envelope of
    one device, and of JAX's staged force."""
    f = forces["prod"]
    _production(f["acc"], f["single"])
    _production(f["acc"], f["jax"])


def test_staged_hier_matches_single_chip(forces):
    """The hierarchical far field from the gathered summaries (the levels
    merged on every rank, the MAC's scale from the gathered samples), VIPs
    on."""
    f = forces["hier"]
    _production(f["acc"], f["single"])
    _production(f["acc"], f["jax"])


LIST_NAMES = ("flat_src_all", "chunk_tgt_all", "near_mask", "far_src", "far_tgt", "vip_idx",
              "is_vip_body_l")


@pytest.mark.parametrize("rank", range(D))
@pytest.mark.parametrize("case", JAX_LISTS)
def test_staged_lists_equal_jax(forces, case, rank):
    """Rank ``rank``'s lists, element for element those of JAX's
    ``_staged_build`` (None where JAX has none)."""
    f = forces[case]
    for name, t, j in zip(LIST_NAMES, f["lists"][rank], f["jax_lists"]):
        if j is None:
            assert t is None, name
        else:
            np.testing.assert_array_equal(t.numpy(), j[rank], err_msg=name)


def test_level0_from_summaries_is_level0():
    """The level-0 tuple from gathered tile summaries is bitwise the one
    from positions (the tiles lie wholly in one shard), and JAX's."""
    npos, nmass = _sorted(3, 4096)
    pos, mass = _torch(npos, nmass)
    x, y, z = pos.unbind(1)
    want = ttc._level0(x, y, z, mass, 64)
    got = ttc._level0_from_summaries(*ttc.tile_summaries_cols(x, y, z, mass, 64))
    jgot = jtc._level0_from_summaries(*jtc.tile_summaries_cols(
        *jnp.asarray(npos).T, jnp.asarray(nmass), 64))
    flat = lambda lv: [*lv[:6], *lv[6]]  # noqa: E731
    for g, w, j in zip(flat(got), flat(want), flat(jgot)):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)


def test_staged_tile_and_plan_rules():
    """``ShardedSimulation``'s rules for the staged strategy, as the JAX
    package's: the hierarchical tile off the card, the flat lists planned on
    any device, and the ``ValueError`` below the flat machinery's size."""
    base = SimConfig(solver="treecode")
    assert auto_tile(base, "treecode_staged", N, "cpu").tree_tile == 128
    assert auto_tile(base, "treecode", N, "cpu").tree_tile == 32
    st = from_numpy(jax_to_numpy(jnb.models.plummer(N, seed=1)))
    cfg, _, _ = plan_treecode(base, st, D, "cpu", "treecode_staged")
    assert cfg.tree_flat_cap > 0 and cfg.tree_far_cap > 0 and cfg.tree_far_max > 0
    small = from_numpy(jax_to_numpy(jnb.models.plummer(64, seed=1)))
    with pytest.raises(ValueError, match="flat-list machinery"):
        plan_treecode(base, small, 2, "cpu", "treecode_staged")


# ------------------------------------------------------- a gloo world of 4
RUN_CFG = SimConfig(solver="treecode", tree_tile=128, tree_src_tile=128, tree_theta=0.55,
                    tree_mac_tau=2e-4, tree_near_slack=0, tree_vip_tiles=8,
                    tree_rebuild_every=4, tree_hier=False, tree_max_near=16,
                    tree_flat_cap=16 * 16)
SMALL_CFG = SimConfig(solver="treecode", tree_tile=32, tree_src_tile=64, tree_theta=0.55,
                      tree_max_near=64, tree_vip_tiles=0, tree_near_slack=0,
                      tree_flat_cap=4096, tree_hier=False)


@pytest.fixture(scope="module")
def world4():
    exact = _sorted(CASES["exact"][0])
    small = _sorted(13, 4096)
    cases = [
        dict(kind="sim", cfg=RUN_CFG, state=jax_to_numpy(jnb.models.plummer(N, seed=43)),
             steps=8, strategy="treecode_staged"),
        dict(kind="staged", cfg=SimConfig(**CASES["exact"][1]), pos=exact[0], mass=exact[1]),
        dict(kind="staged", cfg=SMALL_CFG, pos=small[0], mass=small[1]),
        dict(kind="replay", cfg=RUN_CFG.replace(tree_rebuild_every=2),
             state=jax_to_numpy(jnb.models.plummer(N, seed=44)), steps=3,
             strategy="treecode_staged", calls=1),
    ]
    return spawn_ring(run_cases, D, device_type="cpu", args=(cases,))


def test_staged_run_is_its_eager_loop_bitwise(world4):
    """``ShardedSimulation(strategy="treecode_staged").run`` (its resort,
    build and step programs, called directly on the CPU; the lists' absent
    far entries kept as None) against its eager loop
    (``sharded.eager_run``) from the same state, a chunk of 2 steps and a
    remainder: the gathered state and ``sort_perm``, to the bit."""
    (call,) = world4[3]
    for k, want in call["eager"].items():
        np.testing.assert_array_equal(call["run"][k], want, err_msg=k)
    assert int(call["run"]["step"]) == 3


def test_staged_run_matches_single_chip(world4):
    """``ShardedSimulation(strategy="treecode_staged")``: 8 steps, a resort
    every 4, against ``Simulation`` with the near lists unclamped (max_near
    = K_s), through both ``sort_perm``."""
    got = world4[0]
    ref = Simulation(RUN_CFG.replace(tree_max_near=N // 128,
                                     tree_flat_cap=(N // 128) * (N // 128)),
                     from_numpy(jax_to_numpy(jnb.models.plummer(N, seed=43))), device="cpu")
    ref.run(8)
    a, b = got["pos"][:N], ref.state.pos[:N].numpy()
    inv_a = np.empty(N, int)
    inv_a[got["sort_perm"]] = np.arange(N)
    inv_b = np.empty(N, int)
    inv_b[ref.sort_perm] = np.arange(N)
    np.testing.assert_allclose(a[inv_a], b[inv_b], **RUN_TOL)
    assert got["diag"]["overspeed"] == 0 and np.isfinite(got["diag"]["energy"])


def test_staged_world_force_matches_ranks(world4, forces):
    """The exact-limit force through the world's collectives (gathers, the
    ring's shifts, the summed panel and reactions) against the ranks in
    this process."""
    _exact(world4[1], forces["exact"]["acc"])


def test_staged_rejects_undersized_shard(world4):
    """With fewer source tiles a shard than a chunk's entries the lists
    would hold no chunk and the near field would fall into the far field:
    the ranks raise, in the world and here."""
    assert "K_src >= entries" in world4[2]
    with pytest.raises(ValueError, match="K_src >= entries"):
        stream.staged_acc_ranks(SMALL_CFG, *_torch(*_sorted(13, 4096)), D)
