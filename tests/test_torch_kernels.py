"""The kernels' plain versions against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode with small tiles, as the JAX package's
own tests do. The CUDA kernels themselves are compared with these plain
versions on the card by ``chip_smoke.py``.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import functools

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.ops.pallas_force import pallas_block_acc
from n_body_problem_tpu.ops.pallas_symmetric import symmetric_acc as jax_symmetric_acc
from n_body_problem_tpu_torch.ops import cuda_build, cuda_force, cuda_symmetric

EPS2 = 1e-6
C = 0.1
SOURCES = ["allpairs.cu", "far_hier.cu", "far_single.cu", "gather.cu", "min_dist.cu", "near.cu",
           "near_panel.cu", "stamp.cu", "symmetric.cu", "symmetric_bf16x3.cu", "top_k.cu",
           "vip.cu"]


def _pair(jstate):
    """The same bodies as numpy (for JAX) and torch (for the port)."""
    pos, mass = np.asarray(jstate.pos), np.asarray(jstate.mass)
    return (pos, mass), (torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy()))


@pytest.mark.parametrize("rows", ["square", "block"])
def test_block_acc_plain_matches_pallas(rows):
    # rtol=1e-4, atol=1e-6: the JAX package's bound for this kernel against
    # the direct sum (tests/test_pallas.py:30); both sides are float32 sums
    # over the same pairs in different orders.
    (pj, mj), (tpj, tmj) = _pair(jnb.pad_state(jnb.models.plummer(300, seed=7), multiple=128))
    if rows == "square":
        pi, tpi = pj, tpj
    else:
        pi = np.asarray(jnb.models.plummer(192, seed=8).pos) + np.float32(0.5)
        tpi = torch.from_numpy(pi.copy())
    want = np.asarray(pallas_block_acc(pi, pj, mj, eps2=EPS2, compensate=C,
                                       tile_i=64, tile_j=128))
    got = cuda_force.block_acc(tpi, tpj, tmj, eps2=EPS2, compensate=C,
                               tile_i=64, tile_j=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    plain = cuda_force.block_acc_plain(tpi, tpj, tmj, eps2=EPS2, compensate=C)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize(
    "n_real,tile",
    [
        (120, 32),   # even K = 4
        (200, 32),   # odd K = 7
        (60, 64),    # K = 1 (pure diagonal triangle)
        (90, 32),    # even K with padding bodies in the last tile
        (64, 32),    # K = 2: one slot a tile from the last diagonal
        (150, 32),   # odd K = 5 with padding bodies
        (192, 32),   # even K = 6
    ],
)
def test_symmetric_plain_matches_pallas(n_real, tile):
    # rtol=1e-4, atol=2e-6: the JAX package's bound for this kernel against
    # the direct sum (tests/test_pallas_symmetric.py:27). The coverage is the
    # same; the JAX reaction runs through centred matmul panels, so the
    # rounding differs.
    (p, m), (tp, tm) = _pair(jnb.pad_state(jnb.models.plummer(n_real, seed=3), multiple=tile))
    want = np.asarray(jax_symmetric_acc(p, m, eps2=EPS2, compensate=C, tile=tile))
    got = cuda_symmetric.symmetric_acc(tp, tm, eps2=EPS2, compensate=C, tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-6)


def test_symmetric_plain_covers_every_pair_once():
    """Against the port's own direct sum: a missed or doubled tile pair
    would be off by a whole pair force, far outside float32 rounding."""
    state = tnb.pad_state(tnb.models.plummer(450, seed=9), multiple=64)
    for tile in (64, 128, 32):
        if state.n % tile:
            continue
        got = cuda_symmetric.symmetric_acc_plain(state.pos, state.mass, eps2=EPS2,
                                                 compensate=C, tile=tile)
        want = tnb.ops.direct_acc(state.pos, state.mass, eps2=EPS2, compensate=C)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=2e-6)


def test_symmetric_momentum():
    """Half-pair evaluation applies +/- the same pair force, so the net
    momentum change is zero to rounding (tests/test_pallas_symmetric.py:30-39)."""
    state = tnb.pad_state(tnb.models.plummer(100, seed=5), multiple=32)
    acc = cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, compensate=C, tile=32)
    net = torch.sum(state.mass[:, None] * acc, dim=0)
    np.testing.assert_allclose(net.numpy(), np.zeros(3), atol=1e-6)


def test_slots_are_summed_in_slot_order():
    """``sum_slots`` adds slot 0, then 1, then 2, as ``symmetric_sum_kernel``
    does: (1e8 + 1) - 1e8 is 0 in float32, every other order gives 1."""
    slots = torch.tensor([1e8, 1.0, -1e8]).reshape(1, 3, 1, 1).expand(1, 3, 1, 3)
    assert torch.equal(cuda_symmetric.sum_slots(slots.contiguous()), torch.zeros(1, 3))


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "mixed"])
def test_twins_fill_every_slot_from_one_block(precision, monkeypatch):
    """Both twins store a block's sums with ``_put_slots`` into the slots
    ``symmetric_slots`` names, each of the K^2 once, at an odd and an even
    K; what they return is those slots added in slot order."""
    state = tnb.pad_state(tnb.models.plummer(300, seed=4), multiple=64)
    for tile in (64, 32):                                  # K = 5, 10
        k = state.n // tile
        stores = []
        put = cuda_symmetric._put_slots
        caught = {}

        def record(slots, i, j, s, action, reaction):
            stores.extend((int(t), int(u)) for t, u in zip(i, j))
            if s:
                stores.extend((int(u), int(t)) for t, u in zip(i, j))
            caught["slots"] = slots
            put(slots, i, j, s, action, reaction)

        monkeypatch.setattr(cuda_symmetric, "_put_slots", record)
        got = cuda_symmetric.symmetric_acc_plain(state.pos, state.mass, eps2=EPS2,
                                                 compensate=C, tile=tile, precision=precision)
        monkeypatch.undo()
        assert sorted(stores) == [(t, u) for t in range(k) for u in range(k)]
        want = [cuda_symmetric.symmetric_slots(k, b) for b in range(k * (k + 1) // 2)]
        assert {w[0] for w in want} | {w[1] for w in want} == set(stores)
        assert torch.equal(got, cuda_symmetric.sum_slots(caught["slots"]))


def test_cpu_tensors_launch_no_kernel():
    before = (cuda_force.block_acc.launches, cuda_symmetric.symmetric_acc.launches)
    state = tnb.pad_state(tnb.models.plummer(100, seed=0), multiple=128)
    cuda_force.allpairs_acc(state.pos, state.mass, eps2=EPS2, tile_i=128, tile_j=128)
    cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=128)
    sim = tnb.Simulation(tnb.SimConfig(solver="pallas_symmetric", pallas_sym_tile=64),
                         tnb.models.plummer(64, seed=0), device="cpu")
    sim.run(2)
    assert (cuda_force.block_acc.launches, cuda_symmetric.symmetric_acc.launches) == before
    assert before == (0, 0)


@pytest.mark.parametrize("kernel", ["allpairs", "symmetric"])
def test_misaligned_n_raises(kernel):
    state = tnb.models.plummer(100, seed=0)
    with pytest.raises(ValueError):
        if kernel == "allpairs":
            cuda_force.allpairs_acc(state.pos, state.mass, eps2=EPS2, tile_i=64, tile_j=128)
        else:
            cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=64)


def test_unknown_precision_raises():
    state = tnb.pad_state(tnb.models.plummer(60, seed=0), multiple=64)
    for fn in (cuda_symmetric.symmetric_acc, cuda_symmetric.symmetric_acc_bf16x3):
        with pytest.raises(ValueError):
            fn(state.pos, state.mass, eps2=EPS2, tile=64, precision="f16")
    with pytest.raises(ValueError):
        cuda_symmetric.symmetric_acc_bf16x3(state.pos, state.mass, eps2=EPS2, tile=64,
                                            precision="f32")


def _rel_err(got, want):
    """Per-body relative force difference (tests/test_pallas_symmetric.py:48-51)."""
    return np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-12)


@functools.lru_cache(maxsize=None)
def _fast_case(n_real, multiple, tile, precision):
    """(n_real, port, jax) forces of one mode on Plummer seed 7; the JAX side
    in interpret mode, as tests/test_pallas_symmetric.py runs it."""
    (p, m), (tp, tm) = _pair(jnb.pad_state(jnb.models.plummer(n_real, seed=7), multiple=multiple))
    want = np.asarray(jax_symmetric_acc(p, m, eps2=EPS2, compensate=C, tile=tile,
                                        precision=precision))
    got = cuda_symmetric.symmetric_acc(tp, tm, eps2=EPS2, compensate=C,
                                       tile=tile, precision=precision)
    return got.numpy(), want


FAST_SHAPES = [
    (512, 64, 64),     # even K = 8, the JAX envelope test's shape
    (448, 64, 64),     # odd K = 7
    (450, 512, 64),    # padding bodies in the last tile
    (64, 64, 64),      # K = 1: "mixed" is the f32 mode
    (4096, 512, 512),  # the production tile and its centring
    (320, 64, 64),     # odd K = 5: near and fast diagonals in "mixed"
    (384, 64, 64),     # even K = 6
]


@pytest.mark.parametrize("precision", ["bf16x3", "mixed"])
@pytest.mark.parametrize("n_real,multiple,tile", FAST_SHAPES)
def test_fast_modes_match_jax(n_real, multiple, tile, precision):
    """The port's bf16x3 and mixed modes against the JAX package's.

    A faithful port differs from JAX by float32 summation order only: per
    body p99 <= 1.5e-5 and median <= 4e-7, and its distance from JAX at most
    0.3 of JAX's own distance from its f32 mode. Assigning a pair's action
    and reaction by the wrong tile, or centring the panel on the wrong
    point, stays inside the JAX envelopes but gives a ratio of 1 to 4.5.
    With K <= 3 tiles "mixed" runs no fast diagonal: there it is the f32
    mode, within rtol 1e-4, atol 2e-6 (the f32 kernel's bound)."""
    got, want = _fast_case(n_real, multiple, tile, precision)
    err = _rel_err(got, want)[:n_real]
    assert np.percentile(err, 99) <= 1.5e-5
    assert np.median(err) <= 4e-7
    jax_f32 = _fast_case(n_real, multiple, tile, "f32")[1]
    if precision == "mixed" and got.shape[0] // tile <= 3:
        np.testing.assert_allclose(got, jax_f32, rtol=1e-4, atol=2e-6)
    else:
        ratio = np.linalg.norm(got - want) / np.linalg.norm(want - jax_f32)
        assert ratio <= 0.3, ratio


@pytest.mark.parametrize("precision,p99_bound,median_bound",
                         [("bf16x3", 3e-2, 4e-3), ("mixed", 5e-3, 5e-4)])
def test_fast_modes_stay_in_the_jax_envelopes(precision, p99_bound, median_bound):
    """tests/test_pallas_symmetric.py:54-91 for the port: the fast modes
    against the direct sum, 512 bodies, tile 64."""
    state = tnb.models.plummer(512, seed=7)
    want = tnb.ops.direct_acc(state.pos, state.mass, eps2=EPS2, compensate=C).numpy()
    got = cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, compensate=C,
                                       tile=64, precision=precision).numpy()
    err = _rel_err(got, want)
    assert np.percentile(err, 99) < p99_bound
    assert np.median(err) < median_bound
    assert not np.array_equal(got, cuda_symmetric.symmetric_acc(
        state.pos, state.mass, eps2=EPS2, compensate=C, tile=64).numpy())


@pytest.mark.parametrize("seed", [7, 11])
def test_mixed_tighter_than_bf16x3(seed):
    """tests/test_pallas_symmetric.py:94-106: exact f32 near diagonals make
    "mixed" at least as accurate as "bf16x3"."""
    state = tnb.models.plummer(512, seed=seed)
    want = tnb.ops.direct_acc(state.pos, state.mass, eps2=EPS2, compensate=C).numpy()
    p99 = {}
    for precision in ("bf16x3", "mixed"):
        got = cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, compensate=C,
                                           tile=64, precision=precision).numpy()
        p99[precision] = np.percentile(_rel_err(got, want), 99)
    assert p99["mixed"] <= p99["bf16x3"]


def test_fast_mode_cpu_tensors_launch_no_kernel():
    state = tnb.pad_state(tnb.models.plummer(100, seed=0), multiple=64)
    before = (cuda_symmetric.symmetric_acc.launches, cuda_symmetric.symmetric_acc_bf16x3.launches)
    for precision in ("bf16x3", "mixed"):
        cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=64,
                                     precision=precision)
    assert (cuda_symmetric.symmetric_acc.launches,
            cuda_symmetric.symmetric_acc_bf16x3.launches) == before == (0, 0)


def test_kernel_argument_checks():
    """What the CUDA wrappers check before a launch, on CPU tensors."""
    dev = torch.device("cpu")
    good = torch.zeros((8, 3))
    cuda_build.require_f32("x", good, (8, 3), dev)
    for bad, exc in ((good.double(), TypeError), (good[:, :2], ValueError),
                     (torch.zeros((3, 8)).t(), ValueError), (good.numpy(), TypeError)):
        with pytest.raises(exc):
            cuda_build.require_f32("x", bad, (8, 3), dev)


def test_build_inputs_are_the_package_sources():
    names = [p.name for p in cuda_build.sources()]
    assert names == SOURCES
    assert cuda_build.library_path().parent.parent == cuda_build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS


def test_build_hash_covers_the_included_headers(tmp_path, monkeypatch):
    """Editing a header the kernels include must rebuild the library."""
    import shutil

    for src in cuda_build.CSRC_DIR.iterdir():
        shutil.copy(src, tmp_path / src.name)
    assert (tmp_path / "lists.cuh").is_file()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = cuda_build.source_hash()
    (tmp_path / "lists.cuh").write_text((tmp_path / "lists.cuh").read_text() + "\n")
    assert cuda_build.source_hash() != before
    assert [p.name for p in cuda_build.sources()] == SOURCES
