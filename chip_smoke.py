#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``n_body_problem_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises, so the exit code
is non-zero:

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit; TF32 matmuls must be off.
2. build: compiles the kernels from ``n_body_problem_tpu_torch/csrc``.
3. exact kernels: the all-pairs and symmetric kernels against their plain
   PyTorch versions at N = 128, 896 (odd tile count), 1,024 (90 padding
   bodies) and 65,536, and at K = 1, 3 and 5 (odd, 60 padding bodies) of the
   symmetric kernel's own 512-body tile (N = 512, 1,536, 2,560; 1,024 is
   K = 2), within rtol=1e-4, atol=2e-6; the all-pairs kernel also in block
   form; both launched twice at every shape for bitwise repeatability (the
   symmetric kernels sum their slots in slot order), with the symmetric
   kernel's slot bytes and the peak device memory of its call printed; the
   symmetric kernel for momentum (|sum m a| < 1e-6, < 1e-7 at 65,536), and
   at N = 448 with tile 64 (its wrapper pads to 512). Times both at N =
   65,536, and once each at 262,144, where the two must agree within 1e-4 a
   body and the symmetric kernel's two launches bitwise. Then the all-pairs
   kernel's
   splits: at 384 x 65,536, 2,048 x 65,536 and x 524,288 (the error probe's
   shape), 16,384 x 65,536 (a four-way ring's), 8,192 and 32,768 squared, the
   split its schedule chooses (several column pieces, two launches) and
   others (one piece; 1, 2, 4 and 8 parts), each against the plain version
   and twice for bitwise equality; timed at 8,192 squared and at
   2,048 x 524,288. Then the bf16x3/mixed kernel against its twin
   in both modes at N = 512 and 448 (tile 64), 1,024 (934 real, tile 512)
   and 65,536 (tile 512): |kernel - twin| / |twin - f32 twin| <= 0.3 and a
   per-body p99 <= 1.5e-5 ("mixed" with K <= 3 tiles is the f32 mode and
   matches the f32 kernel within rtol=1e-4, atol=2e-6); each mode's error
   against the all-pairs kernel inside the JAX envelopes, mixed no worse
   than bf16x3; two launches bitwise equal, slot bytes and peak memory
   printed. Times both modes at 65,536.
4. treecode kernels: every treecode kernel against its plain version on
   the port's own work lists, at the shapes of every treecode run of phase
   6 and one smaller: the hierarchical path (near, far, VIP) on Plummer
   spheres of 8,192, 20,480 (with ``tuned_tree_overrides``: 32-body source
   tiles, so 64 entries fill the near kernel's 2,048-body stage), 65,536
   and 524,288 bodies; the single-level flat path (near at 32-body rows,
   single-level far, VIP) at 20,480 and 65,536 with ``tree_hier=False`` and
   at 2,560; the dense path (gather, near-panel, single-level far, VIP) at
   1,024 (every tile near, so no far field) and at 20,480 with
   ``tree_flat_cap=-1``; and the near kernel's other block splits, target
   rows of 64 and 256 bodies at 65,536 (``tree_tile``). Within rtol=1e-4,
   atol=2e-6 on the raw outputs, the gather exactly; each launch repeated
   for bitwise equality. Times each kernel at the largest shape of its
   path, beside its plain version, its bound, its issue floor and (the
   gather) one ``index_select`` call; the near kernel at every row size,
   with the largest and the mean number of chunks a row; the VIP sweep and
   the far field also at 524,288, the single-level far field also at 20,480
   dense and the near-panel kernel also at 1,024; these four each with its
   kernels' device time from a ``torch.profiler`` trace (the sweep is a
   pair and a summing kernel). Last, the acceptance build's
   minimum-distance kernel, which only the flat and dense builds run,
   bitwise its plain twin and itself at the shapes those builds give it in
   one rebuild of phase 6's ``20k flat`` and ``20k dense`` runs (640 x 320,
   32-body rows), timed beside the twin, its bound and its issue floor
   (``compare_min_dist``); phase 6 counts its launches a rebuild. Then the
   hierarchical build's fused opening test (``compare_min_dist_open``):
   every level of one eager rebuild of the 1,048,576-body Plummer sphere
   and of the AGORA disk bitwise its plain twin and itself; level 0 timed
   beside the distances' kernel alone and beside that kernel with the
   PyTorch passes it replaced; phase 6 counts its launches a rebuild. Then the work lists' row selection (``compare_top_k``) bitwise
   its plain twin and itself on every selection of a rebuild (the VIP pick,
   the near and the far lists') at 65,536 and 1,048,576 Plummer bodies and
   on the AGORA disk (2,125,000), timed beside the twin, one ``torch.topk``
   call and the bound of its bytes; phase 6 counts its launches a rebuild
   (``top_k_a_rebuild``).
5. exact main path: ``Simulation(SimConfig(), plummer(65536))`` (the
   symmetric kernel), ``solver="pallas"`` (the all-pairs kernel), leapfrog,
   and ``pallas_sym_precision="bf16x3"`` and ``"mixed"`` (the tensor-core
   kernel); launch counters show that each run launched its kernels every
   step and no other. Then the pair-matrix foil (plain PyTorch) at 4,096
   against the all-pairs kernel's force. Then repeatability
   (``drive_repeat``): ``auto`` and ``solver="pallas_symmetric"`` in each
   precision, at 128 bodies x 25 Euler steps (the JAX determinism test's
   shape) and 65,536 x 200 leapfrog steps, and the foil at 128 x 25 and
   4,096 x 20 leapfrog steps, each run twice from one state: positions and
   velocities bitwise equal.
6. treecode main path: ``Simulation(SimConfig(solver="treecode"))`` at
   N = 65,536 (Euler, then leapfrog; 8 steps primed, 64 timed), at 20,480
   with ``tuned_tree_overrides(20480)`` and at 524,288 (16 timed); then the
   flat path at 20,480 (``tree_hier=False``, the galaxy_20K scale), at
   65,536 with leapfrog and at 2,560 (chosen by N alone), and the dense
   path at 1,024 (chosen by N alone) and at 20,480 (``tree_flat_cap=-1``),
   64 timed steps each. Each run must launch exactly the kernels its path
   makes a step (``launches_a_step``), keep positions finite and overspeed
   0. After it the treecode force on lists built afresh (``bench.py``'s
   probe) must stay within p99 2.5e-3 and median 5e-4 of the all-pairs
   kernel's exact force (all bodies, or 2,048 sampled at 524,288); the
   error on the lists the run last stepped with, ``tree_rebuild_every``
   steps old, is printed beside it. A ``torch.profiler`` trace of 16 steps
   at 65,536, 20,480 flat and 20,480 dense gives the step's breakdown and
   the device's idle share.
7. energy: the JAX package's energy-drift test through the symmetric kernel.
8. CLI: ``python -m n_body_problem_tpu_torch run`` on a galaxy collision of
   20,480 stars, with the default solver and with ``--solver treecode
   --tree-tuned``, in subprocesses.
9. tools, each in a subprocess that counts its kernel launches from 0 and
   reports them as it exits: the bench harness's treecode leg at 65,536
   (``--n 65536 --solver treecode --steps 16``: finite record, ``backend``
   cuda, probe p99 < 2.5e-3 and median < 5e-4); the CLI's ``bench`` with
   its defaults (``auto``: the symmetric kernel at 65,536); ``run`` with no
   ``--model`` and no data file (dataset 1's fallback, 81,920
   galaxy_collision stars on ``auto``) with ``--export-snap --profile``:
   ``final.npz`` at step 20, ``final.snap`` equal to it to the snap format's
   printed precision, a profiler trace naming a device kernel; a Tipsy file
   of galaxy_20K's layout (2,500 dark + 17,500 star, 860,032 bytes) run as
   dataset 0 on the treecode with ``--tree-tuned`` (the hierarchical path,
   padded to 20,224 as in the JAX package) and converted to 20,000 CSV
   rows; and, beside them, ``validate --convergence --n 4096 --solver
   pallas_symmetric``: leapfrog's fitted order >= 1.8 and the float64
   oracle's p99 position delta <= 1e-5. Each tool must launch the kernels
   of its path.
10. render, at full size: (a) a Plummer 65,536 state (seed 0) rendered at
    1024x1024 with ``OrbitCamera(distance=2.0)`` on the card and on the
    CPU, within rtol 1e-5 and atol 1e-5 x the frame's maximum; whether two
    card renders are bitwise equal; the splat's ms a frame. (b) The bench's
    step+render leg, ``bench_render(65536, "pallas_symmetric")``, beside
    phase 5's exact step, with its 40 symmetric launches (20 calls of the
    pair kernel and the slots' sum), peak memory and a
    profiler breakdown; its steps and frames are replays of the movie's
    graphs (phase 13 holds them to the eager frame loop). (c) The
    hierarchical treecode movie at 65,536, a frame every
    ``tree_rebuild_every`` = 8 steps for 16 steps at 1024x768:
    its final state bitwise that of ``run(16)``, and ``trajectory(16,
    save_every=8)``'s last frame ``run(16)``'s positions in call-entry
    order, bitwise. (d) A flat (20,480, ``tree_hier=False``) and a dense
    (1,024, ``tree_flat_cap=-1``) movie, so that kernels 3, 4 and 5 run
    under ``movie``. (e) The CLI: ``run --dataset 0 --steps 200
    --render-every 50`` writes 4 PNGs, ``render`` a PNG of its
    ``final.npz``; ``--gif`` and ``--serve`` where Pillow is installed.
    Every phase-10 launch counts toward the kernels' record.
11. multi-GPU: (a) an NCCL world of min(GPUs, 4) ranks (``parallel.spawn_ring``;
    one rank on a one-GPU machine) runs ``ShardedSimulation`` at the sizes of
    BASELINE.json configs 4 and 5: ``ring`` and ``half_ring`` at 262,144 with
    leapfrog (1 step compared, 4 timed), ``treecode`` at 1,048,576
    (hierarchical), 65,536 with ``tree_hier=False`` (flat) and 20,480 with
    ``tree_flat_cap=-1`` (dense), and ``treecode_staged`` at 1,048,576
    (hierarchical, VIPs; also against the replicated run of the same state),
    8 steps compared and 8 timed. Each world's ``run`` replays its CUDA
    graphs: it must be bitwise its eager loop (``sharded.eager_run``) from
    the same state (state and ``sort_perm``, every rank); ms/step of both in
    turns (eager, replayed, replayed, eager), capture seconds, the peak
    memory of each (the eager loop's and the capturing run's) and the size
    of the static lists. Each world is held against
    the single-device ``Simulation`` of the same state on the same card
    (exact: rtol 1e-5, atol 1e-6 after one step; treecode: rtol 5e-4, atol
    5e-5 through ``sort_perm``), whether bitwise equal, finite, overspeed 0,
    ms/step beside the single device's, and exactly the kernels
    of its path a step, replays counted (``sharded_launches_a_step``; the
    staged near kernel once a stage, D a step); the prime's and the
    replays' launches count toward the kernels' record, the eager loop's
    do not. (b) D = 4 on one card, rank by rank, through
    the per-rank functions (``ring.ring_acc_ranks``,
    ``tree.treecode_acc_ranks``): ring and half ring at 262,144, hierarchical
    at 524,288, flat at 65,536, dense at 20,480, against the single-device
    force on the same positions (the all-pairs kernel; the treecode on the
    ranks' merged lists) within rtol 1e-4, atol 2e-6; every kernel call they
    made (local rows, global sources) again against its plain twin and for
    bitwise repeatability; kernel 7's local form timed at 524,288 / 4 beside
    the single-device call (``at_524288_rank_of_4`` in its record); kernel 7
    with one array as targets and sources bitwise its output before the two
    were split (``kernel_compare.NEAR_GOLDEN_SHA256``). Then the staged
    ranks (``stream.staged_acc_ranks``) at hierarchical 1,048,576 and flat
    65,536 beside the replicated ranks, both against the all-pairs kernel's
    exact force: the staged within the treecode's envelope (p99 2.5e-3,
    median 5e-4) and no further from it than the replicated, their
    difference beside test_stream.py's bar (p99 8e-4, max 8e-3); the exact
    limit (16,384, 8 VIP tiles) within rtol 2e-5 of the single device;
    every call against its twin and bitwise repeatable; kernel 7's 16 stage
    calls at 1,048,576 / 4 (262,144 x 262,144 each) timed beside the
    replicated ranks' 4 (``at_1048576_staged_rank_of_4``), and a rank's
    resident bytes reckoned. (c) ``run --devices 2`` on ``cuda``: exit 2
    with ``make_ring_mesh``'s message on one GPU, ``final.npz`` with two or
    more; ``python -m n_body_problem_tpu_torch.multichip --devices 1
    --device cuda``, all seven legs. (b)'s and (c)'s launches are not
    counted.
12. tools and examples, each in a subprocess that counts its kernel
    launches from 0 (they count toward the kernels' record): (a)
    ``tune_small_n --mode sweep --legs default,flat,rebuild32 --steps 64``,
    every leg finite with its probe's p99 inside 2.5e-3, the summary naming
    a best leg and the card; (b) ``tune_small_n --mode crossover --n 65536
    --steps 64``; (c) ``hier_census.row_counts`` at 8,192 on the card and on
    the CPU: the integer fields equal, at least 99 % of rows with the same
    near and far counts (a float32 score may flip at its threshold), how
    many differ printed; (d) ``dataset_sweep --steps 20``: the fallbacks of
    ids 1 and 2 ``ok`` and finite; (e) the four examples at their default
    sizes (the movie at 2 blocks): exit 0, finite energies, overspeed 0, a
    GIF of 40 frames (the ring example's ranks are processes of its own:
    their launches are not counted); (f) ``validate --solver treecode --integrator
    semi_implicit_euler --n 65536 --steps 1000 --check-every 250``:
    overspeed 0 at every check, max |dE/E| <= 1e-4, the card's name and
    power limit in the report.
13. CUDA graphs (every earlier phase already runs ``Simulation`` through
    its graphs, ``n_body_problem_tpu_torch.graphs``): on each
    single-device path, the graph run beside the eager loop
    (``make_treecode_run``, ``run_steps``) on the same state for two whole
    chunks and a remainder (19 steps; 67 at 20,480 tuned, whose chunks are
    32 steps): the hierarchical path at 65,536 (Euler and leapfrog), 20,480
    tuned, 524,288 and 1,048,576; the flat path at 20,480 and 65,536; the
    dense path at 1,024 and 20,480; ``auto`` at 4,096 and 65,536 and
    ``pallas`` at 65,536. Positions, velocities, accelerations, time, step
    and ``sort_perm`` bitwise the eager loop's; the replays under
    ``set_sync_debug_mode("error")``; launches a step as
    ``launches_a_step`` says, replays counted. Prints ms/step of both in
    turns (eager, graph, graph, eager), capture seconds, the idle share of
    each from ``torch.profiler`` and peak memory of each, and the card's
    name and power limit; writes ``out/chip_smoke_graphs.json``. Then the
    frame rows (``drive_frame_graphs``): ``movie`` (1024x1024) and
    ``trajectory`` with a frame every step, 19 steps, at hierarchical
    65,536 (every frame its own chunk), ``pallas`` 65,536 and (the movie)
    ``auto`` 65,536, against the eager frame loop (``eager_movie``,
    ``eager_trajectory``) from the same state: frames, state and
    ``sort_perm`` bitwise; the frame graph bitwise the eager splat
    of the same state; the replays of spans and frames under
    ``set_sync_debug_mode("error")``; launches a step, replays counted; a
    second camera and scale replayed without a new capture and equal to
    its eager movie; ms/step in turns, capture seconds, idle share and peak
    memory of each; writes ``out/chip_smoke_frame_graphs.json``. The graph
    runs' launches count toward the kernels' record, the eager reference's
    do not.
14. the last gaps against the JAX package (``drive_last_gaps``): (a) the
    free functions ``simulation.run_trajectory`` and ``run_with_frames``
    (1024x1024) with the ``pallas`` step function at 65,536, 8 steps and a
    frame every 2: bitwise their eager loop, the whole call (capture
    included) under ``set_sync_debug_mode("error")``, the all-pairs kernel
    once a step, replays counted; at 4,096 the card's frames after 2 steps
    within rtol 1e-5 / atol 1e-5 x max of the CPU's. (b) ``utils.morton.morton_keys_device``
    at 524,288 bodies (all real, and 1,000 padding) equal to the CPU's
    keys. (c) ``treecode_profile --decompose 20480t,65536`` in a subprocess
    (``tools/decompose_step.py``'s legs on the replays, one JSON line a
    size, ``out/chip_smoke_decompose.json``). (a)'s and (c)'s launches
    count toward the kernels' record.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``. The
records of every kernel but the gather also carry ``issue_floor_ms``
(``kernel_compare.issue_floor_ms`` at the SM clock of this run); those of
the VIP sweep, the two far fields and the near-panel kernel ``device_ms``
and their second shape's record (``at_524288``, ``at_20480_dense``,
``at_1024``).
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

from n_body_problem_tpu_torch.kernel_compare import (MIN_DIST_FLOPS, MIN_DIST_SLOTS,
                                                      PAIR_BOTH_FLOPS, PAIR_BOTH_SLOTS,
                                                      PAIR_FLOPS, PAIR_SLOTS, PEAK_BYTES, PHYS,
                                                      TREE_WORK,
                                                      bound, fast_bound, fast_issue_floor_ms,
                                                      issue_floor_ms, kernel_ms, near_work,
                                                      sm_clock_mhz, tree_bound)

ROOT = pathlib.Path(__file__).resolve().parent
TOL = dict(rtol=1e-4, atol=2e-6)
# (padded N, real N): one tile, odd tile count, padding bodies, full size.
SIZES = ((128, 128), (896, 896), (1024, 934), (65536, 65536),
         (512, 512), (1536, 1536), (2560, 2500))
N_MAIN, N_LARGE = 65536, 262144
PRIME_STEPS, TIMED_STEPS = 5, 20
TREE_PRIME, TREE_TIMED = 8, 64
ERR_P99, ERR_MEDIAN = 2.5e-3, 5e-4   # tests/test_treecode_hier.py:126-127
TREE_KERNELS = ("near", "far", "vip", "far_single", "gather", "near_panel")
# FP32 operations a kernel does per interaction, an FMA counted as two and an
# rsqrt as one (a body against a node's monopole + quadrupole; a body pair one
# way and both ways), the issue slots each takes, the peak rates, ``bound``
# and the physics of every check (PHYS) are ``kernel_compare``'s.
# (padded N, real N, tile) of the fast modes' check: even K = 8 (the JAX
# test's shape), odd K = 7, padding with K = 2, and the production size.
FAST_SIZES = ((512, 512, 64), (448, 448, 64), (1024, 934, 512), (65536, 65536, 512))
FAST_RATIO = 0.3   # |kernel - twin| / |twin - f32 twin|
FAST_P99_VS_TWIN = 1.5e-5   # per-body relative kernel - twin difference
# JAX envelopes of the fast modes against the direct sum, (p99, median)
# (tests/test_pallas_symmetric.py:54-63).
FAST_ENVELOPE = {"bf16x3": (3e-2, 4e-3), "mixed": (5e-3, 5e-4)}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def cloud(n: int, n_real: int, seed: int, device):
    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.state import pad_state_to

    return pad_state_to(models.plummer(n_real, seed=seed), n).to(device)


def agree(res: dict, key: str, name: str, got, want) -> float:
    """Hold a kernel's output against its plain version's; keeps the
    largest |difference| in ``res[key]``."""
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    res[key]["max_abs_err"] = max(res[key]["max_abs_err"], err)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(torch.allclose(got, want, **TOL),
          f"{name}: max |kernel - plain| = {err:.3e} outside rtol=1e-4, atol=2e-6")
    return err


def twice_equal(name: str, fn):
    """``fn()`` launched twice: the two outputs must be bitwise equal.
    Returns the first and the peak device memory the first call took
    beyond what was allocated before it (the scratch and the output)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(torch.equal(got, fn()), f"{name}: two launches differ bitwise")
    return got, peak


def compare_kernels(device, sizes=SIZES, time_at: int | None = N_MAIN) -> dict:
    """Phase 3: each exact kernel against its plain version; returns
    per-kernel ``max_abs_err`` and, at ``time_at`` bodies, ``ms`` and
    ``plain_ms``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    tiles = dict(tile_i=128, tile_j=128)
    res = {"allpairs": {"max_abs_err": 0.0}, "symmetric": {"max_abs_err": 0.0}}
    for n, n_real in sizes:
        s = cloud(n, n_real, seed=n, device=device)
        pos, mass = s.pos, s.mass
        # The twin's tile (any divisor of N: the f32 sum is the same up to
        # rounding); the kernel tiles by 512 whatever the caller names.
        tile = cuda_symmetric.KERNEL_TILE if n % cuda_symmetric.KERNEL_TILE == 0 else 128
        a = cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS)
        ea = agree(res, "allpairs", f"allpairs N={n}", a,
                   cuda_force.block_acc_plain(pos, pos, mass, **PHYS))
        a2 = cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS)
        check(torch.equal(a, a2), f"allpairs N={n}: two launches differ bitwise")
        rows = cloud(384, 384, seed=n + 1, device=device).pos + 0.5
        ab = cuda_force.block_acc(rows, pos, mass, **tiles, **PHYS)
        eb = agree(res, "allpairs", f"allpairs block 384x{n}", ab,
                   cuda_force.block_acc_plain(rows, pos, mass, **PHYS))
        b, peak = twice_equal(f"symmetric N={n}", lambda: cuda_symmetric.symmetric_acc(
            pos, mass, tile=tile, **PHYS))
        es = agree(res, "symmetric", f"symmetric N={n}", b,
                   cuda_symmetric.symmetric_acc_plain(pos, mass, tile=tile, **PHYS))
        net = float((mass[:, None] * b).sum(0).abs().max())
        limit = 1e-7 if n == N_MAIN else 1e-6
        check(net < limit, f"symmetric N={n}: |sum m a| = {net:.3e} >= {limit}")
        torch.cuda.synchronize(device)  # a fault in the run shows here
        k = -(-n // cuda_symmetric.KERNEL_TILE)
        slots = cuda_symmetric.slot_bytes(k * cuda_symmetric.KERNEL_TILE,
                                          cuda_symmetric.KERNEL_TILE)
        print(f"kernels: N={n} (real {n_real}) allpairs err {ea:.3e} "
              f"block(384x{n}) err {eb:.3e} bitwise-repeatable; symmetric (K={k}) err "
              f"{es:.3e} |sum m a| {net:.3e} bitwise-repeatable, slots {slots} B, peak "
              f"{peak} B beyond the inputs", flush=True)

        if n == time_at:
            res["allpairs"]["ms"] = time_ms(
                lambda: cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS), 20)
            res["allpairs"]["plain_ms"] = time_ms(
                lambda: cuda_force.block_acc_plain(pos, pos, mass, **PHYS), 3)
            res["symmetric"]["ms"] = time_ms(
                lambda: cuda_symmetric.symmetric_acc(pos, mass, tile=tile, **PHYS), 20)
            res["symmetric"]["plain_ms"] = time_ms(
                lambda: cuda_symmetric.symmetric_acc_plain(
                    pos, mass, tile=tile, **PHYS), 3)
            # Inputs read once (positions and masses), the (N, 3) output
            # written once; the symmetric kernel takes each pair once.
            nbytes = n * 16 + n * 12
            clock = sm_clock_mhz()
            res["allpairs"].update(library_ms=None, **bound(PAIR_FLOPS * n * n, nbytes),
                                   issue_floor_ms=issue_floor_ms(n * n, PAIR_SLOTS, clock))
            slots = cuda_symmetric.slot_bytes(n, cuda_symmetric.KERNEL_TILE)
            res["symmetric"].update(
                library_ms=None, **bound(PAIR_BOTH_FLOPS * n * (n - 1) // 2, nbytes),
                issue_floor_ms=issue_floor_ms(n * (n - 1) / 2, PAIR_BOTH_SLOTS, clock),
                slot_bytes=slots, slot_bytes_ms=2 * slots / PEAK_BYTES * 1e3)
            print("kernels: times at N={} (ms/call) allpairs {:.4f} vs plain {:.4f}, bound "
                  "{:.4f}, issue floor {:.4f}; symmetric {:.4f} vs plain {:.4f}, bound {:.4f}, "
                  "issue floor {:.4f} at {:.0f} MHz".format(
                      n, res["allpairs"]["ms"], res["allpairs"]["plain_ms"],
                      res["allpairs"]["bound_ms"], res["allpairs"]["issue_floor_ms"],
                      res["symmetric"]["ms"], res["symmetric"]["plain_ms"],
                      res["symmetric"]["bound_ms"], res["symmetric"]["issue_floor_ms"],
                      clock), flush=True)
    if time_at is not None:
        # The largest size `auto` gives the symmetric kernel: once each,
        # beside the all-pairs kernel, which has to agree with it.
        s = cloud(N_LARGE, N_LARGE, seed=N_LARGE, device=device)
        ap = lambda: cuda_force.block_acc(s.pos, s.pos, s.mass, **tiles, **PHYS)  # noqa: E731
        sy = lambda: cuda_symmetric.symmetric_acc(s.pos, s.mass, **PHYS)  # noqa: E731
        got, peak = twice_equal(f"symmetric N={N_LARGE}", sy)
        diff = float(rel_err(got, ap(), N_LARGE).max())
        del got
        check(diff < 1e-4, f"symmetric N={N_LARGE}: {diff:.3e} a body from the all-pairs kernel")
        res["symmetric"]["ms_262144"] = time_ms(sy, 1)
        res["allpairs"]["ms_262144"] = time_ms(ap, 1)
        print(f"kernels: N={N_LARGE} symmetric {res['symmetric']['ms_262144']:.4f} ms, allpairs "
              f"{res['allpairs']['ms_262144']:.4f} ms, largest difference a body {diff:.3e}; "
              f"symmetric bitwise-repeatable, slots "
              f"{cuda_symmetric.slot_bytes(N_LARGE, cuda_symmetric.KERNEL_TILE)} B, peak {peak} "
              f"B beyond the inputs", flush=True)
        del s
        torch.cuda.empty_cache()
    # N = 448 with tile 64: the JAX package takes it; the f32 kernel's
    # wrapper pads to its 512-body tile with zero-mass bodies.
    s = cloud(448, 448, seed=448, device=device)
    got, _ = twice_equal("symmetric N=448 tile 64", lambda: cuda_symmetric.symmetric_acc(
        s.pos, s.mass, tile=64, **PHYS))
    e = agree(res, "symmetric", "symmetric N=448 tile 64", got,
              cuda_symmetric.symmetric_acc_plain(s.pos, s.mass, tile=64, **PHYS))
    torch.cuda.synchronize(device)
    print(f"kernels: symmetric N=448 tile 64 (padded to 512 inside) err {e:.3e} "
          f"bitwise-repeatable", flush=True)
    return res


# (Ni, Nj) of the all-pairs kernel's block form: a few rows, the treecode
# error probe's 2,048 sampled rows at 65,536 and 524,288, a four-way ring's
# share of 65,536, and the square cases whose rows alone do not fill the card.
ALLPAIRS_BLOCKS = ((384, 65536), (2048, 65536), (2048, 524288), (16384, 65536),
                   (8192, 8192), (32768, 32768))
ALLPAIRS_TIMED = ((8192, 8192), (2048, 524288))


def compare_allpairs_splits(device, res: dict, shapes=ALLPAIRS_BLOCKS,
                            timed=ALLPAIRS_TIMED) -> None:
    """Phase 3, the all-pairs kernel's splits: at each (Ni, Nj) the split the
    schedule chooses, the same rows in one piece, and other parts and
    pieces, each against the plain version, twice for bitwise equality, with
    the launches the split says (one, or two with several pieces). Times the
    chosen split at the shapes of ``timed`` into ``res["allpairs"]``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force as cf
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    rule = cf.allpairs_split
    tiles = dict(tile_i=128, tile_j=128)
    try:
        for ni, nj in shapes:
            s = cloud(nj, nj, seed=nj, device=device)
            gen = torch.Generator(device="cpu").manual_seed(0)
            rows = (s.pos if ni == nj else
                    s.pos[torch.randperm(nj, generator=gen)[:ni].sort().values.to(device)])
            want = cf.block_acc_plain(rows, s.pos, s.mass, **PHYS)
            chosen = rule(ni, nj)
            stages = -(-nj // cf.ALLPAIRS_STAGE)
            others = [(128, 8, 1), (128, 8, min(stages, 3)), (256, 4, min(stages, 7)),
                      (512, 2, min(stages, 2)), (1024, 1, stages)]
            seen = []
            for split in [chosen] + [o for o in others if o != chosen]:
                cf.allpairs_split = lambda *_, split=split: split
                before = cf.block_acc.launches
                got = cf.block_acc(rows, s.pos, s.mass, **tiles, **PHYS)
                launched = cf.block_acc.launches - before
                check(launched == (2 if split[2] > 1 else 1),
                      f"allpairs {ni}x{nj} split {split}: {launched} launches")
                err = agree(res, "allpairs", f"allpairs {ni}x{nj} split {split}", got, want)
                check(torch.equal(got, cf.block_acc(rows, s.pos, s.mass, **tiles, **PHYS)),
                      f"allpairs {ni}x{nj} split {split}: two launches differ bitwise")
                seen.append(f"{'x'.join(map(str, split))} err {err:.2e}")
            cf.allpairs_split = rule
            check(chosen[2] > 1, f"allpairs {ni}x{nj}: the rule cut no column pieces")
            if device.type == "cuda":
                torch.cuda.synchronize(device)   # a fault in the run shows here
            line = (f"kernels: allpairs block {ni}x{nj} rule {'x'.join(map(str, chosen))} "
                    f"(rows x parts x pieces); {'; '.join(seen)}; bitwise-repeatable")
            if (ni, nj) in timed:
                ms = time_ms(lambda: cf.block_acc(rows, s.pos, s.mass, **tiles, **PHYS), 20)
                clock = sm_clock_mhz()
                floor = issue_floor_ms(ni * nj, PAIR_SLOTS, clock)
                res["allpairs"][f"ms_{ni}x{nj}"] = ms
                res["allpairs"][f"plain_ms_{ni}x{nj}"] = time_ms(
                    lambda: cf.block_acc_plain(rows, s.pos, s.mass, **PHYS), 3)
                res["allpairs"][f"issue_floor_ms_{ni}x{nj}"] = floor
                ops = bound(PAIR_FLOPS * ni * nj, (ni * 6 + nj * 4) * 4)["bound_ms"]
                line += (f"; {ms:.4f} ms, bound {ops:.4f}, issue floor {floor:.4f} at "
                         f"{clock:.0f} MHz")
            print(line, flush=True)
            del s, rows, want, got
            torch.cuda.empty_cache()
    finally:
        cf.allpairs_split = rule


def rel_err(got, want, n_real: int):
    """Per-body relative force difference over the real bodies."""
    import torch

    d = (got - want)[:n_real].norm(dim=1)
    return d / torch.clamp(want[:n_real].norm(dim=1), min=1e-12)


def compare_fast(device, sizes=FAST_SIZES, time_at: int | None = N_MAIN) -> dict:
    """Phase 3, the fast modes: ``symmetric_bf16x3_kernel`` against its twin
    in "bf16x3" and "mixed" (distance ratio, per-body p99), each mode's
    error against the all-pairs kernel inside the JAX envelopes, mixed no
    worse than bf16x3; times at ``time_at`` bodies beside the f32 kernel."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    res = {"max_abs_err": 0.0}
    for n, n_real, tile in sizes:
        s = cloud(n, n_real, seed=n, device=device)
        pos, mass = s.pos, s.mass
        kw = dict(tile=tile, **PHYS)
        exact = cuda_force.block_acc(pos, pos, mass, tile_i=64, tile_j=64, **PHYS)
        f32_twin = cuda_symmetric.symmetric_acc_plain(pos, mass, **kw)
        f32_kernel = cuda_symmetric.symmetric_acc(pos, mass, **kw)
        k = n // tile
        p99 = {}
        for prec in ("bf16x3", "mixed"):
            got, peak = twice_equal(f"{prec} N={n}", lambda: cuda_symmetric.symmetric_acc(
                pos, mass, precision=prec, **kw))
            twin = cuda_symmetric.symmetric_acc_plain(pos, mass, precision=prec, **kw)
            torch.cuda.synchronize(device)
            check(bool(torch.isfinite(got).all()), f"{prec} N={n}: non-finite output")
            res["max_abs_err"] = max(res["max_abs_err"], float((got - twin).abs().max()))
            diff = rel_err(got, twin, n_real)
            d99 = float(torch.quantile(diff, 0.99))
            if prec == "mixed" and k <= 3:
                # No fast diagonal: "mixed" is the f32 mode.
                check(torch.allclose(got, f32_kernel, **TOL),
                      f"mixed N={n} (K={k}): outside rtol=1e-4, atol=2e-6 of the f32 kernel")
                what = "= f32 kernel"
            else:
                ratio = float((got - twin).norm() / (twin - f32_twin).norm())
                check(ratio <= FAST_RATIO, f"{prec} N={n}: |kernel - twin| / |twin - f32 twin|"
                      f" = {ratio:.3f} > {FAST_RATIO}")
                what = f"ratio {ratio:.3f}"
            check(d99 <= FAST_P99_VS_TWIN,
                  f"{prec} N={n}: per-body p99 vs twin {d99:.3e} > {FAST_P99_VS_TWIN}")
            # Which side's float32 sums set the ratio: the kernel's and the
            # twin's distances from the same mode in float64, over the mode's
            # distance from f32.
            t64 = cuda_symmetric.symmetric_acc_plain(pos.double(), mass.double(),
                                                     precision=prec, **kw).float()
            scale = float((twin - f32_twin).norm())
            noise = (float((got - t64).norm()) / scale, float((twin - t64).norm()) / scale)
            del t64
            err = rel_err(got, exact, n_real)
            p99[prec], med = float(torch.quantile(err, 0.99)), float(err.median())
            env = FAST_ENVELOPE[prec]
            check(p99[prec] < env[0] and med < env[1],
                  f"{prec} N={n}: p99 {p99[prec]:.3e} median {med:.3e} outside {env}")
            net = float((mass[:, None] * got).sum(0).abs().max())
            print(f"fast kernels: N={n} (real {n_real}) tile {tile} {prec}: vs twin {what} "
                  f"p99 {d99:.3e} max |d| {float((got - twin).abs().max()):.3e}; vs float64 "
                  f"kernel {noise[0]:.3f} twin {noise[1]:.3f}; vs all-pairs "
                  f"p99 {p99[prec]:.3e} median {med:.3e}; |sum m a| {net:.3e}; "
                  f"bitwise-repeatable, slots {cuda_symmetric.slot_bytes(n, tile)} B, peak "
                  f"{peak} B beyond the inputs", flush=True)
            if n == time_at:
                fn = lambda: cuda_symmetric.symmetric_acc(pos, mass, precision=prec, **kw)  # noqa: E731
                res[prec] = {"ms": time_ms(fn, 20),
                             "plain_ms": time_ms(lambda: cuda_symmetric.symmetric_acc_plain(
                                 pos, mass, precision=prec, **kw), 3),
                             "p99": p99[prec], "median": med, **fast_bound(n, tile, prec),
                             "slot_bytes": cuda_symmetric.slot_bytes(n, tile),
                             "issue_floor_ms": fast_issue_floor_ms(n, tile, prec,
                                                                   sm_clock_mhz())}
        check(p99["mixed"] <= p99["bf16x3"],
              f"N={n}: mixed p99 {p99['mixed']:.3e} > bf16x3 {p99['bf16x3']:.3e}")
        del s, pos, mass, exact, f32_twin, f32_kernel
        torch.cuda.empty_cache()
    if time_at in [n for n, _, _ in sizes]:
        print(f"fast kernels: times at N={time_at} tile 512 (ms/call): " + "; ".join(
            f"{p} {res[p]['ms']:.4f} vs plain {res[p]['plain_ms']:.4f} bound "
            f"{res[p]['bound_ms']:.4f} ({res[p]['bound_by']}) issue floor "
            f"{res[p]['issue_floor_ms']:.4f}" for p in ("bf16x3", "mixed")),
            flush=True)
    return res


def tree_kernel_cases():
    """(label, N, overrides): the shapes of every treecode run of phase 6,
    and a smaller one."""
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    return (("8,192", 8192, {}), ("20,480 tuned", 20480, tuned_tree_overrides(20480)),
            ("65,536", 65536, {}), ("524,288", 524288, {}),
            ("65,536 rows of 64", 65536, dict(tree_tile=64)),
            ("65,536 rows of 256", 65536, dict(tree_tile=256)),
            ("20,480 flat", 20480, dict(tree_hier=False)),
            ("65,536 flat", 65536, dict(tree_hier=False)),
            ("2,560", 2560, {}), ("1,024", 1024, {}),
            ("20,480 dense", 20480, dict(tree_flat_cap=-1)))


def time_near(kernel, args, kw) -> dict:
    """The near kernel's time at one shape beside its plain twin's, its
    bound, its issue floor at this run's SM clock, and the largest and mean
    number of chunks a target row has."""
    from n_body_problem_tpu_torch.ops.cuda_treecode import near_field_plain
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    work = near_work(args, kw)
    work.pop("pairs")
    ms = time_ms(lambda: kernel(*args, **kw), 20)
    return {"ms": ms, "plain_ms": time_ms(lambda: near_field_plain(*args, **kw), 3),
            **tree_work("near", args, kw), **work}


def tree_work(key: str, args, kw) -> dict:
    """``bound`` of a treecode kernel's call, counting the interactions
    these inputs need (sentinel entries and masked tiles are skipped) and
    each input read and each output written once, and its issue floor at
    this run's SM clock: a pair one way ``PAIR_SLOTS``, and the VIP pairs
    and body-node terms at the slots of ``kernel_compare.TREE_WORK`` (the
    gather has none: it moves bytes)."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    if key == "near":
        count, slots = near_work(args, kw)["pairs"], PAIR_SLOTS
        out = bound(PAIR_FLOPS * count, nbytes + kw["n"] * 12)
    elif key == "gather":
        bodies, near_idx = args
        return {**bound(0, nbytes + near_idx.numel() * kw["tile"] * 16), "issue_floor_ms": None}
    else:
        work_fn, count_key, slots = TREE_WORK[key]
        count, out = work_fn(args, kw)[count_key], tree_bound(key, args, kw)
    return {**out, "issue_floor_ms": issue_floor_ms(count, slots, sm_clock_mhz())}


def gather_library(bodies, near_idx, *, tile: int):
    """One PyTorch call computing the gather: ``index_select`` of the
    (K + 1, T, 4) tile view (timed as the gather's yardstick only)."""
    tiles = bodies.view(-1, tile, 4)
    return tiles.index_select(0, near_idx.reshape(-1)).view(near_idx.shape[0], -1, 4)


# Where each treecode kernel is timed (case labels of ``tree_kernel_cases``):
# the main record at the largest shape of the path it serves below 524,288;
# the VIP sweep and the far field also at 524,288, where the card, not the
# host, sets the step's pace; the single-level far field also at 20,480
# dense (its fewest threads), the near-panel kernel also at 1,024 (the
# dense path N alone chooses).
TIME_AT = {"near": ("65,536",), "far": ("65,536", "524,288"), "vip": ("65,536", "524,288"),
           "far_single": ("65,536 flat", "20,480 dense"), "gather": ("20,480 dense",),
           "near_panel": ("20,480 dense", "1,024")}
# The kernels also timed by their device time from a profiler trace: the
# host enqueues these calls more slowly than the card runs them at some of
# their shapes.
DEVICE_TIMED = ("vip", "far", "far_single", "near_panel")


def at_key(label: str) -> str:
    """The record key of a kernel's time at a further shape, ``at_524288``
    or ``at_20480_dense``."""
    return "at_" + label.replace(",", "").replace(" ", "_")


def compare_tree_kernels(device, cases=None, time_at: dict | None = None) -> dict:
    """Phase 4: each treecode kernel against its plain version on the
    port's work lists (the gather exactly); bitwise repeatability; times,
    bounds and the gather's library call at the shapes of ``time_at``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs, time_ms

    fns = {"near": (ct.near_field, ct.near_field_plain),
           "far": (ct.far_field_hier, ct.far_field_hier_plain),
           "vip": (ct.vip_both, ct.vip_both_plain),
           "far_single": (ct.far_field_single, ct.far_field_single_plain),
           "gather": (ct.gather_panels, ct.gather_panels_plain),
           "near_panel": (ct.near_panel, ct.near_panel_plain)}
    time_at = TIME_AT if time_at is None else time_at
    res = {k: {"max_abs_err": 0.0} for k in TREE_KERNELS}
    for label, n, overrides in cases or tree_kernel_cases():
        inp = kernel_inputs(n, device, **overrides)
        line = []
        for key, (args, kw) in inp["kernels"].items():
            kernel, plain = fns[key]
            got, again = kernel(*args, **kw), kernel(*args, **kw)
            want = plain(*args, **kw)
            if key == "vip":
                err = max(agree(res, key, f"vip action N={label}", got[0], want[0]),
                          agree(res, key, f"vip reaction N={label}", got[1], want[1]))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
            elif key == "gather":
                check(torch.equal(got, want), f"gather N={label}: kernel != plain copy")
                err = 0.0
                same = torch.equal(got, again)
            else:
                err = agree(res, key, f"{key} N={label}", got, want)
                same = torch.equal(got, again)
            check(same, f"{key} N={label}: two launches differ bitwise")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            line.append(f"{key} err {err:.3e}")
            if key == "near" and n == N_MAIN and device.type == "cuda":
                t = time_near(kernel, args, kw)
                res["near"].setdefault("by_rows", {})[f"{inp['path']} {kw['tile']}"] = t
                line.append("near at rows of {} {:.4f} ms, bound {:.4f}, issue floor {:.4f}, "
                            "chunks a row max {} mean {:.2f}".format(
                                kw["tile"], t["ms"], t["bound_ms"], t["issue_floor_ms"],
                                t["chunks_max"], t["chunks_mean"]))
            labels = time_at.get(key, ())
            if label in labels:
                t = {"ms": time_ms(lambda: kernel(*args, **kw), 20)}
                if key in DEVICE_TIMED:   # the kernels alone, without the host's enqueue
                    t["by_kernel_ms"] = kernel_ms(lambda: kernel(*args, **kw), 20)
                    t["device_ms"] = sum(t["by_kernel_ms"].values())
                t.update(tree_work(key, args, kw))
                t["plain_ms"] = time_ms(lambda: plain(*args, **kw), 3)
                if label == labels[0]:
                    t["library_ms"] = None
                    if key == "gather":
                        check(torch.equal(gather_library(*args, **kw), got),
                              f"gather N={label}: index_select != kernel")
                        t["library_ms"] = time_ms(lambda: gather_library(*args, **kw), 20)
                    res[key].update(t)
                else:
                    res[key][at_key(label)] = t
        c, ops = inp["cfg"], inp["ops"]
        shapes = " ".join(f"{x.shape[0]}x{x.shape[1]}" if x.dim() > 1 else str(x.shape[0])
                          for x in inp["aux"][:-1])
        print(f"tree kernels: N={label} path={inp['path']} tile={c.tree_tile} "
              f"src_tile={c.tree_src_tile} max_near={c.tree_max_near} lists {shapes} "
              f"VIP panel {0 if ops['panel'] is None else ops['panel'].shape[0]} bodies; "
              f"{'; '.join(line)}; bitwise-repeatable", flush=True)
        del inp
        if device.type == "cuda":
            torch.cuda.empty_cache()
    timed = [k for k in TREE_KERNELS if "ms" in res[k]]
    if timed:
        print("tree kernels: times (ms/call): " + "; ".join(
            f"{k} at {time_at[k][0]} {res[k]['ms']:.4f} vs plain {res[k]['plain_ms']:.4f}"
            f" bound {res[k]['bound_ms']:.4f} ({res[k]['bound_by']})"
            + (f" issue floor {res[k]['issue_floor_ms']:.4f}" if res[k]["issue_floor_ms"]
               else "")
            + (f" library {res[k]['library_ms']:.4f}" if res[k]["library_ms"] else "")
            for k in timed), flush=True)
    for k in DEVICE_TIMED:
        for label in time_at.get(k, ()):
            t = res[k] if label == time_at[k][0] else res[k].get(at_key(label))
            if t and "device_ms" in t:
                print(f"tree kernels: {k} at {label}: call {t['ms']:.4f} ms, kernels "
                      + " + ".join(f"{name} {ms:.4f}" for name, ms in t["by_kernel_ms"].items())
                      + f" = {t['device_ms']:.4f} ms; bound {t['bound_ms']:.4f}, issue floor "
                      f"{t['issue_floor_ms']:.4f}", flush=True)
    return res


# The distances' kernel (csrc/min_dist.cu's min_tile_dist_kernel) runs only
# in the flat and dense builds: it is held to its twin at the shapes one
# rebuild of these phase 6 runs gives it, the first the record's own.
MIN_DIST_RUNS = ("20k flat", "20k dense")


def recorded_calls(sim, name: str) -> list:
    """(args, kw) of every call of ``treecode.<name>`` in one eager rebuild
    of ``sim``'s lists, in order (on the hierarchical path, level 0 first)."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_fns

    got, real = [], getattr(treecode, name)

    def record(*args, **kw):
        got.append((tuple(a.contiguous() if hasattr(a, "contiguous") else a for a in args), kw))
        return real(*args, **kw)

    setattr(treecode, name, record)
    try:
        tree_fns(sim.cfg)[0](sim.state.pos, sim.state.mass)
    finally:
        setattr(treecode, name, real)
    return got


def min_dist_work(n: int, k_l: int, tile: int) -> dict:
    """``bound`` and the issue floor of one minimum-distance call: n x k_l
    distances, the columns read and the (n / tile, k_l) output written once."""
    nbytes = (3 * n + 3 * k_l + n // tile * k_l) * 4
    return {**bound(MIN_DIST_FLOPS * n * k_l, nbytes),
            "issue_floor_ms": issue_floor_ms(n * k_l, MIN_DIST_SLOTS, sm_clock_mhz())}


def compare_min_dist(device, labels=MIN_DIST_RUNS) -> dict:
    """Phase 4: the minimum-distance kernel bitwise its plain twin (and
    itself) on the call of one eager rebuild of each of ``labels``' phase 6
    runs (Plummer, seed 0), then its time beside the twin's, its bound and
    its issue floor; the first run is the record's, the others
    ``at_<N>_<path>``."""
    import torch

    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops.registry import tree_path
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    runs = {run[0]: run for run in tree_runs()}
    res = {"max_abs_err": 0.0, "library_ms": None}
    for i, label in enumerate(labels):
        _, n_bodies, cfg, _, _ = runs[label]
        sim = Simulation(cfg, models.plummer(n_bodies, seed=0), device=device)
        found = recorded_calls(sim, "_min_tile_dist")
        want_calls, path = min_dist_a_rebuild(sim.cfg, sim.state.n)[0], tree_path(sim.cfg)
        del sim
        check(len(found) == want_calls,
              f"min_dist [{label}]: {len(found)} calls a rebuild, expected {want_calls}")
        args = found[0][0]
        cols, cen, tile = args[:3], args[3:6], args[6]
        n = cols[0].shape[0]
        got, again = ct.min_tile_dist(*args), ct.min_tile_dist(*args)
        want = ct.min_tile_dist_plain(*args)
        check(torch.equal(got, want), f"min_dist [{label}]: kernel != plain twin bitwise")
        check(torch.equal(got, again), f"min_dist [{label}]: two launches differ bitwise")
        t = {"ms": time_ms(lambda: ct.min_tile_dist(*args), 20),
             "plain_ms": time_ms(lambda: ct.min_tile_dist_plain(*args), 3),
             "shape": f"{n // tile} x {cen[0].shape[0]}, tile {tile}, {path}",
             **min_dist_work(n, cen[0].shape[0], tile)}
        print(f"min_dist [{label}]: {t['shape']}: bitwise the twin; {t['ms']:.4f} ms vs plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']}), issue floor "
              f"{t['issue_floor_ms']:.4f}", flush=True)
        if i == 0:
            res.update(t)
        else:
            res[at_key(f"{n} {path}")] = t
        del found, args, cols, cen, got, again, want
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def min_dist_open_work(n: int, k_l: int, tile: int, score: bool) -> dict:
    """``bound`` and the issue floor of one fused opening test: the
    distances' operations and issue slots (the epilogue's few a (row, node)
    element are left out: under a tenth of a 128-body row's sweep), the
    columns and three node vectors read, and the level's outputs (bool
    opens, float32 far keys and, at level 0, scores) written once."""
    nbytes = (3 * n + 6 * k_l) * 4 + n // tile * k_l * (5 + 4 * score)
    return {**bound(MIN_DIST_FLOPS * n * k_l, nbytes),
            "issue_floor_ms": issue_floor_ms(n * k_l, MIN_DIST_SLOTS, sm_clock_mhz())}


def open_runs():
    """(bodies, config, state) of ``compare_min_dist_open``: the 1,048,576
    Plummer sphere (seed 4, treecode defaults: the flat MAC at level 0) and
    the AGORA disk (seed 1, the benchmark's physics)."""
    from n_body_problem_tpu_torch import SimConfig, models

    agora = SimConfig(solver="treecode", dt=1.0227e-4, G=43007.1, eps2=0.0064, compensate=1.0,
                      integrator="leapfrog")
    return ((1048576, SimConfig(solver="treecode"), lambda: models.plummer(1048576, seed=4)),
            (2125000, agora, lambda: models.agora_disk(2125000, seed=1)))


def same_open_test(a, b) -> bool:
    """Whether two (opens, far, score) triples are the same bits."""
    import torch

    return torch.equal(a[0], b[0]) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x.view(torch.int32), y.view(torch.int32)))
        for x, y in zip(a[1:], b[1:]))


def compare_min_dist_open(device, runs=None) -> dict:
    """Phase 4: the fused opening test (``cuda_treecode.min_dist_open``) on
    every level of one eager rebuild of each of ``open_runs``: bitwise its
    plain twin and itself at each level; level 0's time beside the
    distances' kernel alone (``dist_ms``) and beside that kernel followed by
    the PyTorch passes the fusion replaced (``unfused_ms``: the clamp, the
    MAC, the self-overlap, the threshold and the far key,
    ``open_test_plain`` on the card), its bound and its issue floor. The
    first run's level 0 is the record's, the others ``at_<bodies>``."""
    import torch

    from n_body_problem_tpu_torch import Simulation
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    res = {"max_abs_err": 0.0, "library_ms": None}
    for i, (bodies, cfg, state) in enumerate(runs or open_runs()):
        sim = Simulation(cfg, state(), device=device)
        found = recorded_calls(sim, "_min_dist_open")
        want_calls = min_dist_a_rebuild(sim.cfg, sim.state.n)[1]
        del sim
        if device.type == "cuda":
            torch.cuda.empty_cache()
        check(len(found) == want_calls and found[0][1]["score"],
              f"min_dist_open {bodies:,}: {len(found)} calls a rebuild, expected {want_calls}"
              " with level 0 first")
        for level, (args, kw) in enumerate(found):
            got = ct.min_dist_open(*args, **kw)
            for other, what in ((ct.min_dist_open(*args, **kw), "itself"),
                                (ct.min_dist_open_plain(*args, **kw), "plain twin")):
                check(same_open_test(got, other),
                      f"min_dist_open {bodies:,} level {level}: kernel != {what} bitwise")
                del other
            if level == 0:
                opened = float(got[0].float().mean())
            del got
            if device.type == "cuda":
                torch.cuda.empty_cache()
        args, kw = found[0]
        del found
        cols, cen, tile = args[:3], args[3:6], kw["tile"]
        n = cols[0].shape[0]
        t = {"ms": time_ms(lambda: ct.min_dist_open(*args, **kw), 20),
             "dist_ms": time_ms(lambda: ct.min_tile_dist(*cols, *cen, tile), 20),
             "unfused_ms": time_ms(lambda: ct.open_test_plain(
                 ct.min_tile_dist(*cols, *cen, tile), **kw), 10),
             "plain_ms": time_ms(lambda: ct.min_dist_open_plain(*args, **kw), 2),
             "shape": f"{n // tile} x {cen[0].shape[0]}, tile {tile}, mac {kw['mac']}",
             "levels_checked": want_calls, "open_share": opened,
             **min_dist_open_work(n, cen[0].shape[0], tile, True)}
        print(f"min_dist_open [{bodies:,}]: {want_calls} levels bitwise the twin and itself; "
              f"level 0 {t['shape']}: {t['ms']:.4f} ms vs the distances alone "
              f"{t['dist_ms']:.4f}, kernel + PyTorch passes {t['unfused_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}; bound {t['bound_ms']:.4f} ({t['bound_by']}), issue floor "
              f"{t['issue_floor_ms']:.4f}; opened {opened:.4f}", flush=True)
        if i == 0:
            res.update(t)
        else:
            res[at_key(f"{bodies}")] = t
        del args, kw, cols, cen
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def recorded_selections(sim) -> list:
    """(x, k) of every row selection (``treecode._top_k``) of one eager
    rebuild of ``sim``'s lists: the VIP pick, then each list's."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_fns

    got, real = [], treecode._top_k

    def record(x, k):
        got.append((x.clone(), k))
        return real(x, k)

    treecode._top_k = record
    try:
        tree_fns(sim.cfg)[0](sim.state.pos, sim.state.mass)
    finally:
        treecode._top_k = real
    return got


def top_k_work(rows: int, cols: int, k: int) -> dict:
    """``bound`` of one selection: the (rows, cols) float32 input read once
    and the (rows, k) float32 values and int64 indices written once."""
    return bound(0, rows * cols * 4 + rows * k * 12)


def compare_top_k(device) -> dict:
    """Phase 4's row selection: the kernel bitwise its plain twin (and
    itself) on every selection of one rebuild (the VIP pick where the path
    keeps VIP tiles, then the near and the far lists', with the planner's k)
    of the 65,536- and the 1,048,576-body Plummer spheres (seed 4, treecode
    defaults) and of the AGORA disk (2,125,000 bodies, seed 1; the
    benchmark's physics), then its time beside the twin's, one
    ``torch.topk`` call (the library's selection, ``library_ms``) and the
    bound of its bytes. The 1,048,576-body near lists' shape is the
    record's, the others ``at_<N>_<list>``; rows under 8,192 columns (all of
    the 65,536-body rebuild's) take the 8-bit digits, the rest 11."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    agora = SimConfig(solver="treecode", dt=1.0227e-4, G=43007.1, eps2=0.0064, compensate=1.0,
                      integrator="leapfrog")
    res = {"max_abs_err": 0.0}
    for n, cfg, state in ((65536, SimConfig(solver="treecode"),
                           lambda: models.plummer(65536, seed=4)),
                          (1048576, SimConfig(solver="treecode"),
                           lambda: models.plummer(1048576, seed=4)),
                          (2125000, agora, lambda: models.agora_disk(2125000, seed=1))):
        sim = Simulation(cfg, state(), device=device)
        found = recorded_selections(sim)
        del sim
        names = ("vip",) * (len(found) - 2) + ("near", "far")
        check(len(names) == len(found), f"top_k {n:,}: {len(found)} selections a rebuild")
        for name, (x, k) in zip(names, found):
            rows, cols = x.shape
            got, again = ct.top_k(x, k), ct.top_k(x, k)
            want = ct.top_k_plain(x, k)
            for a, b, what in ((got, want, "plain twin"), (got, again, "itself")):
                check(torch.equal(a[0].view(torch.int32), b[0].contiguous().view(torch.int32))
                      and torch.equal(a[1], b[1]), f"top_k {n:,} {name}: kernel != {what} bitwise")
            t = {"ms": time_ms(lambda: ct.top_k(x, k), 20),
                 "plain_ms": time_ms(lambda: ct.top_k_plain(x, k), 3),
                 "library_ms": time_ms(lambda: torch.topk(x, k, dim=1), 5),
                 "shape": f"{rows} x {cols}, k {k}", "sentinel_share": float((x < 0).float().mean()),
                 **top_k_work(rows, cols, k)}
            print(f"top_k [{n:,} {name}]: {t['shape']}: bitwise the twin; {t['ms']:.4f} ms vs "
                  f"plain {t['plain_ms']:.4f}, torch.topk {t['library_ms']:.4f}, bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']}); sentinels {t['sentinel_share']:.3f}",
                  flush=True)
            if (n, name) == (1048576, "near"):
                res.update(t)
            else:
                res[at_key(f"{n}_{name}")] = t
            del got, again, want
        del found, x
        torch.cuda.empty_cache()
    return res


def top_k_a_rebuild(cfg, n: int) -> int:
    """Row selections a rebuild of ``cfg``'s path makes: the VIP pick where
    the path keeps VIP tiles, and one a list (near and far on the
    hierarchical path, the near lists or tiles on the flat and dense
    paths)."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_kwargs, tree_path

    kw, _ = tree_kwargs(cfg)
    path = tree_path(cfg)
    if path == "dense":
        vip = treecode._static_args(n, kw["tile"], kw["theta"], kw["max_near"],
                                    kw["vip_tiles"])[2]
    else:
        vip = treecode._flat_static(n, kw["tile"], kw["src_tile"], kw["theta"], kw["max_near"],
                                    kw["vip_tiles"])[4]
    return (1 if vip else 0) + (2 if path == "hier" else 1)


def min_dist_a_rebuild(cfg, n: int) -> tuple[int, int]:
    """Minimum-distance launches a rebuild of ``cfg``'s path, (the
    distances' kernel, the fused opening test): on the hierarchical path the
    fused one once a level while ``tree_hier_union`` (level 0 alone without
    it), on the flat and dense paths the distances' once."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_path

    if tree_path(cfg) != "hier":
        return 1, 0
    if not cfg.tree_hier_union:
        return 0, 1
    return 0, len(treecode._level_plan(n // cfg.tree_src_tile, treecode.HIER_BRANCH))


def counters() -> dict:
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, cuda_treecode

    return {"allpairs": cuda_force.block_acc, "symmetric": cuda_symmetric.symmetric_acc,
            "symmetric_bf16x3": cuda_symmetric.symmetric_acc_bf16x3,
            "near": cuda_treecode.near_field, "far": cuda_treecode.far_field_hier,
            "vip": cuda_treecode.vip_both, "far_single": cuda_treecode.far_field_single,
            "gather": cuda_treecode.gather_panels, "near_panel": cuda_treecode.near_panel}


def launches_a_step(cfg, n: int) -> dict:
    """Kernel launches a treecode step of ``cfg``'s path makes, by wrapper
    (the VIP sweep is its pair kernel and the kernel that sums its
    per-block reactions): hierarchical near, far and VIP; flat near,
    single-level far and VIP; dense gather, near-panel, the single-level
    far field when ``max_near < K``, and VIP."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_path

    path = tree_path(cfg)
    want = dict.fromkeys(TREE_KERNELS, 0)
    if path == "dense":
        k, max_near, vip = treecode._static_args(n, cfg.tree_tile, cfg.tree_theta,
                                                 cfg.tree_max_near, cfg.tree_vip_tiles)
        want.update(gather=1, near_panel=1, far_single=int(max_near < k))
    else:
        vip = treecode._flat_static(n, cfg.tree_tile, cfg.tree_src_tile, cfg.tree_theta,
                                    cfg.tree_max_near, cfg.tree_vip_tiles)[4]
        want.update({"near": 1, "far" if path == "hier" else "far_single": 1})
    want["vip"] = 2 if vip else 0
    return want


def drive_main_path(device, n: int = N_MAIN, prime: int = PRIME_STEPS,
                    timed: int = TIMED_STEPS) -> dict:
    """Phase 5: the default simulation, then solver="pallas", leapfrog, and
    the symmetric solver's "bf16x3" and "mixed" precisions, each through
    the public ``Simulation`` entry point; each run launches its kernel as
    often a step as its schedule says (once) and no other kernel. Returns
    each run's ms/step by label."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models

    from n_body_problem_tpu_torch.ops.cuda_force import allpairs_split
    from n_body_problem_tpu_torch.ops.cuda_symmetric import LAUNCHES_A_CALL

    wrappers = counters()
    # Kernel launches a force: the all-pairs kernel is one with one column
    # piece, two with several; the symmetric kernels two (the pair kernel
    # and the slots' sum).
    a_force = {"allpairs": 2 if allpairs_split(n, n)[2] > 1 else 1,
               "symmetric": LAUNCHES_A_CALL, "symmetric_bf16x3": LAUNCHES_A_CALL}
    runs = (
        ("default", SimConfig(), "pallas_symmetric", "symmetric"),
        ("pallas", SimConfig(solver="pallas"), "pallas", "allpairs"),
        ("leapfrog", SimConfig(integrator="leapfrog"), "pallas_symmetric", "symmetric"),
        ("bf16x3", SimConfig(pallas_sym_precision="bf16x3"), "pallas_symmetric",
         "symmetric_bf16x3"),
        ("mixed", SimConfig(pallas_sym_precision="mixed"), "pallas_symmetric",
         "symmetric_bf16x3"),
    )
    ms_a_step = {}
    for label, cfg, solver, key in runs:
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        check(sim.solver == solver, f"{label}: resolved {sim.solver!r}, expected {solver!r}")
        e0 = sim.diagnostics()["energy"]
        start = {k: w.launches for k, w in wrappers.items()}
        sim.run(prime)
        before, wall0 = wrappers[key].launches, sim.wall_seconds
        sim.run(timed)
        launched = wrappers[key].launches - before
        wall = sim.wall_seconds - wall0
        want = a_force[key] * timed
        check(launched == want,
              f"{label}: kernel launched {launched} times in {timed} steps, expected {want}")
        others = {k: w.launches - start[k] for k, w in wrappers.items() if k != key}
        check(not any(others.values()), f"{label}: other kernels launched: {others}")
        check(bool(torch.isfinite(sim.state.pos).all()), f"{label}: non-finite positions")
        d = sim.diagnostics()
        check(d["overspeed"] == 0, f"{label}: overspeed {d['overspeed']}")
        check(d["step"] == prime + timed, f"{label}: step {d['step']}")
        ms = ms_a_step[label] = wall / timed * 1e3
        print(f"main path [{label}]: N={sim.state.n_real} solver={sim.solver} "
              f"precision={cfg.pallas_sym_precision} integrator={cfg.integrator} "
              f"{ms:.4f} ms/step {sim.pairs_per_step() * timed / wall:.4e} pairs/s "
              f"launches {launched} |dE/E| after {prime + timed} steps "
              f"{abs((d['energy'] - e0) / e0):.3e}", flush=True)
    return ms_a_step


def drive_pair_matrix(device, n: int = 4096, steps: int = 10) -> None:
    """Phase 5, the pair-matrix foil (plain PyTorch, no kernel of its own):
    its force against the all-pairs kernel's, then ``steps`` timed steps."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_force
    from n_body_problem_tpu_torch.ops.registry import make_force_fn

    cfg = SimConfig(solver="pair_matrix")
    sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
    check(sim.solver == "pair_matrix" and sim.state.n == n, "pair_matrix: solver or padding")
    s = sim.state
    got = make_force_fn(cfg, device.type, s.n)(s.pos, s.mass)
    want = cuda_force.block_acc(s.pos, s.pos, s.mass, tile_i=128, tile_j=128, **PHYS)
    check(torch.allclose(got, want, **TOL),
          f"pair_matrix: force outside rtol=1e-4, atol=2e-6 of the all-pairs kernel "
          f"(max |d| {float((got - want).abs().max()):.3e})")
    sim.run(2)
    wall0 = sim.wall_seconds
    sim.run(steps)
    wall = sim.wall_seconds - wall0
    check(bool(torch.isfinite(sim.state.pos).all()), "pair_matrix: non-finite positions")
    print(f"main path [pair_matrix]: N={n} plain PyTorch {wall / steps * 1e3:.4f} ms/step "
          f"{sim.pairs_per_step() * steps / wall:.4e} pairs/s; force vs all-pairs max |d| "
          f"{float((got - want).abs().max()):.3e}", flush=True)


def repeat_runs():
    """(label, config overrides, N, steps) of phase 5's repeatability: the
    default solver and ``pallas_symmetric`` in each precision at the JAX
    determinism test's shape (128 bodies, 25 Euler steps) and at 65,536 x
    200 leapfrog steps; the foil at 128 x 25 and 4,096 x 20 leapfrog."""
    runs = [(f"{solver} {precision} {n}", dict(solver=solver, pallas_sym_precision=precision,
                                               integrator=integ), n, steps)
            for solver in ("auto", "pallas_symmetric")
            for precision in ("f32", "bf16x3", "mixed")
            for n, steps, integ in ((128, 25, "semi_implicit_euler"),
                                    (N_MAIN, 200, "leapfrog"))]
    return runs + [("pair_matrix 128", dict(solver="pair_matrix"), 128, 25),
                   ("pair_matrix 4096", dict(solver="pair_matrix", integrator="leapfrog"),
                    4096, 20)]


def drive_repeat(device, runs=None) -> None:
    """Phase 5, repeatability (tests/test_determinism.py on the card): each
    run twice from the same state through ``Simulation.run``; positions and
    velocities must end bitwise equal. The symmetric kernels sum their
    slots in slot order and the foil sorts before it adds, so no sum on
    these paths depends on the order in which the card runs its blocks."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models

    t0 = time.perf_counter()
    for label, overrides, n, steps in runs or repeat_runs():
        ends = []
        for _ in range(2):
            sim = Simulation(SimConfig(**overrides), models.plummer(n, seed=0), device=device)
            sim.run(steps)
            torch.cuda.synchronize(device)
            ends.append((sim.state.pos.clone(), sim.state.vel.clone()))
        want = "pair_matrix" if overrides["solver"] == "pair_matrix" else "pallas_symmetric"
        check(sim.solver == want, f"repeat [{label}]: resolved {sim.solver!r}, expected {want!r}")
        check(bool(torch.isfinite(ends[0][0]).all()), f"repeat [{label}]: non-finite positions")
        same = torch.equal(ends[0][0], ends[1][0]) and torch.equal(ends[0][1], ends[1][1])
        check(same, f"repeat [{label}]: two runs from one state differ (max |d pos| "
                    f"{float((ends[0][0] - ends[1][0]).abs().max()):.3e})")
        print(f"repeat [{label}]: {steps} {overrides.get('integrator', 'semi_implicit_euler')} "
              f"steps twice from one state: positions and velocities bitwise equal", flush=True)
        del sim, ends
    print(f"repeat: {time.perf_counter() - t0:.1f} s", flush=True)


def tree_force_error(sim, sample: int | None = None,
                     fresh: bool = True) -> tuple[float, float]:
    """(p99, median) relative error of the treecode force on ``sim``'s
    current bodies against the all-pairs kernel's exact force (on
    ``sample`` random real bodies, or on all of them).

    ``fresh``: the bodies re-sorted and the lists built anew, as
    ``bench.py``'s probe does. Otherwise the lists the run last stepped
    with, on the bodies as it left them: ``tree_rebuild_every`` steps after
    the lists were built (after a run of whole chunks), as stale as the
    lists of a leapfrog step get and one step staler than an Euler step's.
    """
    import torch

    from n_body_problem_tpu_torch.ops.registry import make_force_fn, tree_fns
    from n_body_problem_tpu_torch.treecode_profile import force_error
    from n_body_problem_tpu_torch.utils.morton import device_resort

    s = sim.state
    if fresh:
        s, _ = device_resort(s, torch.arange(s.n, device=s.device))
        tree = make_force_fn(sim.cfg, s.device.type, s.n)(s.pos, s.mass)
    else:
        tree = tree_fns(sim.cfg)[1](s.pos, s.mass, sim.tree_lists)
    return force_error(tree, s.pos, s.mass, s.n_real, sim.cfg, sample)


def tree_runs():
    """(label, N, config, timed steps, bodies sampled by the error probe)."""
    from n_body_problem_tpu_torch import SimConfig
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    return (
        ("65k euler", 65536, SimConfig(solver="treecode"), TREE_TIMED, None),
        ("65k leapfrog", 65536, SimConfig(solver="treecode", integrator="leapfrog"),
         TREE_TIMED, None),
        ("20k tuned", 20480, SimConfig(solver="treecode", **tuned_tree_overrides(20480)),
         TREE_TIMED, None),
        ("524k", 524288, SimConfig(solver="treecode"), 16, 2048),
        ("20k flat", 20480, SimConfig(solver="treecode", tree_hier=False), TREE_TIMED, None),
        ("65k flat leapfrog", 65536,
         SimConfig(solver="treecode", tree_hier=False, integrator="leapfrog"),
         TREE_TIMED, None),
        # Flat by N alone. Not 3,072: there K_s = 48 source tiles is no
        # multiple of the 32 entries a chunk, the planner clamps max_near to
        # 32 below the 41 tiles rows open, and the JAX package's own force
        # misses the envelope (p99 1.4e-2; ROADMAP §3).
        ("2.5k default", 2560, SimConfig(solver="treecode"), TREE_TIMED, None),
        ("1k default", 1024, SimConfig(solver="treecode"), TREE_TIMED, None),
        ("20k dense", 20480, SimConfig(solver="treecode", tree_flat_cap=-1), TREE_TIMED, None),
    )


PROFILED = ("65k euler", "20k flat", "20k dense")


def drive_treecode(device, runs=None, profiled=PROFILED) -> dict:
    """Phase 6: the treecode main path through ``Simulation``; returns the
    launch counts of the runs (the error probes are not counted)."""
    import torch

    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.ops.cuda_treecode import min_dist_open, min_tile_dist, top_k
    from n_body_problem_tpu_torch.ops.registry import tree_path
    from n_body_problem_tpu_torch.simulation import chunk_lengths
    from n_body_problem_tpu_torch.treecode_profile import profile_tree_step

    wrappers = counters()
    launched = {k: 0 for k in TREE_KERNELS + ("min_dist", "min_dist_open", "top_k")}
    for label, n, cfg, timed, sample in runs or tree_runs():
        t0 = time.perf_counter()
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        init_s = time.perf_counter() - t0
        e0 = sim.diagnostics()["energy"]
        before = {k: wrappers[k].launches for k in TREE_KERNELS}
        dist_before = min_tile_dist.launches, min_dist_open.launches
        select_before = top_k.launches
        sim.run(TREE_PRIME)
        wall0 = sim.wall_seconds
        sim.run(timed)
        wall = sim.wall_seconds - wall0
        moved = {k: wrappers[k].launches - before[k] for k in TREE_KERNELS}
        per_step = launches_a_step(sim.cfg, sim.state.n)
        for k in TREE_KERNELS:   # (a CPU rehearsal runs the plain versions)
            want = per_step[k] * (TREE_PRIME + timed) if device.type == "cuda" else 0
            check(moved[k] == want,
                  f"treecode [{label}]: {k} launches {moved[k]}, expected {want}")
            launched[k] += moved[k]
        # The build's kernel a rebuild: every call restarts the cadence.
        rebuilds = sum(len(chunk_lengths(k, sim.cfg.tree_rebuild_every))
                       for k in (TREE_PRIME, timed))
        moved["min_dist"] = min_tile_dist.launches - dist_before[0]
        moved["min_dist_open"] = min_dist_open.launches - dist_before[1]
        per_rebuild = min_dist_a_rebuild(sim.cfg, sim.state.n)
        for key, per in zip(("min_dist", "min_dist_open"), per_rebuild):
            want = per * rebuilds if device.type == "cuda" else 0
            check(moved[key] == want,
                  f"treecode [{label}]: {key} launches {moved[key]}, expected {want}")
            launched[key] += moved[key]
        moved["top_k"] = top_k.launches - select_before
        want = top_k_a_rebuild(sim.cfg, sim.state.n) * rebuilds if device.type == "cuda" else 0
        check(moved["top_k"] == want,
              f"treecode [{label}]: top_k launches {moved['top_k']}, expected {want}")
        launched["top_k"] += moved["top_k"]
        check(bool(torch.isfinite(sim.state.pos).all()), f"treecode [{label}]: non-finite positions")
        d = sim.diagnostics()
        check(d["overspeed"] == 0, f"treecode [{label}]: overspeed {d['overspeed']}")
        check(d["step"] == TREE_PRIME + timed, f"treecode [{label}]: step {d['step']}")
        # The envelope holds on fresh lists, as the JAX package's tests and
        # bench.py measure it; the error on the run's own lists, as stale
        # as the run lets them get, is reported beside it (PERF.md §6).
        errs = {lists: tree_force_error(sim, sample, fresh=fresh)
                for lists, fresh in (("fresh lists", True), ("the run's lists", False))}
        p99, med = errs["fresh lists"]
        check(p99 < ERR_P99 and med < ERR_MEDIAN,
              f"treecode [{label}]: force error p99 {p99:.3e} median {med:.3e}")
        check(all(map(math.isfinite, errs["the run's lists"])),
              f"treecode [{label}]: non-finite error on the run's lists")
        c = sim.cfg
        print(f"treecode [{label}]: N={sim.state.n_real} path={tree_path(c)} tile={c.tree_tile} "
              f"src_tile={c.tree_src_tile} vip={c.tree_vip_tiles} caps(max_near="
              f"{c.tree_max_near} flat={c.tree_flat_cap} far_max={c.tree_far_max} "
              f"far={c.tree_far_cap}) rebuild_every={c.tree_rebuild_every} "
              f"integrator={c.integrator} init {init_s:.3f} s; "
              f"{wall / timed * 1e3:.4f} ms/step over {timed} steps "
              f"{sim.pairs_per_step() * timed / wall:.4e} pairs/s; launches "
              f"{ {k: v for k, v in moved.items() if v} }; |dE/E| after {TREE_PRIME + timed} steps "
              f"{abs((d['energy'] - e0) / e0):.3e}; force error vs all-pairs on "
              f"{sample or sim.state.n_real} bodies: " + "; ".join(
                  f"{lists} p99 {p99:.3e} median {med:.3e}"
                  for lists, (p99, med) in errs.items()), flush=True)
        if label in profiled:
            prof = profile_tree_step(sim)
            print(f"treecode profile [{label}, 16 steps, ms]: " + " ".join(
                f"{k} {v:.4f}" for k, v in prof.items()), flush=True)
        del sim
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return launched


def energy_check(device) -> None:
    """Phase 7: the JAX package's energy-drift test, through the
    symmetric kernel (tests/test_integrators.py:53-64)."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, diagnostics, models

    for integrator, tol in (("leapfrog", 1e-4), ("semi_implicit_euler", 5e-3)):
        cfg = SimConfig(solver="pallas_symmetric", integrator=integrator, dt=0.002,
                        eps2=1e-6, compensate=0.1)
        sim = Simulation(cfg, models.plummer(256, seed=4), device=device)
        e0 = float(diagnostics.total_energy(sim.state, cfg))
        sim.run(200)
        e1 = float(diagnostics.total_energy(sim.state, cfg))
        drift = abs((e1 - e0) / e0)
        check(drift < tol, f"energy [{integrator}]: |dE/E| {drift:.3e} >= {tol}")
        print(f"energy [{integrator}]: N=256 200 steps |dE/E| {drift:.3e} < {tol}",
              flush=True)


def run_cli(out: pathlib.Path, n: int = 20480, device: str | None = None,
            extra: tuple[str, ...] = ()) -> None:
    """Phase 8: the CLI's ``run`` subcommand in a subprocess."""
    from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint

    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "n_body_problem_tpu_torch", "run",
           "--model", "galaxy_collision", "--n", str(n), "--steps", "20",
           "--diag-every", "10", "--out", str(out), *extra]
    if device:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stderr.splitlines():
        print(f"  cli| {line}")
    check(proc.returncode == 0, f"cli {' '.join(extra)}: rc={proc.returncode}")
    state, _ = load_checkpoint(out / "final.npz")
    check(int(state.step) == 20, f"cli: final.npz at step {int(state.step)}")
    check(bool(state.pos.isfinite().all()), "cli: non-finite positions in final.npz")
    print(f"cli {' '.join(extra) or '(default solver)'}: rc 0, final.npz with "
          f"{state.n_real} bodies at step 20", flush=True)


# A tool run as ``__main__`` in a subprocess, with every launch counter set
# to 0 first and written to a JSON file (argv[1]) as it exits.
_COUNTED = """
import json, runpy, sys
from chip_smoke import counters
wrappers = counters()
for w in wrappers.values():
    w.launches = 0
out, module = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    with open(out, "w") as f:
        json.dump({k: w.launches for k, w in wrappers.items()}, f)
"""
TOOLS_DIR = ROOT / "out" / "chip_smoke_tools"


def start_tool(label: str, module: str, *args: str) -> tuple:
    """Phase 9: start ``python -m module args`` with counted launches."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "NBODY_DATA_DIR"}
    counts = TOOLS_DIR / f"{label}.launches.json"
    counts.unlink(missing_ok=True)
    cmd = [sys.executable, "-c", _COUNTED, str(counts), module, *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return label, proc, counts, time.perf_counter()


def finish_tool(started: tuple, timeout: float = 600) -> tuple[list[str], dict]:
    """Wait for a started tool; its stdout lines and kernel launches."""
    label, proc, counts, t0 = started
    out, err = proc.communicate(timeout=timeout)
    for line in err.splitlines()[-12:]:
        print(f"  {label}| {line}")
    check(proc.returncode == 0, f"tool [{label}]: rc={proc.returncode}")
    launched = {k: v for k, v in json.loads(counts.read_text()).items() if v}
    print(f"tool [{label}]: rc 0 in {time.perf_counter() - t0:.1f} s, launches {launched}",
          flush=True)
    return out.splitlines(), launched


def run_tool(label: str, module: str, *args: str) -> tuple[list[str], dict]:
    return finish_tool(start_tool(label, module, *args))


def finite_record(label: str, lines: list[str]) -> dict:
    rec = json.loads(lines[-1])
    check(all(math.isfinite(rec[k]) and rec[k] > 0 for k in ("ms_per_step", "pairs_per_sec")),
          f"tool [{label}]: non-finite record {rec}")
    check(rec["backend"] == "cuda", f"tool [{label}]: backend {rec['backend']!r}")
    return rec


def needs(label: str, launched: dict, kernels: tuple[str, ...]) -> None:
    missing = [k for k in kernels if not launched.get(k)]
    check(not missing, f"tool [{label}]: never launched {missing}")


def drive_tools() -> dict:
    """Phase 9: the bench harness, the CLI's bench, run on datasets 1 and
    0 with the snap export and the profiler, convert, and validate's
    convergence study; returns the kernel launches of all of them."""
    import numpy as np

    from n_body_problem_tpu_torch.io import read_snap, write_tipsy
    from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint
    from n_body_problem_tpu_torch.io.datasets import DATASETS, data_dir
    from n_body_problem_tpu_torch.models import disk_galaxy

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    total: dict = {}

    def add(launched: dict) -> None:
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v

    validate = start_tool("validate", "n_body_problem_tpu_torch.validate", "--convergence",
                          "--n", "4096", "--solver", "pallas_symmetric")

    lines, launched = run_tool("bench treecode 65536", "n_body_problem_tpu_torch.bench",
                               "--n", "65536", "--solver", "treecode", "--steps", "16")
    rec = finite_record("bench treecode 65536", lines)
    check(rec["force_err_p99"] < ERR_P99 and rec["force_err_median"] < ERR_MEDIAN,
          f"bench treecode: probe p99 {rec['force_err_p99']:.3e} "
          f"median {rec['force_err_median']:.3e}")
    needs("bench treecode 65536", launched, ("near", "far", "vip", "allpairs"))
    add(launched)
    print(f"bench [treecode, 65,536]: {rec['ms_per_step']:.4f} ms/step "
          f"{rec['pairs_per_sec']:.4e} pairs/s vs_baseline {rec['vs_baseline']:.4f}; "
          f"probe after {rec['probe_depth_steps']} steps p99 {rec['force_err_p99']:.3e} "
          f"median {rec['force_err_median']:.3e}; {rec['device']}", flush=True)

    lines, launched = run_tool("cli bench", "n_body_problem_tpu_torch", "bench")
    rec = finite_record("cli bench", lines)
    needs("cli bench", launched, ("symmetric",))
    add(launched)
    print(f"bench [cli defaults: {rec['solver']}, {rec['n']}]: {rec['ms_per_step']:.4f} "
          f"ms/step {rec['pairs_per_sec']:.4e} pairs/s", flush=True)

    # dataset 1 with no file: its fallback on auto, the snap export, the trace
    check(not (data_dir() / DATASETS[1].filename).exists(),
          f"{data_dir() / DATASETS[1].filename} exists: the fallback would not run")
    out = TOOLS_DIR / "run_default"
    _, launched = run_tool("run dataset 1", "n_body_problem_tpu_torch", "run", "--steps",
                           "20", "--diag-every", "10", "--export-snap", "--profile",
                           "--out", str(out))
    needs("run dataset 1", launched, ("symmetric",))
    add(launched)
    state, _ = load_checkpoint(out / "final.npz")
    pos = state.pos[:state.n_real].numpy()
    check(int(state.step) == 20 and state.n_real == 81922 and np.isfinite(pos).all(),
          f"run dataset 1: final.npz step {int(state.step)}, {state.n_real} bodies")
    snap = read_snap(out / "final.snap")
    # %.7g: 7 significant digits, then rounded to float32
    check(snap.n == state.n_real and np.allclose(snap.pos, pos, rtol=1e-6, atol=0.0),
          f"run dataset 1: final.snap differs from final.npz "
          f"(max |d| {np.abs(snap.pos - pos).max():.3e})")
    trace = json.loads((out / "profile" / "trace.json").read_text())
    device_kernels = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    check(bool(device_kernels), "run dataset 1: the profiler's trace names no device kernel")
    print(f"run [dataset 1 fallback]: {state.n_real} bodies at step 20, final.snap = "
          f"final.npz to 7 digits (max |d| {np.abs(snap.pos - pos).max():.3e}), trace "
          f"names {len(device_kernels)} device kernels", flush=True)

    # dataset 0: a Tipsy file of galaxy_20K's own layout
    data = TOOLS_DIR / "data"
    data.mkdir()
    g = disk_galaxy(19999, seed=0)
    tipsy = data / DATASETS[0].filename
    write_tipsy(tipsy, g.pos.numpy(), g.vel.numpy(), g.mass.numpy(), time=0.0, n_dark=2500)
    check(tipsy.stat().st_size == 860032, f"galaxy_20K layout: {tipsy.stat().st_size} bytes")
    out = TOOLS_DIR / "run_dataset0"
    _, launched = run_tool("run dataset 0 treecode", "n_body_problem_tpu_torch", "run",
                           "--dataset", "0", "--data-dir", str(data), "--solver", "treecode",
                           "--tree-tuned", "--steps", "20", "--out", str(out))
    needs("run dataset 0 treecode", launched, ("near", "far", "vip"))
    add(launched)
    state, cfg = load_checkpoint(out / "final.npz")
    check(int(state.step) == 20 and state.n == 20224 and state.n_real == 20000
          and bool(state.pos.isfinite().all()),
          f"run dataset 0: step {int(state.step)}, {state.n_real} of {state.n} bodies")
    run_tool("convert", "n_body_problem_tpu_torch", "convert", str(tipsy),
             str(TOOLS_DIR / "galaxy_20k.csv"))
    rows = len((TOOLS_DIR / "galaxy_20k.csv").read_text().splitlines()) - 1
    check(rows == 20000, f"convert: {rows} rows")
    print(f"run [dataset 0, treecode tuned]: 20,000 of 20,224 bodies at step 20 "
          f"(src_tile {cfg.tree_src_tile}); convert: {rows} rows", flush=True)

    lines, launched = finish_tool(validate)
    needs("validate", launched, ("symmetric",))
    add(launched)
    rep = json.loads(lines[-1])
    orders = {k: v["fitted_order"] for k, v in rep["scaling"].items()}
    oracle = rep["oracle_f64"]
    print(f"validate [convergence, {rep['n']}, {rep['solver']}]: fitted orders "
          + " ".join(f"{k} {v:.4f}" for k, v in orders.items()) + "; float64 oracle "
          + " ".join(f"{k} {v:.4e}" for k, v in oracle.items()), flush=True)
    check(orders["leapfrog"] >= 1.8, f"validate: leapfrog order {orders['leapfrog']:.3f}")
    check(oracle["pos_delta_p99"] <= 1e-5,
          f"validate: oracle pos_delta_p99 {oracle['pos_delta_p99']:.3e}")
    return total


RENDER_N, RENDER_W, RENDER_H = 65536, 1024, 1024   # the bench's render leg
MOVIE_W, MOVIE_H = 1024, 768
RENDER_TOL = 1e-5   # rtol, and atol x the frame's maximum: card against CPU


def png_image(path: pathlib.Path) -> tuple[int, int, int]:
    """(width, height, brightest byte) of an 8-bit RGB PNG as
    ``render.image.write_png`` writes it; raises if it is not one."""
    import struct
    import zlib

    raw = path.read_bytes()
    check(raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR", f"{path}: not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", raw[16:26])
    check(depth == 8 and color == 2, f"{path}: not 8-bit RGB")
    start = raw.index(b"IDAT") + 4
    size = int.from_bytes(raw[start - 8:start - 4], "big")
    data = zlib.decompress(raw[start:start + size])
    check(len(data) == h * (3 * w + 1), f"{path}: {len(data)} bytes of pixels for {w}x{h}")
    return w, h, max(data)   # each row's filter byte is 0


def frames_ok(label: str, frames, count: int, height: int, width: int) -> None:
    import torch

    check(tuple(frames.shape) == (count, height, width, 3),
          f"{label}: frames {tuple(frames.shape)}")
    check(frames.device.type == "cuda", f"{label}: frames on {frames.device}")
    check(bool(torch.isfinite(frames).all()), f"{label}: non-finite frame")
    lit = [float(f.max()) for f in frames]
    check(min(lit) > 0, f"{label}: blank frame (maxima {lit})")


def render_card_vs_cpu(device) -> dict:
    """Phase 10 (a): one Plummer 65,536 state at 1024x1024 on the card and
    on the CPU; two card renders compared bit for bit; no host sync in a
    frame; the splat's time a frame and its three steps' (the sprite pass
    beside the one-call 2-to-1 ``conv2d`` it replaces on the card); both
    forms of the sprite pass on the host's CPU, where the port takes the
    2-to-1."""
    import torch
    import torch.nn.functional as F

    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.render import OrbitCamera, render_state
    from n_body_problem_tpu_torch.render.splat import (_bilinear_scatter, _conv_sprites,
                                                       _sprite_constants, project_to_screen,
                                                       splat_frame)
    from n_body_problem_tpu_torch.render.sprites import MASS_THRESHOLD
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    s = models.plummer(RENDER_N, seed=0)
    cam = OrbitCamera(distance=2.0)
    kw = dict(width=RENDER_W, height=RENDER_H)
    c = s.to(device)
    card = render_state(c, cam, **kw)
    again = render_state(c, cam, **kw)
    cpu = render_state(s, cam, **kw)
    frames_ok("render 65,536", torch.stack([card, again]), 2, RENDER_H, RENDER_W)
    peak = float(cpu.max())
    err = float((card.cpu() - cpu).abs().max())
    check(torch.allclose(card.cpu(), cpu, rtol=RENDER_TOL, atol=RENDER_TOL * peak),
          f"render: card frame max |d| {err:.3e} from the CPU's (max {peak:.4f}) outside "
          f"rtol {RENDER_TOL}, atol {RENDER_TOL} x max")
    bitwise = torch.equal(card, again)
    args = (c.pos, c.mass, c.real_mask(), torch.as_tensor(cam.view_projection(), device=device),
            torch.zeros(3, device=device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        splat_frame(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = time_ms(lambda: splat_frame(*args, **kw), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        splat_frame(*args, **kw)
    enqueue_ms = (time.perf_counter() - t0) / 20 * 1e3
    px, py, vis = project_to_screen(c.pos, *args[3:], RENDER_W, RENDER_H)
    draw, large = vis & args[2], c.mass > MASS_THRESHOLD
    steps = {
        "project": time_ms(lambda: project_to_screen(c.pos, *args[3:], RENDER_W, RENDER_H), 20),
        "scatter": time_ms(lambda: _bilinear_scatter(px, py, draw, large, RENDER_H, RENDER_W), 20),
    }
    planes = _bilinear_scatter(px, py, draw, large, RENDER_H, RENDER_W)
    steps["sprites"] = time_ms(lambda: _conv_sprites(planes), 20)
    k = _sprite_constants(device)[0].transpose(0, 1)
    cudnn = torch.backends.cudnn

    def library():
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            return F.conv2d(planes[None], k, padding=k.shape[-1] // 2)[0, 0]

    lib = library()
    check(torch.allclose(_conv_sprites(planes), lib, rtol=RENDER_TOL,
                         atol=RENDER_TOL * float(lib.max())),
          "render: the depthwise sprite pass differs from the 2-to-1 conv2d")
    library_ms = time_ms(library, 20)

    def host_ms(fn, reps: int = 3) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    host = planes.cpu()
    depthwise = _sprite_constants(host.device)[0]
    cpu_ms = {"2-to-1 (the port's)": host_ms(lambda: _conv_sprites(host)),
              "depthwise": host_ms(lambda: F.conv2d(host[None], depthwise, padding=k.shape[-1] // 2,
                                                    groups=2)[0].sum(0))}
    print(f"render [a, card vs CPU]: Plummer {RENDER_N:,} at {RENDER_W}x{RENDER_H}, frame max "
          f"{peak:.4f}, max |card - CPU| {err:.3e} (rtol {RENDER_TOL}, atol {RENDER_TOL} x max); "
          f"two card renders bitwise equal: {bitwise}; no host sync in a frame; splat "
          f"{ms:.4f} ms a frame (CUDA events, mean of 20; host enqueue {enqueue_ms:.4f}); "
          f"steps: " + ", ".join(f"{k_} {v:.4f}" for k_, v in steps.items())
          + f"; one 2-to-1 conv2d in place of the sprite pass {library_ms:.4f} ms; the sprite "
          f"pass on the host's CPU ({torch.get_num_threads()} threads, mean of 3): "
          + ", ".join(f"{k_} {v:.4f} ms" for k_, v in cpu_ms.items()), flush=True)
    return {"splat_ms": ms, "bitwise": bitwise, "max_abs_err": err}


def render_bench_leg(device, exact_ms: float) -> None:
    """Phase 10 (b): the bench's step+render leg, beside the exact step of
    phase 5; its symmetric launches (the warm movie and the timed one), peak
    memory and a profiler breakdown of one more movie."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.bench import bench_render
    from n_body_problem_tpu_torch.ops.cuda_symmetric import LAUNCHES_A_CALL
    from n_body_problem_tpu_torch.render import OrbitCamera
    from n_body_problem_tpu_torch.treecode_profile import _busy_us, _device_events, _trace

    sym = counters()["symmetric"]
    before = sym.launches
    torch.cuda.reset_peak_memory_stats(device)
    ms = bench_render(RENDER_N, "pallas_symmetric")
    launched = sym.launches - before
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    check(math.isfinite(ms) and ms > 0, f"bench_render: {ms} ms/step")
    check(launched == 20 * LAUNCHES_A_CALL,
          f"bench_render: symmetric kernel launched {launched} times, not (10 + 10) x "
          f"{LAUNCHES_A_CALL}")
    sim = Simulation(SimConfig(), models.plummer(RENDER_N, seed=0), device=device)
    cam = OrbitCamera(distance=2.0)
    sim.movie(2, render_every=1, camera=cam, width=RENDER_W, height=RENDER_H)
    events, wall_us = _trace(lambda: sim.movie(10, render_every=1, camera=cam,
                                               width=RENDER_W, height=RENDER_H))
    gpu = _device_events(events)
    by_name: dict = {}
    for e in gpu:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"] / 1e3 / 10
    busy = _busy_us(gpu)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"render [b, bench leg]: bench_render({RENDER_N}, pallas_symmetric) "
          f"{ms:.4f} ms/step with a {RENDER_W}x{RENDER_H} frame a step, against the exact "
          f"step's {exact_ms:.4f} ms/step (phase 5); symmetric launches {launched} ((10 warm + "
          f"10 timed) x {LAUNCHES_A_CALL}); peak device memory {peak:.3f} GiB; profiled movie "
          f"of 10: device busy "
          f"{busy / 1e3 / 10:.4f} ms a step of {wall_us / 1e3 / 10:.4f}, idle share "
          f"{1 - busy / wall_us:.3f}; device ms a step by kernel: "
          + "; ".join(f"{k} {v:.4f}" for k, v in top), flush=True)


def render_tree_movies(device) -> None:
    """Phase 10 (c) and (d): the treecode movies. The hierarchical movie at
    65,536 with ``render_every == tree_rebuild_every`` ends bitwise where
    ``run`` ends, and the trajectory's last frame is ``run``'s positions in
    call-entry order, bitwise; then a flat and a dense movie."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops.registry import tree_path
    from n_body_problem_tpu_torch.render import OrbitCamera
    from n_body_problem_tpu_torch.treecode_profile import _busy_us, _device_events, _trace

    wrappers = counters()
    cam = OrbitCamera(distance=2.0, aspect=MOVIE_W / MOVIE_H)
    kw = dict(width=MOVIE_W, height=MOVIE_H)
    cfg = SimConfig(solver="treecode")
    r = cfg.tree_rebuild_every
    sims = [Simulation(cfg, models.plummer(RENDER_N, seed=0), device=device) for _ in range(3)]
    ref, mov, traj = sims
    check(all(tree_path(x.cfg) == "hier" for x in sims),
          "treecode movie: not the hierarchical path")
    entry = torch.from_numpy(traj.sort_perm.astype("int64")).to(device)
    before = {k: w.launches for k, w in wrappers.items()}
    frames = mov.movie(2 * r, r, cam, **kw)
    moved = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]}
    frames_ok("hierarchical movie", frames, 2, MOVIE_H, MOVIE_W)
    ref.run(2 * r)
    check(torch.equal(mov.state.pos, ref.state.pos) and torch.equal(mov.state.vel, ref.state.vel),
          "hierarchical movie: final state differs from run()'s "
          f"(max |d| {float((mov.state.pos - ref.state.pos).abs().max()):.3e})")
    check((mov.sort_perm == ref.sort_perm).all(), "hierarchical movie: sort_perm differs")
    hist = traj.trajectory(2 * r, save_every=r)
    check(tuple(hist.shape) == (2, ref.state.n, 3), f"trajectory: shape {tuple(hist.shape)}")
    # run()'s positions in call-entry order: body sort_perm[i] of the input
    # is at slot i now, and at entry slot inverse(entry)[sort_perm[i]].
    ids = torch.from_numpy(ref.sort_perm.astype("int64")).to(device)
    slot_of = torch.empty_like(entry)
    slot_of[entry] = torch.arange(len(entry), device=device)
    n_real = ref.state.n_real
    want = torch.empty_like(ref.state.pos[:n_real])
    want[slot_of[ids]] = ref.state.pos[:n_real]
    check(torch.equal(hist[-1][:n_real], want),
          "trajectory: last frame is not run()'s positions in call-entry order, bitwise")
    # times: five calls of each, alternated, from one state (run and movie
    # stay bitwise equal), then one profiled call of each. A 16-step call
    # varies by tens of per cent from one call to the next, so one sample
    # of each cannot tell them apart.
    reps = 5
    wall = {"movie": [], "run": []}
    calls = {"movie": lambda: mov.movie(2 * r, r, cam, **kw), "run": lambda: ref.run(2 * r)}
    for _ in range(reps):
        for label, x in (("movie", mov), ("run", ref)):
            w0 = x.wall_seconds
            calls[label]()
            wall[label].append((x.wall_seconds - w0) / (2 * r) * 1e3)
    check(torch.equal(mov.state.pos, ref.state.pos),
          "hierarchical movie: later calls differ from run()'s")
    prof = {}
    for label in ("movie", "run"):
        events, wall_us = _trace(calls[label])
        busy = _busy_us(_device_events(events))
        prof[label] = (busy / 1e3 / (2 * r), wall_us / 1e3 / (2 * r), 1 - busy / wall_us)
    spread = {k: f"mean {sum(v) / reps:.4f} (min {min(v):.4f}, max {max(v):.4f})"
              for k, v in wall.items()}
    print(f"render [c, hierarchical movie]: {RENDER_N:,} bodies, {2 * r} steps, a frame every "
          f"{r} ({MOVIE_W}x{MOVIE_H}); final state = run({2 * r})'s bitwise; trajectory's last "
          f"frame = run's positions in call-entry order bitwise; launches in the movie {moved}; "
          f"{reps} later calls each, alternated: movie {spread['movie']} ms/step, run "
          f"{spread['run']} ms/step; profiled: "
          + "; ".join(f"{k} device busy {b:.4f} ms/step of {w:.4f}, idle share {i:.3f}"
                      for k, (b, w, i) in prof.items()), flush=True)
    del sims, ref, mov, traj, hist
    torch.cuda.empty_cache()

    for label, n, over, kernels in (
            ("flat", 20480, dict(tree_hier=False), ("near", "far_single", "vip")),
            ("dense", 1024, dict(tree_flat_cap=-1), ("gather", "near_panel", "vip"))):
        sim = Simulation(SimConfig(solver="treecode", **over), models.plummer(n, seed=0),
                         device=device)
        check(tree_path(sim.cfg) == label, f"{label} movie: path {tree_path(sim.cfg)}")
        before = {k: w.launches for k, w in wrappers.items()}
        frames = sim.movie(2 * r, r, cam, **kw)
        moved = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]}
        frames_ok(f"{label} movie", frames, 2, MOVIE_H, MOVIE_W)
        check(all(moved.get(k, 0) >= 2 * r for k in kernels),
              f"{label} movie: launches {moved}, expected each of {kernels} every step")
        check(bool(torch.isfinite(sim.state.pos).all()), f"{label} movie: non-finite positions")
        print(f"render [d, {label} movie]: {n:,} bodies, {2 * r} steps, 2 frames; launches "
              f"{moved}; {sim.wall_seconds / (2 * r) * 1e3:.4f} ms/step with the frames "
              f"(first call)", flush=True)


def render_cli(device) -> dict:
    """Phase 10 (e): ``run --render-every`` (and, where Pillow is present,
    ``--gif`` and ``--serve``) and ``render`` on the card, each counting its
    kernel launches."""
    import importlib.util

    data = TOOLS_DIR / "data"        # phase 9's galaxy_20K-layout file
    out = TOOLS_DIR / "render_run"
    shutil.rmtree(out, ignore_errors=True)
    total: dict = {}
    pil = importlib.util.find_spec("PIL") is not None
    extra = ("--gif",) if pil else ()
    _, launched = run_tool("run render-every 50", "n_body_problem_tpu_torch", "run",
                           "--dataset", "0", "--data-dir", str(data), "--steps", "200",
                           "--render-every", "50", "--out", str(out), *extra)
    needs("run render-every 50", launched, ("symmetric",))
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    pngs = sorted((out / "frames").glob("*.png"))
    check(len(pngs) == 4, f"run --render-every 50: {len(pngs)} frames, not 4")
    for path in pngs:
        w, h, lit = png_image(path)
        check((w, h) == (1024, 768) and lit > 0, f"{path.name}: {w}x{h}, brightest {lit}")
    if pil:
        check((out / "movie.gif").stat().st_size > 0, "run --gif: no movie.gif")
    _, launched = run_tool("render", "n_body_problem_tpu_torch", "render",
                           str(out / "final.npz"), str(out / "frame.png"))
    w, h, lit = png_image(out / "frame.png")
    check((w, h) == (1024, 768) and lit > 0, f"render: frame.png {w}x{h}, brightest {lit}")
    served = "skipped: Pillow is not installed"
    if pil:
        served = serve_in_process(device)
    print(f"render [e, CLI]: run --dataset 0 --steps 200 --render-every 50: 4 PNGs "
          f"(1024x768, lit){', movie.gif' if pil else ''}; render final.npz: frame.png "
          f"{w}x{h}; Pillow {'found' if pil else 'not found: --gif and --serve not run'}; "
          f"--serve: {served}", flush=True)
    return total


def serve_in_process(device) -> str:
    """``run --serve`` through the CLI's ``main`` in this process, so that
    the viewer it starts can be read after the run."""
    import socket

    from n_body_problem_tpu_torch.cli import main as cli_main
    from n_body_problem_tpu_torch.render.server import LiveViewer

    seen = {}
    orig = LiveViewer.__init__

    def spy(self, port, camera, **kw):
        orig(self, port, camera, **kw)
        seen["viewer"] = self

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    LiveViewer.__init__ = spy
    try:
        rc = cli_main(["run", "--model", "plummer", "--n", "20480", "--steps", "100",
                       "--steps-per-block", "25", "--serve", str(port),
                       "--out", str(TOOLS_DIR / "render_serve")])
    finally:
        LiveViewer.__init__ = orig
    v = seen.get("viewer")
    check(rc == 0 and v is not None, f"run --serve: rc {rc}")
    deadline = time.time() + 10
    while v._frame_no < 1 and time.time() < deadline:
        time.sleep(0.05)
    check(v.stats["step"] == 100 and v._frame_no >= 1,
          f"run --serve: stats {v.stats}, {v._frame_no} frames encoded")
    return f"{v._frame_no} JPEG frames encoded from card frames, stats {v.stats}"


def drive_render(device, exact_ms: float) -> dict:
    """Phase 10: rendering on the card. Returns the kernel launches of the
    CLI's subprocesses (the in-process launches are on the counters)."""
    t0 = time.perf_counter()
    render_card_vs_cpu(device)
    render_bench_leg(device, exact_ms)
    render_tree_movies(device)
    launched = render_cli(device)
    print(f"render: phase 10 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


# ------------------------------------------------------------ 11. multi-GPU
# (label, N, strategy, SimConfig overrides, steps): BASELINE.json configs 4
# and 5 (262,144 exact over a ring, 1,048,576 treecode) and the flat and
# dense treecode paths.
MULTI_RUNS = (
    ("ring 262,144", 262144, "ring", dict(integrator="leapfrog"), 4),
    ("half_ring 262,144", 262144, "half_ring", dict(integrator="leapfrog"), 4),
    ("treecode 1,048,576", 1048576, "treecode", {}, 8),
    ("treecode 65,536 flat", 65536, "treecode", dict(tree_hier=False), 8),
    ("treecode 20,480 dense", 20480, "treecode", dict(tree_flat_cap=-1), 8),
    ("treecode_staged 1,048,576", 1048576, "treecode_staged", {}, 8),
)
TREE_STRATEGIES = ("treecode", "treecode_staged")
MULTI_EXACT_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_parallel.py, one step
MULTI_TREE_TOL = dict(rtol=5e-4, atol=5e-5)    # tests/test_parallel.py:270-273
RANKS = 4   # the rank-by-rank check's ring


def sharded_launches_a_step(cfg, n: int, strategy: str, size: int) -> dict:
    """Kernel launches rank 0 makes a sharded step: the exact ring's
    ``block_acc`` calls (``size`` a force; the half ring one for its own
    block and two a stage it computes, rank 0 computing every stage), each
    one launch or two where ``allpairs_split`` cuts the columns; the
    treecode paths' kernels as one device's, the dense path's single-level
    far field on every step (the sharded force always calls it); the
    staged treecode's near kernel once a stage, ``size`` a step."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.cuda_force import allpairs_split
    from n_body_problem_tpu_torch.parallel import stream, tree as ptree

    want = dict.fromkeys(("allpairs",) + TREE_KERNELS, 0)
    if strategy not in TREE_STRATEGIES:
        b = n // size
        calls = size if strategy == "ring" else 1 + 2 * (size // 2)
        want["allpairs"] = calls * (2 if allpairs_split(b, b)[2] > 1 else 1)
        return want
    if strategy == "treecode_staged":
        *_, vip, hier = stream.staged_shapes(cfg, n // size, size)
        want.update({"near": size, "far" if hier else "far_single": 1,
                     "vip": 2 if vip else 0})
        return want
    path = ptree.sharded_path(cfg)
    if path == "dense":
        vip = treecode._dense_src_static(n, cfg.tree_tile, cfg.tree_max_near,
                                         cfg.tree_vip_tiles)[0]
        want.update(gather=1, near_panel=1, far_single=1)
    else:
        vip = treecode._flat_src_static(n, cfg.tree_tile, cfg.tree_src_tile,
                                        cfg.tree_max_near, cfg.tree_vip_tiles)[3]
        want.update({"near": 1, "far" if path == "hier" else "far_single": 1})
    want["vip"] = 2 if vip else 0
    return want


def multi_gpu_rank(mesh, runs) -> list[dict]:
    """Phase 11 (a) on one rank of the NCCL world: each run of ``runs``
    through ``ShardedSimulation``, its replays beside its eager loop
    (``sharded.eager_run``) from the same state, then on rank 0 the
    single-device ``Simulation`` of the same state on the same card.
    Returns rank 0's records; their launches are the prime's and the
    replays', not the eager loop's."""
    import numpy as np
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch import diagnostics as diag
    from n_body_problem_tpu_torch.parallel import ShardedSimulation, eager_run

    wrappers = counters()
    dev, out = mesh.device, []
    replicated = {}   # N: the replicated treecode's positions in input order
    for label, n, strategy, overrides, steps in runs:
        exact = strategy not in TREE_STRATEGIES
        cfg = SimConfig(solver="pallas" if exact else "treecode", **overrides)
        state = models.plummer(n, seed=0)
        for w in wrappers.values():
            w.launches = 0
        uncounted = dict.fromkeys(wrappers, 0)

        def eager(k):
            """The eager loop of ``k`` steps from the shard's state; its
            launches are not counted."""
            before = {key: w.launches for key, w in wrappers.items()}
            got = eager_run(sim, k)
            torch.cuda.synchronize(dev)
            for key, w in wrappers.items():
                uncounted[key] += w.launches - before[key]
            return got

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sim = ShardedSimulation(cfg, state, mesh, strategy=strategy)
        first = 1 if exact else steps      # compared, then ``steps`` timed
        # the eager loop (its result kept on the host), then the replays'
        # first run (the capture), each with its peak memory
        fields = ("pos", "vel", "acc", "time", "step")
        torch.cuda.reset_peak_memory_stats(dev)
        ref, ref_perm = eager(first)
        peak_e = torch.cuda.max_memory_allocated(dev)
        ref = {k: getattr(ref, k).cpu() for k in fields}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        sim.run(first)
        peak_g = torch.cuda.max_memory_allocated(dev)
        same = all(torch.equal(getattr(sim.state, k).cpu(), ref[k]) for k in fields)
        same = same and (ref_perm is None or bool((sim.sort_perm == ref_perm).all()))
        flags = mesh.all_gather(torch.tensor([int(same)], dtype=torch.int32, device=dev))
        del ref
        after_first = sim.gather_state()
        perm_first = None if exact else np.asarray(sim.sort_perm).copy()
        # ms/step in turns, eager, replayed, replayed, eager; the replays counted
        ms = {"eager": [], "graph": []}
        timed = dict.fromkeys(wrappers, 0)
        for kind in ("eager", "graph", "graph", "eager"):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.perf_counter()
            if kind == "eager":
                eager(steps)
            else:
                sim.run(steps)
                for k, w in wrappers.items():
                    timed[k] += w.launches - before[k]
            ms[kind].append((time.perf_counter() - t0) / steps * 1e3)
        rec = {"label": label, "n": n, "strategy": strategy, "devices": mesh.size,
               "ms_per_step": ms["graph"], "eager_ms_per_step": ms["eager"],
               "bitwise_vs_eager": bool(flags.all()),
               "peak_gib": peak_g / 2**30, "peak_gib_eager": peak_e / 2**30,
               "capture_s": sim.capture_seconds,
               "lists_gib": sum(a.nbytes for a in sim._static.aux or () if a is not None) / 2**30,
               "launched": {k: w.launches - uncounted[k] for k, w in wrappers.items()},
               "timed": {k: v // 2 for k, v in timed.items()},
               "timed_even": all(v % 2 == 0 for v in timed.values()),
               "want": sharded_launches_a_step(sim.cfg, sim.n, strategy, mesh.size),
               "steps": steps, "cfg": sim.cfg.to_dict()}
        final = sim.gather_state()
        del sim
        if mesh.rank == 0:
            rec["finite"] = bool(torch.isfinite(final.pos).all())
            rec["overspeed"] = int(diag.overspeed_count(final))
            del final
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ref = Simulation(cfg, state, device=dev)
            ref.run(first)
            k = n
            got, want = after_first.pos[:k], ref.state.pos[:k]
            if exact:
                rec["bitwise"] = bool(torch.equal(got, want)
                                      and torch.equal(after_first.vel[:k], ref.state.vel[:k]))
                rec["ok"] = bool(torch.allclose(got, want, **MULTI_EXACT_TOL)
                                 and torch.allclose(after_first.vel[:k], ref.state.vel[:k],
                                                    **MULTI_EXACT_TOL))
            else:
                inv_a = torch.as_tensor(np.argsort(perm_first), device=dev)
                inv_b = torch.as_tensor(np.argsort(np.asarray(ref.sort_perm)), device=dev)
                got, want = got[inv_a], want[inv_b]
                rec["bitwise"] = bool(torch.equal(got, want))
                rec["ok"] = bool(torch.allclose(got, want, **MULTI_TREE_TOL))
                if strategy == "treecode":
                    replicated[n] = got
                elif n in replicated:
                    other = replicated.pop(n)
                    rec["vs_replicated"] = {
                        "max_abs_diff": float((got - other).abs().max()),
                        "bitwise": bool(torch.equal(got, other)),
                        "ok": bool(torch.allclose(got, other, **MULTI_TREE_TOL))}
            rec["max_abs_diff"] = float((got - want).abs().max())
            wall0 = ref.wall_seconds
            ref.run(steps)
            rec["single_ms_per_step"] = (ref.wall_seconds - wall0) / steps * 1e3
            rec["single_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            del ref
        del after_first
        torch.cuda.empty_cache()
        out.append(rec)
    return out


def nccl_world(runs=MULTI_RUNS, device_type: str = "cuda", size: int | None = None) -> dict:
    """Phase 11 (a): a real NCCL world of min(GPUs, 4) ranks, spawned by
    ``parallel.spawn_ring``; each run checked against the single-device
    run; rank 0's launches, by kernel, returned for the kernels' record."""
    import torch

    from n_body_problem_tpu_torch.parallel import spawn_ring

    size = size or min(torch.cuda.device_count(), 4)
    print(f"multi-GPU: an NCCL world of {size} rank(s) on {torch.cuda.device_count()} "
          f"GPU(s)", flush=True)
    t0 = time.perf_counter()
    records = spawn_ring(multi_gpu_rank, size, device_type=device_type, args=(runs,))
    launched: dict = {}
    for rec in records:
        keys = set(rec["want"]) | set(rec["timed"])
        want = {k: rec["want"].get(k, 0) * rec["steps"] for k in keys}
        timed = {k: rec["timed"].get(k, 0) for k in keys}
        check(timed == want and rec["timed_even"],
              f"{rec['label']}: each replayed run launched {timed}, expected {want}")
        check(rec["bitwise_vs_eager"],
              f"{rec['label']}: the replayed world is not bitwise its eager loop")
        check(rec["ok"], f"{rec['label']}: sharded vs single-device max |diff| "
                         f"{rec['max_abs_diff']:.3e} outside tolerance")
        check(rec["finite"] and rec["overspeed"] == 0,
              f"{rec['label']}: finite {rec['finite']}, overspeed {rec['overspeed']}")
        vs = rec.get("vs_replicated")
        if vs:
            check(vs["ok"], f"{rec['label']}: vs the replicated treecode's world run max |diff| "
                            f"{vs['max_abs_diff']:.3e} outside tolerance")
            print(f"multi-GPU [{rec['label']}]: vs the replicated treecode world run of the "
                  f"same state: max |diff| {vs['max_abs_diff']:.3e}, bitwise {vs['bitwise']}",
                  flush=True)
        for k, v in rec["launched"].items():
            launched[k] = launched.get(k, 0) + v
        ms = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        print(f"multi-GPU [{rec['label']}]: D={rec['devices']} {rec['strategy']} ms/step "
              f"eager {ms(rec['eager_ms_per_step'])}, replayed {ms(rec['ms_per_step'])} (in "
              f"turns) vs single-device {rec['single_ms_per_step']:.4f}; replayed bitwise its "
              f"eager loop: True; capture {rec['capture_s']:.3f} s; peak GiB eager "
              f"{rec['peak_gib_eager']:.3f}, replayed {rec['peak_gib']:.3f} (its static lists "
              f"{rec['lists_gib']:.3f}), single device "
              f"{rec['single_peak_gib']:.3f}; max |diff| vs single device "
              f"{rec['max_abs_diff']:.3e} after "
              f"{rec['steps'] if rec['strategy'] in TREE_STRATEGIES else 1} step(s), bitwise "
              f"{rec['bitwise']}; launches a step (replays counted) "
              f"{dict((k, v) for k, v in rec['want'].items() if v)}; overspeed 0", flush=True)
    print(f"multi-GPU: NCCL world in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launched": launched, "records": records}


class _Recorded:
    """The kernel wrappers replaced, for the duration, by recorders that
    keep each call's arguments and then call the wrapper."""

    NAMES = (("cuda_treecode", "near_field"), ("cuda_treecode", "far_field_hier"),
             ("cuda_treecode", "far_field_single"), ("cuda_treecode", "gather_panels"),
             ("cuda_treecode", "near_panel"), ("cuda_treecode", "vip_both"),
             ("cuda_force", "block_acc"))

    def __enter__(self):
        from n_body_problem_tpu_torch.ops import cuda_force, cuda_treecode

        mods = {"cuda_treecode": cuda_treecode, "cuda_force": cuda_force}
        self.calls, self.saved = [], []
        for mod_name, name in self.NAMES:
            mod = mods[mod_name]
            orig = getattr(mod, name)

            def recorder(*args, _orig=orig, _name=name, **kw):
                self.calls.append((_name, args, kw))
                return _orig(*args, **kw)

            recorder.launches = orig.launches
            self.saved.append((mod, name, orig))
            setattr(mod, name, recorder)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def _plain_of(name: str):
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_treecode

    if name == "block_acc":
        return lambda *a, tile_i=1, tile_j=1, **kw: cuda_force.block_acc_plain(*a, **kw)
    return getattr(cuda_treecode, f"{name}_plain")


def replay_against_plain(calls, res: dict, label: str) -> int:
    """Each recorded call (each distinct shape once for ``block_acc``)
    again through its kernel, twice, and through its plain twin: within
    rtol=1e-4, atol=2e-6 and bitwise repeatable. Returns the calls checked."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force, cuda_treecode

    seen, checked = set(), 0
    for name, args, kw in calls:
        shape = (name, tuple(tuple(a.shape) for a in args if hasattr(a, "shape")))
        if name == "block_acc" and shape in seen:
            continue
        seen.add(shape)
        kernel = getattr(cuda_force if name == "block_acc" else cuda_treecode, name)
        got, again, want = kernel(*args, **kw), kernel(*args, **kw), _plain_of(name)(*args, **kw)
        got, again, want = ((x,) if name != "vip_both" else x for x in (got, again, want))
        key = {"block_acc": "allpairs", "near_field": "near", "far_field_hier": "far",
               "far_field_single": "far_single", "gather_panels": "gather",
               "vip_both": "vip", "near_panel": "near_panel"}[name]
        for g, a, w in zip(got, again, want):
            if name == "gather_panels":
                check(torch.equal(g, w), f"{label}: gather kernel != plain copy")
            else:
                agree(res, key, f"{label} {name} {shape[1]}", g, w)
            check(torch.equal(g, a), f"{label}: {name} launches differ bitwise")
        checked += 1
    return checked


RANK_TREES = (("hier 524,288", 524288, {}), ("flat 65,536", 65536, dict(tree_hier=False)),
              ("dense 20,480", 20480, dict(tree_flat_cap=-1)))


def ranks_on_one_card(device, res: dict, n_ring: int = N_LARGE, trees=RANK_TREES) -> dict:
    """Phase 11 (b): the D = 4 forces rank by rank on one card through the
    per-rank functions (``ring.ring_acc_ranks``, ``tree.treecode_acc_ranks``:
    the visiting tiles sliced, the VIP reactions added over the ranks),
    against the single-device force on the same positions (the all-pairs
    kernel; the treecode on the ranks' merged lists), within rtol=1e-4,
    atol=2e-6; every kernel call they made against its plain twin at its
    shape, and repeated for bitwise equality; the near kernel's local form
    timed at 524,288 / 4 beside the single-device call on the merged lists."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, models
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_treecode as ct, treecode as tc
    from n_body_problem_tpu_torch.parallel import tree as ptree
    from n_body_problem_tpu_torch.parallel.ring import ring_acc_ranks
    from n_body_problem_tpu_torch.parallel.sharded import plan_treecode
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    phys = dict(eps2=PHYS["eps2"], compensate=PHYS["compensate"], G=PHYS["G"])
    s = models.plummer(n_ring, seed=0).to(device)
    single = cuda_force.allpairs_acc(s.pos, s.mass, **phys)
    for strategy, blocks in (("ring", 16), ("half_ring", 10)):
        with _Recorded() as rec:
            got = ring_acc_ranks(s.pos, s.mass, RANKS, strategy=strategy, **phys)
        calls = sum(1 for name, *_ in rec.calls if name == "block_acc")
        check(calls == (16 if strategy == "ring" else 4 + 2 * 6),
              f"ranks {strategy}: {calls} block_acc calls")
        err = float((got - single).abs().max())
        check(torch.allclose(got, single, **TOL),
              f"ranks {strategy}: max |ranks - single device| {err:.3e} outside rtol=1e-4, "
              "atol=2e-6")
        n_checked = replay_against_plain(rec.calls, res, f"ranks {strategy}")
        print(f"multi-GPU ranks: {strategy} D={RANKS} at {n_ring} ({blocks} blocks of "
              f"{n_ring // RANKS} rows, {calls} block_acc calls): max |ranks - single| "
              f"{err:.3e}; {n_checked} shape(s) vs plain, bitwise-repeatable", flush=True)
    del s, single
    local_near = {}
    for label, n, overrides in trees:
        cfg, st, _ = plan_treecode(SimConfig(solver="treecode", **overrides),
                                   models.plummer(n, seed=0).to(device), RANKS, device.type)
        path = ptree.sharded_path(cfg)
        with _Recorded() as rec:
            acc, lists = ptree.treecode_acc_ranks(cfg, st.pos, st.mass, RANKS)
        entries = tc.CHUNK_LANES // cfg.tree_src_tile
        merged = ptree.merge_rank_lists(path, lists, st.n // RANKS // cfg.tree_tile, entries)
        kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, tile=cfg.tree_tile,
                  theta=cfg.tree_theta, vip_tiles=cfg.tree_vip_tiles)
        if path == "dense":
            want = tc.treecode_acc(st.pos, st.mass, merged, max_near=merged[0].shape[1], **kw)
        elif path == "flat":
            want = tc.treecode_acc_flat(st.pos, st.mass, merged, src_tile=cfg.tree_src_tile,
                                        max_near=cfg.tree_max_near, **kw)
        else:
            want = tc.treecode_acc_hier(st.pos, st.mass, merged, src_tile=cfg.tree_src_tile,
                                        max_near=cfg.tree_max_near, far_max=cfg.tree_far_max,
                                        **kw)
        torch.cuda.synchronize(device)
        err = float((acc - want).abs().max())
        check(torch.allclose(acc, want, **TOL),
              f"ranks {label}: max |ranks - single device| {err:.3e} outside rtol=1e-4, "
              "atol=2e-6")
        n_checked = replay_against_plain(rec.calls, res, f"ranks {label}")
        names = sorted({name for name, *_ in rec.calls})
        print(f"multi-GPU ranks: {label} path={path} D={RANKS}: max |ranks - single| "
              f"{err:.3e} (bitwise {bool(torch.equal(acc, want))}); kernels {names}, "
              f"{n_checked} calls vs plain, bitwise-repeatable", flush=True)
        if path == "hier":
            near = [(a, k) for name, a, k in rec.calls if name == "near_field"]
            args, kw0 = near[0]
            rank_ms = [time_ms(lambda a=a, k=k: ct.near_field(*a, **k), 20) for a, k in near]
            b = tc.kernel_operands(st.pos, st.mass, merged[-1], compensate=cfg.compensate,
                                   G=cfg.G, src_tile=cfg.tree_src_tile,
                                   vip_src=tc._flat_src_static(st.n, cfg.tree_tile,
                                                               cfg.tree_src_tile,
                                                               cfg.tree_max_near,
                                                               cfg.tree_vip_tiles)[3],
                                   plan=None)["bodies"]
            one = ((b, b, merged[0], merged[1]), dict(kw0, n=st.n))
            check(torch.equal(ct.near_field(*one[0], **one[1]),
                              torch.cat([ct.near_field(*a, **k) for a, k in near])),
                  "near local form: the ranks' rows != the single-device call's, bitwise")
            local_near = {"ms": rank_ms[0], "ranks_ms": rank_ms,
                          "single_device_ms": time_ms(lambda: ct.near_field(*one[0],
                                                                           **one[1]), 20),
                          "plain_ms": time_ms(lambda: ct.near_field_plain(*args, **kw0), 3),
                          **tree_work("near", args, kw0)}
            print(f"multi-GPU ranks: near local form at {n} / {RANKS}: rank 0 "
                  f"{rank_ms[0]:.4f} ms (ranks {', '.join(f'{m:.4f}' for m in rank_ms)}; "
                  f"sum {sum(rank_ms):.4f}) vs the single-device call on the merged lists "
                  f"{local_near['single_device_ms']:.4f} ms, bitwise equal row for row; "
                  f"bound {local_near['bound_ms']:.4f} ms ({local_near['bound_by']})",
                  flush=True)
        del st, acc, want, rec, lists, merged
        torch.cuda.empty_cache()
    return local_near


STAGED_TREES = (("hier 1,048,576", 1048576, {}),
                ("flat 65,536", 65536, dict(tree_hier=False)))
# tests/test_stream.py's production-MAC bar (per-body relative force, the
# staged ranks against the replicated ranks), the treecode's envelope
# against the exact force (tests/test_treecode_hier.py:126-127), and
# test_stream.py's exact-limit VIP config (lines 95-100: every tile near, 8
# VIP tiles) with its bar.
STAGED_P99, STAGED_MAX = 8e-4, 8e-3
ENVELOPE_P99, ENVELOPE_MEDIAN = 2.5e-3, 5e-4
STAGED_EXACT = (16384, 17, dict(tree_tile=128, tree_src_tile=128, tree_theta=1e-30,
                                tree_mac_tau=0.0, tree_max_near=2048, tree_near_slack=0,
                                tree_vip_tiles=8, tree_flat_cap=16 * 128, tree_hier=False))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def staged_on_one_card(device, res: dict, trees=STAGED_TREES) -> dict:
    """Phase 11 (b), staged: ``stream.staged_acc_ranks`` at D = 4 on one
    card beside ``tree.treecode_acc_ranks`` on the same positions and
    config, both against the exact force (the all-pairs kernel): the staged
    force within the treecode's envelope (per-body relative p99 < 2.5e-3,
    median < 5e-4) and no further from it than the replicated one at p99
    and median (each shard's lists take at least the replicated lists'
    exact work); the staged-to-replicated difference printed beside
    test_stream.py's bar (p99 8e-4, max 8e-3), which assumes a reference
    within it of the exact force. At the exact limit, against the
    single-device flat force (rtol 2e-5, atol 2e-6 x max). Every kernel
    call again against its plain twin and bitwise repeatable.
    At 1,048,576 the D stage calls of kernel 7 of each rank are timed beside
    the replicated ranks' one call, and each rank's resident bytes between
    steps are reckoned from the tensors it keeps. Returns kernel 7's staged
    record."""
    import numpy as np
    import torch

    from n_body_problem_tpu_torch import SimConfig, models
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_treecode as ct, treecode as tc
    from n_body_problem_tpu_torch.parallel import stream, tree as ptree
    from n_body_problem_tpu_torch.parallel.sharded import plan_treecode
    from n_body_problem_tpu_torch.treecode_profile import time_ms
    from n_body_problem_tpu_torch.utils.morton import apply_permutation, morton_argsort

    record = {}
    for label, n, overrides in trees:
        cfg, st, _ = plan_treecode(SimConfig(solver="treecode", **overrides),
                                   models.plummer(n, seed=0).to(device), RANKS, device.type,
                                   "treecode_staged")
        with _Recorded() as rec:
            acc, lists = stream.staged_acc_ranks(cfg, st.pos, st.mass, RANKS)
        with _Recorded() as rep:
            want, rep_lists = ptree.treecode_acc_ranks(cfg, st.pos, st.mass, RANKS)
        exact = cuda_force.allpairs_acc(st.pos, st.mass, eps2=cfg.eps2,
                                        compensate=cfg.compensate, G=cfg.G)
        torch.cuda.synchronize(device)

        def rel(a, b):
            r = ((a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-12))[:st.n_real].cpu().numpy()
            return {"p99": float(np.percentile(r, 99)), "median": float(np.median(r)),
                    "max": float(r.max())}

        err = {"staged": rel(acc, exact), "replicated": rel(want, exact),
               "staged_vs_replicated": rel(acc, want)}
        st_e, rp_e, diff = err["staged"], err["replicated"], err["staged_vs_replicated"]
        check(st_e["p99"] < ENVELOPE_P99 and st_e["median"] < ENVELOPE_MEDIAN,
              f"staged ranks {label}: against the exact force p99 {st_e['p99']:.3e}, median "
              f"{st_e['median']:.3e} (envelope {ENVELOPE_P99:g} / {ENVELOPE_MEDIAN:g})")
        check(st_e["p99"] <= rp_e["p99"] and st_e["median"] <= rp_e["median"],
              f"staged ranks {label}: p99 {st_e['p99']:.3e}, median {st_e['median']:.3e} "
              f"against the exact force, further than the replicated ranks' "
              f"{rp_e['p99']:.3e}, {rp_e['median']:.3e}")
        n_checked = replay_against_plain(rec.calls, res, f"staged ranks {label}")
        names = sorted({name for name, *_ in rec.calls})
        near = [(a, k) for name, a, k in rec.calls if name == "near_field"]
        check(len(near) == RANKS * RANKS, f"staged ranks {label}: {len(near)} near calls, "
                                          f"expected {RANKS} a rank")
        bar = diff["p99"] < STAGED_P99 and diff["max"] < STAGED_MAX
        print(f"multi-GPU staged ranks: {label} D={RANKS} hier={cfg.tree_far_max > 0}: "
              f"against the exact force staged p99 {st_e['p99']:.3e} median "
              f"{st_e['median']:.3e} max {st_e['max']:.3e}, replicated p99 {rp_e['p99']:.3e} "
              f"median {rp_e['median']:.3e} max {rp_e['max']:.3e}; staged vs replicated p99 "
              f"{diff['p99']:.3e} max {diff['max']:.3e} ({'inside' if bar else 'outside'} "
              f"test_stream.py's {STAGED_P99:g} / {STAGED_MAX:g}; bitwise "
              f"{bool(torch.equal(acc, want))}); kernels {names}, {n_checked} calls vs plain, "
              f"bitwise-repeatable", flush=True)
        b = st.n // RANKS
        state_bytes = b * 11 * 4   # pos, vel, acc, mass, eps of a shard
        kept = {"staged": state_bytes + _nbytes(*lists[0]),
                "replicated": state_bytes + _nbytes(*rep_lists[0]) + st.n * 4}   # + mass_g
        moved = {"staged": stream.staged_shapes(cfg, b, RANKS)[5] * 11 * 4 + (b + cfg.tree_src_tile) * 16,
                 "replicated": st.n * 12 + (st.n + cfg.tree_src_tile) * 16}
        print(f"multi-GPU staged ranks: {label} rank 0 keeps between steps "
              f"{kept['staged'] / 2**20:.2f} MiB staged vs {kept['replicated'] / 2**20:.2f} MiB "
              f"replicated (shard columns + lists, + the gathered masses); per force it holds "
              f"{moved['staged'] / 2**20:.2f} MiB of others' data staged (summaries + one "
              f"visiting shard) vs {moved['replicated'] / 2**20:.2f} MiB replicated (gathered "
              f"positions + source rows)", flush=True)
        if cfg.tree_far_max > 0:
            stage_ms = [time_ms(lambda a=a, k=k: ct.near_field(*a, **k), 20) for a, k in near]
            rep_near = [(a, k) for name, a, k in rep.calls if name == "near_field"]
            rep_ms = [time_ms(lambda a=a, k=k: ct.near_field(*a, **k), 20) for a, k in rep_near]
            per_rank = [sum(stage_ms[r * RANKS:(r + 1) * RANKS]) for r in range(RANKS)]
            record = {"ms": stage_ms[0], "stage_ms": stage_ms, "rank_sum_ms": per_rank,
                      "force_error": err,
                      "sum_ms": sum(stage_ms), "replicated_rank_ms": rep_ms,
                      "launches_a_force": RANKS, "resident_bytes": kept,
                      "others_bytes_a_force": moved,
                      "plain_ms": time_ms(lambda: ct.near_field_plain(*near[0][0],
                                                                      **near[0][1]), 3),
                      **tree_work("near", *near[0])}
            print(f"multi-GPU staged ranks: near staged form at {n} / {RANKS} "
                  f"({b:,} x {b:,} a stage): stages "
                  + "; ".join(f"rank {r} " + ", ".join(f"{m:.4f}" for m in
                                                     stage_ms[r * RANKS:(r + 1) * RANKS])
                              + f" (sum {per_rank[r]:.4f})" for r in range(RANKS))
                  + f" ms; all {sum(stage_ms):.4f} vs the replicated ranks' one call each "
                  f"{', '.join(f'{m:.4f}' for m in rep_ms)} (sum {sum(rep_ms):.4f}); rank 0 "
                  f"stage 0 bound {record['bound_ms']:.4f} ms ({record['bound_by']}), issue "
                  f"floor {record['issue_floor_ms']:.4f}", flush=True)
        del st, acc, want, exact, lists, rep_lists, rec, rep, near
        torch.cuda.empty_cache()

    n, seed, kw = STAGED_EXACT
    cfg = SimConfig(solver="treecode", **kw)
    st = apply_permutation(models.plummer(n, seed=seed), morton_argsort(
        models.plummer(n, seed=seed).pos)).to(device)
    pos, mass = st.pos.contiguous(), st.mass.contiguous()
    with _Recorded() as rec:
        acc, _ = stream.staged_acc_ranks(cfg, pos, mass, RANKS)
    sel = dict(tile=128, src_tile=128, theta=cfg.tree_theta, max_near=cfg.tree_max_near,
               vip_tiles=cfg.tree_vip_tiles)
    aux = tc.build_tree_flat(pos, mass, slack=0, flat_cap=cfg.tree_flat_cap * 8,
                             mac_tau=0.0, eps2=cfg.eps2, compensate=cfg.compensate, **sel)
    want = tc.treecode_acc_flat(pos, mass, aux, eps2=cfg.eps2, compensate=cfg.compensate,
                                G=cfg.G, **sel)
    err = float((acc - want).abs().max())
    check(torch.allclose(acc, want, rtol=2e-5, atol=2e-6 * float(want.abs().max())),
          f"staged ranks exact limit: max |d| {err:.3e} outside rtol 2e-5, atol 2e-6 x max")
    n_checked = replay_against_plain(rec.calls, res, "staged ranks exact limit")
    print(f"multi-GPU staged ranks: exact limit {n} (VIP 8) D={RANKS}: max |ranks - single "
          f"device| {err:.3e}; {n_checked} calls vs plain, bitwise-repeatable", flush=True)
    return record


def multichip_cli() -> None:
    """Phase 11 (c): ``python -m n_body_problem_tpu_torch.multichip --devices
    1 --device cuda``, the seven legs of the dry run in an NCCL world of one
    rank, each within its tolerance of the single device."""
    proc = subprocess.run(
        [sys.executable, "-m", "n_body_problem_tpu_torch.multichip", "--devices", "1",
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    legs = [ln for ln in proc.stdout.splitlines() if "sharded == single-chip" in ln]
    check(proc.returncode == 0 and len(legs) == 7,
          f"multichip --devices 1: rc {proc.returncode}, {len(legs)} legs, stderr "
          f"{proc.stderr[-800:]}")
    for line in legs:
        print(f"multi-GPU: {line}", flush=True)


def near_golden(device) -> bool:
    """Kernel 7 at D = 1 (one ``bodies`` as targets and sources) on the
    golden inputs: its output digest against the one the kernel gave
    before it took targets and sources apart."""
    import hashlib

    import torch

    from n_body_problem_tpu_torch.kernel_compare import NEAR_GOLDEN_SHA256, near_golden_case
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    args, kw = near_golden_case(device)
    out = ct.near_field(*args, **kw)
    torch.cuda.synchronize(device)
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    same = digest == NEAR_GOLDEN_SHA256
    check(same, f"near kernel at D = 1: output sha256 {digest} != {NEAR_GOLDEN_SHA256} "
                "(the kernel's before targets and sources were split)")
    print(f"multi-GPU: near kernel at D = 1 on the golden inputs: sha256 {digest[:16]}..., "
          "bitwise the kernel's output before the split", flush=True)
    return same


def devices_cli(device) -> None:
    """Phase 11 (c): ``run --devices 2`` on ``cuda``: with one GPU it exits 2
    with ``make_ring_mesh``'s message; with two or more it writes
    ``final.npz``."""
    import torch

    out = ROOT / "out" / "chip_smoke_devices"
    shutil.rmtree(out, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", "n_body_problem_tpu_torch", "run", "--model", "plummer",
         "--n", "4096", "--steps", "4", "--devices", "2", "--strategy", "half_ring",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if torch.cuda.device_count() < 2:
        want = f"requested 2 devices, have {torch.cuda.device_count()}"
        check(proc.returncode == 2 and want in proc.stderr,
              f"run --devices 2 on one GPU: rc {proc.returncode}, stderr {proc.stderr[-500:]}")
        print(f"multi-GPU: run --devices 2 on {torch.cuda.device_count()} GPU exits 2: "
              f"{proc.stderr.strip().splitlines()[-1]}", flush=True)
    else:
        check(proc.returncode == 0 and (out / "final.npz").is_file(),
              f"run --devices 2: rc {proc.returncode}, stderr {proc.stderr[-500:]}")
        print("multi-GPU: run --devices 2 wrote final.npz", flush=True)


def drive_multi_gpu(device, res: dict) -> dict:
    """Phase 11: (a) the NCCL world, (b) the D = 4 ranks on one card, the
    replicated and the staged treecode, (c) the CLI and the multi-device dry
    run, and kernel 7 at D = 1 against its earlier output. Returns the
    launches of (a) by kernel; (b)'s, (c)'s and the comparisons' are not
    counted."""
    t0 = time.perf_counter()
    world = nccl_world()
    saved = {k: w.launches for k, w in counters().items()}
    near_golden(device)
    res["near"]["at_524288_rank_of_4"] = ranks_on_one_card(device, res)
    res["near"]["at_1048576_staged_rank_of_4"] = staged_on_one_card(device, res)
    devices_cli(device)
    multichip_cli()
    for k, w in counters().items():
        w.launches = saved[k]
    print(f"multi-GPU: phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    return world["launched"]


# ------------------------------------------------------- 12. tools and examples
TUNE_LEGS = ("default", "rebuild32", "flat")   # in SWEEP order, as they run
CROSS_N = 65536
CENSUS_N = 8192
CENSUS_ROWS = 0.99   # rows with identical counts, card against CPU, where a tie flips
LONG_RUN = ("--solver", "treecode", "--integrator", "semi_implicit_euler", "--n", "65536",
            "--steps", "1000", "--check-every", "250")
LONG_RUN_DRIFT = 1e-4
_ENERGY = re.compile(r"\bE0?=(\S+)")


def census_card_vs_cpu(device) -> None:
    """Phase 12 (c): ``hier_census`` at 8,192 on the card and on the CPU:
    the integer fields equal, and every row's near and far counts, or (a
    float32 score that flips at its threshold) at least 99 % of rows."""
    import numpy as np

    from n_body_problem_tpu_torch import hier_census

    t0 = time.perf_counter()
    info, card = hier_census.row_counts(CENSUS_N, device=device)
    info_cpu, cpu = hier_census.row_counts(CENSUS_N, device="cpu")
    check(info == info_cpu, f"census: {info} on the card, {info_cpu} on the CPU")
    for union in (False, True):
        (near, far), (near_c, far_c) = card[union], cpu[union]
        same = (near == near_c) & np.all([a == b for a, b in zip(far, far_c)], axis=0)
        print(f"census [{CENSUS_N:,}, union_coarse={union}]: {int((~same).sum())} of "
              f"{len(same)} rows differ from the CPU's", flush=True)
        check(same.mean() >= CENSUS_ROWS, f"census: {int((~same).sum())} rows differ")
    recs, recs_cpu = hier_census.records(info, card), hier_census.records(info, cpu)
    ints = ("n", "src", "k_src", "union_coarse", "near_max", "far_max")
    check([[r[k] for k in ints] for r in recs] == [[r[k] for k in ints] for r in recs_cpu],
          f"census: integer fields {recs} on the card, {recs_cpu} on the CPU")
    for rec in recs:
        print(f"census: {json.dumps(rec)}", flush=True)
    print(f"census: card and CPU in {time.perf_counter() - t0:.1f} s; records "
          f"{'equal' if recs == recs_cpu else 'differ in a mean'}", flush=True)


def finite_energies(label: str, lines: list[str], count: int) -> list[float]:
    energies = [float(e) for line in lines for e in _ENERGY.findall(line)]
    check(len(energies) == count and all(math.isfinite(e) for e in energies),
          f"{label}: energies {energies}")
    return energies


def drive_phase12(device) -> dict:
    """Phase 12: ``tune_small_n`` (a sweep of three legs and the crossover at
    65,536), ``hier_census`` on the card against the CPU, ``dataset_sweep``,
    the four examples and a 1,000-step Euler treecode long run at 65,536,
    each tool in a subprocess that counts its launches. Returns the launches
    by kernel."""
    from n_body_problem_tpu_torch.bench import device_name

    t0 = time.perf_counter()
    out = TOOLS_DIR / "phase12"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    total: dict = {}

    def add(label: str, launched: dict, kernels: tuple[str, ...]) -> None:
        needs(label, launched, kernels)
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v

    # (f) and the ring example (mostly its world's start-up) beside (a)
    validate = start_tool("validate long", "n_body_problem_tpu_torch.validate", *LONG_RUN)
    ring = start_tool("example multichip_ring",
                      "n_body_problem_tpu_torch.examples.multichip_ring")
    lines, launched = run_tool("tune sweep", "n_body_problem_tpu_torch.tune_small_n",
                               "--mode", "sweep", "--legs", ",".join(TUNE_LEGS),
                               "--steps", "64")
    add("tune sweep", launched, ("near", "far", "far_single", "vip", "allpairs"))
    *legs, summary = [json.loads(line) for line in lines]
    check([r["leg"] for r in legs] == list(TUNE_LEGS), f"tune sweep: legs {legs}")
    for r in legs:
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in
                  ("ms_per_step", "pairs_per_sec", "force_err_p99", "force_err_median")),
              f"tune sweep: leg {r['leg']} {r}")
        check(r["force_err_p99"] < ERR_P99, f"tune sweep: {r['leg']} p99 {r['force_err_p99']}")
        print(f"tune [sweep, 20,480, 64 steps]: {r['leg']} {r['ms_per_step']:.4f} ms/step "
              f"vs_baseline {r['vs_baseline']:.4f} p99 {r['force_err_p99']:.3e}", flush=True)
    check(summary["best_leg"] in TUNE_LEGS and summary["device"] == device_name(device),
          f"tune sweep: summary {summary}")
    print(f"tune [sweep]: best leg {summary['best_leg']} ({summary['power_limit']})", flush=True)

    lines, launched = run_tool("tune crossover", "n_body_problem_tpu_torch.tune_small_n",
                               "--mode", "crossover", "--n", str(CROSS_N), "--steps", "64")
    add("tune crossover", launched, ("near", "far", "vip", "allpairs"))
    rec, summary = [json.loads(line) for line in lines]
    check(rec["leg"] == f"n{CROSS_N}" and math.isfinite(rec["vs_baseline"])
          and rec["force_err_p99"] < ERR_P99, f"tune crossover: {rec}")
    check(list(summary["vs_baseline_by_n"]) == [str(CROSS_N)], f"tune crossover: {summary}")
    print(f"tune [crossover, 65,536, 64 steps]: {rec['ms_per_step']:.4f} ms/step vs_baseline "
          f"{rec['vs_baseline']:.4f} p99 {rec['force_err_p99']:.3e}", flush=True)

    started = [
        start_tool("dataset_sweep", "n_body_problem_tpu_torch.dataset_sweep", "--steps", "20",
                   "--out", str(out / "dataset_sweep.json")),
        start_tool("example quickstart", "n_body_problem_tpu_torch.examples.quickstart"),
        start_tool("example galaxy_collision_movie",
                   "n_body_problem_tpu_torch.examples.galaxy_collision_movie",
                   str(out / "collision"), "--blocks", "2"),
        start_tool("example treecode_large_n",
                   "n_body_problem_tpu_torch.examples.treecode_large_n"),
    ]
    census_card_vs_cpu(device)
    (_, launched), (lines_q, launched_q), (lines_m, launched_m), (lines_t, launched_t) = (
        finish_tool(s) for s in started)

    add("dataset_sweep", launched, ("symmetric",))
    report = json.loads((out / "dataset_sweep.json").read_text())
    check(report["device"] == device_name(device), f"dataset_sweep: {report['device']}")
    for r in report["results"]:
        print(f"dataset_sweep: {json.dumps(r)}", flush=True)
    ok = {r["dataset"]: r for r in report["results"] if r["status"] == "ok"}
    check(all(i in ok and ok[i]["finite"] and math.isfinite(ok[i]["ms_per_step"])
              for i in (1, 2)), f"dataset_sweep: fallbacks of ids 1 and 2 {ok}")

    add("example quickstart", launched_q, ("symmetric",))
    finite_energies("example quickstart", lines_q, 6)
    add("example galaxy_collision_movie", launched_m, ("symmetric",))
    gif = out / "collision" / "movie.gif"
    check(lines_m[-1] == f"wrote {gif} (40 frames)" and gif.read_bytes()[:6] == b"GIF89a",
          f"example galaxy_collision_movie: {lines_m}")
    add("example treecode_large_n", launched_t, ("near", "far", "vip"))
    match = re.search(r"dE/E=(\S+)  overspeed=(\d+)$", lines_t[-1])
    check(bool(match) and math.isfinite(float(match[1])) and match[2] == "0",
          f"example treecode_large_n: {lines_t}")
    # its ranks are processes of their own, whose launches this count cannot
    # see (phase 11 (a) counts a world's launches rank by rank)
    lines_r, _ = finish_tool(ring)
    finite_energies("example multichip_ring", lines_r, 3)
    check(all(line.endswith("overspeed=0") for line in lines_r[-3:]),
          f"example multichip_ring: {lines_r}")
    for label, lines in (("quickstart", lines_q), ("galaxy_collision_movie", lines_m),
                         ("treecode_large_n", lines_t), ("multichip_ring", lines_r)):
        for line in lines:
            print(f"example [{label}]: {line}", flush=True)

    lines, launched = finish_tool(validate)
    add("validate long", launched, ("near", "far", "vip"))
    rep = json.loads(lines[-1])
    history = rep["history"]
    check(rep["max_abs_drift"] <= LONG_RUN_DRIFT
          and all(h["overspeed"] == 0 and math.isfinite(h["energy"]) for h in history)
          and rep["device"] == device_name(device) and rep["power_limit"],
          f"validate long: {rep}")
    print(f"validate [treecode Euler, 65,536, 1,000 steps]: max |dE/E| "
          f"{rep['max_abs_drift']:.3e}, drift at " + ", ".join(
              f"{h['step']} {h['rel_energy_drift']:+.3e}" for h in history)
          + f"; momentum err {rep['momentum_err_final']:.3e}; overspeed 0; "
          f"{rep['wall_seconds']:.1f} s; {rep['device']}, {rep['power_limit']}", flush=True)
    print(f"tools and examples: phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# ------------------------------------------------- phase 13: CUDA graphs
GRAPH_REM = 3   # steps of the remainder chunk after two whole chunks


def graph_runs():
    """(label, N, config) of phase 13: every single-device path."""
    from n_body_problem_tpu_torch import SimConfig
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    tree = dict(solver="treecode")
    return (
        ("hier 65,536 euler", 65536, SimConfig(**tree)),
        ("hier 65,536 leapfrog", 65536, SimConfig(integrator="leapfrog", **tree)),
        ("hier 20,480 tuned", 20480, SimConfig(**tree, **tuned_tree_overrides(20480))),
        ("hier 524,288", 524288, SimConfig(**tree)),
        ("hier 1,048,576", 1048576, SimConfig(**tree)),
        ("flat 20,480", 20480, SimConfig(tree_hier=False, **tree)),
        ("flat 65,536", 65536, SimConfig(tree_hier=False, **tree)),
        ("dense 1,024", 1024, SimConfig(tree_flat_cap=-1, **tree)),
        ("dense 20,480", 20480, SimConfig(tree_flat_cap=-1, **tree)),
        ("auto 4,096", 4096, SimConfig()),
        ("auto 65,536", 65536, SimConfig()),
        ("pallas 65,536", 65536, SimConfig(solver="pallas")),
    )


def idle_share(fn) -> float:
    """The device's idle share of the wall time of ``fn()`` (a
    ``torch.profiler`` trace; ``treecode_profile``'s measure)."""
    from n_body_problem_tpu_torch.treecode_profile import _busy_us, _device_events, _trace

    events, wall_us = _trace(fn)
    gpu = _device_events(events)
    check(bool(gpu), "profiler: the trace holds no device activity")
    return 1.0 - _busy_us(gpu) / wall_us


def exact_launches_a_step(sim) -> dict:
    """Kernel launches an exact step makes, by wrapper."""
    from n_body_problem_tpu_torch.ops.cuda_force import allpairs_split
    from n_body_problem_tpu_torch.ops.cuda_symmetric import LAUNCHES_A_CALL

    if sim.solver == "pallas":
        return {"allpairs": 2 if allpairs_split(sim.state.n, sim.state.n)[2] > 1 else 1}
    key = "symmetric" if sim.cfg.pallas_sym_precision == "f32" else "symmetric_bf16x3"
    return {key: LAUNCHES_A_CALL}


def drive_graphs(device, runs=None, smi: str = "") -> dict:
    """Phase 13: ``Simulation.run`` through its CUDA graphs beside the eager
    loop (``make_treecode_run``, ``run_steps``) on the same state, for two
    whole chunks and a remainder. Checks: positions and ``sort_perm``
    bitwise the eager loop's; no host sync in the replays; the launches a
    step ``launches_a_step``, replays counted. Prints ms/step of both (eager, graph, graph, eager),
    capture seconds, idle share of each from ``torch.profiler`` and the peak
    memory of each (the graphs' in their first run, the capture's).
    Returns the launches of the graph runs (the eager reference's are not
    counted)."""
    import torch

    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.graphs import clone_state
    from n_body_problem_tpu_torch.ops.registry import tree_path
    from n_body_problem_tpu_torch.simulation import make_step_fn, make_treecode_run, run_steps

    t_phase = time.perf_counter()
    wrappers = counters()
    start = {k: w.launches for k, w in wrappers.items()}
    eager_launches = dict.fromkeys(wrappers, 0)   # the reference's: not counted
    records = []
    for label, n, cfg in runs or graph_runs():
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        tree = sim.solver == "treecode"
        r = sim.cfg.tree_rebuild_every if tree else 8
        steps = 2 * r + GRAPH_REM
        s0, perm0 = clone_state(sim.state), sim.sort_perm
        ref = (make_treecode_run(sim.cfg) if tree else
               lambda st, k, f=make_step_fn(sim.cfg, "cuda", sim.state.n):
               (run_steps(st, f, k), None, None))

        def eager(state, k=steps):
            before = {key: w.launches for key, w in wrappers.items()}
            out = ref(state, k)
            torch.cuda.synchronize(device)
            for key, w in wrappers.items():
                eager_launches[key] += w.launches - before[key]
            return out
        # the eager reference, then the graphs' first run (the capture)
        torch.cuda.reset_peak_memory_stats(device)
        state_e, ids_e, _ = eager(clone_state(s0))
        peak_e = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        sim.run(steps)
        peak_g = torch.cuda.max_memory_allocated(device)
        got = sim.state
        same = all(torch.equal(getattr(got, k), getattr(state_e, k))
                   for k in ("pos", "vel", "acc", "time", "step"))
        check(same, f"graphs [{label}]: state not bitwise the eager loop's")
        if tree:
            want = ids_e[: sim.state.n_real].cpu().numpy()
            check((sim.sort_perm == (want if perm0 is None else perm0[want])).all(),
                  f"graphs [{label}]: sort_perm differs from the eager loop's")
        # no host sync in a replay; the launches a step, replays counted
        g, programs = sim._prepare(tree, steps)
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.set_sync_debug_mode("error")
        try:
            if tree:
                sim._chunks(programs, steps)
            else:
                g.repeat(programs[0], steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        moved = {k: w.launches - before[k] for k, w in wrappers.items()}
        if tree:
            sim._unload_tree(steps)
            a_step = launches_a_step(sim.cfg, sim.state.n)
        else:
            sim.state = g.unload()
            a_step = exact_launches_a_step(sim)
        torch.cuda.synchronize(device)
        want = {k: a_step.get(k, 0) * steps for k in wrappers}
        check(moved == want, f"graphs [{label}]: launches {moved}, expected {want}")
        # times: eager, graph, graph, eager over the same number of steps
        state = clone_state(sim.state)
        ms = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            t0 = time.perf_counter()
            if kind == "eager":
                state = eager(state)[0]
            else:
                sim.run(steps)
            ms[kind].append((time.perf_counter() - t0) / steps * 1e3)
        idle = {"eager": idle_share(lambda: eager(clone_state(sim.state))),
                "graph": idle_share(lambda: sim.run(steps))}
        check(bool(torch.isfinite(sim.state.pos).all()), f"graphs [{label}]: non-finite")
        rec = {"label": label, "n": sim.state.n_real,
               "path": tree_path(sim.cfg) if tree else sim.solver,
               "steps": steps, "bitwise": same, "eager_ms": ms["eager"], "graph_ms": ms["graph"],
               "capture_s": sim.capture_seconds,
               "launches_a_step": {k: v for k, v in a_step.items() if v},
               "idle_eager": idle["eager"], "idle_graph": idle["graph"],
               "peak_gib_eager": peak_e / 2**30, "peak_gib_graph": peak_g / 2**30}
        records.append(rec)
        print(f"graphs [{label}]: N={rec['n']} path={rec['path']} {steps} steps; bitwise "
              f"{same}; ms/step eager {ms['eager'][0]:.4f} {ms['eager'][1]:.4f} graph "
              f"{ms['graph'][0]:.4f} {ms['graph'][1]:.4f}; capture {sim.capture_seconds:.3f} s; "
              f"launches a step {rec['launches_a_step']}; idle eager {idle['eager']:.4f} graph "
              f"{idle['graph']:.4f}; peak GiB eager {rec['peak_gib_eager']:.3f} graph "
              f"{rec['peak_gib_graph']:.3f}", flush=True)
        del sim, state, state_e, s0
        torch.cuda.empty_cache()
    out = ROOT / "out" / "chip_smoke_graphs.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(f"graphs: phase 13 in {time.perf_counter() - t_phase:.1f} s on {smi} -> {out}",
          flush=True)
    return {k: w.launches - start[k] - eager_launches[k] for k, w in wrappers.items()}


def frame_runs():
    """(label, kind, N, config) of phase 13's frame rows: the hierarchical
    treecode at 65,536 (each frame its own chunk: a resort, a build and a
    step) and the exact 65,536 (the all-pairs kernel, and the default
    solver's symmetric kernel, the bench's render leg), a frame every
    step."""
    from n_body_problem_tpu_torch import SimConfig

    return (("movie hier 65,536", "movie", 65536, SimConfig(solver="treecode")),
            ("trajectory hier 65,536", "trajectory", 65536, SimConfig(solver="treecode")),
            ("movie pallas 65,536", "movie", 65536, SimConfig(solver="pallas")),
            ("trajectory pallas 65,536", "trajectory", 65536, SimConfig(solver="pallas")),
            ("movie auto 65,536", "movie", 65536, SimConfig()))


FRAME_STEPS = 19   # a frame every step, as phase 13's runs: two chunks of 8 and 3


def drive_frame_graphs(device, runs=None, smi: str = "") -> dict:
    """Phase 13's frame rows: ``Simulation.movie`` (1024x1024) and
    ``trajectory``, a frame every step, through the frame graph beside
    their eager frame loop (``simulation.eager_movie``, ``eager_trajectory``)
    from the same state. Checks: the frames, the state and ``sort_perm``
    bitwise the eager loop's, and the last frame of the movie bitwise the
    eager splat of its final state; no host sync in the replays of the spans
    and the frames;
    launches a step as ``launches_a_step``, replays counted; a second
    camera and scale replay the same graphs (no new capture) and match
    their eager movie. Prints ms/step of both in turns (eager, replayed,
    replayed, eager), capture seconds, the idle share and the peak memory
    of each. Returns the replays' launches (the eager loop's are not
    counted)."""
    import torch

    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.ops.registry import tree_path
    from n_body_problem_tpu_torch.render import OrbitCamera
    from n_body_problem_tpu_torch.simulation import (eager_movie, eager_trajectory,
                                                     frame_inputs, movie_frame)

    t_phase = time.perf_counter()
    wrappers = counters()
    start = {k: w.launches for k, w in wrappers.items()}
    uncounted = dict.fromkeys(wrappers, 0)
    cams = ((OrbitCamera(distance=2.0), (0.0, 0.0, 0.0)),
            (OrbitCamera(theta_deg=35.0, phi_deg=20.0, distance=2.5), (0.5, 0.5, 0.5)))
    kw = dict(width=RENDER_W, height=RENDER_H)
    records = []
    for label, kind, n, cfg in runs or frame_runs():
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        steps = FRAME_STEPS

        def call(k=steps, cam=cams[0]):
            if kind == "movie":
                return sim.movie(k, 1, cam[0], cam[1], **kw)
            return sim.trajectory(k, save_every=1)

        def eager(k=steps, cam=cams[0]):
            before = {key: w.launches for key, w in wrappers.items()}
            out = (eager_movie(sim, k, 1, cam[0], cam[1], **kw) if kind == "movie"
                   else eager_trajectory(sim, k, save_every=1))
            torch.cuda.synchronize(device)
            for key, w in wrappers.items():
                uncounted[key] += w.launches - before[key]
            return out

        def same_as(got, want, what: str) -> bool:
            frames, state, perm = want
            same = (torch.equal(got, frames)
                    and all(torch.equal(getattr(sim.state, k), getattr(state, k))
                            for k in ("pos", "vel", "acc", "time", "step"))
                    and (perm is None or bool((sim.sort_perm == perm).all())))
            check(same, f"graphs [{label}] {what}: frames or state not bitwise the eager "
                        f"frame loop's")
            return same

        torch.cuda.reset_peak_memory_stats(device)
        want = eager()
        peak_e = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        got = call()
        peak_g = torch.cuda.max_memory_allocated(device)
        if kind == "movie":
            frames_ok(label, got, steps, RENDER_H, RENDER_W)
        else:
            check(tuple(got.shape) == (steps, sim.state.n, 3) and bool(torch.isfinite(got).all()),
                  f"graphs [{label}]: trajectory {tuple(got.shape)}")
        bitwise = same_as(got, want, "first call")
        del want, got
        # the frame program against the eager splat of the same state
        if kind == "movie":
            got = call()
            out = torch.empty_like(got[-1])
            movie_frame(out, sim.state, None,
                        **frame_inputs(sim.state, cams[0][0].view_projection(), cams[0][1]), **kw)
            check(torch.equal(out, got[-1]),
                  f"graphs [{label}]: the frame graph is not bitwise the eager splat")
            del got, out
        # no host sync in the replays; the launches a step, replays counted
        chunked = sim._chunked()
        key = f"movie {RENDER_W}x{RENDER_H}" if kind == "movie" else "trajectory"
        g, programs = sim._prepare(chunked, steps)
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.set_sync_debug_mode("error")
        try:
            frames = sim._replay_frames(programs, g._programs[key], key, steps, 1, "every")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        moved = {k: w.launches - before[k] for k, w in wrappers.items()}
        if chunked:
            sim._unload_tree(steps)
            a_step = launches_a_step(sim.cfg, sim.state.n)
        else:
            sim.state = g.unload()
            a_step = exact_launches_a_step(sim)
        torch.cuda.synchronize(device)
        del frames
        check(moved == {k: a_step.get(k, 0) * steps for k in wrappers},
              f"graphs [{label}]: launches {moved}, expected {a_step} a step")
        # a second camera and scale: the same graphs, no new capture
        capture_s, programs_n = sim.capture_seconds, len(g._programs)
        if kind == "movie":
            want = eager(cam=cams[1])
            same_as(call(cam=cams[1]), want, "second camera")
            check(sim.capture_seconds == capture_s and len(g._programs) == programs_n,
                  f"graphs [{label}]: a second camera captured again")
            del want
        # times: eager, replayed, replayed, eager; then the idle share of each
        ms = {"eager": [], "graph": []}
        for which in ("eager", "graph", "graph", "eager"):
            t0 = time.perf_counter()
            (eager if which == "eager" else call)(FRAME_STEPS)
            torch.cuda.synchronize(device)
            ms[which].append((time.perf_counter() - t0) / FRAME_STEPS * 1e3)
        idle = {"eager": idle_share(lambda: eager(FRAME_STEPS)),
                "graph": idle_share(lambda: call(FRAME_STEPS))}
        check(bool(torch.isfinite(sim.state.pos).all()), f"graphs [{label}]: non-finite")
        rec = {"label": label, "kind": kind, "n": sim.state.n_real,
               "path": tree_path(sim.cfg) if sim.solver == "treecode" else sim.solver,
               "steps": FRAME_STEPS, "bitwise": bitwise, "eager_ms": ms["eager"],
               "graph_ms": ms["graph"], "capture_s": capture_s,
               "launches_a_step": {k: v for k, v in a_step.items() if v},
               "idle_eager": idle["eager"], "idle_graph": idle["graph"],
               "peak_gib_eager": peak_e / 2**30, "peak_gib_graph": peak_g / 2**30}
        records.append(rec)
        movie = (f"{RENDER_W}x{RENDER_H}; frame graph bitwise the eager splat; a second "
                 f"camera replayed without a capture" if kind == "movie" else "positions")
        print(f"graphs [{label}]: N={rec['n']} path={rec['path']} a frame every step "
              f"({movie}); bitwise the eager frames {bitwise}; no host sync in replays; ms/step "
              f"eager {ms['eager'][0]:.4f} {ms['eager'][1]:.4f} replayed {ms['graph'][0]:.4f} "
              f"{ms['graph'][1]:.4f} ({FRAME_STEPS} steps); capture {capture_s:.3f} s; "
              f"launches a step {rec['launches_a_step']}; idle eager {idle['eager']:.4f} "
              f"replayed {idle['graph']:.4f}; peak GiB eager {rec['peak_gib_eager']:.3f} "
              f"replayed {rec['peak_gib_graph']:.3f}", flush=True)
        del sim
        torch.cuda.empty_cache()
    out = ROOT / "out" / "chip_smoke_frame_graphs.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(f"graphs: phase 13's frame rows in {time.perf_counter() - t_phase:.1f} s on {smi} "
          f"-> {out}", flush=True)
    return {k: w.launches - start[k] - uncounted[k] for k, w in wrappers.items()}


# ------------------------------------------------- phase 14: the last gaps
FREE_N, FREE_CPU_N = 65536, 4096   # the free functions on the card; against the CPU
FREE_STEPS, FREE_EVERY = 8, 2
MORTON_N = 524288
DECOMPOSE_SIZES = "20480t,65536"


def drive_free_functions(device) -> dict:
    """Phase 14 (a): ``simulation.run_trajectory`` and ``run_with_frames``
    (1024x1024) with ``make_step_fn(SimConfig(solver="pallas"), "cuda", n)``
    (the all-pairs kernel): at 65,536 bitwise their eager loop
    (``run_frames`` of ``run_steps``, the frame recorded eagerly) from the
    same state, frames and state; each whole call under
    ``set_sync_debug_mode("error")``; the kernel launched once a step,
    replays counted, and no other kernel; at 4,096 the card's frames after
    one span of 2 steps within rtol 1e-5 / atol 1e-5 x max of the CPU's
    (8 steps read 2.2e-5 of a 2.53 maximum: the kernel and its twin sum in
    other orders, and the bodies drift apart). Returns the calls' launches on
    the card (the eager loop's are not counted)."""
    import functools

    import torch

    from n_body_problem_tpu_torch import SimConfig, make_step_fn, models
    from n_body_problem_tpu_torch.graphs import clone_state
    from n_body_problem_tpu_torch.render import OrbitCamera
    from n_body_problem_tpu_torch.simulation import (frame_inputs, movie_frame, run_frames,
                                                     run_steps, run_trajectory,
                                                     run_with_frames, trajectory_frame)

    cfg = SimConfig(solver="pallas")
    cam, scale = OrbitCamera(distance=2.0), (0.5, 0.5, 0.5)
    wrappers = counters()
    start = {k: w.launches for k, w in wrappers.items()}

    def free(kind: str, state, step_fn, camera: dict, steps: int = FREE_STEPS):
        if kind == "trajectory":
            return run_trajectory(state, step_fn, steps, FREE_EVERY)
        return run_with_frames(state, step_fn, steps, FREE_EVERY, camera["view_projection"],
                               camera["scale_factors"], RENDER_W, RENDER_H)

    def eager(kind: str, state, step_fn):
        before = {k: w.launches for k, w in wrappers.items()}
        if kind == "trajectory":
            shape, record, inputs = (state.n, 3), trajectory_frame, {}
        else:
            shape = (RENDER_H, RENDER_W, 3)
            record = functools.partial(movie_frame, width=RENDER_W, height=RENDER_H)
            inputs = frame_inputs(state, cam.view_projection(), scale)
        out = run_frames(clone_state(state), lambda s, k: run_steps(s, step_fn, k), FREE_STEPS,
                         FREE_EVERY, "every", shape, lambda f, s: record(f, s, None, **inputs))
        torch.cuda.synchronize(device)
        for k, w in wrappers.items():
            start[k] += w.launches - before[k]
        return out

    state = models.plummer(FREE_N, seed=0).to(device)
    step_fn = make_step_fn(cfg, "cuda", state.n)
    frames_n = FREE_STEPS // FREE_EVERY
    camera = frame_inputs(state, cam.view_projection(), scale)   # on the card before the call
    for kind in ("trajectory", "movie"):
        want_state, want = eager(kind, state, step_fn)
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_state, got = free(kind, state, step_fn, camera)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(device)
        call_s = time.perf_counter() - t0
        moved = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches != before[k]}
        check(moved == {"allpairs": FREE_STEPS},
              f"free [{kind}]: launches {moved}, expected the all-pairs kernel {FREE_STEPS} times")
        frame = (state.n, 3) if kind == "trajectory" else (RENDER_H, RENDER_W, 3)
        check(tuple(got.shape) == (frames_n, *frame) and bool(torch.isfinite(got).all()),
              f"free [{kind}]: frames {tuple(got.shape)}, expected {(frames_n, *frame)}, finite")
        same = torch.equal(got, want) and all(
            torch.equal(getattr(got_state, k), getattr(want_state, k))
            for k in ("pos", "vel", "acc", "time", "step"))
        check(same, f"free [{kind}]: frames or state not bitwise the eager loop's")
        check(int(got_state.step) == int(state.step) + FREE_STEPS
              and (kind == "movie" or torch.equal(got[-1], got_state.pos)),
              f"free [{kind}]: the step count or the last frame is off")
        print(f"free [{kind}]: run_{'trajectory' if kind == 'trajectory' else 'with_frames'} "
              f"N={state.n} pallas, {FREE_STEPS} steps, a frame every {FREE_EVERY} "
              f"{tuple(got.shape)}: bitwise the eager loop, no host sync in the call "
              f"(capture included), launches {moved}, call {call_s:.3f} s", flush=True)
        del got, want, got_state, want_state
    # the card's frames against the CPU's, after one span (the kernel and
    # its plain twin sum in other orders, so the bodies drift apart)
    small = models.plummer(FREE_CPU_N, seed=1)
    for kind in ("trajectory", "movie"):
        on_card = free(kind, small.to(device), make_step_fn(cfg, "cuda", small.n),
                       camera, FREE_EVERY)[1].cpu()
        on_cpu = free(kind, small, make_step_fn(cfg, "cpu", small.n),
                      frame_inputs(small, cam.view_projection(), scale), FREE_EVERY)[1]
        peak = float(on_cpu.abs().max())
        err = float((on_card - on_cpu).abs().max())
        check(peak > 0 and torch.allclose(on_card, on_cpu, rtol=RENDER_TOL, atol=RENDER_TOL * peak),
              f"free [{kind}] {FREE_CPU_N}: card vs CPU max |d| {err:.3e} (max {peak:.3e})")
        print(f"free [{kind}] N={FREE_CPU_N}, {FREE_EVERY} steps: card vs CPU max |d| "
              f"{err:.3e} of max {peak:.4e} (rtol 1e-5, atol 1e-5 x max)", flush=True)
    return {k: w.launches - start[k] for k, w in wrappers.items()}


def drive_last_gaps(device) -> dict:
    """Phase 14: (a) the free functions (``drive_free_functions``); (b)
    ``utils.morton.morton_keys_device`` on 524,288 Plummer bodies (all real,
    and the last 1,000 as padding) on the card, equal to the CPU's keys;
    (c) ``treecode_profile --decompose 20480t,65536`` in a subprocess that
    counts its launches: one JSON line a size with the legs of
    ``tools/decompose_step.py`` (each finite and positive), the split, and
    the card's name and power limit; it must launch the near, far and VIP
    kernels. Returns the launches of (a) and (c)."""
    import torch

    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.utils.morton import morton_keys_device

    t0 = time.perf_counter()
    launched = drive_free_functions(device)
    pos = models.plummer(MORTON_N, seed=0).pos
    for n_real in (MORTON_N, MORTON_N - 1000):
        card = morton_keys_device(pos.to(device), n_real).cpu()
        check(card.dtype == torch.int32 and torch.equal(card, morton_keys_device(pos, n_real)),
              f"morton_keys_device at {MORTON_N} ({n_real} real): card != CPU")
    print(f"morton_keys_device: N={MORTON_N} (all real, and {MORTON_N - 1000} real) card "
          f"keys equal the CPU's", flush=True)
    out = ROOT / "out" / "chip_smoke_decompose.json"
    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    lines, tool = run_tool("decompose", "n_body_problem_tpu_torch.treecode_profile",
                           "--sizes", "", "--decompose", DECOMPOSE_SIZES, "--json", str(out))
    needs("decompose", tool, ("near", "far", "vip"))
    rows = [json.loads(line) for line in lines if line.startswith('{"size"')]
    check([r["size"] for r in rows] == DECOMPOSE_SIZES.split(","),
          f"decompose: sizes {[r['size'] for r in rows]}")
    for r in rows:
        legs = ("floor", "force", "force_euler", "resort", "build", "full_step")
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in legs) and r["nvidia_smi"],
              f"decompose [{r['size']}]: legs {[r[k] for k in legs]}")
        print(f"decompose [{r['size']}]: " + " ".join(
            f"{k} {r[k]:.4f}" for k in (*legs, "integrator_ms", "amortized_rebuild_ms",
                                        "glue_ms")) + " | busy " + " ".join(
            f"{k} {v:.4f}" for k, v in r["busy_ms"].items()), flush=True)
    for k, v in tool.items():
        launched[k] = launched.get(k, 0) + v
    print(f"last gaps: phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    from n_body_problem_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | tf32 off", flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    log = (cuda_build.library_path().parent / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas| {line.strip()}")
    print(f"build: {build_s:.3f} s -> {cuda_build.library_path()}", flush=True)

    res = compare_kernels(device)
    compare_allpairs_splits(device, res)
    fast = compare_fast(device)
    print(f"kernels: symmetric at N={N_MAIN}: f32 {res['symmetric']['ms']:.4f} ms, bf16x3 "
          f"{fast['bf16x3']['ms']:.4f}, mixed {fast['mixed']['ms']:.4f}", flush=True)
    res["symmetric_bf16x3"] = {
        "max_abs_err": fast["max_abs_err"], "library_ms": None,
        **{k: fast["bf16x3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "issue_floor_ms")},
        **{f"{k}_mixed": fast["mixed"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                    "issue_floor_ms")}}
    res.update(compare_tree_kernels(device))
    res["min_dist"] = compare_min_dist(device)
    res["min_dist_open"] = compare_min_dist_open(device)
    res["top_k"] = compare_top_k(device)

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    main_ms = drive_main_path(device)
    launches = {k: wrappers[k].launches for k in ("allpairs", "symmetric", "symmetric_bf16x3")}
    drive_pair_matrix(device)
    drive_repeat(device)
    for key in ("symmetric", "symmetric_bf16x3"):
        launches[key] = wrappers[key].launches
    for w in wrappers.values():
        w.launches = 0
    launches.update(drive_treecode(device))
    for key, count in launches.items():
        check(count > 0, f"main path never launched the {key} kernel")
    energy_check(device)
    run_cli(ROOT / "out" / "chip_smoke_cli")
    run_cli(ROOT / "out" / "chip_smoke_cli_tree",
            extra=("--solver", "treecode", "--tree-tuned"))
    t0 = time.perf_counter()
    for key, count in drive_tools().items():
        launches[key] = launches.get(key, 0) + count
    print(f"tools: {time.perf_counter() - t0:.1f} s", flush=True)
    for w in wrappers.values():
        w.launches = 0
    rendered = drive_render(device, main_ms["default"])
    for key, w in wrappers.items():
        launches[key] = launches.get(key, 0) + w.launches + rendered.get(key, 0)
    for key, count in drive_multi_gpu(device, res).items():
        launches[key] = launches.get(key, 0) + count
    for key, count in drive_phase12(device).items():
        launches[key] = launches.get(key, 0) + count
    graphed = drive_graphs(device, smi=smi)
    for key in ("allpairs", "symmetric") + TREE_KERNELS:
        check(graphed[key] > 0, f"phase 13 never replayed the {key} kernel")
    framed = drive_frame_graphs(device, smi=smi)
    for key in ("allpairs", "symmetric", "near", "far", "vip"):
        check(framed[key] > 0, f"phase 13's frame rows never replayed the {key} kernel")
    for key, count in framed.items():
        graphed[key] += count
    for key, count in graphed.items():
        launches[key] = launches.get(key, 0) + count
    for key, count in drive_last_gaps(device).items():
        launches[key] = launches.get(key, 0) + count

    records = (
        ("allpairs", "allpairs_acc_kernel", "allpairs.cu", "pallas_force.py:41"),
        ("symmetric", "symmetric_acc_kernel+symmetric_sum_kernel", "symmetric.cu",
         "pallas_symmetric.py:87"),
        ("symmetric_bf16x3", "symmetric_bf16x3_kernel+symmetric_sum_kernel",
         "symmetric_bf16x3.cu", "pallas_symmetric.py:87"),
        ("far_single", "far_single_kernel", "far_single.cu", "treecode.py:436"),
        ("gather", "gather_panels_kernel", "gather.cu", "treecode.py:617"),
        ("near_panel", "near_panel_kernel", "near_panel.cu", "treecode.py:718"),
        ("vip", "vip_both_kernel+vip_sum_kernel", "vip.cu", "treecode.py:805"),
        ("near", "near_field_kernel", "near.cu", "treecode.py:1286"),
        ("far", "far_field_kernel", "far_hier.cu", "treecode.py:2164"),
        ("min_dist", "min_tile_dist_kernel", "min_dist.cu",
         "none: XLA fused the JAX package's plain _min_tile_dist (treecode.py:163)"),
        ("min_dist_open", "min_dist_open_kernel", "min_dist.cu",
         "none: XLA fused the JAX package's plain _min_tile_dist and opening test "
         "(treecode.py:163, :1914)"),
        ("top_k", "top_k_kernel", "top_k.cu",
         "none: the JAX package leaves its lax.top_k (treecode.py:341, :1157) to XLA"),
    )
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"n_body_problem_tpu_torch/csrc/{src}",
         "replaces": tpu if tpu.startswith("none") else f"n_body_problem_tpu/ops/{tpu}",
         "launches": launches[key], **res[key]}
        for key, name, src, tpu in records]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
