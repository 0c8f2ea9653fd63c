"""The yardstick's arithmetic on hand-made inputs: operation counts of the
rooflines, the sample, the trace's busy union, idle gaps and labels, and the
comparison's verdict."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nbody_bench import judge, peaks, spec
from nbody_bench.trace import Trace


def test_pair_counts():
    assert peaks.symmetric_flops(4) == 27 * 6
    # 65,536 bodies: 0.8654 ms at the FP32 peak, the kernel table's bound.
    assert peaks.symmetric_flops(65536) / peaks.PEAK_FP32 * 1e3 == pytest.approx(0.8654, abs=1e-4)


def test_near_pairs_of_a_small_list():
    # n = 512, target rows of 128 (4 rows), source tiles of 64 (8 tiles,
    # sentinel 8), 2 entries a chunk; chunk 3 is unused (target sentinel 4).
    flat_src = torch.tensor([0, 1, 2, 8, 5, 8, 7, 7])
    chunk_tgt = torch.tensor([0, 1, 3, 4])
    assert peaks.near_pairs(flat_src, chunk_tgt, 512, 128, 64) == 4 * 64 * 128


def test_far_terms_and_the_level_plan():
    assert peaks.level_nodes(64) == 64 + 32 + 16
    assert peaks.level_nodes(48) == 48 + 24
    sentinel = peaks.level_nodes(64)                  # n = 4,096, src tile 64
    far_src = torch.tensor([3, sentinel, 70, 100, 5, 6])
    far_tgt = torch.tensor([0, 2, 32])                # 32 = 4096 // 128, unused
    assert peaks.far_terms(far_src, far_tgt, 4096, 128, 64) == 3 * 128


def test_tree_flops_adds_the_vip_sweep():
    lists = (torch.tensor([0, 1]), torch.tensor([0]), torch.tensor([112, 112]),
             torch.tensor([4]), torch.tensor([True] * 64 + [False] * 448))
    # n 512: one chunk of two live near entries, no live far entry, 64 VIP bodies
    want = 20 * 2 * 64 * 128 + 27 * 512 * 64
    assert peaks.tree_flops(lists, 512, 128, 64) == want


def test_sample_slots_stride_and_offset():
    rng = np.random.default_rng(1)
    s = judge.sample_slots(1000, 100, rng)
    assert len(s) == 100 and np.all(np.diff(s) == 10) and 0 <= s[0] < 10 and s[-1] < 1000
    assert len(judge.sample_slots(50, 100, rng)) == 50


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_busy_union_idle_share_and_labels():
    events = [
        _ev("user_annotation", "treecode.build", 0, 10),
        _ev("user_annotation", "bench.run", 0, 100),
        _ev("cuda_runtime", "cudaGraphLaunch", 2, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _ev("cuda_runtime", "cudaStreamSynchronize", 30, 60),
        _ev("kernel", "k_a", 10, 20, corr=1),
        _ev("kernel", "near_field_kernel", 25, 15, corr=2),    # overlaps k_a
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 10),
    ]
    tr = Trace(events, wall_us=100.0)
    assert tr.busy_us() == 30 + 10                   # [10, 40] and [60, 70]
    assert tr.idle_gaps() == [(40, 20)]
    assert tr.launches == 2
    labels = {o[2]: o[4] for o in tr.device}
    assert labels == {"k_a": "treecode.build", "near_field_kernel": "bench.run",
                      "Memcpy DtoH": None}
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["cudaStreamSynchronize", 20 / 1e6]]
    assert bd["device_ops"][0] == ["k_a", 20 / 1e6]
    reader = spec._module(spec.ROOT / "nbody_bench/metrics/device_idle_pct.py")
    assert reader.read(tr, None) == pytest.approx(60.0)


def test_verdict_counts_calls_over_their_limits():
    checks, failed = judge.verdict(
        [{"force_p99": 1e-6, "dx_p90": 0.01}, {"force_p99": 3e-6, "dx_p90": float("nan")},
         {"force_p99": 2e-6, "dx_p90": 0.02}], {"force_p99": 2.5e-6, "dx_p90": 0.05})
    assert failed == 1
    assert checks["force_p99"] == {"value": 3e-6, "limit": 2.5e-6}
    assert np.isnan(checks["dx_p90"]["value"])
