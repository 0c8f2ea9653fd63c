"""``kernel_compare``'s arithmetic on the CPU: the bounds, the pair counts of
the fast symmetric modes, the block cases' inputs' shapes, and the SASS
reader that counts the instructions a pair of a kernel's inner loops. The
timings themselves need the card."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import pytest
import torch

from n_body_problem_tpu_torch import kernel_compare as kc
from n_body_problem_tpu_torch.ops import cuda_build
from n_body_problem_tpu_torch.ops.cuda_symmetric import near_diagonals

LISTING = """
	code for sm_90a
		Function : _ZN3foo19allpairs_acc_kernelILi8EEEvPKf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe20000000800 */
        /*0010*/                   MUFU.RCP R9, R9 ;                       /* 0x0 */
        /*0020*/                   LDS.128 R4, [R2] ;                      /* 0x0 */
        /*0030*/                   FFMA R1, R2, R3, R4 ;                   /* 0x0 */
        /*0040*/                   MUFU.RSQ R5, R1 ;                       /* 0x0 */
        /*0050*/                   FMUL R6, R5, R5 ;                       /* 0x0 */
        /*0060*/                   MUFU.RSQ R7, R1 ;                       /* 0x0 */
        /*0070*/              @!P0 BRA 0x20 ;                              /* 0x0 */
        /*0080*/                   IADD3 R8, R8, 0x1, RZ ;                 /* 0x0 */
        /*0090*/               @P1 BRA 0x10 ;                              /* 0x0 */
        /*00a0*/                   STS [R2], R4 ;                          /* 0x0 */
        /*00b0*/                   BRA 0xb0 ;                              /* 0x0 */
		Function : _ZN3bar12other_kernelEv
        /*0000*/                   MUFU.RSQ R5, R1 ;                       /* 0x0 */
        /*0010*/                   BRA 0x0 ;                               /* 0x0 */
"""


def test_sass_reader_counts_the_innermost_pair_loop():
    fns = kc.sass_functions(LISTING)
    assert list(fns) == ["_ZN3foo19allpairs_acc_kernelILi8EEEvPKf", "_ZN3bar12other_kernelEv"]
    instrs = fns["_ZN3foo19allpairs_acc_kernelILi8EEEvPKf"]
    assert instrs[0] == (0, "LDC R1, c[0x0][0x28]") and len(instrs) == 12
    # Three backward branches: the inner loop 0x20..0x70 (two rsqrts), the
    # outer one around it (not innermost) and the idle loop at the end (no
    # pair): only the first is counted.
    (loop,) = kc.sass_pair_loops(instrs)
    assert loop["instructions"] == 6 and loop["pairs"] == 2 and loop["a_pair"] == 3.0
    assert loop["by_opcode"] == {"MUFU": 2, "LDS": 1, "FFMA": 1, "FMUL": 1, "BRA": 1}
    assert kc.sass_pair_loops(fns["_ZN3bar12other_kernelEv"])[0]["a_pair"] == 2.0
    assert kc.sass_pair_loops([(0, "EXIT")]) == []


def test_counted_kernels_are_sources_of_the_build():
    names = {p.name for p in cuda_build.sources()}
    assert set(kc.COUNTED) <= names
    for src, kernel in kc.COUNTED.items():
        assert kernel in (cuda_build.CSRC_DIR / src).read_text()


@pytest.mark.parametrize("precision", ["bf16x3", "mixed"])
@pytest.mark.parametrize("n,tile", [(512, 64), (448, 64), (1024, 512), (65536, 512)])
def test_fast_pairs_split_every_pair_once(n, tile, precision):
    """The f32 diagonals' pairs and the panel product's add up to N(N-1)/2;
    "bf16x3" has no f32 diagonal, "mixed" has diagonals 0 and 1 (all of them
    with K <= 3 tiles)."""
    near, fast = kc.fast_pairs(n, tile, precision)
    k = n // tile
    assert near + fast == n * (n - 1) // 2 and near >= 0 and fast >= 0
    if precision == "bf16x3":
        assert near == 0
    elif k <= 3:
        assert fast == 0 and near_diagonals(k, precision) == k // 2
    else:
        assert near == k * tile * (tile - 1) // 2 + k * tile * tile
    b = kc.fast_bound(n, tile, precision)
    want = (kc.PAIR_BOTH_FLOPS * near + kc.FAST_PAIR_FLOPS * fast) / kc.PEAK_FLOPS * 1e3
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(want)
    # The tensor cores' share never sets the bound: 24 bf16 operations a pair
    # at 989 TFLOP/s against 21 FP32 at 67.
    assert kc.FAST_PAIR_TC_FLOPS * fast / kc.PEAK_BF16 * 1e3 < b["bound_ms"]


def test_bound_is_the_larger_of_operations_and_bytes():
    assert kc.bound(67e12, 0) == {"bound_ms": pytest.approx(1e3), "bound_by": "operations"}
    assert kc.bound(0, 3.35e12) == {"bound_ms": pytest.approx(1e3), "bound_by": "bytes"}
    # The all-pairs kernel at 65,536: 20 operations a pair, 1.28 ms.
    b = kc.bound(kc.PAIR_FLOPS * 65536 ** 2, 65536 * 40)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1.2821, abs=1e-4)
    assert kc.FAST_PAIR_SLOTS < kc.PAIR_BOTH_SLOTS and kc.PAIR_SLOTS < kc.FAST_PAIR_SLOTS


def test_near_work_counts_live_entries():
    """Two rows of 4 targets, 2 entries a chunk of 2-body source tiles: the
    sentinel entry (source tile n / src_tile) and the unused tail chunk
    (target row n / tile) do no work."""
    n, tile, src_tile, entries = 8, 4, 2, 2
    flat_src = torch.tensor([0, 1, 2, 4, 3, 4, 0, 0], dtype=torch.int32)
    chunk_tgt = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    work = kc.near_work((None, None, flat_src, chunk_tgt),
                        dict(n=n, n_s=n, tile=tile, src_tile=src_tile, entries=entries))
    assert work["pairs"] == 4 * src_tile * tile
    assert work["chunks_max"] == 2 and work["chunks_mean"] == pytest.approx(1.5)


def test_counted_covers_every_pair_and_treecode_kernel():
    """The SASS report counts the inner loops of the four pair kernels and
    of the treecode's near, VIP, far, single-level far and near-panel
    kernels: every source with a pair or term loop, all but the gather and
    the span stamp (one thread, no loop over bodies)."""
    assert set(kc.COUNTED) == ({p.name for p in cuda_build.sources()}
                               - {"gather.cu", "stamp.cu"})


def test_vip_work_counts_both_ways_once():
    rows, panel = torch.zeros((1000, 4)), torch.zeros((96, 4))
    work = kc.vip_work((rows, panel), {})
    assert work == {"pairs": 96000, "rows": 1000, "vips": 96}
    b = kc.tree_bound("vip", (rows, panel), {})
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(kc.PAIR_BOTH_FLOPS * 96000 / kc.PEAK_FLOPS * 1e3)
    assert kc.VIP_PAIR_SLOTS == kc.PAIR_BOTH_SLOTS
    # W = 0: no pair, only the rows read and the actions written.
    empty = kc.tree_bound("vip", (rows, panel[:0]), {})
    assert empty["bound_by"] == "bytes"
    assert empty["bound_ms"] == pytest.approx(1000 * 28 / kc.PEAK_BYTES * 1e3)


def test_far_work_counts_live_terms():
    """Two rows of 4 targets, one chunk of 64 entries each and a third chunk
    on the unused tail: sentinel entries (the last summary row) and the tail
    do no work."""
    from n_body_problem_tpu_torch.ops.cuda_treecode import FAR_ENTRIES

    n, tile, k = 8, 4, 10            # summ rows 0 .. 9, row 9 the zero sentinel
    far_src = torch.full((3 * FAR_ENTRIES,), k - 1, dtype=torch.int32)
    far_src[:40] = 1                 # row 0: 40 live entries
    far_src[FAR_ENTRIES:FAR_ENTRIES + 7] = 2   # row 1: 7
    far_src[2 * FAR_ENTRIES:] = 3    # the tail chunk: not a row's
    far_tgt = torch.tensor([0, 1, 2], dtype=torch.int32)
    args = (torch.zeros((n + 64, 4)), torch.zeros((k, 12)), far_src, far_tgt)
    work = kc.far_work(args, dict(n=n, tile=tile))
    assert work == {"terms": 47 * tile, "chunks_max": 1, "chunks_mean": 1.0}
    b = kc.tree_bound("far", args, dict(n=n, tile=tile))
    assert b["bound_ms"] == pytest.approx(
        max(kc.NODE_FLOPS * 47 * tile / kc.PEAK_FLOPS,
            (sum(a.numel() * a.element_size() for a in args) + n * 12) / kc.PEAK_BYTES) * 1e3)


def test_far_term_counts_are_the_kernels():
    """NODE_FLOPS and the 33 instructions of the far slot counts are what
    the shared far_term (csrc/nodes.cuh) does: its FMAs (two operations
    each), multiplies, subtractions and the rsqrt. Both far kernels include
    that header, define no term of their own and call it for two targets a
    thread, which halve the node row's three shared loads a term."""
    src = (cuda_build.CSRC_DIR / "nodes.cuh").read_text()
    body = src[src.index("void far_term("):]
    body = body[body.index("{"):body.index("\n}\n")]
    fmas, muls, subs = body.count("fmaf("), body.count(" * "), body.count(" - ")
    rsqrts = body.count("rsqrt_normal(")
    assert rsqrts == 1
    assert fmas + muls + subs + rsqrts == kc.NODE_TERM_INSTRUCTIONS == 33
    assert 2 * fmas + muls + subs + rsqrts == kc.NODE_FLOPS == 52
    for name in ("far_hier.cu", "far_single.cu"):
        kernel = (cuda_build.CSRC_DIR / name).read_text()
        assert '#include "nodes.cuh"' in kernel and "void far_term(" not in kernel
        assert kernel.count("far_term(a, q, r, me0,") == kernel.count("far_term(a, q, r, me1,") == 1
        assert "rsqrtf(" not in kernel
    assert kc.FAR_TERM_SLOTS == kc.FAR_SINGLE_TERM_SLOTS == 33 + 3 / 2


def test_single_work_leaves_masked_tiles_out():
    """Three rows of 32 targets against 5 source tiles: the near mask's
    tiles do no far work, a row with every tile masked none at all."""
    mask = torch.tensor([[0, 1, 0, 0, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], dtype=torch.uint8)
    args = (torch.zeros((96 + 64, 4)), torch.zeros((6, 12)), mask)
    kw = dict(n=96, tile=32)
    work = kc.single_work(args, kw)
    assert work == {"terms": (3 + 0 + 5) * 32, "live_max": 5, "live_mean": pytest.approx(8 / 3)}
    assert kc.single_work((*args[:2], mask.bool()), kw) == work
    b = kc.tree_bound("far_single", args, kw)
    assert b["bound_ms"] == pytest.approx(
        max(kc.NODE_FLOPS * 8 * 32 / kc.PEAK_FLOPS,
            (sum(a.numel() * a.element_size() for a in args) + 96 * 12) / kc.PEAK_BYTES) * 1e3)


def test_panel_work_is_k_t_w():
    """Every target of each of K tiles against all W rows of its panel,
    zero-mass rows included; the bound at 20,480 dense (K = 640 tiles of
    32, W = 13,312) is set by operations: 0.0814 ms."""
    panels = torch.zeros((7, 96, 4))
    work = kc.panel_work((torch.zeros((7 * 32, 4)), panels), dict(tile=32))
    assert work == {"pairs": 7 * 32 * 96, "tiles": 7, "width": 96}
    assert kc.TREE_WORK["near_panel"][1:] == ("pairs", kc.PAIR_SLOTS)
    pairs = 640 * 32 * 13312
    nbytes = 20512 * 16 + 640 * 13312 * 16 + 20480 * 12
    assert kc.bound(kc.PAIR_FLOPS * pairs, nbytes) == {
        "bound_ms": pytest.approx(0.0814, abs=1e-4), "bound_by": "operations"}


@pytest.mark.parametrize("key", ["vip", "far", "far_single", "near_panel"])
def test_tree_sweep_settings_are_schedules(key, monkeypatch):
    """Every setting --sweep times gives a schedule the kernel takes (the far
    kernel's whole warps, at most 512 threads, staging two node quads a
    thread; the VIP sweep's whole sub-panels; the single-level far kernel's
    and the near-panel kernel's at most 512 threads), each another one."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct

    names, settings = kc.tree_sweep(key)
    seen = set()
    for values in settings:
        for name, value in zip(names, values):
            monkeypatch.setattr(ct, name, value)
        if key == "vip":
            split = (ct.vip_split(65536, 1024), ct.vip_split(524288, 4096))
            for (groups, pieces, piece), w in zip(split, (1024, 4096)):
                assert piece % 32 == 0 and pieces * piece >= w > (pieces - 1) * piece
        elif key == "far":
            split = ct.far_split(128)
            sub, parts, stage = split
            threads = sub // 2 * parts
            assert threads <= ct.FAR_MAX_THREADS and threads % 32 == 0
            assert 3 * ct.FAR_ENTRIES * stage <= ct.FAR_SLOTS * threads
        elif key == "far_single":
            split = ct.single_split(32)
            parts, per, stage = split
            assert stage == per * 16 * parts <= ct.SINGLE_MAX_ENTRIES * ct.SINGLE_MAX_THREADS
        else:
            split = ct.panel_split(32)
            parts, stage = split
            assert 8 * parts <= ct.PANEL_MAX_THREADS and stage >= 1
        seen.add(split)
    assert len(seen) == len(settings)   # no setting repeats another's schedule
