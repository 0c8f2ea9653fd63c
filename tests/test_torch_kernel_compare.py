"""``kernel_compare``'s arithmetic on the CPU: the bounds, the pair counts of
the fast symmetric modes, the block cases' inputs' shapes, and the SASS
reader that counts the instructions a pair of a kernel's inner loops. The
timings themselves need the card."""

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
    work = kc.near_work((None, flat_src, chunk_tgt),
                        dict(n=n, tile=tile, src_tile=src_tile, entries=entries))
    assert work["pairs"] == 4 * src_tile * tile
    assert work["chunks_max"] == 2 and work["chunks_mean"] == pytest.approx(1.5)
