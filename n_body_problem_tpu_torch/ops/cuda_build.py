"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper),
one ``nvcc`` process a source, all started together, and the objects are
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``. Nothing is built when a module is imported: the first wrapper
that launches a kernel calls :func:`load_library`, and that builds from the
package's own sources into ``_build/<hash>/``, keyed by a hash of the
sources and the flags. A later process with the same sources loads the
library that is already there.

No PyTorch header is included, so a build takes seconds. The kernels launch
on the stream they are given (PyTorch's current stream) and return
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libnbody_kernels.so"
# The kernels index float triples and quads with 32-bit ints.
MAX_BODIES = (1 << 31) // 4
# The smallest normal float32. Every pair and term kernel takes the bare
# rsqrt instruction (csrc/pairs.cuh), which flushes a denormal argument to
# zero: c^2 |d|^2 + eps2 is normal for every pair only if eps2 is.
MIN_EPS2 = 1.1754944e-38
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (argtypes, restype). P = pointer or stream,
# I = int, F = float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (pos_i, ni, cols4, nj, parts, stages_a_piece, pieces, partial, out, c2,
    #  eps2, stream) -> cudaError_t
    "nbody_allpairs_acc": ((_P, _I, _P, _I, _I, _I, _I, _P, _P, _F, _F, _P), _I),
    # (body4, n, slots, out, c2, eps2, stream) -> cudaError_t
    "nbody_symmetric_acc": ((_P, _I, _P, _P, _F, _F, _P), _I),
    # (body4, n, tile, centers4, near_s, warps, step, slots, out, c2, eps2,
    #  stream) -> cudaError_t
    "nbody_symmetric_bf16x3": ((_P, _I, _I, _P, _I, _I, _I, _P, _P, _F, _F, _P), _I),
    # (targets4, n_t, sources4, n_s, tile, sub, src_tile, entries, parts, piece,
    #  flat_src, chunk_tgt, n_chunks, out, c2, eps2, stream) -> cudaError_t
    "nbody_near_field": ((_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _F, _F,
                          _P), _I),
    # (bodies4, n, tile, sub, parts, stage_chunks, summ12, far_src, far_tgt,
    #  n_chunks, out, c2, eps2, gc, stream) -> cudaError_t
    "nbody_far_field": ((_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _F, _F, _F, _P), _I),
    # (bodies4, n, tile, parts, per, summ12, k_s, mask, out, c2, eps2, gc,
    #  stream) -> cudaError_t
    "nbody_far_single": ((_P, _I, _I, _I, _I, _P, _I, _P, _P, _F, _F, _F, _P), _I),
    # (bodies4, tile, near_idx, k, m_near, out, stream) -> cudaError_t
    "nbody_gather_panels": ((_P, _I, _P, _I, _I, _P, _P), _I),
    # (bodies4, tile, panels4, k, width, parts, stage, out, c2, eps2, stream)
    #  -> cudaError_t
    "nbody_near_panel": ((_P, _I, _P, _I, _I, _I, _I, _P, _F, _F, _P), _I),
    # (rows4, n, panel4, w, pieces, piece, react_part, act_part, action,
    #  react, c2, eps2, stream) -> cudaError_t
    "nbody_vip_both": ((_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _F, _F, _P), _I),
    # (x, y, z, n, tile, cx, cy, cz, k_l, out, stream) -> cudaError_t
    "nbody_min_tile_dist": ((_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P), _I),
    # (x, y, z, n, tile, cx, cy, cz, k_l, mac, amp, radius, mass, a_med, thresh,
    #  tiny, row_offset, row_div, col_div, opens, far, score, stream) -> cudaError_t
    "nbody_min_dist_open": ((_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _F, _F,
                             ctypes.c_longlong, _I, _I, _P, _P, _P, _P), _I),
    # (x, rows, cols, ld, k, scratch, values, indices, stream) -> cudaError_t
    "nbody_top_k": ((_P, _I, _I, ctypes.c_longlong, _I, _P, _P, _P, _P), _I),
    # (rows, k) -> bytes of device scratch nbody_top_k needs (0: none)
    "nbody_top_k_scratch_bytes": ((_I, _I), ctypes.c_longlong),
    # (ring, cursor, capacity, code, counters, n_counters, stream) -> cudaError_t
    "nbody_span_stamp": ((_P, _P, _I, _I, _P, _I, _P), _I),
    # (cudaError_t) -> message
    "nbody_error_string": ((_I,), ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels need the CUDA toolkit")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def build_library() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into the library unless it is already built.

    One ``nvcc -c`` a source, all running at once, then one link. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``build.log``.
    """
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = lib.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}rc={proc.returncode}\n")
        failed |= proc.returncode != 0
    tmp = lib.with_name(f"{LIB_NAME}.{tag}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}rc={proc.returncode}\n")
        failed = proc.returncode != 0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "".join(log) + f"seconds={time.perf_counter() - t0:.3f}\n"
    (lib.parent / "build.log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library with ``argtypes``/``restype`` set on every entry."""
    lib = ctypes.CDLL(str(build_library()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def require_f32(name: str, t: torch.Tensor, shape: tuple[int, ...],
                device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` — what the kernels take, and all they take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_normal_eps2(name: str, eps2: float) -> None:
    """Raise unless the softening is a normal float32 (:data:`MIN_EPS2`)."""
    if not eps2 >= MIN_EPS2:
        raise ValueError(f"{name}: eps2={eps2} must be at least {MIN_EPS2} on the card")


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = load_library().nbody_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
