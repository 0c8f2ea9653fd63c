"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into one shared library with a plain C interface, which is loaded with
``ctypes``. Nothing is built when a module is imported: the first wrapper
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (argtypes, restype). P = pointer or stream,
# I = int, F = float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (pos_i, ni, cols4, nj, out, c2, eps2, stream) -> cudaError_t
    "nbody_allpairs_acc": ((_P, _I, _P, _I, _P, _F, _F, _P), _I),
    # (body4, n, out, c2, eps2, stream) -> cudaError_t
    "nbody_symmetric_acc": ((_P, _I, _P, _F, _F, _P), _I),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def build_library() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into the library unless it is already built.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``build.log``.
    """
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}\nrc={proc.returncode} seconds={seconds:.3f}\n"
    (lib.parent / "build.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n{log}")
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


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = load_library().nbody_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
