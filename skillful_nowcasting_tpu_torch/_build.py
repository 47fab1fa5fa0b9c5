"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
one shared library with a plain C interface, at first use, under
``build/kernels/`` next to the package. The file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads the
cached binary. Pointers and the stream cross the boundary as ``c_void_p``;
each entry point returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import time, so every module imports on a machine
without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: argument types, return int (cudaError_t).
SIGNATURES = {
    "gru_gates_f32": [_P] * 6 + [_I] * 4 + [_P],
    "gru_update_f32": [_P] * 7 + [_I] * 4 + [_P],
    "gblock_conv1_f32": [_P] * 7 + [_I] * 4 + [_P],
    "gblock_conv2_f32": [_P] * 6 + [_I] * 6 + [_P],
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` when the CUDA toolkit is absent."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): the "
            "CUDA kernels of skillful_nowcasting_tpu_torch are compiled from csrc/ "
            "on the machine with the GPU. CPU tensors take the plain PyTorch versions."
        )
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdgmr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    target = library_path()
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    # Build to a private name and rename, so concurrent processes never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, *sources], capture_output=True, text=True
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, target)
    return target


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dgmr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dgmr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` and raise if its launch was refused."""
    lib = load_library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.dgmr_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} (cudaError {code})")
