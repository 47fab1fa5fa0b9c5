"""Zstandard frames: the C++ decoder of ``hostsrc/zstd.cpp``, and a writer of raw-block frames.

The decoder (RFC 8878, no dictionaries) is compiled by the host C++ compiler
(``$CXX``, else ``c++``) at first use into ``build/host/`` next to the
package, under a name that carries a hash of the source and flags, and is
loaded with ctypes. The library is built aside and renamed into place, so
processes that build at once never load a partial file. A missing compiler
or a failed build raises: there is no other decoder. ctypes releases the GIL
during a call, so chunks decode in parallel on threads.

:func:`compress_raw` writes one frame of raw blocks with its content size
and no checksum: what the port writes, and what any zstd decoder reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "hostsrc" / "zstd.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
MAGIC = b"\x28\xb5\x2f\xfd"
MAX_BLOCK = 128 * 1024

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "no host C++ compiler (neither $CXX nor c++ / g++ on PATH): the zstd decoder of "
            f"the Orbax checkpoint reader is built from {SOURCE}"
        )
    return cxx


def library_path() -> Path:
    """Where the decoder for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdgmr_zstd_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``hostsrc/zstd.cpp`` unless the library for this source exists."""
    target = library_path()
    if target.exists():
        return target
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        lib = work / target.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(lib, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dgmr_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                                 ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
            lib.dgmr_zstd_decompress.restype = ctypes.c_longlong
            lib.dgmr_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                                   ctypes.POINTER(ctypes.c_longlong),
                                                   ctypes.POINTER(ctypes.c_size_t)]
            lib.dgmr_zstd_content_size.restype = ctypes.c_int
            lib.dgmr_zstd_error_string.argtypes = [ctypes.c_int]
            lib.dgmr_zstd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_DST_TOO_SMALL = 5


def _error(lib, code: int, at: int) -> ValueError:
    return ValueError(f"zstd: {lib.dgmr_zstd_error_string(code).decode()} at byte {at}")


def _as_u8(buf) -> np.ndarray:
    """A uint8 view of any contiguous bytes-like object (no copy)."""
    return np.frombuffer(buf, dtype=np.uint8)


def content_size(data) -> Optional[int]:
    """The decoded size that the frames declare, or ``None`` if one of them does not."""
    lib = _load()
    src = _as_u8(data)
    total, at = ctypes.c_longlong(), ctypes.c_size_t()
    code = lib.dgmr_zstd_content_size(src.ctypes.data, src.size, ctypes.byref(total),
                                      ctypes.byref(at))
    if code:
        raise _error(lib, code, at.value)
    return None if total.value < 0 else total.value


def decompress_into(data, out) -> int:
    """Decode ``data`` into the writable buffer ``out``; returns the decoded size.

    Raises ``ValueError`` (with the input offset) on a malformed frame, a
    failed checksum, or output that does not fit ``out``.
    """
    lib = _load()
    src = _as_u8(data)
    dst = np.frombuffer(out, dtype=np.uint8)
    if not dst.flags.writeable:
        raise ValueError("decompress_into needs a writable buffer")
    at = ctypes.c_size_t()
    n = lib.dgmr_zstd_decompress(src.ctypes.data, src.size, dst.ctypes.data, dst.size,
                                 ctypes.byref(at))
    if n < 0:
        raise _error(lib, -n, at.value)
    return int(n)


def decompress(data) -> bytes:
    """Decode every frame of ``data``.

    The output buffer is the frames' declared size; where a frame declares
    none, it grows until the frames fit.
    """
    size = content_size(data)
    cap = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        out = bytearray(cap)
        try:
            n = decompress_into(data, out)
        except ValueError as e:
            if size is not None or "too small" not in str(e):
                raise
            cap *= 2
            continue
        return bytes(out[:n]) if n != cap else bytes(out)


def compress_raw(data) -> bytes:
    """One zstd frame holding ``data`` in raw blocks, with its content size and no checksum."""
    view = memoryview(data).cast("B")
    n = len(view)
    # Frame header: content-size field of 4 (or 8) bytes, a window of 128 KiB
    # (raw blocks refer to nothing earlier), no checksum, no dictionary.
    if n < 1 << 32:
        header = bytes([0x80, 0x38]) + n.to_bytes(4, "little")
    else:
        header = bytes([0xC0, 0x38]) + n.to_bytes(8, "little")
    parts = [MAGIC, header]
    starts = range(0, n, MAX_BLOCK) if n else [0]
    for start in starts:
        size = min(MAX_BLOCK, n - start)
        last = start + MAX_BLOCK >= n
        parts.append((int(last) | (size << 3)).to_bytes(3, "little"))
        parts.append(view[start:start + size])
    return b"".join(parts)
