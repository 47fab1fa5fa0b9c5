"""ctypes bindings for the native host data path (``native/radar_window.cpp``).

A copy of ``skillful_nowcasting_tpu/data/native.py``'s loader: the first use
runs ``make -C native`` (g++ -O3 -fopenmp) and loads
``native/libradar_window.so`` as it is; every entry point has a numpy
fallback, so the pipeline works without a toolchain. The library packs
THWC; the wrappers here take and return the port's TCHW / NTCHW layouts,
which for the single-channel radar are the same bytes (no copy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libradar_window.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        build_err = None
        try:
            # make's timestamp rule rebuilds when radar_window.cpp changed; the
            # .so is never committed, so a foreign-ISA binary cannot shadow it.
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            build_err = e  # a library built earlier on this host may still load
        try:
            lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
        except OSError as e:
            print(f"native radar_window unavailable (build: {build_err or 'ok'}; load: {e}); "
                  "numpy fallback", file=sys.stderr)
            return None
        if build_err is not None:
            print(f"native radar_window rebuild failed ({build_err}); using the existing library",
                  file=sys.stderr)

        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pack_windows.restype = ctypes.c_int
        lib.pack_windows.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            f32p, f32p,
        ]
        lib.space_to_depth.restype = ctypes.c_int
        lib.space_to_depth.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, f32p,
        ]
        lib.omp_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _channels_last(a: np.ndarray, axis: int) -> np.ndarray:
    """Contiguous float32 with ``axis`` (the channel axis) moved last; no copy for one channel."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), axis, -1))


def _channels_first(a: np.ndarray, axis: int) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, -1, axis))


def pack_windows(
    frames: np.ndarray,
    starts: np.ndarray,
    crop_y: np.ndarray,
    crop_x: np.ndarray,
    n_in: int,
    n_tgt: int,
    crop_h: int,
    crop_w: int,
    scale: float = 1.0,
    offset: float = 0.0,
    nan_fill: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather, crop and normalize a batch of windows from a TCHW frame pool.

    Returns ``(inputs (B, n_in, C, crop_h, crop_w), targets (B, n_tgt, C, ...))``.
    """
    frames = _channels_last(frames, 1)  # THWC, as the library packs
    starts = np.ascontiguousarray(starts, np.int64)
    crop_y = np.ascontiguousarray(crop_y, np.int64)
    crop_x = np.ascontiguousarray(crop_x, np.int64)
    nf, h, w, c = frames.shape
    b = starts.shape[0]
    out_in = np.empty((b, n_in, crop_h, crop_w, c), np.float32)
    out_tg = np.empty((b, n_tgt, crop_h, crop_w, c), np.float32)

    lib = _load()
    if lib is not None:
        rc = lib.pack_windows(
            _f32p(frames), nf, h, w, c,
            _i64p(starts), _i64p(crop_y), _i64p(crop_x),
            b, n_in, n_tgt, crop_h, crop_w,
            ctypes.c_float(scale), ctypes.c_float(offset), ctypes.c_float(nan_fill),
            _f32p(out_in), _f32p(out_tg),
        )
        if rc != 0:
            raise ValueError("pack_windows: window or crop out of bounds")
    else:
        total = n_in + n_tgt
        for i in range(b):
            s, y, x = int(starts[i]), int(crop_y[i]), int(crop_x[i])
            if s < 0 or s + total > nf or y + crop_h > h or x + crop_w > w:
                raise ValueError("pack_windows: window or crop out of bounds")
            win = frames[s : s + total, y : y + crop_h, x : x + crop_w, :]
            win = np.nan_to_num(win, nan=nan_fill) * scale + offset
            out_in[i] = win[:n_in]
            out_tg[i] = win[n_in:]
    return _channels_first(out_in, 2), _channels_first(out_tg, 2)


def space_to_depth_host(x: np.ndarray, factor: int) -> np.ndarray:
    """Host NTCHW space-to-depth in ``torch.nn.functional.pixel_unshuffle``'s channel order."""
    x = _channels_last(x, 2)
    n, t, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError("spatial dims must divide the factor")
    out = np.empty((n, t, h // factor, w // factor, c * factor * factor), np.float32)
    lib = _load()
    if lib is not None:
        if lib.space_to_depth(_f32p(x), n, t, h, w, c, factor, _f32p(out)) != 0:
            raise ValueError("space_to_depth: invalid factor")
    else:
        r = x.reshape(n, t, h // factor, factor, w // factor, factor, c)
        out = np.transpose(r, (0, 1, 2, 4, 6, 3, 5)).reshape(out.shape)
    return _channels_first(out, 2)
