"""ctypes binding of the native data-plane runtime (``native/dlco_native.cpp``).

Port of ``opencv_dlco_tpu/native.py``: a threaded BMP decoder, patch-sheet
cropper and m50 pair-index parser in C++, so a host without cv2 or PIL
still decodes the Brown sheets and BMP frames. The library is built at
first use with ``g++`` (the flags of ``native/Makefile``) into the port's
build directory (``_build/`` beside the package, where ``ops/cuda_build``
puts the kernels; listed in ``.gitignore``), named by a hash of the source
and flags; ``native/`` is only read.

``available()`` says whether the library built and loaded. Without it,
``load_patch_sheets`` falls back to cv2 and ``parse_m50`` to numpy, as the
JAX binding does; ``load_gray`` decodes ``.bmp`` natively and other
formats (or every format, without the library) through cv2, else PIL;
with neither, the ImportError carries the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "dlco_native.cpp")
#: native/Makefile's CXXFLAGS, and a shared object
CXX_FLAGS = ["-O3", "-Wall", "-Werror", "-std=c++17", "-fPIC", "-pthread",
             "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the library is unavailable (the compiler's output), once tried
error: Optional[str] = None


def lib_path() -> str:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libdlco_native-{h.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native library needs a C++ "
                           "compiler on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as err:
            error = str(err)
            return None
        lib.dlco_version.restype = ctypes.c_int
        lib.dlco_bmp_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dlco_bmp_load_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int]
        lib.dlco_load_patch_sheets.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.dlco_parse_m50.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
        lib.dlco_parse_m50.restype = ctypes.c_long
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def bmp_load_gray(path: str) -> np.ndarray:
    """Decode a BMP to a grayscale uint8 (H, W) array via the native lib."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {error}")
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.dlco_bmp_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"bmp probe failed ({rc}): {path}")
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.dlco_bmp_load_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w.value, h.value)
    if rc != 0:
        raise IOError(f"bmp decode failed ({rc}): {path}")
    return out


def load_gray(path: str) -> np.ndarray:
    """Decode an image file to grayscale uint8 (H, W): ``.bmp`` through the
    native decoder when the library is available, other formats (or every
    format without it) through cv2, else PIL."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.splitext(path)[1].lower() == ".bmp" and available():
        return bmp_load_gray(path)
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError as err:
            raise ImportError(
                f"cannot decode {path}: neither cv2 nor PIL is installed, "
                f"and the native decoder (.bmp only) is unavailable: "
                f"{error}") from err

        return np.asarray(Image.open(path).convert("L"))
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"cv2 failed to decode {path}")
    return img


def load_patch_sheets(paths: Sequence[str], patch: int = 64, grid: int = 16,
                      n_threads: int = 0) -> np.ndarray:
    """Decode sheets and crop their patch grids: (len(paths)*grid^2, P, P).

    Multithreaded native path; decode-and-crop fallback without it."""
    lib = _load()
    n = len(paths)
    out = np.empty((n * grid * grid, patch, patch), np.uint8)
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = lib.dlco_load_patch_sheets(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            patch, grid, n_threads)
        if rc != 0:
            raise IOError(f"sheet load failed ({rc})")
        return out
    from .data.brown import crop_patch_grid

    for i, p in enumerate(paths):
        out[i * grid * grid:(i + 1) * grid * grid] = crop_patch_grid(
            load_gray(p), grid * grid)
    return out


def parse_m50(path: str, max_rows: int = 2_000_000) -> np.ndarray:
    """Fast m50 pair-index parse -> (N, 4) int32; numpy fallback."""
    lib = _load()
    if lib is None:
        from .data.brown import parse_pair_index

        return parse_pair_index(path)
    out = np.empty((max_rows, 4), np.int32)
    n = lib.dlco_parse_m50(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_rows)
    if n < 0:
        raise IOError(path)
    return out[:n].copy()
