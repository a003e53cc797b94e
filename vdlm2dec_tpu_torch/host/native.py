"""ctypes binding to the native host deframer (csrc/hostdec.cpp).

Builds the library with g++ on first use into the package's _build/
directory (listed in .gitignore; the name carries a hash of the source, so
an edited source is rebuilt).  Where no toolchain is found the callers get
None and use the pure-Python Unstuffer; both paths are behaviour-identical
(tested against each other).  `native_available()` says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hostdec.cpp"
BUILD_DIR = _PKG / "_build"

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhostdec_{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, out.name)
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
             "-o", so, str(SOURCE)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(so, out)


def get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (subprocess.SubprocessError, OSError):
            _build_failed = True
            return None
        lib.vdl2_deframe_block.restype = ctypes.c_int
        lib.vdl2_deframe_block.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.vdl2_deframe_batch.restype = ctypes.c_int
        lib.vdl2_deframe_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ deframer built and loaded (building it if this
    is the first use)."""
    return get_lib() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def deframe_block_native(
    block: np.ndarray, nbrow: int, nlbyte: int
) -> list[np.ndarray] | None:
    """Native single-block deframe; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    blk = np.zeros((8, 255), dtype=np.uint8)
    blk[: min(nbrow, 8)] = np.asarray(block, dtype=np.uint8)[:8]
    out = np.zeros(4096, dtype=np.uint8)
    offs = np.zeros(64, dtype=np.int32)
    lens = np.zeros(64, dtype=np.int32)
    n = lib.vdl2_deframe_block(
        _u8p(np.ascontiguousarray(blk)), int(nbrow), int(nlbyte),
        _u8p(out), out.size, _i32p(offs), _i32p(lens), 64,
    )
    return [out[offs[i] : offs[i] + lens[i]].copy() for i in range(n)]


def deframe_batch_native(
    blocks: np.ndarray, nbrow: np.ndarray, nlbyte: np.ndarray
) -> list[list[np.ndarray]] | None:
    """blocks (N, 8, 255) -> per-block lists of CRC-valid frames."""
    lib = get_lib()
    if lib is None:
        return None
    n = blocks.shape[0]
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    nbrow = np.ascontiguousarray(nbrow, dtype=np.int32)
    nlbyte = np.ascontiguousarray(nlbyte, dtype=np.int32)
    max_frames = max(64, 8 * n)
    out = np.zeros(4096 * max(1, n), dtype=np.uint8)
    offs = np.zeros(max_frames, dtype=np.int32)
    lens = np.zeros(max_frames, dtype=np.int32)
    fblk = np.zeros(max_frames, dtype=np.int32)
    nper = np.zeros(n, dtype=np.int32)
    total = lib.vdl2_deframe_batch(
        _u8p(blocks), _i32p(nbrow), _i32p(nlbyte), n,
        _u8p(out), out.size, _i32p(offs), _i32p(lens), _i32p(fblk),
        max_frames, _i32p(nper),
    )
    result: list[list[np.ndarray]] = [[] for _ in range(n)]
    for i in range(total):
        result[fblk[i]].append(out[offs[i] : offs[i] + lens[i]].copy())
    return result
