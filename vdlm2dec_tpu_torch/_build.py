"""Builds the package's CUDA kernels from csrc/ and binds them with ctypes.

At first use, one `nvcc -gencode arch=compute_90a,code=sm_90a -c` per
csrc/*.cu (the sync scan and the fused u8 channelizer), all started
together, then one `nvcc -shared` link into a single library with a plain
C interface, in _build/ beside this file (listed in .gitignore).  The
library's name carries a hash of the sources, so an edited kernel is
rebuilt and a stale one is never loaded.  Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}        # library path, nvcc seconds, ptxas report


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvdl2_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands concurrently; (returncode, stdout + stderr) of
    each.  Every process is gone when this returns, on error too."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        results = []
        for p in procs:
            text = p.communicate(timeout=NVCC_TIMEOUT_S)[0]
            results.append((p.returncode, text))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory and rename: a concurrent or
    # interrupted build never leaves a half-written library under the
    # final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        so = str(Path(tmp) / out.name)
        t = time.perf_counter()
        steps = [
            [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
             for obj, src in zip(objs, _sources())],
            [[nvcc, *ARCH, "-shared", "-o", so, *objs]],
        ]
        report = []
        for cmds in steps:
            for cmd, (rc, text) in zip(cmds, _run_all(cmds)):
                report.append(text.strip())
                if rc:
                    raise RuntimeError(f"nvcc failed ({rc}):\n"
                                       f"{' '.join(cmd)}\n{text}")
        build_info["nvcc_s"] = time.perf_counter() - t
        build_info["ptxas"] = "\n".join(report)
        os.replace(so, out)


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                # several processes may start on a fresh tree (the
                # multi-host workers): one compiles, the others wait for
                # its flock (released even if it dies) and load its build
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(BUILD_DIR / "build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not path.exists():
                        _compile(path)
            lib = ctypes.CDLL(str(path))
            lib.vdl2_sync_scan.restype = ctypes.c_int
            lib.vdl2_sync_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.vdl2_chan_u8.restype = ctypes.c_int
            lib.vdl2_chan_u8.argtypes = [
                *[ctypes.c_void_p] * 8, ctypes.c_float, ctypes.c_void_p,
                *[ctypes.c_int] * 6, ctypes.c_void_p,
            ]
            build_info["library"] = str(path)
            _lib = lib
        return _lib
