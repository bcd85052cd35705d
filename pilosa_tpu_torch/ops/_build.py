"""Build and load the hand-written CUDA kernels (csrc/bitmap_kernels.cu).

nvcc compiles the source into a shared library with a plain C interface at
first use, and ctypes loads it. The library lands in build/pilosa_tpu_torch/
at the root of the checkout, named by a digest of the source and flags, so
an edited source never loads a stale build. Nothing here runs at import
time: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bitmap_kernels.cu"
BUILD_DIR = _PKG.parent / "build" / "pilosa_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# what the last build() did: seconds spent in nvcc (0.0 when the library
# was already built) and the compiler's log (ptxas register/spill report)
build_info = {"seconds": 0.0, "log": "", "path": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbitmap_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact source is already built."""
    so = library_path()
    if so.exists():
        build_info.update(seconds=0.0, path=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(log)
    build_info.update(seconds=seconds, log=log, path=str(so))
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pbk_error_string.argtypes = [i]
        lib.pbk_error_string.restype = ctypes.c_char_p
        lib.pbk_pair_stream_counts.argtypes = [vp, i, i, i, vp, ll, ll, ll,
                                               i, i, vp]
        lib.pbk_pair_stream_counts.restype = i
        lib.pbk_program_count.argtypes = [vp, vp, i, i, i, vp, ll, ll, i,
                                          vp]
        lib.pbk_program_count.restype = i
        lib.pbk_program_count_table.argtypes = [vp, i, i, i, vp, ll, ll, i,
                                                vp]
        lib.pbk_program_count_table.restype = i
        lib.pbk_intersect_count.argtypes = [vp, vp, vp, ll, ll, i, vp]
        lib.pbk_intersect_count.restype = i
        lib.pbk_bsi_compare.argtypes = [vp, vp, vp, i, i, vp, ll, i, vp]
        lib.pbk_bsi_compare.restype = i
        lib.pbk_bsi_sum_counts.argtypes = [vp, vp, i, i, vp, ll, ll, vp]
        lib.pbk_bsi_sum_counts.restype = i
        lib.pbk_bsi_sum_staged.argtypes = [vp, vp, i, i, vp, ll, ll, i, vp]
        lib.pbk_bsi_sum_staged.restype = i
        lib.pbk_topn_counts.argtypes = [vp, i, vp, vp, ll, ll, ll, vp]
        lib.pbk_topn_counts.restype = i
        lib.pbk_cross_count.argtypes = [vp, vp, i, i, vp, ll, ll, ll, i, i,
                                        vp]
        lib.pbk_cross_count.restype = i
        lib.pbk_sparse_intersect_dense.argtypes = [vp, vp, vp, ll, i, ll, i,
                                                   i, i, ll, vp]
        lib.pbk_sparse_intersect_dense.restype = i
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.pbk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def build_log() -> str:
    """The compiler's log of the loaded build (read back from beside the
    library when this process did not compile it)."""
    if build_info["log"] or not build_info["path"]:
        return build_info["log"]
    log = Path(build_info["path"]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(log: str) -> dict:
    """Per compiled function (mangled name), what ptxas -v reported:
    registers and the bytes of stack frame, spill stores and spill loads."""
    report: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[name].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report
