"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` has a plain C entry point (no PyTorch headers), so a
build takes seconds.  The sources are compiled in parallel, one nvcc per
file, for ``sm_90a`` and linked into one shared library under
``build/repro_torch/`` at the repository root (listed in ``.gitignore``).
The library's name carries a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is.  Nothing here
runs at import time: the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c = ctypes
# name -> (argtypes) of each C entry point; every one returns a cudaError_t
SIGNATURES = {
    "pt_walk_launch": [_c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p,
                       _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int,
                       _c.c_int, _c.c_longlong, _c.c_longlong, _c.c_void_p,
                       _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                       _c.c_int, _c.c_void_p],
    "empty_launch": [_c.c_void_p],
    "block_copy_launch": [_c.c_void_p] * 5 + [_c.c_int] * 4
                         + [_c.c_longlong, _c.c_void_p],
    "paged_attention_launch": [_c.c_void_p] * 8 + [_c.c_int] * 9
                              + [_c.c_void_p],
    "paged_attention_occupancy": [_c.c_int, _c.c_int, _c.c_void_p],
    "paged_attention_capture_id": [_c.c_void_p, _c.c_void_p],
    "alloc_scan_launch": [_c.c_void_p] * 10 + [_c.c_int] * 7
                         + [_c.c_void_p] * 11,
    "fast_window_launch": [_c.c_void_p] * 3,
}


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float        # 0.0 when an earlier build was loaded
    log: str              # nvcc's output (register and spill report)
    lib: ctypes.CDLL


_BUILT: Built | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels of repro_torch cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [s.name for s, p in zip(_sources(), procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs),
                               "-o", str(lib_tmp)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out)       # atomic: a reader sees all or nothing
    return "\n".join(logs)


def build() -> Built:
    """Build (or load) the kernel library once per process."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    log, seconds = "", 0.0
    if not out.exists():
        t0 = time.perf_counter()
        log = _compile(out)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _BUILT = Built(out, seconds, log, lib)
    return _BUILT


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
