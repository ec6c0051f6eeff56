"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers it includes) is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ``ctypes``.
Each source compiles in its own ``nvcc`` process, all started together;
a final ``nvcc -shared`` links them. The library lands in ``_build/``
next to this file, named by a hash of the sources, headers and flags, so
a changed source or header rebuilds and an unchanged one loads at once.

Nothing here runs at import: the first kernel launch calls
:func:`load_library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v"]
LINK_FLAGS = ARCH + ["-shared"]

_lib = None
#: what the last build printed (ptxas register/spill report) and took
build_info: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(sources=None) -> pathlib.Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in list(sources or _sources()) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build(sources=None) -> pathlib.Path:
    """Compile every source (default: ``csrc/*.cu``) in parallel and link
    the library (no-op if this exact build exists). Raises with nvcc's
    output on failure."""
    sources = sources or _sources()
    lib = library_path(sources)
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                # -I csrc: a source built from elsewhere (an A/B variant)
                # still finds the shared headers
                [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = pathlib.Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, *(str(o) for _, o, _ in procs),
             "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    build_info.update(seconds=time.time() - t0, log="\n".join(log),
                      path=str(lib))
    return lib


_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: argument and result types of every launch function
SIGNATURES = {
    "mailbox_pack_launch": (
        [ctypes.POINTER(_vp), _ci, _vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp],
        _ci),
    "local_chase_launch": (
        [_vp, _vp, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp],
        _ci),
    "flash_attention_launch": (
        [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
         _ci, _ci, ctypes.c_float, ctypes.c_float, _vp], _ci),
    "flash_attention_decode_launch": (
        [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
         ctypes.c_float, ctypes.c_float, _ci, _ci, _ci, _vp, _vp, _vp], _ci),
    "ssd_scan_launch": (
        [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
         _vp], _ci),
    "ssd_scan_smem_bytes": ([_ci, _ci, _ci], _ll),
    "ssd_scan_bf16_launch": (
        [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci,
         _ci, _ci, _ci, _ci, _vp], _ci),
    "ssd_scan_bf16_smem_bytes": ([_ci, _ci, _ci], _ll),
    "ssd_scan_bf16_chunk_pad": ([_ci], _ci),
}


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of every launch function; a
    library that lacks one raises (AttributeError) here, at load."""
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
