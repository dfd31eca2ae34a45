"""Build and load the port's CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface for ``sm_90a``; ``ctypes`` loads it.  No PyTorch header is
included, so the build takes seconds.  The library lands in
``<repo>/build/kernels/<hash of the sources>/`` (listed in .gitignore), so a
changed source builds anew and an unchanged one is reused.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libsrgpt_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (restype int = cudaError_t)
_SIGNATURES = {
    "srgpt_vit_attention": [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 12 + [_I, _F, _P],
    "srgpt_prefill_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 12 + [_I, _F, _P],
    "srgpt_decode_attention": [_P] * 10 + [_I] * 5 + [_F, _P],
    "srgpt_decode_num_splits": [_I],
}

_lib = None
build_info: dict = {}  # seconds, path, ptxas log of the build this process used


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> Path:
    """Compile csrc/*.cu if this source hash has no library yet; return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("path", str(lib_path))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see a partial file
    build_info.update(seconds=seconds, path=str(lib_path), log=log)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
