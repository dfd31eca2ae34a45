"""Build and load the port's CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source and all at once, and links the objects into one shared library
with a plain C interface; ``ctypes`` loads it.  No PyTorch header is
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (restype int = cudaError_t)
_SIGNATURES = {
    "srgpt_vit_attention": [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 12 + [_I, _F, _P],
    "srgpt_prefill_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 12 + [_I, _F, _P],
    "srgpt_decode_attention": [_P] * 7 + [_I] * 6 + [_F, _P],
    "srgpt_flash_fwd": [_P] * 6 + [_I] * 5 + [_LL] * 12 + [_I, _F, _P],
    "srgpt_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_LL] * 12 + [_I, _F, _P],
    "srgpt_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_LL] * 12 + [_I, _F, _P],
    "srgpt_grid_bias_attention": [_P] * 6 + [_I] * 6 + [_LL] * 12 + [_F, _P],
    "srgpt_layer_norm": [_P] * 4 + [_LL, _I, _F, _I, _P],
    "srgpt_act_quant": [_P, _P, _P, _LL, _I, _P],
    "srgpt_act_quant_dy": [_P] * 4 + [_LL, _I, _LL, _P],
    "srgpt_w8a8_gemm": [_P] * 5 + [_I, _P, _P] + [_I] * 4 + [_P],
    "srgpt_w8_gemm": [_P] * 4 + [_I, _P, _P] + [_I] * 4 + [_P],
    "srgpt_int8_dx_gemm": [_P, _LL] + [_P] * 4 + [_I] * 3 + [_P],
    "srgpt_int8_transpose": [_P, _P, _I, _I, _P],
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
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        # one nvcc per source, all started together: the build takes as long
        # as its slowest source
        jobs, objs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", objs[-1], str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = ""
        for cmd, proc in jobs:
            log += " ".join(cmd) + "\n" + proc.communicate()[0]
        failed = [cmd[-1] for cmd, proc in jobs if proc.returncode != 0]
        if not failed:
            so = os.path.join(tmp, LIB_NAME)
            cmd = [nvcc, "-shared", "-o", so, *objs]
            link = subprocess.run(cmd, capture_output=True, text=True)
            log += " ".join(cmd) + "\n" + link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["link"]
        (out_dir / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        os.replace(so, lib_path)  # atomic: concurrent builders never see a partial file
    build_info.update(seconds=time.time() - t0, path=str(lib_path), log=log)
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
