"""Build and load the CUDA kernels of ``csrc/``.

At first use, each ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, and the objects are linked into one
shared library under ``<repo>/build/kernels/``.  The library's name carries
a hash of the sources and flags, so an edited source is never served from a
stale build.  The library exposes a plain C interface (pointers, ints, the
stream) and is loaded with ``ctypes``: no PyTorch headers are compiled.

No ``--use_fast_math``: the quantizer's codes must be the plain version's
bit for bit, which needs IEEE rounding (and division at near-ties).
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point → argtypes; each returns cudaError_t as int
SIGNATURES = {
    # W, w_is_bf16, D, packed, S, Z, n, dp, d, bits, g, blocks, warps,
    # blocks_per_sm, strips, stream
    "ttq_quantize_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P],
    # x, x_is_bf16, packed, S, Z, dinv, y, T, dp, d, bits, g, split, stream
    "ttq_gemm_launch": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    # x, packed, S, Z, dinv, y, T, dp, d, bits, g, stream (the wide tile)
    "ttq_gemm_wide_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, x_is_bf16, x_shared, packed, S, Z, dinv, y, E, T, dp, d, bits, g,
    # split, stream
    "ttq_gemm_experts_launch": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _P],
    # x, x_shared, packed, S, Z, dinv, y, E, T, dp, d, g, n_sm, stream
    "ttq_gemm_experts_mma_launch": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _P],
    # the same launch's copy ring alone (a measurement: tools/experts_probe)
    "ttq_gemm_experts_mma_copies_launch": [_P, _I, _P, _P, _P, _P, _P, _I, _I,
                                           _I, _I, _I, _I, _P],
    # q, q_is_bf16, scale, kq, ks, vq, vs, cur_pos, out, B, Hkv, G, Gt, S,
    # Dh, n_groups, bits, soft_cap, splits, stream
    "ttq_decode_attention_launch": [_P, _I, _F, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, q_is_bf16, scale, kq, ks, vq, vs, block_table, cur_pos, out, B,
    # Hkv, G, Gt, bs, nblk, Dh, n_groups, bits, soft_cap, splits, stream
    "ttq_paged_decode_attention_launch": [_P, _I, _F, _P, _P, _P, _P, _P, _P,
                                          _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _F, _I, _P],
}

# launches per kernel, counted by the wrappers where they launch
LAUNCHES = {"ttq_quantize": 0, "ttq_gemm": 0, "ttq_gemm_experts": 0,
            "ttq_decode_attention": 0, "ttq_paged_decode_attention": 0}
# the tile each ttq_gemm_experts launch took (kernels/ttq_gemm.py:
# experts_tile), counted beside LAUNCHES["ttq_gemm_experts"]
EXPERTS_TILES = {"mma": 0, "batched": 0}
# the tile each ttq_gemm launch took (kernels/ttq_gemm.py:gemm_tile), counted
# beside LAUNCHES["ttq_gemm"]
GEMM_TILES = {"split": 0, "wide": 0}

_lib = None
build_seconds = 0.0
build_log = ""


def reset_launches():
    for counts in (LAUNCHES, EXPERTS_TILES, GEMM_TILES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _build() -> Path:
    global build_seconds, build_log
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = BUILD_DIR / f"libttq_kernels_{h.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for src, pr in procs:
            out, _ = pr.communicate()
            logs.append(f"== {src.name}\n{out}")
            if pr.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs), "-lcudart"],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        log_path.write_text(build_log)
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(_build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
