"""Build and load the package's CUDA kernels.

Each source in ollamamq_tpu_torch/csrc/*.cu is compiled by nvcc for
sm_90a into its own shared library with a plain C interface and loaded
with ctypes (no PyTorch headers: a build takes seconds); one library may
export several entry points. Builds happen at first use, all missing
libraries at once in parallel, into
ollamamq_tpu_torch/_build/ (or $OLLAMAMQ_TORCH_BUILD_DIR). A library's
file name carries a digest of its sources and flags, so an edited source
is never served by a stale build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# Entry point -> (source file, C argtypes). Every entry point returns the
# cudaError_t of its launch as an int. The int8 variants take the two
# f32 scale planes right after the pools.
KERNELS = {
    # q, k, v, page_table, seq_lens, out, scratch, B, H, Hk, hd,
    # page_size, max_pages, then the launch plan (split, kv_tile, threads,
    # smem_bytes, n_splits), dtype, stream
    "paged_decode_attention": ("paged_decode_attention.cu",
                               [_P] * 7 + [_I] * 12 + [_P]),
    # q, k, v, k_scale, v_scale, page_table, seq_lens, out, scratch, B, ...
    "paged_decode_attention_int8": ("paged_decode_attention.cu",
                                    [_P] * 9 + [_I] * 12 + [_P]),
    # q, k, v, page_table, q_start, q_lens, kv_lens, out, T, B, H, Hk,
    # hd, page_size, max_pages, then the launch plan (q_tile, kv_tile,
    # threads, smem_bytes, blocks), dtype, stream
    "ragged_paged_attention": ("ragged_paged_attention.cu",
                               [_P] * 8 + [_I] * 13 + [_P]),
    # q, k, v, k_scale, v_scale, page_table, q_start, q_lens, kv_lens,
    # out, T, ...
    "ragged_paged_attention_int8": ("ragged_paged_attention.cu",
                                    [_P] * 10 + [_I] * 13 + [_P]),
}

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("OLLAMAMQ_TORCH_BUILD_DIR") or os.path.join(_PKG, "_build")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources() -> list:
    """The distinct .cu sources of KERNELS, in table order."""
    return list(dict.fromkeys(src for src, _ in KERNELS.values()))


def lib_path(src: str) -> str:
    """The library built from csrc/`src`: its name carries a digest of
    the flags, the source and every header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == src or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + b"\0" + fh.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(build_dir(), f"lib{stem}-{h.hexdigest()[:16]}.so")


def build() -> Dict[str, dict]:
    """Compile every source whose library is missing, one nvcc per
    source, all started together. Returns {source: {"seconds", "log",
    "cached", "entry_points"}}; raises RuntimeError with nvcc's output if
    any fails."""
    with _lock:
        return _build_locked(sources())


def _build_locked(srcs) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    procs = {}
    os.makedirs(build_dir(), exist_ok=True)
    t0 = time.monotonic()
    for src in srcs:
        path = lib_path(src)
        if os.path.exists(path):
            out[src] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    failed = []
    for src, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        with open(path + ".log", "w") as fh:
            fh.write(log)
        out[src] = {"seconds": time.monotonic() - t0, "log": log,
                    "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for src, info in out.items():
        info["entry_points"] = [n for n, (s, _) in KERNELS.items() if s == src]
    return out


def kernel_fn(name: str):
    """The C entry point of kernel `name`, building its library first if
    needed. Raises if nvcc or the load fails: there is no fallback."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            src, argtypes = KERNELS[name]
            lib = _libs.get(src)
            if lib is None:
                path = lib_path(src)
                if not os.path.exists(path):
                    _build_locked([src])
                lib = _libs[src] = ctypes.CDLL(path)
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn
