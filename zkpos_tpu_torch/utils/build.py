"""Build and load the port's native libraries.

Two shared libraries, each built at first use into ``_build/`` inside the
package and cached by a hash of its sources and flags:

* the CUDA kernels: ``nvcc`` compiles every ``csrc/*.cu`` for sm_90a (one
  process per source, all started together; the log gives each one's
  seconds), links them into one ``.so``
  with a plain C interface, and ``ctypes`` loads it;
* the host runtime (``csrc/host/zkpos_native.cpp``): ``g++`` into a second
  ``.so`` (the witness solver VM and batched host field arithmetic).

Every CUDA entry point returns ``cudaGetLastError()``; ``check`` raises
when it is not 0.  Pointers and the stream are passed as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_cuda_lib: Optional[ctypes.CDLL] = None
_host_lib: Optional[ctypes.CDLL] = None
# per-kernel register / spill report of the last nvcc build (ptxas -v)
PTXAS_LOG: str = ""


def _digest(paths: List[str], flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (looked on PATH and in /usr/local/cuda)")


def _build_cuda() -> str:
    global PTXAS_LOG
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    tag = _digest(sources + headers, NVCC_FLAGS)
    out_dir = os.path.join(BUILD, "cuda-" + tag)
    so = os.path.join(out_dir, "libzkpos_kernels.so")
    log = os.path.join(out_dir, "ptxas.log")
    if os.path.exists(so):
        if os.path.exists(log):
            with open(log) as f:
                PTXAS_LOG = f.read()
        return so
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    objs = [os.path.join(out_dir, os.path.basename(src) + ".o")
            for src in sources]
    done = {}

    def compile_one(src, obj):
        t0 = time.time()
        p = subprocess.run([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o",
                            obj], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        done[src] = (p.returncode, p.stdout, time.time() - t0)
    threads = [threading.Thread(target=compile_one, args=so)
               for so in zip(sources, objs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    logs = [f"== {os.path.basename(src)} ({done[src][2]:.1f} s)\n"
            f"{done[src][1]}" for src in sources]
    failed = [src for src in sources if done[src][0] != 0]
    PTXAS_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + PTXAS_LOG)
    tmp = so + ".tmp"
    subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                   check=True, capture_output=True, text=True)
    with open(log, "w") as f:
        f.write(PTXAS_LOG)
    os.replace(tmp, so)
    return so


def cuda_lib() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be
    built (no toolkit) -- there is no fallback."""
    global _cuda_lib
    with _lock:
        if _cuda_lib is None:
            L = ctypes.CDLL(_build_cuda())
            V, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            sigs = {
                "zk_ff_binary": [I, I, V, V, V, LL, I, I, V],
                "zk_ff_pow": [I, V, V, V, V, LL, V],
                "zk_ntt_stage": [V, V, LL, LL, LL, V],
                "zk_csr_eval": [V, V, V, V, V, V, LL, LL, V, V, V],
                "zk_g1_add": [V, V, V, LL, I, V],
                "zk_g2_add": [V, V, V, LL, I, V],
                "zk_g1_horner": [V, V, I, I, V],
                "zk_g2_horner": [V, V, I, I, V],
                "zk_seg_scan": [I, V, V, V, V, LL, V],
                "zk_seg_sums": [I, V, V, V, V, LL, V],
                "zk_poseidon_sparse3": [V, V, V, LL, LL, V, V],
                "zk_poseidon_plain": [I, V, V, LL, V, V, V],
                "zk_poseidon_sparse": [I, V, V, LL, V, V],
                "zk_poseidon_chain": [V, V, LL, I, V, I, V, I, V],
                "zk_probe_rate": [I, V, V, V, LL, I, V],
                "zk_probe_conv": [I, V, V, V, LL, V],
                "zk_probe_product": [I, V, V, V, LL, V],
                "zk_probe_latency": [V, V, V, I, I, V],
                "zk_probe_split": [I, V, V, V, LL, LL, V, I, V],
                "zk_probe_scan_copy": [I, V, V, V, V, LL, V],
                "zk_probe_scan_structure": [I, V, V, V, V, LL, V],
                "zk_probe_scan_local": [I, V, V, V, V, V, LL, I, V],
                "zk_probe_scan_fixup": [I, V, V, V, LL, I, V],
                "zk_probe_lookback": [I, V, V, V, V, LL, V],
                "zk_probe_scan_stage": [I, I, V, V, V, V, LL, V],
                "zk_probe_dot": [I, I, V, V, V, LL, V],
            }
            for name, args in sigs.items():
                fn = getattr(L, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            L.zk_csr_chunks.argtypes = [LL]
            L.zk_csr_chunks.restype = LL
            L.zk_seg_scratch_bytes.argtypes = [I, I, LL]
            L.zk_seg_scratch_bytes.restype = LL
            L.zk_probe_scan_bytes.argtypes = [I, I, LL]
            L.zk_probe_scan_bytes.restype = LL
            L.zk_probe_scan_tpc.argtypes = [I, LL]
            L.zk_probe_scan_tpc.restype = LL
            for fn in (L.zk_probe_stage_bytes, L.zk_probe_stage_carries):
                fn.argtypes = [I, LL]
                fn.restype = LL
            L.zk_probe_stage_tpc.argtypes = [I, I, LL]
            L.zk_probe_stage_tpc.restype = LL
            L.zk_probe_conv_resident.argtypes = []
            L.zk_probe_conv_resident.restype = LL
            _cuda_lib = L
    return _cuda_lib


def cuda_objects_dir() -> str:
    """The directory of the built kernel library and its per-source
    objects (``<source>.cu.o``), building them first if needed."""
    with _lock:
        return os.path.dirname(_build_cuda())


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {rc}")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _build_host() -> str:
    src = os.path.join(CSRC, "host", "zkpos_native.cpp")
    tag = _digest([src], GXX_FLAGS)
    out_dir = os.path.join(BUILD, "host-" + tag)
    so = os.path.join(out_dir, "libzkpos_native.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = so + ".tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src], check=True,
                   capture_output=True, timeout=600)
    os.replace(tmp, so)
    return so


def host_lib() -> ctypes.CDLL:
    """The host runtime, built with g++ on first use."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            _host_lib = ctypes.CDLL(_build_host())
    return _host_lib
