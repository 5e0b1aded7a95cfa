"""Variants of the wide Poseidon permutation (csrc/poseidon.cu ``k_wide``,
the sparse schedule one permutation a thread at t = 4..17) on the card,
beside the kernel as the package builds it:

* without the block barrier at every partial round (poseidon.cuh
  ``permute_wide``'s ``block_sync()``);
* in blocks of 64 threads instead of 128 (``kWideBlock``);
* with the state in shared memory instead of the stack frame: 8 T + 1
  words a thread (an odd stride, so a warp's 32 lanes reading the same
  word of their states meet 32 banks), 70,144 bytes a block at t = 17;
  the mix's result stays in the stack frame;
* with ``--parent DIR``, the permutation of another checkout (DIR holds
  its ``zkpos_tpu_torch/csrc``), e.g. the commit before a change,
  unpacked with ``git archive``: before the sparse kernel, the plain
  schedule's ``k_plain<T>`` (``zk_poseidon_plain``) ran these widths.

Each variant's poseidon.cu is built alone with nvcc (its ptxas registers,
stack and spill bytes logged), held bit for bit against the current
kernel on random reduced states at the leaves' largest launch (59,340
permutations, the service path's t = 6 and t = 17 launches; t = 11 its
commitments' tail blocks), and timed with CUDA events in turns (each
variant, then the same in reverse order).  One JSON line per width and
variant, then the card's name and power limit; exits 2 without a CUDA
device, 1 if a variant disagrees.

    python -m zkpos_tpu_torch.probes.poseidon_variants [--parent DIR]

Not part of the probes path (``python -m zkpos_tpu_torch.probes``): it
measures design choices of the kernel, which keeps none of them as an
option.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import threading

from ..utils import build
from .common import build_variant, kernel_resources, smi, variant_sources

N = 59_340
WIDTHS = (6, 11, 17)
SYNC = "    block_sync();\n    // x_0 <- m00"
BLOCK = "const int kWideBlock = 128;"
STACK_STATE = """  uint32_t x[T][8];
  for (int j = 0; j < T; ++j) {
    if (i < n)"""
SHARED_STATE = """  extern __shared__ uint32_t wide_state[];
  uint32_t (*x)[8] = reinterpret_cast<uint32_t (*)[8]>(
      wide_state + (8 * T + 1) * threadIdx.x);
  for (int j = 0; j < T; ++j) {
    if (i < n)"""
LAUNCH = """  if (n > 0)
    k_wide<T><<<grid_for(n, kWideBlock), kWideBlock, 0,"""
SHARED_LAUNCH = """  const int smem = kWideBlock * (8 * T + 1) * 4;
  cudaFuncSetAttribute(k_wide<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (n > 0)
    k_wide<T><<<grid_for(n, kWideBlock), kWideBlock, smem,"""
# each variant's (file, old, new) substitutions in a copy of csrc
VARIANTS = {
    "nosync": (("poseidon.cuh", SYNC, "    // x_0 <- m00"),),
    "block64": (("poseidon.cu", BLOCK, BLOCK.replace("128", "64")),),
    "smem": (("poseidon.cu", STACK_STATE, SHARED_STATE),
             ("poseidon.cu", LAUNCH, SHARED_LAUNCH))}


def _sources(name: str, csrc: str, subs=()) -> str:
    """A directory with csrc's headers and sources, each (file, old, new)
    of `subs` substituted."""
    return variant_sources("poseidon_variants", name, csrc, subs)


def _resources(log: str, t: int, parent: bool) -> dict:
    pattern = f"7k_plainILi{t}EE" if parent else f"6k_wideILi{t}EE"
    return next(iter(kernel_resources(pattern, log).values()), None)


def main(argv=None) -> int:
    import torch
    from ..ops import poseidon as P
    from ..ops import poseidon_sparse as S
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose csrc to build too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    srcs = {"current": _sources("current", build.CSRC)}
    for name, sub in VARIANTS.items():
        srcs[name] = _sources(name, build.CSRC, sub)
    if args.parent:
        srcs["parent"] = _sources("parent", os.path.join(
            args.parent, "zkpos_tpu_torch", "csrc"))
    done = {}
    threads = [threading.Thread(target=build_variant,
                                args=(s, "poseidon.cu", done, n))
               for n, s in srcs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    V, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs, logs, secs = {}, {}, {}
    for name in srcs:
        rc, log, sec, so = done[name]
        if rc != 0:
            print(log, file=sys.stderr)
            print(f"FAIL: nvcc failed for {name}", file=sys.stderr)
            return 1
        L = ctypes.CDLL(so)
        if name == "parent":
            L.zk_poseidon_plain.argtypes = [I, V, V, LL, V, V, V]
            L.zk_poseidon_plain.restype = I
        else:
            L.zk_poseidon_sparse.argtypes = [I, V, V, LL, V, V]
            L.zk_poseidon_sparse.restype = I
        libs[name], logs[name], secs[name] = L, log, round(sec, 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    ok = True
    card = smi()
    for t in WIDTHS:
        x = torch.randint(0, 1 << 32, (N, t, 8), generator=gen,
                          dtype=torch.int64, device="cuda")
        x[:, :, 7] %= 0x30644E72                  # below r's top limb
        x = torch.where(x >= 1 << 31, x - (1 << 32), x)
        x = x.to(torch.int32).contiguous()
        K = S.table("cuda", t)
        C, M = P.tables(t, "cuda")

        def perm(name):
            out = torch.empty((N, 8), dtype=torch.int32, device="cuda")
            L = libs[name]
            if name == "parent":
                rc = L.zk_poseidon_plain(t, build.ptr(out), build.ptr(x), N,
                                         build.ptr(C), build.ptr(M),
                                         build.stream_ptr(x))
            else:
                rc = L.zk_poseidon_sparse(t, build.ptr(out), build.ptr(x), N,
                                          build.ptr(K), build.stream_ptr(x))
            build.check(rc, "poseidon_variants")
            return out
        ref = perm("current")
        times = {k: [] for k in libs}
        for name in list(libs) + list(libs)[::-1]:
            perm(name)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(3):
                perm(name)
            e.record()
            torch.cuda.synchronize()
            times[name].append(round(s.elapsed_time(e) / 3, 4))
        for name in libs:
            same = bool(torch.equal(perm(name), ref))
            ok = ok and same
            print(json.dumps({
                "poseidon_variant": name, "t": t, "n": N,
                "equal_to_current": same, "ms": times[name],
                "ptxas": _resources(logs[name], t, name == "parent"),
                "build_s": secs[name], "card": card}), flush=True)
        del x, ref
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
