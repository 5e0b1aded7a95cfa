"""Variants of the weights-first product's kernels (csrc/probes.cu
``k_dot_ffma`` / ``k_dot_tf32``) on the card, beside the kernels as the
package builds them:

* ``ffma_tile4``: the FP32 tile of 8 rows x 4 columns, four warps and
  three slabs in flight a block (the shape the kernel first took);
* ``ffma_3stages``: the 8 x 8 tile with three slabs in flight (three
  blocks an SM where two slabs allow four);
* ``tf32_4x2``: a TF32 warp on all 64 rows of 16 columns (a warp barrier a
  step, 128 registers of A fragments) where the kernel's covers 32 x 32;
* ``tf32_4blocks``: the TF32 kernel held to 128 registers, four blocks an
  SM where it runs three;
* ``steps1`` / ``steps2`` / ``steps4``: k_dot's chain cut to 1, 2 or 4
  products (both routes), which splits a route's time into the stream of
  X and Y and the products;
* with ``--parent DIR``, the kernels of another checkout (DIR holds its
  ``zkpos_tpu_torch/csrc``), e.g. the commit before a change, unpacked
  with ``git archive``.

Each variant's probes.cu is built alone with nvcc (its ptxas figures
logged), each chain of full length held bit for bit against the current
kernel's output (and the current kernel within probe_dot.TOL against the
plain chain), and every variant timed with CUDA events in turns (each,
then the same in reverse order) on probe_dot's inputs (2^22 columns).
One JSON line per kind, route and variant, then the card's name and power
limit; exits 2 without a CUDA device, 1 if a variant's chain of full
length disagrees with the current kernel (the parent's is reported, not
required: an elementwise tail may round its FMAs otherwise).

    python -m zkpos_tpu_torch.probes.dot_variants [--parent DIR]

Not part of the probes path: it measures design choices of the product's
kernels, which keep none of them as an option.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import threading

from ..utils import build
from . import probe_dot as pd
from .common import (build_variant, kernel_resources, max_rel_err, smi,
                     variant_sources)

STEPS = "const int kDotSteps = 8;"
FFMA_STAGES = ("const int kFfmaStages = 2;", "const int kFfmaStages = 3;")
TF32_BOUNDS = "__launch_bounds__(128, 3)"
VARIANTS = {
    "current": (),
    "ffma_tile4": (("const int kTileC = 8;", "const int kTileC = 4;"),
                   FFMA_STAGES,
                   ("__launch_bounds__(512 / kTileC, 4)",
                    "__launch_bounds__(512 / kTileC, 3)")),
    "ffma_3stages": (FFMA_STAGES,),
    # the warp's chain is its own: warp barriers in place of the block's
    "tf32_4x2": (("const int kMT = 2;", "const int kMT = 4;"),
                 (TF32_BOUNDS, "__launch_bounds__(128, 2)"),
                 ("__syncthreads();    // the step's products read",
                  "__syncwarp();"),
                 ("__syncthreads();    // the step's outputs stored",
                  "__syncwarp();")),
    "tf32_4blocks": ((TF32_BOUNDS, "__launch_bounds__(128, 4)"),),
    **{f"steps{k}": ((STEPS, STEPS.replace("8", str(k))),) for k in (1, 2, 4)},
}
REPS = 10


def _resources(log: str) -> dict:
    """{route: {kind: ptxas figures}} of the product's kernels in a log."""
    return {r: {k: next(iter(kernel_resources(
        f"k_dot_{r}ILb{int(k == 'mix')}E", log).values()), None)
        for k in pd.KINDS} for r in pd.ROUTES}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose csrc to build too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    srcs = {name: variant_sources(
        "dot_variants", name, build.CSRC,
        tuple(("probes.cu", old, new) for old, new in subs))
        for name, subs in VARIANTS.items()}
    if args.parent:
        srcs["parent"] = variant_sources("dot_variants", "parent", os.path.join(
            args.parent, "zkpos_tpu_torch", "csrc"))
    done = {}
    threads = [threading.Thread(target=build_variant,
                                args=(s, "probes.cu", done, n))
               for n, s in srcs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    V, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs, info = {}, {}
    for name in srcs:
        rc, log, secs, so = done[name]
        if rc != 0:
            print(log, file=sys.stderr)
            print(f"FAIL: nvcc failed for {name}", file=sys.stderr)
            return 1
        L = ctypes.CDLL(so)
        L.zk_probe_dot.argtypes = [I, I, V, V, V, LL, V]
        L.zk_probe_dot.restype = I
        libs[name] = L
        info[name] = {"build_s": round(secs, 1), "ptxas": _resources(log)}
    w, x = pd.inputs(pd.N, 0, "cuda")
    n = x.shape[1]
    ok, card = True, smi()
    for kind in pd.KINDS:
        plain = pd.plain_chain(kind, w, x)
        for route in pd.ROUTES:
            def chain(L):
                y = torch.empty_like(x)
                build.check(L.zk_probe_dot(
                    pd.ROUTES.index(route), pd.KINDS.index(kind),
                    build.ptr(y), build.ptr(w), build.ptr(x), n,
                    build.stream_ptr(x)), "dot_variants")
                return y
            names = [k for k in libs
                     if kind == "dot" or not k.startswith("steps")]
            ref = chain(libs["current"])
            rel = max_rel_err(ref, plain)
            ok = ok and rel <= pd.TOL[kind, route]
            times = {k: [] for k in names}
            for name in names + names[::-1]:
                L = libs[name]
                chain(L)
                torch.cuda.synchronize()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(REPS):
                    chain(L)
                e.record()
                torch.cuda.synchronize()
                times[name].append(round(s.elapsed_time(e) / REPS, 4))
            for name in names:
                same = None
                if not name.startswith("steps"):
                    same = bool(torch.equal(chain(libs[name]), ref))
                    ok = ok and (same or name == "parent")
                print(json.dumps({
                    "dot_variant": name, "kind": kind, "route": route,
                    "n": n, "ms": times[name], "equal_to_current": same,
                    "rel_err_of_current": rel,
                    "ptxas": info[name]["ptxas"][route][kind],
                    "build_s": info[name]["build_s"], "card": card}),
                    flush=True)
            del ref
        del plain
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
