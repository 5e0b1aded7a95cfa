"""Variants of the complete-add kernel (csrc/ec_add.cu) on the card, beside
the kernel as the package builds it:

* the G2 add at other launch bounds: copies of the source with
  ``Shape<Fp2>::kMin`` (blocks an SM the registers must allow) changed;
* with ``--parent DIR``, the kernel of another checkout (DIR holds its
  ``zkpos_tpu_torch/csrc``), e.g. the commit before a change, unpacked
  with ``git archive``.

Each variant is built alone with nvcc (its ptxas registers, stack and
spill bytes logged), held bit for bit against the current kernel on
random reduced coordinates at the prove path's largest add launches
(2,097,151 G1 and 1,924,679 G2 points: setup's fixed-base batches), and
timed with CUDA events in turns (each variant, then the same in reverse
order).  One JSON line per curve and variant, then the card's name and
power limit; exits 2 without a CUDA device, 1 if a variant disagrees.

    python -m zkpos_tpu_torch.probes.ec_variants [--parent DIR]

Not part of the probes path (``python -m zkpos_tpu_torch.probes``): it
measures design choices of the add kernel, which keeps none of them as
an option.
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

N = {3: 2_097_151, 6: 1_924_679}
KMIN = "struct Shape<Fp2> { static const int kBlock = 128, kMin = 2; }"
G2_KMIN = (3, 4)                 # the current kernel's is 2


def _sources(name: str, csrc: str, kmin=None) -> str:
    """A directory with csrc's headers and ec_add.cu, kMin substituted."""
    subs = (() if kmin is None else
            (("ec_add.cu", KMIN, KMIN.replace("kMin = 2", f"kMin = {kmin}")),))
    return variant_sources("ec_variants", name, csrc, subs)


def _resources(log: str) -> dict:
    """{curve: ptxas figures} of k_padd<Fp1> / <Fp2> in a ptxas log."""
    return {c: next(iter(kernel_resources(f"6k_paddIN2ff3Fp{k}EE",
                                          log).values()), None)
            for c, k in (("g1", 1), ("g2", 2))}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose csrc to build too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    srcs = {"current": _sources("current", build.CSRC)}
    for k in G2_KMIN:
        srcs[f"g2_kmin{k}"] = _sources(f"g2_kmin{k}", build.CSRC, k)
    if args.parent:
        srcs["parent"] = _sources("parent", os.path.join(
            args.parent, "zkpos_tpu_torch", "csrc"))
    done = {}
    threads = [threading.Thread(target=build_variant,
                                args=(s, "ec_add.cu", done, n))
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
        for fn in (L.zk_g1_add, L.zk_g2_add):
            fn.argtypes = [V, V, V, LL, I, V]
            fn.restype = I
        libs[name] = L
        info[name] = {"build_s": round(secs, 1), "ptxas": _resources(log)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    ok = True
    card = smi()
    for curve, na in (("g1", 3), ("g2", 6)):
        n = N[na]

        def rand():
            x = torch.randint(0, 1 << 32, (n, na, 8), generator=gen,
                              dtype=torch.int64, device="cuda")
            x[:, :, 7] %= 0x30644E72          # below p's top limb
            x = torch.where(x >= 1 << 31, x - (1 << 32), x)
            return x.to(torch.int32).contiguous()
        a, b = rand(), rand()

        def add(L):
            out = torch.empty_like(a)
            fn = L.zk_g1_add if na == 3 else L.zk_g2_add
            build.check(fn(build.ptr(out), build.ptr(a), build.ptr(b), n, 1,
                           build.stream_ptr(a)), "ec_variants")
            return out
        ref = add(libs["current"])
        times = {k: [] for k in libs}
        order = list(libs) + list(libs)[::-1]
        for name in order:
            L = libs[name]
            add(L)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5):
                add(L)
            e.record()
            torch.cuda.synchronize()
            times[name].append(round(s.elapsed_time(e) / 5, 4))
        for name, L in libs.items():
            same = bool(torch.equal(add(L), ref))
            ok = ok and same
            print(json.dumps({"ec_variant": name, "curve": curve, "n": n,
                              "equal_to_current": same, "ms": times[name],
                              "ptxas": info[name]["ptxas"][curve],
                              "build_s": info[name]["build_s"],
                              "card": card}), flush=True)
        del a, b, ref
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
