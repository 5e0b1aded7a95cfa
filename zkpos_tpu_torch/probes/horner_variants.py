"""Where the Horner kernel's time goes (csrc/ec_add.cu k_horner, ec.cuh's
schedule of levels), on the card: the kernel as the package builds it
beside copies of ec.cuh with one part of each level taken out, so that
the difference is that part's time on the critical path:

* ``products_only``: every operand is its first leaf (no sums, no
  doublings), the products and the exchanges as they are;
* ``sums_only``: every product is the sum of its operands (ladd for
  lmul);
* ``sum_loads_only``: that, and the operands' leaves combined by XOR
  (every leaf still loaded, their ladd and lsub gone);
* ``exchange_only``: no sums and no products: what is left is the
  levels' shared-memory loads and stores, their ``__syncwarp``, one ladd,
  the G2 products' trade and the loop;
* ``no_trade``: G2's three lanes of a product keep their own part (no
  shuffles, no c0 / c1 / s sums);
* with ``--parent DIR`` (repeatable), the Horner of another checkout (DIR
  holds its ``zkpos_tpu_torch/csrc``; e.g. the commit before a change,
  unpacked with ``git archive``), named by DIR's last part.

The ablations compute another function: their points are reported, not
checked.  A parent must give the current kernel's point (by affine value
when its formulas differ, ``same_point``).  Each variant is built alone
with nvcc (its ptxas figures logged) and timed with CUDA events in turns
on random window sums: W = 2 with c = 1024 (one add, 1,024 doublings:
the time of a doubling) and the prove's widths (G1 W = 16, c = 16; G2
W = 22, c = 12).  One JSON line per curve, set and variant, then the
card's name and power limit; exits 2 without a CUDA device, 1 if a parent
disagrees.

    python -m zkpos_tpu_torch.probes.horner_variants [--parent DIR]

Not part of the probes path (``python -m zkpos_tpu_torch.probes``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import sys
import threading

from ..utils import build
from .common import build_variant, kernel_resources, smi, variant_sources

# (file, old, new) substitutions of each ablation
_NO_SUM = ("ec.cuh", "  Fp1 x = lsub(",
           "  if (true) return s[T.t[0]];\n  Fp1 x = lsub(")
_NO_ADD = ("ec.cuh",
           "  Fp1 x = lsub(ladd(s[T.t[0]], s[T.t[1]]), s[T.t[2]]);",
           "  Fp1 x = s[T.t[0]];\n"
           "  for (int q = 0; q < 8; ++q)\n"
           "    x.v[q] ^= s[T.t[1]].v[q] ^ s[T.t[2]].v[q];")
_NO_MUL = ("ec.cuh", "if (J.live) r = lmul(", "if (J.live) r = ladd(")
_NO_TRADE = ("ec.cuh", "      if (NC == 3) {", "      if (false) {")
VARIANTS = {"products_only": (_NO_SUM,), "sums_only": (_NO_MUL,),
            "sum_loads_only": (_NO_ADD, _NO_MUL),
            "exchange_only": (_NO_SUM, _NO_MUL),
            "no_trade": (_NO_TRADE,)}
# (name, curve, W, c): a doubling's time, and the prove's widths
SETS = (("dbl", "g1", 2, 1024), ("dbl", "g2", 2, 1024),
        ("prove", "g1", 16, 16), ("prove", "g2", 22, 12))


def _resources(log: str) -> dict:
    """{curve: ptxas figures} of k_horner<Fp1> / <Fp2>."""
    out = {}
    for cv, k in (("g1", 1), ("g2", 2)):
        found = kernel_resources(f"8k_hornerIN2ff3Fp{k}E", log)
        out[cv] = next(iter(found.values()), None)
    return out


def main(argv=None) -> int:
    import torch
    from ..crypto import bn254 as bn
    from ..ops import ec
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout whose csrc to build too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    srcs = {"current": variant_sources("horner_variants", "current",
                                       build.CSRC)}
    for name, subs in VARIANTS.items():
        srcs[name] = variant_sources("horner_variants", name, build.CSRC,
                                     subs)
    for d in args.parent:
        name = os.path.basename(os.path.normpath(d))
        srcs[name] = variant_sources("horner_variants", name, os.path.join(
            d, "zkpos_tpu_torch", "csrc"))
    done = {}
    threads = [threading.Thread(target=build_variant,
                                args=(s, "ec_add.cu", done, n))
               for n, s in srcs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    V, I = ctypes.c_void_p, ctypes.c_int
    libs, info = {}, {}
    for name in srcs:
        rc, log, secs, so = done[name]
        if rc != 0:
            print(log, file=sys.stderr)
            print(f"FAIL: nvcc failed for {name}", file=sys.stderr)
            return 1
        L = ctypes.CDLL(so)
        for fn in (L.zk_g1_horner, L.zk_g2_horner):
            fn.argtypes = [V, V, I, I, V]
            fn.restype = I
        libs[name] = L
        info[name] = {"build_s": round(secs, 1), "ptxas": _resources(log)}
    rnd = random.Random(12)
    ok = True
    card = smi()
    for set_name, curve, W, c in SETS:
        gen, mul = ((bn.G1_GEN, bn.g1_mul) if curve == "g1"
                    else (bn.G2_GEN, bn.g2_mul))
        rw = ec.from_affine([mul(gen, rnd.randrange(1, bn.R))
                             for _ in range(W)], curve, "cuda")

        def run(L):
            out = torch.empty((1, rw.shape[1], 8), dtype=torch.int32,
                              device="cuda")
            fn = L.zk_g1_horner if curve == "g1" else L.zk_g2_horner
            build.check(fn(build.ptr(out), build.ptr(rw), W, c,
                           build.stream_ptr(rw)), "horner_variants")
            return out
        ref = run(libs["current"])
        times = {k: [] for k in libs}
        for name in list(libs) + list(libs)[::-1]:
            L = libs[name]
            run(L)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(3):
                run(L)
            e.record()
            torch.cuda.synchronize()
            times[name].append(round(s.elapsed_time(e) / 3, 4))
        depth = ec.horner_levels(W, c)
        for name, L in libs.items():
            out = run(L)
            row = {"horner_variant": name, "curve": curve, "set": set_name,
                   "W": W, "c": c, "ms": times[name],
                   "us_per_level": round(sum(times[name]) / 2 * 1e3 / depth,
                                         4),
                   "ptxas": info[name]["ptxas"][curve],
                   "build_s": info[name]["build_s"], "card": card}
            if name not in VARIANTS:
                row["same_point"] = ec.to_affine(out.cpu()) == \
                    ec.to_affine(ref.cpu())
                ok = ok and row["same_point"]
            print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
