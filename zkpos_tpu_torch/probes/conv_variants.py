"""Where the grouped convolution's time goes (csrc/probes.cu ``k_conv_ring``,
the grouped form of probe_conv), on the card: the kernel as the package
builds it beside copies of its sources with one part changed, so that the
differences split its time:

* ``nomerge``: the same products (probes.cuh conv_grouped, no merge of
  partial sums) in the one-thread-a-column grid of ``k_conv<0 / 2>``,
  a block a slab of 128 columns, each thread loading its digits before
  its rounds;
* ``noload``: that, with each digit made from the column index (no
  global read): what the rounds and the stores cost alone in that grid;
* ``ring_noload``: the persistent kernel with no fetch, each digit made
  from the column index: the rounds and stores alone in its own layout;
* with ``--parent DIR``, the kernels of another checkout (DIR holds its
  ``zkpos_tpu_torch/csrc``; e.g. the commit before a change, unpacked
  with ``git archive``): its grouped form.

So parent - nomerge is what the merge costs, nomerge - noload what the
copy costs where it does not overlap the rounds, the kernel - ring_noload
what is left of it in the ring, and noload against the bound what the
rounds lose to the FP32 pipe's issue.  Each variant's probes.cu is built
alone with nvcc (its ptxas figures logged), every output held against
plain_rounds("grouped") within probe_conv.TOL on all N = 2^22 columns
(the variants without loads on the digits they make), and every variant
timed with CUDA events in turns (each, then the same in reverse order).
From each variant's cuobjdump -sass (where the toolkit has it): its
grouped kernel's instructions and, over its FFMAs, how many sources come
from the register file rather than the operand reuse cache and how often
two of those are registers of one parity (sass_stats).  One JSON line per
variant, one with the split, then the card's name and power limit; exits
2 without a CUDA device, 1 if an output is out of tolerance.

    python -m zkpos_tpu_torch.probes.conv_variants [--parent DIR]

Not part of the probes path: it measures the design of the grouped
form's kernel, which keeps none of these as an option.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import threading
from collections import Counter

from ..utils import build
from . import probe_conv as pc
from .common import (FP32_FMA_PER_S, build_variant, kernel_resources,
                     max_rel_err, smi, variant_sources)

# the digits the variants without loads make from the column index c: one
# conversion a column and an add a digit
_DIGIT_A = "(float)(c & 127) + (float)(3 * i)"
_DIGIT_B = "(float)((c * 5) & 127) + (float)(3 * i)"
_GRID = ("probes.cu",
         "    case 1: return launch_conv_ring((float*)out, pa, pb, n, s);\n",
         "    case 1: k_conv<1><<<g, kBlock, 0, s>>>((float*)out, pa, pb, n);"
         " break;\n")
_NOLOAD = ("probes.cu", "    x[i] = a[i * n + c];\n    bb[i] = b[i * n + c];",
           f"    x[i] = {_DIGIT_A};\n    bb[i] = {_DIGIT_B};")
_NOFETCH = ("probes.cuh", "  if (c < n) {\n    const float* pa = a + c;",
            "  if (false) {\n    const float* pa = a + c;")
_RING_DIGITS = ("probes.cuh",
                "      x[i] = s[i * kConvSlab];\n"
                "      bb[i] = s[(kDigits + i) * kConvSlab];",
                f"      x[i] = {_DIGIT_A};\n      bb[i] = {_DIGIT_B};")

VARIANTS = {"current": (), "nomerge": (_GRID,), "noload": (_GRID, _NOLOAD),
            "ring_noload": (_NOFETCH, _RING_DIGITS)}
NO_LOADS = ("noload", "ring_noload")
REPS = 10


def column_digits(n: int, device):
    """The (34, n) digit planes the variants without loads make: digit i
    of column c is (c mod 128) + 3 i in a, (5 c mod 128) + 3 i in b (all
    below 256)."""
    import torch
    c = torch.arange(n, dtype=torch.int64, device=device)
    i = torch.arange(pc.ND, dtype=torch.int64, device=device)[:, None]
    return (((c & 127) + 3 * i).float().contiguous(),
            (((c * 5) & 127) + 3 * i).float().contiguous())


def _resources(log: str) -> dict:
    """ptxas figures of the grouped form's kernels in a log (the grid's
    k_conv<1>, the persistent k_conv_ring)."""
    out = {}
    for tag, pattern in (("k_conv<1>", "k_convILi1E"),
                         ("k_conv_ring", "k_conv_ring")):
        found = kernel_resources(pattern, log)
        if found:
            out[tag] = next(iter(found.values()))
    return out


_REG = re.compile(r"-?\|?R(\d+)\|?(\.reuse)?$")


def sass_stats(text: str, pattern: str):
    """Of the function whose name holds `pattern` in cuobjdump -sass text:
    its instructions, the five commonest base opcodes, and over its FFMAs
    the distinct registers read from the register file -- a source comes
    from the operand reuse cache when the instruction before named the
    same register in the same slot with .reuse -- as a histogram
    ``rf_reads``, with ``same_parity``, the FFMAs two or three of whose
    register-file reads are registers of one parity; None if absent."""
    body, on = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            on = pattern in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)\s*([^;]*);", line)
        if on and m:
            body.append((m.group(1), [t.strip() for t in
                                      m.group(2).split(",")]))
    if not body:
        return None
    ops = Counter(op.split(".")[0] for op, _ in body)
    reads, same, prev = Counter(), 0, {}
    for op, args in body:
        slots = {}
        for k, t in enumerate(args[1:4]):
            m = _REG.match(t)
            if m:
                slots[k] = (int(m.group(1)), bool(m.group(2)))
        if op.split(".")[0] == "FFMA":
            rf = {r for k, (r, _) in slots.items() if prev.get(k) != r}
            reads[len(rf)] += 1
            if len(rf) >= 2 and max(Counter(r % 2 for r in rf).values()) >= 2:
                same += 1
        prev = {k: r for k, (r, reuse) in slots.items() if reuse}
    return {"instructions": len(body), "top": dict(ops.most_common(5)),
            "ffma": ops["FFMA"], "rf_reads": dict(sorted(reads.items())),
            "same_parity": same}


def _sass(so: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ""
    return subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose csrc to build too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    srcs = {name: variant_sources("conv_variants", name, build.CSRC, subs)
            for name, subs in VARIANTS.items()}
    if args.parent:
        srcs["parent"] = variant_sources(
            "conv_variants", "parent",
            os.path.join(args.parent, "zkpos_tpu_torch", "csrc"))
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
        L.zk_probe_conv.argtypes = [I, V, V, V, LL, V]
        L.zk_probe_conv.restype = I
        libs[name] = L
        text = _sass(so)
        info[name] = {"build_s": round(secs, 1), "ptxas": _resources(log),
                      "sass": {t: sass_stats(text, p_) for t, p_ in (
                          ("k_conv<1>", "k_convILi1E"),
                          ("k_conv_ring", "k_conv_ring"))
                          if p_ in text}}
    grouped = pc.FORMS.index("grouped")
    a, b = pc.inputs(pc.N, 0, "cuda")
    planes = {"random": (a, b), "column": column_digits(pc.N, "cuda")}
    runs = [(k, "column" if k in NO_LOADS else "random") for k in libs]
    out = torch.empty_like(a)

    def conv(L, x, y):
        build.check(L.zk_probe_conv(grouped, build.ptr(out), build.ptr(x),
                                    build.ptr(y), pc.N, build.stream_ptr(x)),
                    "conv_variants")
    ok, card, rel = True, smi(), {}
    for key, (x, y) in planes.items():
        plain = pc.plain_rounds("grouped", x, y)
        for name, k in runs:
            if k == key:
                conv(libs[name], x, y)
                rel[name] = max_rel_err(out, plain)
                ok = ok and rel[name] <= pc.TOL
        del plain
    times = {name: [] for name, _ in runs}
    for name, k in runs + runs[::-1]:
        L, (x, y) = libs[name], planes[k]
        conv(L, x, y)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(REPS):
            conv(L, x, y)
        e.record()
        torch.cuda.synchronize()
        times[name].append(round(s.elapsed_time(e) / REPS, 4))
    bound = (pc.N * pc.REPS * (pc.FMAS["grouped"] + 2 * pc.ND)
             / FP32_FMA_PER_S * 1e3)
    ms = {name: sum(v) / len(v) for name, v in times.items()}
    for name, k in runs:
        print(json.dumps({
            "conv_variant": name, "inputs": k, "n": pc.N, "ms": times[name],
            "share_of_bound": round(bound / ms[name], 4),
            "rel_err": rel[name], "tol": pc.TOL,
            "ptxas": info[name]["ptxas"], "sass": info[name]["sass"],
            "build_s": info[name]["build_s"], "card": card}), flush=True)
    cur, grid = ms["current"], ms["nomerge"]
    split = {"bound_ms": round(bound, 4),
             "unoverlapped_copy_ms": round(grid - ms["noload"], 4),
             "rounds_over_bound_ms": round(ms["noload"] - bound, 4),
             "ring_copy_ms": round(cur - ms["ring_noload"], 4),
             "ring_gain_ms": round(grid - cur, 4),
             "share_of_bound": round(bound / cur, 4)}
    if "parent" in ms:
        split["merge_ms"] = round(ms["parent"] - grid, 4)
        split["parent_gap_ms"] = round(ms["parent"] - bound, 4)
    print(json.dumps({"conv_split": split, "card": card}), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
