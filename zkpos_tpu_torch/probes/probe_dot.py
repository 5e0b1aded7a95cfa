"""The weights-first product Y = W(64, 64) @ X(64, N), chained on chip.

Counterpart of scripts/micro_probe3.py:117-159 (``k_dot``: 8 chained
products, each scaled by 1e-2; ``k_mix``: 4 x (the product, then
``x = x 1e-2 + y 1e-3`` and 16 dependent ``x = x 0.999 + 1``)), which
measured the TPU's MXU through ``pl.dot`` with the batch on the lanes.
On this card ``k_dot_ffma`` / ``k_dot_tf32`` (csrc/probes.cu) run
persistent blocks that take W once and stream X's slabs of 64 columns
through a ring of three shared-memory buffers (cp.async), each slab's
chain in place in its buffer while the next two load, Y leaving in
16-byte stores; the products two ways:

* ``ffma``: exact float32 FMAs on the FP32 pipes, a register tile of 8
  rows x 4 columns a thread (csrc/probes.cuh ``dot_tile``: 32 FMAs to 3
  shared loads), each sum over k in ascending order (bound: 128 FMAs per
  SM per clock);
* ``tf32``: the TF32 tensor cores through ``mma.sync.aligned.m16n8k8``,
  this card's matrix unit as the MXU was the TPU's, W's A fragments
  converted once a block and kept in registers, each step's output stored
  back already rounded to tf32 (bound: the bytes of X and Y, 495 TFLOP/s
  dense beside them), with the elementwise tail on the FP32 pipes.

The one probe with a library yardstick: ``torch.matmul`` over the same
chain, timed with ``torch.backends.cuda.matmul.allow_tf32`` False (beside
the FFMA rows) and True (beside the TF32 rows).  It is never the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field as F
from ..utils import build
from ..utils.device import resolve
from . import common as C

NF = 64
N = 1 << 22
KINDS = ("dot", "mix")
ROUTES = ("ffma", "tf32")
REPLACES = {"dot": "scripts/micro_probe3.py:117",
            "mix": "scripts/micro_probe3.py:146"}
# Against the plain version (float64 products rounded to f32 at each step
# of the chain), each limit held to what the product alone can err by.
# FFMA sums 64 products of one sign in f32: 64 x 2^-24 = 4e-6 of a product
# at worst, far less in practice.  TF32 rounds both operands to 10 bits:
# each product within 2^-10 = 1e-3, and k_dot's 8 chained products within
# 8 x 2^-10 = 7.8e-3.  In k_mix the last product is a small part of the
# output (y 1e-3 is about 0.5 beside x = 16.5 after the tail, 4 % at the
# most for the largest row of W), so its 2^-10 moves the output by 4e-5 at
# most: the TF32 mix limit is 1e-4, and a product wrong by 0.3 % fails it.
TOL = {("dot", "ffma"): 1e-5, ("dot", "tf32"): 1e-2,
       ("mix", "ffma"): 1e-5, ("mix", "tf32"): 1e-4}


def plain_chain(kind: str, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The chain with each product summed in float64 and rounded to f32,
    the elementwise steps in f32 as the kernel does them."""
    w64 = w.double()
    for _ in range(8 if kind == "dot" else 4):
        y = (w64 @ x.double()).float()
        if kind == "dot":
            x = y * 1e-2
        else:
            x = x * 1e-2 + y * 1e-3
            for _ in range(16):
                x = x * 0.999 + 1.0
    return x


def library_chain(kind: str, w: torch.Tensor, x: torch.Tensor):
    """The same chain through torch.matmul (the yardstick)."""
    for _ in range(8 if kind == "dot" else 4):
        y = torch.matmul(w, x)
        if kind == "dot":
            x = y * 1e-2
        else:
            x = x * 1e-2 + y * 1e-3
            for _ in range(16):
                x = x * 0.999 + 1.0
    return x


def chain(kind: str, route: str, w: torch.Tensor,
          x: torch.Tensor) -> torch.Tensor:
    """k_dot_<route> on the card (counted as ``dot_<kind>_<route>``),
    plain_chain on the CPU.  w (64, 64), x (64, n) float32, n a multiple
    of 64."""
    if (w.dtype != torch.float32 or x.dtype != torch.float32
            or w.shape != (NF, NF) or x.dim() != 2 or x.shape[0] != NF
            or x.shape[1] % 64 or not w.is_contiguous()
            or not x.is_contiguous()):
        raise ValueError("chain takes w (64, 64) and x (64, n) contiguous "
                         "float32, n a multiple of 64")
    if C.check_device(w, x) == "cpu":
        return plain_chain(kind, w, x)
    y = torch.empty_like(x)
    name = f"dot_{kind}_{route}"
    build.check(build.cuda_lib().zk_probe_dot(
        ROUTES.index(route), KINDS.index(kind), build.ptr(y), build.ptr(w),
        build.ptr(x), x.shape[1], build.stream_ptr(x)), name)
    F.count_launch(name, x.shape[1])
    return y


def inputs(n: int, seed: int, device):
    """W and X uniform in [0, 1), as the TPU probe made them."""
    rng = np.random.default_rng(seed)
    w = rng.random((NF, NF), np.float32)
    x = rng.random((NF, n), np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(x).to(device)


def fmas(kind: str, n: int):
    """(matrix FMAs, elementwise FP32 operations) of one chain."""
    if kind == "dot":
        return 8 * NF * NF * n, 8 * NF * n
    return 4 * NF * NF * n, 4 * NF * n * (2 + 16)


def run(device=None, log=print):
    """Times both chains by both routes (and torch.matmul over them) at N
    columns and returns ``check``, which holds each against its plain
    version and returns the rows."""
    dev = resolve(device)
    w, x = inputs(N, 0, dev)
    lib, times = {}, {}
    for kind in KINDS:
        if dev.type == "cuda":
            saved = torch.backends.cuda.matmul.allow_tf32
            try:
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    lib[kind, tf32] = C.time_ms(
                        lambda: library_chain(kind, w, x), dev, reps=3)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        for route in ROUTES:
            times[kind, route] = C.time_ms(lambda: chain(kind, route, w, x),
                                           dev, reps=5)

    def check():
        rows = []
        for kind in KINDS:
            p, plain_ms = C.timed(lambda: plain_chain(kind, w, x), dev)
            mm, ew = fmas(kind, N)
            for route in ROUTES:
                k = chain(kind, route, w, x)
                ms = times[kind, route]
                peak = (C.FP32_FMA_PER_S if route == "ffma"
                        else C.TF32_FMA_PER_S)
                rel = C.max_rel_err(k, p)
                r = C.row(f"dot_{kind}_{route}", REPLACES[kind], N, ms,
                          plain_ms, N, 2 * NF * 4 * N + NF * NF * 4,
                          mm / peak + ew / C.FP32_FMA_PER_S,
                          C.max_abs_err(k, p), rel_err=rel,
                          tol=TOL[kind, route],
                          library_ms=lib.get((kind, route == "tf32")),
                          library=("torch.matmul, allow_tf32="
                                   f"{route == 'tf32'}"),
                          tflops=round(2 * mm / ms / 1e9, 3),
                          ptxas=next(iter(C.kernel_resources(
                              f"k_dot_{route}ILb{int(kind == 'mix')}E"
                          ).values()), None), device=dev.type)
                log(f"probe dot_{kind}_{route}: {ms:.3f} ms, {r['tflops']} "
                    f"TFLOP/s, library {r['library_ms']} ms, rel err "
                    f"{rel:.2e} (tol {r['tol']})")
                rows.append(r)
                del k
        return rows
    return check
