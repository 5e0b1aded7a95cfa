"""The 34-digit f32 convolution in three forms.

Counterpart of scripts/probe_conv.py:64-85 (``mk(f).kern``, the TPU's
Pallas kernel over ``conv_padloop`` :27, ``conv_grouped`` :35 and
``conv_triangle`` :51).  Each form computes (34, T) x (34, T) -> (67, T)
on base-256 digits held in f32, REPS = 8 rounds a load with the TPU
probe's fold back to 34 digits (``x = c[:34] 1e-7 + pad(c[34:], 1) 1e-7 +
b``) so that the rounds depend on each other.  ``padloop`` and ``grouped``
are the full 34 x 34 products summed in two orders; ``triangle`` is the
squaring from the products with i <= j.

On this card each form runs one thread per column with its 34 digits, its
34 operand digits and its 67 coefficients in registers; the planes are
(34, n) with a column's digit i at i * n + c, so a warp reads 32
neighbouring words per digit.  Padloop and triangle run ``k_conv``
(csrc/probes.cu), a block a slab of 128 columns.  Grouped runs
``k_conv_ring``: its products FMA'd straight into the coefficients, class
by class (no merge of partial sums), in persistent blocks whose threads
fetch their next column's digits into shared memory by cp.async while
the current column's rounds run (csrc/probes.cuh conv_walk).  Bound: FP32
FMAs at 128 per SM per clock (1,156 a product, 595 a squaring, plus the
fold's 68); the TPU chose digits in f32 because its f32 FMA outran its u32
multiply, and this probe measures the same trade here.  The forms stay on
the FP32 pipe: TF32 tensor cores keep 10 bits of mantissa, about 1e-3
relative after the first fold against TOL, and a column's product shares
no operand with another column's, so a matrix unit would find no reuse.

Library yardstick: one PyTorch call computes each round's convolution,
``torch.nn.functional.conv1d`` with a group a column and the column's
digits as its kernel (library_rounds), timed over the same rounds and fold
with cuDNN's TF32 off (the kernel is exact float32).  It is never the
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field as F
from ..utils import build
from ..utils.device import resolve
from . import common as C

ND, NC = 34, 67
REPS = 8
N = 1 << 22           # columns
CHECK_N = 1 << 16     # columns the plain version checks
# k_conv_ring's columns a slab and its ring's stages (csrc/probes.cuh
# kConvSlab, kConvStages)
SLAB, STAGES = 128, 2
# grouped's second check: RING_WALK slabs for each block the card holds at
# once, so that every thread walks RING_WALK columns or more and refills
# each stage of its ring (the first refill comes at a thread's column
# STAGES + 1), and RAGGED more (a ragged last slab; n not a multiple of 4)
RING_WALK, RAGGED = STAGES + 2, 37
FORMS = ("padloop", "grouped", "triangle")
# each form's kernel, as ptxas names it
KERNELS = {"padloop": "k_convILi0E", "grouped": "k_conv_ring",
           "triangle": "k_convILi2E"}
REPLACES = "scripts/probe_conv.py:65"
# FMAs of one convolution (products) in each form
FMAS = {"padloop": ND * ND, "grouped": ND * ND, "triangle": ND * (ND + 1) // 2}
# After the first round the digits are no longer integers, so rounding
# enters: nvcc contracts each product into an FMA where PyTorch rounds the
# product first.  The fold scales the coefficients by 1e-7 against b's
# digits (0 to 255), so the difference stays near one rounding of x.
TOL = 1e-5


def _pad(c: torch.Tensor, top: int, rows: int) -> torch.Tensor:
    out = c.new_zeros((rows, c.shape[1]))
    out[top:top + c.shape[0]] = c
    return out


def plain_conv(form: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One convolution in the form's summation order; (34, T) -> (67, T).
    The triangle squares a (b is not read)."""
    if form == "padloop":
        acc = None
        for i in range(ND):
            p = _pad(a[i:i + 1] * b, i, NC)
            acc = p if acc is None else acc + p
        return acc
    if form == "grouped":
        acc = None
        for r in range(8):
            s = None
            for q in range(5):
                i = 8 * q + r
                if i >= ND:
                    break
                p = _pad(a[i:i + 1] * b, 8 * q, NC)
                s = p if s is None else s + p
            t = _pad(s[:NC - r], r, NC)
            acc = t if acc is None else acc + t
        return acc
    a2 = a + a
    acc = None
    for i in range(ND):
        row = a[i:i + 1] if i == ND - 1 else torch.cat([a[i:i + 1],
                                                        a2[i + 1:]])
        p = _pad(a[i:i + 1] * row, 2 * i, NC)
        acc = p if acc is None else acc + p
    return acc


def plain_rounds(form: str, a: torch.Tensor, b: torch.Tensor):
    """REPS rounds of the form and the fold: the function of k_conv."""
    x = a
    for _ in range(REPS):
        c = plain_conv(form, x, b)
        x = c[:ND] * 1e-7 + _pad(c[ND:], 0, ND) * 1e-7 + b
    return x


def library_rounds(form: str, a: torch.Tensor, b: torch.Tensor):
    """The same rounds with each convolution one PyTorch call:
    conv1d over the columns as N groups of one channel, a column's 34
    digits of b (of x itself for the triangle's squaring) reversed as its
    kernel, padded to the 67 coefficients; the fold in PyTorch.  (34, n)
    planes in and out."""
    n = a.shape[1]
    x, bt = a.T.contiguous(), b.T.contiguous()
    wb = bt.flip(1).unsqueeze(1).contiguous()
    for _ in range(REPS):
        w = x.flip(1).unsqueeze(1) if form == "triangle" else wb
        c = torch.nn.functional.conv1d(x.unsqueeze(0), w, padding=ND - 1,
                                       groups=n)[0]
        x = (c[:, :ND] * 1e-7
             + torch.nn.functional.pad(c[:, ND:], (0, 1)) * 1e-7 + bt)
    return x.T.contiguous()


def conv_rounds(form: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """k_conv on the card (counted as ``conv_<form>``), plain_rounds on the
    CPU.  a, b: (34, n) float32."""
    for t in (a, b):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != ND
                or not t.is_contiguous()):
            raise ValueError("conv_rounds takes contiguous (34, n) float32")
    if a.shape != b.shape:
        raise ValueError("conv_rounds: a and b differ in shape")
    if C.check_device(a, b) == "cpu":
        return plain_rounds(form, a, b)
    out = torch.empty_like(a)
    n = a.shape[1]
    build.check(build.cuda_lib().zk_probe_conv(
        FORMS.index(form), build.ptr(out), build.ptr(a), build.ptr(b), n,
        build.stream_ptr(a)), f"conv_{form}")
    F.count_launch(f"conv_{form}", n)
    return out


def ring_walks(n: int, blocks: int) -> tuple[int, int]:
    """(least, most) columns a thread of k_conv_ring walks when `blocks`
    blocks share n columns: global thread g = blk * SLAB + t walks columns
    g, g + blocks * SLAB, ... below n."""
    q, rem = divmod(n, blocks * SLAB)
    return q, q + (rem > 0)


def ring_check_n(resident: int) -> tuple[int, int]:
    """grouped's second check's columns and the blocks k_conv_ring spreads
    them over, `resident` blocks fitting on the card at once."""
    n = RING_WALK * resident * SLAB + RAGGED
    return n, min(resident, -(-n // SLAB))


def inputs(n: int, seed: int, device):
    """Digits below 256, as the TPU probe made them."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 256, (2, ND, n)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def run(device=None, log=print):
    """Times every form at N columns and returns ``check``, which holds each
    against its plain version on the first CHECK_N columns and returns the
    rows."""
    dev = resolve(device)
    a, b = inputs(N, 0, dev)
    times = {form: C.time_ms(lambda: conv_rounds(form, a, b), dev, reps=5)
             for form in FORMS}
    lib = {}
    if dev.type == "cuda":
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for form in ("grouped", "triangle"):     # padloop's is grouped's
                lib[form] = C.time_ms(lambda: library_rounds(form, a, b),
                                      dev, reps=2)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        lib["padloop"] = lib["grouped"]

    # k_conv_ring's blocks resident at once (one slab a block on the CPU)
    resident = (int(build.cuda_lib().zk_probe_conv_resident())
                if dev.type == "cuda" else 1)

    def check():
        ac, bc = a[:, :CHECK_N].contiguous(), b[:, :CHECK_N].contiguous()
        rows = []
        for form in FORMS:
            ms = times[form]
            k = conv_rounds(form, ac, bc)
            p, plain_ms = C.timed(lambda: plain_rounds(form, ac, bc), dev)
            fmas = N * REPS * (FMAS[form] + 2 * ND)
            extra = {}
            if form in lib:
                saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                try:
                    extra["library_rel_err"] = C.max_rel_err(
                        library_rounds(form, ac, bc), p)
                finally:
                    torch.backends.cudnn.allow_tf32 = saved
                extra["library"] = ("torch.nn.functional.conv1d, groups=N, "
                                    "cudnn.allow_tf32=False")
            if form == "grouped":
                rn, blocks = ring_check_n(resident)
                ar, br = a[:, :rn].contiguous(), b[:, :rn].contiguous()
                rag = C.max_rel_err(conv_rounds(form, ar, br),
                                    plain_rounds(form, ar, br))
                least, most = ring_walks(rn, blocks)
                extra.update(ragged_n=rn, ragged_blocks=blocks,
                             ragged_walk=[least, most],
                             ragged_rel_err=rag, ragged_within_tol=rag <= TOL,
                             ragged_refills_ring=least >= STAGES + 1)
            r = C.row(f"conv_{form}", REPLACES, N, ms, plain_ms, CHECK_N,
                      3 * ND * 4 * N, fmas / C.FP32_FMA_PER_S,
                      C.max_abs_err(k, p), rel_err=C.max_rel_err(k, p),
                      tol=TOL, library_ms=lib.get(form), **extra,
                      mconv_per_s=round(N * REPS / ms / 1e3, 3),
                      gfma_per_s=round(fmas / ms / 1e6, 3),
                      share_of_fp32_peak=round(fmas / ms / 1e-3
                                               / C.FP32_FMA_PER_S, 4),
                      registers=C.kernel_resources(KERNELS[form]),
                      device=dev.type)
            r["ok"] = (r["ok"] and r.get("ragged_within_tol", True)
                       and r.get("ragged_refills_ring", True))
            log(f"probe conv_{form}: {r['mconv_per_s']} M conv/s, "
                f"{r['gfma_per_s']} G FMA/s, rel err {r['max_rel_err']:.2e}")
            rows.append(r)
        return rows
    return check
