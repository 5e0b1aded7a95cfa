"""The latency of one Montgomery product: dependent products on one warp.

The port's own probe, with no TPU script of its own: it times the fused
product of scripts/debug_f32p.py:73 (``k_red``; here field.cuh's CIOS
``ff::mul<Fr>``) the way the chain kernel (csrc/poseidon.cu ``k_chain``)
pays for it, each product waiting on the one before, on a warp alone on
the card.  ``k_latency`` (csrc/probes.cu) runs N = 32 rows, one a thread,
each x <- x b STEPS times (``probe::mont_chain``); ``ns_per_product`` is
the launch's time over STEPS.  Set beside the chain's time over the
products its schedule puts on one lane's critical path (chip_smoke.py's
``critical_path``), it says how much of the chain is product latency and
how much is the rest (the shuffles, the shared-memory exchanges, the
adds).

The plain version computes the same a b^STEPS R^-STEPS by square and
multiply over ops/field.plain_mul (about 2 log2(STEPS) products), so the
timed launch itself is checked bit for bit.  Bound: its 32-bit multiplies
at the INT32 rate, or its bytes; a latency probe sits far above both.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..utils import build
from ..utils.device import resolve
from . import common as C
from .debug_product import random_fr

N = 32                  # rows: one warp
STEPS = 1 << 16
REPLACES = "scripts/debug_f32p.py:73"
REPS = 3


def plain_mont_chain(a: torch.Tensor, b: torch.Tensor,
                     steps: int) -> torch.Tensor:
    """a b^steps R^-steps for (n, 8) int32 Montgomery rows: STEPS
    Montgomery products by b, in O(log steps) plain products."""
    if steps == 0:
        return a.clone()
    acc = b                 # b^k R^-(k - 1), k = the bits read so far
    for bit in bin(steps)[3:]:
        acc = F.plain_mul(acc, acc, F.FR)
        if bit == "1":
            acc = F.plain_mul(acc, b, F.FR)
    return F.plain_mul(a, acc, F.FR)


def mont_chain(a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """k_latency on the card (counted as ``latency_mont``), its plain
    version on the CPU: a, b (n, 8) int32 rows, n <= 32."""
    for t in (a, b):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8
                or not t.is_contiguous()):
            raise ValueError("mont_chain: contiguous (n, 8) int32 rows")
    if a.shape != b.shape or a.shape[0] > 32:
        raise ValueError("mont_chain: equal shapes of at most 32 rows")
    if C.check_device(a, b) == "cpu":
        return plain_mont_chain(a, b, steps)
    out = torch.empty_like(a)
    build.check(build.cuda_lib().zk_probe_latency(
        build.ptr(out), build.ptr(a), build.ptr(b), a.shape[0], steps,
        build.stream_ptr(a)), "latency_mont")
    F.count_launch("latency_mont", a.shape[0])
    return out


def run(device=None, log=print):
    """Times STEPS dependent products on one warp and returns ``check``,
    which holds that launch against the plain version and returns the
    row."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(6)
    a, b = random_fr(N, gen, dev), random_fr(N, gen, dev)
    got = None

    def call():
        nonlocal got
        got = mont_chain(a, b, STEPS)
    ms = C.time_ms(call, dev, reps=REPS,
                   warm=lambda: mont_chain(a, b, min(STEPS, 64)))

    def check():
        p, plain_ms = C.timed(lambda: plain_mont_chain(a, b, STEPS), dev)
        err = C.max_abs_err(got, p)
        ns = ms * 1e6 / STEPS
        r = C.row("latency_mont", REPLACES, N, ms, plain_ms, N, 3 * 32 * N,
                  N * STEPS * C.MULS_PER_MONT / C.INT32_OPS_PER_S, err,
                  steps=STEPS, reps=REPS, ns_per_product=round(ns, 2),
                  device=dev.type)
        log(f"probe latency_mont: {STEPS} dependent products on one warp "
            f"in {ms:.3f} ms, {ns:.1f} ns a product, err {err}")
        return [r]
    return check
