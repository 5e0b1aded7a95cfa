"""The Montgomery product stage by stage: separated against fused.

Counterpart of scripts/debug_f32p.py:27-73 (``run_kernel`` over ``k_conv``
:38, ``k_rip`` :48 and ``k_red`` :73), which ran the TPU's f32-digit
product (R = 2^272) one stage per Pallas kernel.  The port's product
(csrc/field.cuh, R = 2^256, 8 x 32-bit limbs) has the same three stages,
each a kernel of csrc/probes.cu over n elements of Fr:

* ``product``: the 8 x 8-limb schoolbook product into 16 limbs (k_conv);
* ``reduce``: the Montgomery reduction of 16 limbs to 8, fully reduced
  (the reduction half of k_red);
* ``cios``: the fused CIOS ``ff::mul<Fr>`` of field.cuh, which the main
  path runs (k_red: convolution and reduction in one kernel).

There is no counterpart of ``k_rip``: the TPU's digits carried lazily and
needed carry-ripple passes, while here every limb step resolves its carry
in the 64-bit accumulator.  Each stage is held bit for bit against its
plain version, and the card checks cios == reduce(product) on every
element.  Bound: 32-bit multiplies (128 for the product, 136 for the
reduction, 264 fused) at the INT32 rate, or bytes; separated, the 16-limb
intermediate goes through device memory twice, which is the cost the
timing puts beside the fused kernel's.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..utils import build
from ..utils.device import resolve
from . import common as C

N = 1 << 24
CHECK_N = 1 << 16
STAGES = ("product", "reduce", "cios")
REPLACES = {"product": "scripts/debug_f32p.py:38",
            "reduce": "scripts/debug_f32p.py:73",
            "cios": "scripts/debug_f32p.py:73"}
MULS = {"product": 128, "reduce": 136, "cios": C.MULS_PER_MONT}


def _wide_to16(t: torch.Tensor) -> torch.Tensor:
    """(n, 16) int32 limbs -> (n, 32) 16-bit limbs."""
    return F._to16(t.reshape(-1, 2, 8)).reshape(-1, 32)


def _wide_from16(t16: torch.Tensor) -> torch.Tensor:
    return F._from16(t16.reshape(-1, 2, 16)).reshape(-1, 16)


def plain_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _wide_from16(F._prod16(F._to16(a), F._to16(b)))


def plain_reduce(t: torch.Tensor) -> torch.Tensor:
    r = F._cond_sub16(F._redc_raw16(_wide_to16(t), F.FR), F.FR)
    return F._from16(r)


def plain_cios(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.plain_mul(a, b, F.FR)


PLAIN = {"product": plain_product, "reduce": plain_reduce,
         "cios": plain_cios}


def stage(name: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """One stage on the card (counted as ``product_<name>``), its plain
    version on the CPU.  product / cios: a, b (n, 8) int32 -> (n, 16) /
    (n, 8); reduce: a (n, 16), a value below p * 2^256 -> (n, 8)."""
    width = 16 if name == "reduce" else 8
    ops = (a,) if name == "reduce" else (a, b)
    for t in ops:
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != width
                or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous (n, {width}) int32 rows")
    if len(ops) == 2 and a.shape != b.shape:
        raise ValueError(f"{name}: operands differ in shape")
    if C.check_device(*ops) == "cpu":
        return PLAIN[name](*ops)
    n = a.shape[0]
    out = torch.empty((n, 16 if name == "product" else 8), dtype=torch.int32,
                      device=a.device)
    build.check(build.cuda_lib().zk_probe_product(
        STAGES.index(name), build.ptr(out), build.ptr(a),
        build.ptr(b if b is not None else a), n, build.stream_ptr(a)),
        f"product_{name}")
    F.count_launch(f"product_{name}", n)
    return out


def random_fr(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n reduced elements of Fr (top limb below r's), 0, 1 and r - 1 first."""
    x = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    x[:, 7] %= 0x30644E72
    x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    x[:3] = F.ints_to_tensor([0, 1, F.FR_MOD - 1])[:min(3, n)]
    return x.to(device)


def run(device=None, log=print):
    """Times every stage at N elements and returns ``check``, which holds
    each against its plain version on the first CHECK_N (and CIOS against
    the reduction of the product on all N) and returns the rows."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(5)
    a, b = random_fr(N, gen, dev), random_fr(N, gen, dev)
    t = stage("product", a, b)
    calls = {"product": lambda: stage("product", a, b),
             "reduce": lambda: stage("reduce", t),
             "cios": lambda: stage("cios", a, b)}
    times = {s: C.time_ms(calls[s], dev, reps=5) for s in STAGES}

    def check():
        fused_eq = torch.equal(stage("cios", a, b), stage("reduce", t))
        args = {"product": (a[:CHECK_N], b[:CHECK_N]),
                "reduce": (t[:CHECK_N],), "cios": (a[:CHECK_N], b[:CHECK_N])}
        rows = []
        for s in STAGES:
            got = stage(s, *args[s])
            p, plain_ms = C.timed(lambda: PLAIN[s](*args[s]), dev)
            err = C.max_abs_err(got, p)
            if s == "cios" and not fused_eq:
                err = max(err, 1)
            words = {"product": 8 + 8 + 16, "reduce": 16 + 8, "cios": 24}[s]
            r = C.row(f"product_{s}", REPLACES[s], N, times[s], plain_ms,
                      CHECK_N, 4 * words * N, MULS[s] * N / C.INT32_OPS_PER_S,
                      err, cios_equals_reduce_of_product=fused_eq,
                      m_per_s=round(N / times[s] / 1e3, 3), device=dev.type)
            log(f"probe product_{s}: {times[s]:.3f} ms for {N}, "
                f"max_abs_err {err}, cios == reduce(product): {fused_eq}")
            rows.append(r)
        return rows
    return check
