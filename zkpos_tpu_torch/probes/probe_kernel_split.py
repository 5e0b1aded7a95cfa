"""Where the sparse Poseidon(2) kernel's time goes: ablated variants.

Counterpart of scripts/probe_kernel_split.py:28-127 (``build_variant(mode)
.kern``), which ran the TPU's fused ``_perm2_kernel`` with one part of its
work taken out at a time and read each part's share of the full time.
Here the kernel is the tree's node hash as it runs, csrc/poseidon.cu's
``k_sparse3`` (the sparse schedule at one hash a thread, blocks of 1,024
threads, one an SM, a block barrier at every partial round), rebuilt as
one template over a policy in csrc/probes.cuh (``probe::Sparse3``), its
kernels in csrc/probes_split.cu; the main path's kernel is left as it
is.  Variants, with the TPU mode each
stands for; the first six in k_sparse3's layout:

* ``full``: the schedule as it is; equal to ops/poseidon_sparse
  .hash2_mont_sparse bit for bit;
* ``noproduct`` (noconv): each Montgomery product replaced by one limb-wise
  multiply (the top limb cut to 28 bits, so values stay below r);
* ``noreduce`` (nomm): the 8 x 8 schoolbook product kept, the reduction
  skipped (its high half, below r);
* ``nofinalsub`` (noglue): the product without its final conditional
  subtraction, a lazy bound;
* ``noconst``: every constant-table read replaced by a value computed from
  the entry's index (``noconst_table``; no load issued, and the values
  differ by entry, so no product of the schedule can be merged);
* ``stackstate``: the state sent through a local array by a lane index the
  compiler cannot resolve, as k_plain's state is;
* ``block1024``: ``full`` in blocks of 1,024 threads without the barrier;
* ``block128``: ``full`` in blocks of 128 threads without the barrier, the
  tree hash's first layout, which the other ablations ran in before they
  moved to k_sparse3's;
* ``registers``: ``block128`` with every lane loop unrolled, so that the
  state stays in registers (``probe::sparse3_registers``);
* ``hashes2`` / ``hashes4``: the main kernel itself (hash loops unrolled)
  at two or four hashes a thread, interleaved so that each partial round
  has independent products (``k_split_hashes``).

A variant in k_sparse3's layout has at most 64 registers a thread; one
whose policy needs more spills, and its row's ptxas figures say so.  Each
variant is defined by its plain version (``plain_split``), which the
g++ rehearsal and the card hold the kernel to bit for bit, so a variant
whose body the compiler dropped cannot pass.  The run is the tree path's
first level: 2^26 pairs read in place with a row stride of 16 words, as
merkle/tree.py reads a level, each variant timed over REPS launches;
``share(mode) = (t_full - t_mode) / t_full`` as
scripts/probe_kernel_split.py:171-174 computes it.  Bound: 32-bit
multiplies at the INT32 rate (604 products a hash, each 264, 128 or 8 of
them by variant), or 96 bytes a hash.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..ops import poseidon_sparse as S
from ..utils import build
from ..utils.device import resolve
from . import common as C

MODES = ("full", "noproduct", "noreduce", "nofinalsub", "noconst",
         "stackstate", "block1024", "block128", "registers", "hashes2",
         "hashes4")
# (state through the stack, barrier each partial round, threads a block)
# of the k_split modes off k_sparse3's layout; the others: (0, 1, 1024)
LAYOUT = {"stackstate": (1, 1, 1024), "block1024": (0, 0, 1024),
          "block128": (0, 0, 128), "registers": (0, 0, 128)}
# the modes on probe::sparse3_registers (the last template flag)
REGISTERS = ("registers",)
# the modes on k_split_hashes, by hashes a thread
HASHES = {"hashes2": 2, "hashes4": 4}
REPLACES = "scripts/probe_kernel_split.py:86"
SOURCE = "zkpos_tpu_torch/csrc/probes_split.cu"
LOG_LEAVES = 27         # the tree path's leaves: 2^26 pairs at level 0
REPS = 1                # a launch of 0.08-1.8 s, after a warm-up
CHECK_N = 1 << 10
MONTS = 604             # Montgomery products of one sparse Poseidon(2)
MULS = {"full": C.MULS_PER_MONT, "noproduct": 8, "noreduce": 128,
        "nofinalsub": C.MULS_PER_MONT, "noconst": C.MULS_PER_MONT,
        "stackstate": C.MULS_PER_MONT, "block1024": C.MULS_PER_MONT,
        "block128": C.MULS_PER_MONT, "registers": C.MULS_PER_MONT,
        "hashes2": C.MULS_PER_MONT, "hashes4": C.MULS_PER_MONT}
M32 = 0xFFFFFFFF
# probes.cuh's PNoConst: limb i of entry e is (8 e + i + 1) * NOCONST_MUL
NOCONST_MUL = 0x9E3779B1


# --- plain versions: 16-bit limb rows, the kernel's arithmetic exactly ------

def add_any16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ff::add<Fr> on any 256-bit operands: the sum, less r when it is at
    least r, modulo 2^256."""
    z = torch.zeros_like(a[..., :1])
    s = F._norm(torch.cat([a + b, z], -1))                  # 17 limbs
    rmp = F._tables(F.FR, str(a.device))[4]                 # R - r
    v = F._norm(torch.cat([s + torch.cat([rmp, rmp[:1] * 0]), z], -1))
    return torch.where((v[..., 16:] != 0).any(-1, keepdim=True),
                       v[..., :16], s[..., :16])


def _limbwise16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a32 = a[..., 0::2] | (a[..., 1::2] << 16)
    b32 = b[..., 0::2] | (b[..., 1::2] << 16)
    p = (a32 * (b32 & 0xFFFF) + (((a32 * (b32 >> 16)) & 0xFFFF) << 16)) & M32
    p[..., 7] &= 0x0FFFFFFF
    return torch.stack([p & 0xFFFF, p >> 16], -1).reshape(a.shape)


def _mul_of(mode: str):
    """The variant's product on (B, 16) limb rows."""
    if mode == "noproduct":
        return _limbwise16
    if mode == "noreduce":
        return lambda a, b: F._prod16(a, b)[:, 16:]
    if mode == "nofinalsub":
        return lambda a, b: F._redc_raw16(F._prod16(a, b), F.FR)
    return lambda a, b: F._mul16(a, b, F.FR)


def noconst_table(entries: int) -> torch.Tensor:
    """The values PNoConst computes in place of the table's entries, as
    (entries, 8) int32 rows (the top limb cut to 28 bits)."""
    w = torch.arange(1, 8 * entries + 1, dtype=torch.int64).reshape(-1, 8)
    v = (w * NOCONST_MUL) & M32
    v[:, 7] &= 0x0FFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _table16(mode: str, device: str) -> torch.Tensor:
    k = S._table16(device)
    if mode == "noconst":
        return F._to16(noconst_table(k.shape[0]).to(device))
    return k


def plain_split(mode: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The variant's Poseidon(a[i], b[i]) for (N, 8) int32 Montgomery rows:
    probe::Sparse3's schedule step by step, each mix a running sum of
    products as the kernel adds them."""
    K = _table16(mode, str(a.device))
    mul16 = _mul_of(mode)
    L = S.Layout(S.T)
    T = L.t

    def mul(c, v):
        return mul16(c.expand_as(v).contiguous(), v)

    def sbox(v):
        v2 = mul16(v, v)
        return mul16(mul16(v2, v2), v)

    def fma(acc, c, v):
        return add_any16(acc, mul(c, v))

    def mix(x, M):
        out = []
        for i in range(T):
            acc = torch.zeros_like(x[0])
            for j in range(T):
                acc = fma(acc, M[T * i + j], x[j])
            out.append(acc)
        return out

    def full(x, c_next):
        x = mix([sbox(v) for v in x], K[L.mds:])
        if c_next is not None:
            x = [add_any16(v, c_next[i].expand_as(v)) for i, v in
                 enumerate(x)]
        return x

    a16 = F._to16(a)
    x = [torch.zeros_like(a16), a16, F._to16(b)]
    x = [add_any16(v, K[L.c_init + i].expand_as(v)) for i, v in enumerate(x)]
    for r in range(4):
        x = full(x, K[L.c_full(r):] if r < 3 else None)
    x[0] = add_any16(x[0], K[L.d_partial].expand_as(x[0]))
    for i in range(L.rp):
        x[0] = sbox(x[0])
        if i < L.rp - 1:
            row = K[L.rows + L.row * i:]
            x0 = torch.zeros_like(x[0])
            for j in range(T):
                x0 = fma(x0, row[j], x[j])
            for j in range(1, T):
                x[j] = fma(x[j], row[T - 1 + j], x[0])
            x[0] = add_any16(x0, K[L.d_partial + i + 1].expand_as(x0))
        else:
            x = mix(x, K[L.dense:])
            x = [add_any16(v, K[L.c_resume + j].expand_as(v))
                 for j, v in enumerate(x)]
    for r in range(4):
        x = full(x, K[L.c_full2(r):] if r < 3 else None)
    return F._from16(x[1])


# --- the kernel -----------------------------------------------------------------

def split_hash(mode: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """k_split on the card (counted as ``split_<mode>``), plain_split on
    the CPU.  a, b as hash2_mont_sparse takes them: (N, 8) int32 rows,
    possibly strided views of one level."""
    for x in (a, b):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 8:
            raise ValueError("split_hash takes (N, 8) int32 rows")
    if a.shape != b.shape:
        raise ValueError("split_hash: a and b differ in shape")
    if C.check_device(a, b) == "cpu":
        return plain_split(mode, a, b)
    n = a.shape[0]
    stride = a.stride(0) if n > 1 else 8
    if (a.stride(1) != 1 or b.stride(1) != 1
            or (n > 1 and b.stride(0) != stride) or stride % 4
            or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("split_hash needs rows of 8 contiguous limbs and "
                         "one 16-byte-aligned row stride")
    out = torch.empty((n, 8), dtype=torch.int32, device=a.device)
    build.check(build.cuda_lib().zk_probe_split(
        MODES.index(mode), build.ptr(out), build.ptr(a), build.ptr(b), n,
        stride, build.ptr(S.table(str(a.device))), 0, build.stream_ptr(a)),
        f"split_{mode}")
    F.count_launch(f"split_{mode}", n)
    return out


def random_level(n: int, seed: int, device) -> torch.Tensor:
    """n reduced rows (top limb below r's), made on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    for j in range(8):
        hi = 0x30644E72 if j == 7 else 1 << 32
        col = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int64,
                            device=device)
        out[:, j] = torch.where(col >= 1 << 31, col - (1 << 32), col)
    return out


def _policy(mode: str) -> str:
    return {"noproduct": "PNoProduct", "noreduce": "PNoReduce",
            "nofinalsub": "PNoFinalSub", "noconst": "PNoConst"}.get(
                mode, "PFull")


def run(device=None, log=print):
    """Times every variant over the tree path's first level and returns
    ``check``, which holds each against its plain version (and ``full``
    against the main path's kernel) and returns the rows: its launches
    are not the probe's (probes.run_probe reads the counts between)."""
    dev = resolve(device)
    level = random_level(1 << LOG_LEAVES, 9, dev)
    a, b = level[0::2], level[1::2]
    n = a.shape[0]
    warm = min(n, 1 << 16)
    times = {m: C.time_ms(lambda: split_hash(m, a, b), dev, reps=REPS,
                          warm=lambda: split_hash(m, a[:warm], b[:warm]))
             for m in MODES}

    def check():
        full_eq = torch.equal(split_hash("full", a, b),
                              S.hash2_mont_sparse(a, b))
        ac, bc = a[:CHECK_N], b[:CHECK_N]
        ptxas = C.kernel_resources("k_split")
        rows = []
        t_full = times["full"]
        for m in MODES:
            got = split_hash(m, ac, bc)
            p, plain_ms = C.timed(lambda: plain_split(m, ac, bc), dev)
            err = C.max_abs_err(got, p)
            if m == "full" and not full_eq:
                err = max(err, 1)
            stack, sync, block = LAYOUT.get(m, (0, 1, 1024))
            key = (f"k_split_hashesILi{HASHES[m]}E" if m in HASHES else
                   f"{_policy(m)}ELb{stack}ELb{sync}ELi{block}ELb"
                   f"{int(m in REGISTERS)}E")
            res = {k: v for k, v in ptxas.items() if key in k}
            r = C.row(f"split_{m}", REPLACES, n, times[m], plain_ms, CHECK_N,
                      96 * n, MONTS * MULS[m] * n / C.INT32_OPS_PER_S, err,
                      reps=REPS, mhash_per_s=round(n / times[m] / 1e3, 3),
                      share=round((t_full - times[m]) / t_full, 4),
                      full_equals_main_kernel=full_eq, source=SOURCE,
                      ptxas=next(iter(res.values()), None), device=dev.type)
            log(f"probe split_{m}: {r['mhash_per_s']} M hashes/s, share "
                f"{100 * r['share']:.1f} %, ptxas {r['ptxas']}, err {err}")
            rows.append(r)
        return rows
    return check
