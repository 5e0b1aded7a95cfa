"""BN254 Fr / Fp arithmetic on tensors: the wrappers of csrc/fr_kernels.cu
and their plain PyTorch versions.

Counterpart of zkpos_tpu/ops/fd32.py (the FR and FP engines).  The number
format differs on purpose: an element is 8 little-endian 32-bit limbs held
in an ``int32`` tensor of shape (N, 8), in Montgomery form with R = 2^256,
always fully reduced.  The native solver's (N, 4) uint64 rows are a
zero-copy view of the same bytes.

Each wrapper launches its CUDA kernel for tensors on the card (and raises
if it cannot), and runs the plain version for tensors on the CPU.  The
plain versions work on 16 limbs of 16 bits in int64 tensors so that every
product and column sum is exact; they run on any device, which is how
chip_smoke.py holds the kernels against them on the card.
"""

from __future__ import annotations

from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from ..crypto.bn254 import P as FP_MOD, R as FR_MOD
from ..utils import build

FR, FP = 0, 1
MODULI = (FR_MOD, FP_MOD)
RMONT = 1 << 256

# kernel launches by kernel name, and the largest launch (elements) seen
# by each: chip_smoke.py resets both before the main path and reads them
# after it
LAUNCHES: Counter = Counter()
SIZES: Counter = Counter()


def count_launch(name: str, n: int) -> None:
    LAUNCHES[name] += 1
    SIZES[name] = max(SIZES[name], int(n))

_M16 = 0xFFFF
_PLAIN_CHUNK = 1 << 18


# --- host <-> tensor conversions ----------------------------------------------

def ints_to_tensor(values, device="cpu") -> torch.Tensor:
    """Python ints (already reduced) -> (N, 8) int32 limb rows."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, dtype=np.int32).reshape(-1, 8).copy()
    return torch.from_numpy(arr).to(device)


def tensor_to_ints(t: torch.Tensor) -> list:
    arr = t.detach().to("cpu").contiguous().numpy().reshape(-1, 8)
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


def u64_to_tensor(rows: np.ndarray, device="cpu") -> torch.Tensor:
    """(N, 4) uint64 standard-form rows (native solver output) -> (N, 8)."""
    arr = np.ascontiguousarray(rows, dtype=np.uint64).view(np.int32)
    return torch.from_numpy(arr.reshape(-1, 8).copy()).to(device)


def const(v: int, field: int = FR, device="cpu", mont: bool = True):
    """One element as a (1, 8) tensor, in Montgomery form unless mont=False."""
    m = MODULI[field]
    return ints_to_tensor([(v * RMONT) % m if mont else v % m], device)


def to_mont(x: torch.Tensor, field: int = FR) -> torch.Tensor:
    """Standard form (any value below 2^256) -> Montgomery form."""
    return mul(x, const(pow(RMONT, 2, MODULI[field]), field, x.device,
                        mont=False), field)


def from_mont(x: torch.Tensor, field: int = FR) -> torch.Tensor:
    return mul(x, const(1, field, x.device, mont=False), field)


# --- plain versions: 16 x 16-bit limbs in int64 -------------------------------

def _to16(x: torch.Tensor) -> torch.Tensor:
    y = x.long() & 0xFFFFFFFF
    return torch.stack([y & _M16, y >> 16], dim=-1).reshape(
        *x.shape[:-1], 16)


def _from16(y: torch.Tensor) -> torch.Tensor:
    y = y.reshape(*y.shape[:-1], 8, 2)
    v = y[..., 0] | (y[..., 1] << 16)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _limbs16(v: int, n: int = 16):
    return [(v >> (16 * i)) & _M16 for i in range(n)]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Exact carry normalization of non-negative lazy limbs, modulo
    2^(16 K): carry passes until no limb but the top one carries (a few
    passes for the bounds used here; the top carry is dropped)."""
    x = x.clone()
    while True:
        hi = x >> 16
        if not bool(hi[..., :-1].any()):
            return x & _M16
        x &= _M16
        x[..., 1:] += hi[..., :-1]


@lru_cache(maxsize=None)
def _tables(field: int, device: str):
    p = MODULI[field]
    nprime = (-pow(p, -1, RMONT)) % RMONT
    pl, nl = _limbs16(p), _limbs16(nprime)
    skew = torch.zeros(256, 32, dtype=torch.float64)
    ntoep = torch.zeros(16, 16, dtype=torch.float64)
    ptoep = torch.zeros(16, 32, dtype=torch.float64)
    for i in range(16):
        for j in range(16):
            skew[16 * i + j, i + j] = 1.0
            if i + j < 16:
                ntoep[i, i + j] = nl[j]
            ptoep[i, i + j] = pl[j]
    dev = torch.device(device)
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return (skew.to(dev), ntoep.to(dev), ptoep.to(dev), as_t(pl),
            as_t(_limbs16(RMONT - p)))


def _cond_sub16(r: torch.Tensor, field: int) -> torch.Tensor:
    """r (…, 16) canonical limbs with value below 2p -> r mod p."""
    rmp = _tables(field, str(r.device))[4]
    s = torch.cat([r + rmp, torch.zeros_like(r[..., :1])], dim=-1)
    s = _norm(s)
    return torch.where(s[..., 16:17] == 1, s[..., :16], r)


def _prod16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b as 32 canonical 16-bit limbs, for canonical (N, 16) limb rows.
    The column sums run as float64 matmuls: every partial sum is an
    integer below 2^37, so they are exact."""
    skew = _tables(FR, str(a.device))[0]
    n = a.shape[0]
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(n, 256)
    return _norm((prod.double() @ skew).long())


def _redc_raw16(t: torch.Tensor, field: int) -> torch.Tensor:
    """(t + m*p) / R mod 2^256 for 32 canonical limbs t, m = -t/p mod R:
    the Montgomery reduction before its conditional subtraction (below 2p
    for t < p*R)."""
    _, ntoep, ptoep, _, _ = _tables(field, str(t.device))
    m = _norm((t[:, :16].double() @ ntoep).long())    # t*(-1/p) mod R
    u = _norm(t + (m.double() @ ptoep).long())        # t + m*p = 0 mod R
    return u[:, 16:]


def _mul16(a: torch.Tensor, b: torch.Tensor, field: int) -> torch.Tensor:
    """Montgomery product a*b/R mod p of canonical 16-bit limb rows."""
    return _cond_sub16(_redc_raw16(_prod16(a, b), field), field)


def _flat2(a: torch.Tensor, b: torch.Tensor):
    a2, b2 = a.reshape(-1, 8), b.reshape(-1, 8)
    n = max(a2.shape[0], b2.shape[0])
    return a2.expand(n, 8), b2.expand(n, 8), n


def plain_mul(a: torch.Tensor, b: torch.Tensor, field: int = FR):
    a2, b2, n = _flat2(a, b)
    outs = [_from16(_mul16(_to16(a2[i:i + _PLAIN_CHUNK]),
                           _to16(b2[i:i + _PLAIN_CHUNK]), field))
            for i in range(0, n, _PLAIN_CHUNK)]
    return torch.cat(outs) if outs else a2.new_empty((0, 8))


def _add16(a, b, field):
    s = torch.cat([a + b, torch.zeros_like(a[..., :1])], dim=-1)
    return _cond_sub16(_norm(s)[..., :16], field)


def _sub16(a, b, field):
    # a - b + p + R, with R - 1 - b limb-wise: no limb goes negative
    p16 = _tables(field, str(a.device))[3]
    s = a + p16 + (_M16 - b)
    s[..., 0] += 1
    s = torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1)
    return _cond_sub16(_norm(s)[..., :16], field)


def plain_add(a, b, field: int = FR):
    a2, b2, _ = _flat2(a, b)
    return _from16(_add16(_to16(a2), _to16(b2), field))


def plain_sub(a, b, field: int = FR):
    a2, b2, _ = _flat2(a, b)
    return _from16(_sub16(_to16(a2), _to16(b2), field))


def plain_pow(a: torch.Tensor, e: int, field: int = FR):
    acc = const(1, field, a.device).expand(a.shape[0], 8)
    for bit in range(255, -1, -1):
        acc = plain_mul(acc, acc, field)
        if (e >> bit) & 1:
            acc = plain_mul(acc, a, field)
    return acc


# --- kernel wrappers ------------------------------------------------------------

def _check_fe(*ts):
    for t in ts:
        if t.dtype != torch.int32 or t.shape[-1] != 8 or not t.is_contiguous():
            raise ValueError("field tensors must be contiguous int32 (N, 8)")


def _binary(op: int, name: str, plain, a, b, field):
    _check_fe(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(a, b, field)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("operands must share one CUDA device")
    na, nb = a.shape[0], b.shape[0]
    n = max(na, nb)
    if na not in (1, n) or nb not in (1, n):
        raise ValueError(f"cannot broadcast {tuple(a.shape)} with "
                         f"{tuple(b.shape)}")
    out = torch.empty((n, 8), dtype=torch.int32, device=a.device)
    L = build.cuda_lib()
    build.check(L.zk_ff_binary(op, field, build.ptr(out), build.ptr(a),
                               build.ptr(b), n, int(na == n), int(nb == n),
                               build.stream_ptr(a)), name)
    count_launch(name, n)
    return out


def mul(a, b, field: int = FR):
    """Montgomery product; either operand may be a single (1, 8) row."""
    return _binary(0, "ff_mul", plain_mul, a, b, field)


def add(a, b, field: int = FR):
    return _binary(1, "ff_add", plain_add, a, b, field)


def sub(a, b, field: int = FR):
    return _binary(2, "ff_sub", plain_sub, a, b, field)


def power(a: torch.Tensor, e: int, field: int = FR) -> torch.Tensor:
    """a^e elementwise (Montgomery in and out); e = p - 2 inverts."""
    _check_fe(a)
    if a.device.type == "cpu":
        return plain_pow(a, e, field)
    dev = a.device
    out = torch.empty_like(a)
    et = ints_to_tensor([e], dev)
    one = const(1, field, dev)
    L = build.cuda_lib()
    build.check(L.zk_ff_pow(field, build.ptr(out), build.ptr(a),
                            build.ptr(et), build.ptr(one), a.shape[0],
                            build.stream_ptr(a)), "ff_pow")
    count_launch("ff_pow", a.shape[0])
    return out


def inverse(a: torch.Tensor, field: int = FR) -> torch.Tensor:
    return power(a, MODULI[field] - 2, field)


# --- NTT stage -----------------------------------------------------------------

def _bfly_index(n: int, half: int, device):
    k = torch.arange(n // 2, device=device)
    j = k & (half - 1)
    i0 = ((k - j) << 1) + j
    return j, i0, i0 + half


def plain_ntt_stage(a: torch.Tensor, tw: torch.Tensor, half: int,
                    tw_step: int) -> torch.Tensor:
    """One DIT stage over bit-reversed input (Fr, Montgomery): returns the
    new array."""
    j, i0, i1 = _bfly_index(a.shape[0], half, a.device)
    t = plain_mul(tw[j * tw_step], a[i1])
    out = torch.empty_like(a)
    out[i0] = plain_add(a[i0], t)
    out[i1] = plain_sub(a[i0], t)
    return out


def ntt_stage(a: torch.Tensor, tw: torch.Tensor, half: int,
              tw_step: int) -> None:
    """In place: a[i0] += w*a[i1], a[i1] = a[i0] - w*a[i1] for every
    butterfly of the stage with the given half-width; w = tw[j*tw_step]."""
    _check_fe(a, tw)
    if a.device.type == "cpu":
        a.copy_(plain_ntt_stage(a, tw, half, tw_step))
        return
    L = build.cuda_lib()
    build.check(L.zk_ntt_stage(build.ptr(a), build.ptr(tw), a.shape[0],
                               half, tw_step, build.stream_ptr(a)),
                "ntt_stage")
    count_launch("ntt_stage", a.shape[0])


# --- the QAP row evaluation ------------------------------------------------------

def _reduce_wide16(s: torch.Tensor, field: int) -> torch.Tensor:
    """Lazy non-negative limbs (N, K > 16), each below 2^62 -> value mod p
    as 16 canonical limbs, by folding the part above 2^256 back with
    2^256 mod p until it vanishes."""
    p = MODULI[field]
    fold = torch.tensor(_limbs16(RMONT % p), dtype=torch.int64,
                        device=s.device)
    k = s.shape[-1]
    s = _norm(s)
    while bool((s[:, 16:] != 0).any()):
        hi = s[:, 16:]                                    # (N, k - 16)
        add = torch.zeros_like(s)
        for h in range(k - 16):
            add[:, h:h + 16] += hi[:, h:h + 1] * fold
        s = _norm(torch.cat([s[:, :16], torch.zeros_like(hi)], -1) + add)
    r = s[:, :16]
    for _ in range(RMONT // p):
        r = _cond_sub16(r, field)
    return r


def plain_csr_eval(row: torch.Tensor, col: torch.Tensor, cid: torch.Tensor,
                   pool: torch.Tensor, x: torch.Tensor,
                   nrows: int) -> torch.Tensor:
    out16 = torch.zeros((nrows, 20), dtype=torch.int64, device=x.device)
    if col.shape[0]:
        prods = plain_mul(pool[cid.long()], x[col.long()])
        out16[:, :16].index_add_(0, row.long(), _to16(prods))
    return _from16(_reduce_wide16(out16, FR))


def csr_eval(row: torch.Tensor, col: torch.Tensor, cid: torch.Tensor,
             pool: torch.Tensor, x: torch.Tensor, nrows: int) -> torch.Tensor:
    """out[r] = sum over the terms t with row[t] = r of
    pool[cid[t]] * x[col[t]] (Fr, Montgomery), for r < nrows; rows with no
    term are 0.  row, col, cid: (T,) int32, the terms sorted by row (every
    row below nrows)."""
    _check_fe(pool, x)
    if x.device.type == "cpu":
        return plain_csr_eval(row, col, cid, pool, x, nrows)
    for t in (row, col, cid):
        if (t.dtype != torch.int32 or t.device != x.device
                or not t.is_contiguous() or t.shape != col.shape):
            raise ValueError("csr terms: contiguous int32 row, col and cid "
                             "of one length, on the operand's device")
    out = torch.empty((nrows, 8), dtype=torch.int32, device=x.device)
    L = build.cuda_lib()
    T = col.shape[0]
    chunks = L.zk_csr_chunks(T)
    crow = torch.empty((2 * chunks,), dtype=torch.int32, device=x.device)
    cval = torch.empty((2 * chunks, 8), dtype=torch.int32, device=x.device)
    build.check(L.zk_csr_eval(build.ptr(out), build.ptr(row),
                              build.ptr(col), build.ptr(cid),
                              build.ptr(pool), build.ptr(x), nrows, T,
                              build.ptr(crow), build.ptr(cval),
                              build.stream_ptr(x)), "csr_eval")
    count_launch("csr_eval", T)
    return out


# --- helpers built on the wrappers ------------------------------------------------

def powers(base: int, n: int, device, start: int = 1,
           field: int = FR) -> torch.Tensor:
    """[start * base^i for i < n] in Montgomery form, by doubling: log2(n)
    multiply launches."""
    m = MODULI[field]
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    if n == 0:
        return out
    out[0:1] = const(start, field, device)
    have, step = 1, base % m
    while have < n:
        k = min(have, n - have)
        out[have:have + k] = mul(out[:k], const(step, field, device), field)
        have += k
        step = step * step % m
    return out
