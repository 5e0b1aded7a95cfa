"""Plain PyTorch arithmetic in BN254's Fr for the benchmark's reference.

Elements are rows of 16 limbs of 16 bits, little-endian, in int64 tensors
(a product of two limbs is below 2^32, so sums of many stay exact).  Two
kinds of work:

  * modular products (Montgomery, R = 2^256, one 16-bit digit a step) for
    the Lagrange basis, with powers and a batch inverse by a product tree;
  * exact integer sums of products with no reduction at all (``wide``,
    ``normalize``, ``dot_int``): a matrix row's value sum_k coeff_k z_k is
    kept as a wide integer, and only the final dot product is reduced, once,
    in Python.

Written for this benchmark; it imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .host import R

LIMBS = 16
MASK = 0xFFFF
RINV16 = (-pow(R, -1, 1 << 16)) % (1 << 16)       # -r^-1 mod 2^16
RMONT = (1 << 256) % R
R2 = (1 << 512) % R


def limbs_of(ints: Sequence[int], device) -> torch.Tensor:
    """Python ints below 2^256 -> (N, 16) limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in ints)
    arr = np.frombuffer(raw, dtype=np.uint16).reshape(len(ints), LIMBS)
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def limbs_of_u64(rows: np.ndarray, device) -> torch.Tensor:
    """(N, 4) uint64 little-endian rows (standard form) -> (N, 16) limbs."""
    arr = np.ascontiguousarray(rows, dtype=np.uint64).view(np.uint16)
    return torch.from_numpy(arr.reshape(-1, LIMBS).astype(np.int64)).to(device)


def ints_of(t: torch.Tensor) -> List[int]:
    """(N, k) limbs below 2^16 -> Python ints."""
    cols = t.cpu().tolist()
    return [sum(v << (16 * j) for j, v in enumerate(row)) for row in cols]


def int_of_columns(cols: torch.Tensor) -> int:
    """A (k,) vector of non-negative column sums -> sum_j cols[j] 2^(16 j)."""
    return sum(int(v) << (16 * j) for j, v in enumerate(cols.cpu().tolist()))


def normalize(cols: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """(N, k) non-negative columns -> (N, k + extra) limbs below 2^16 of
    the same integers (carries propagated upwards)."""
    out = torch.nn.functional.pad(cols, (0, extra))
    for j in range(out.shape[1] - 1):
        out[:, j + 1] += out[:, j] >> 16
        out[:, j] &= MASK
    return out


def wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of (N, ka) and (N, kb) limbs, no carries:
    (N, ka + kb - 1), each column below min(ka, kb) 2^32."""
    if a.shape[1] < b.shape[1]:
        a, b = b, a
    n, ka, kb = a.shape[0], a.shape[1], b.shape[1]
    out = torch.zeros((n, ka + kb - 1), dtype=torch.int64, device=a.device)
    for i in range(kb):
        out[:, i:i + ka] += a * b[:, i:i + 1]
    return out


def _cond_sub(x: torch.Tensor, m_limbs: torch.Tensor) -> torch.Tensor:
    """x - m where x >= m, else x; x (N, 16) limbs below 2m."""
    y = x - m_limbs
    for j in range(LIMBS - 1):
        c = y[:, j] >> 16                       # floor: -1 on a borrow
        y[:, j] &= MASK
        y[:, j + 1] += c
    return torch.where((y[:, LIMBS - 1] < 0)[:, None], x, y)


def _r_limbs(device) -> torch.Tensor:
    return limbs_of([R], device)[0]


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b 2^-256 mod r for (N, 16) limbs of values below r."""
    rl = _r_limbs(a.device)
    t = torch.nn.functional.pad(wide(a, b), (0, 2))        # (N, 33)
    for i in range(LIMBS):
        m = ((t[:, i] & MASK) * RINV16) & MASK
        t[:, i:i + LIMBS] += m[:, None] * rl
        t[:, i + 1] += t[:, i] >> 16
    out = normalize(t[:, LIMBS:].contiguous())[:, :LIMBS].contiguous()
    return _cond_sub(out, rl)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod r for limbs of values below r."""
    rl = _r_limbs(a.device)
    y = a - b
    for j in range(LIMBS - 1):
        c = y[:, j] >> 16
        y[:, j] &= MASK
        y[:, j + 1] += c
    neg = y[:, LIMBS - 1] < 0
    fixed = normalize(torch.where(neg[:, None], y + rl, y), 0)
    return fixed


def const(v: int, n: int, device) -> torch.Tensor:
    return limbs_of([v % R], device).expand(n, LIMBS).contiguous()


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, const(R2, a.shape[0], a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, const(1, a.shape[0], a.device))


def powers_mont(w: int, n: int, device) -> torch.Tensor:
    """w^0 .. w^(n-1) in Montgomery form, by doubling the prefix."""
    out = const(RMONT, 1, device)
    step = w % R
    while out.shape[0] < n:
        k = out.shape[0]
        more = mont_mul(out[:min(k, n - k)],
                        const(step * RMONT % R, min(k, n - k), device))
        out = torch.cat([out, more])
        step = step * step % R
    return out


def batch_inverse_mont(x: torch.Tensor) -> torch.Tensor:
    """Inverses of Montgomery-form rows (none zero), by a product tree:
    products up the tree, one host inverse of the root, then down."""
    n = x.shape[0]
    size = 1
    while size < n:
        size *= 2
    one = const(RMONT, size - n, x.device)
    levels = [torch.cat([x, one])]
    while levels[-1].shape[0] > 1:
        lv = levels[-1]
        levels.append(mont_mul(lv[0::2].contiguous(), lv[1::2].contiguous()))
    root = ints_of(levels[-1])[0]                   # a R mod r
    a = root * pow(RMONT, -1, R) % R
    inv = limbs_of([pow(a, -1, R) * RMONT % R], x.device)
    for lv in reversed(levels[:-1]):
        nxt = torch.empty_like(lv)
        nxt[0::2] = mont_mul(inv, lv[1::2].contiguous())
        nxt[1::2] = mont_mul(inv, lv[0::2].contiguous())
        inv = nxt
    return inv[:n]


def dot_int(a: torch.Tensor, b: torch.Tensor, block: int = 1 << 20) -> int:
    """sum_i a_i b_i as an exact Python int, for (N, ka) and (N, kb) limb
    rows (each below 2^16): the columns of each block's products summed
    over its rows in int64 (below 2^63 while N min(ka, kb) < 2^31)."""
    total = 0
    for lo in range(0, a.shape[0], block):
        cols = wide(a[lo:lo + block], b[lo:lo + block]).sum(0)
        total += int_of_columns(cols)
    return total
