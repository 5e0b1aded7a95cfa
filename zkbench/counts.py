"""The work the inputs need, and the chip's published peaks: the least
time a kernel's work could take, whatever implements it.

Peaks of one NVIDIA H100 SXM (data sheet; at the full 700 W): HBM3 at
3.35 TB/s; 32-bit integer multiplies at 64 lanes an SM a clock (half the
128 FP32 lanes behind the 67 TFLOP/s float32 figure) on 132 SMs at
1.98 GHz.  A Montgomery product over 8 x 32-bit limbs is 8 (16 + 1 + 16)
= 264 multiplies.  Counts as PERF.md's kernel table counts them: a
complete G1 add 12 products, a G2 add 42; the sparse Poseidon schedule at
width t: 8 (3t + t^2) + 3 R_P + (R_P - 1)(2t - 1) + t^2 products (604 at
t = 3).  Bytes: each input byte read once and each output byte written
once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .reference.host import R

HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 64 * 132 * 1.98e9
MULS_PER_PRODUCT = 8 * (16 + 1 + 16)
PRODUCTS_PER_ADD = {"g1": 12, "g2": 42}
POINT_BYTES = {"g1": 3 * 32, "g2": 6 * 32}     # projective, 32-byte coords
WINDOW_BITS = {"g1": 16, "g2": 12}
SCALAR_BITS = 254


def poseidon_products(t: int, r_p: int) -> int:
    return 8 * (3 * t + t * t) + 3 * r_p + (r_p - 1) * (2 * t - 1) + t * t


def least_seconds(muls: float, nbytes: float) -> float:
    """The larger of the operations' and the bytes' least times."""
    return max(muls / INT32_MULS_PER_S, nbytes / HBM_BYTES_PER_S)


def window_digits(z_u64: np.ndarray, c: int) -> np.ndarray:
    """(W, N) unsigned c-bit window digits, little-endian, of (N, 4)
    uint64 standard-form scalars; W = ceil(254 / c)."""
    z = np.ascontiguousarray(z_u64, dtype=np.uint64)
    W = -(-SCALAR_BITS // c)
    out = np.empty((W, z.shape[0]), dtype=np.int64)
    for w in range(W):
        word, sh = divmod(w * c, 64)
        v = z[:, word] >> np.uint64(sh)
        if sh + c > 64 and word + 1 < 4:
            v = v | (z[:, word + 1] << np.uint64(64 - sh))
        out[w] = (v & np.uint64((1 << c) - 1)).astype(np.int64)
    return out


def bucket_adds(z_u64: np.ndarray, c: int, block: int = 1 << 20) -> Dict[str, int]:
    """The segment sums' work for one MSM over these scalars at c-bit
    windows: a complete add for each non-zero digit that is not the first
    in its bucket (zero digits weigh 0 and need none).  Also the non-zero
    digits (points read) and the non-empty buckets (sums written)."""
    W = -(-SCALAR_BITS // c)
    seen = np.zeros((W, 1 << c), dtype=bool)
    nonzero = 0
    for lo in range(0, z_u64.shape[0], block):
        dig = window_digits(z_u64[lo:lo + block], c)
        nonzero += int((dig != 0).sum())
        for w in range(W):
            seen[w, dig[w]] = True
    buckets = int(seen[:, 1:].sum())
    return {"adds": nonzero - buckets, "digits": nonzero, "buckets": buckets}


def uniform_bucket_adds(n: int, c: int) -> Dict[str, float]:
    """The expected bucket_adds of n scalars uniform below r (the H
    coefficients, which only the program computes)."""
    W = -(-SCALAR_BITS // c)
    digits = buckets = 0.0
    for w in range(W):
        top = min((R - 1) >> (w * c), (1 << c) - 1)     # largest digit
        p_zero = 1.0 / (top + 1)
        digits += n * (1 - p_zero)
        buckets += top * (1 - (1 - 1.0 / (top + 1)) ** n)
    return {"adds": digits - buckets, "digits": digits, "buckets": buckets}


def seg_sums_work(parts) -> Dict[str, float]:
    """Multiplies and bytes of the segment sums, for (curve, bucket_adds)
    pairs."""
    muls = nbytes = 0.0
    for curve, w in parts:
        muls += w["adds"] * PRODUCTS_PER_ADD[curve] * MULS_PER_PRODUCT
        nbytes += (w["digits"] + w["buckets"]) * POINT_BYTES[curve]
    return {"muls": muls, "bytes": nbytes}


def poseidon_work(hashes: int, t: int = 3, r_p: int = 57) -> Dict[str, float]:
    """Multiplies and bytes of `hashes` width-t sparse-schedule hashes of
    two inputs (two 32-byte inputs read, one written)."""
    return {"muls": float(hashes) * poseidon_products(t, r_p)
            * MULS_PER_PRODUCT,
            "bytes": float(hashes) * 3 * 32}
