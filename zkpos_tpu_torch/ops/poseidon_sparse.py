"""Poseidon(2) on the sparse-MDS schedule: the account tree's node hash.

Counterpart of zkpos_tpu/ops/poseidon_f32_pallas.py (``hash2_mont_f32p``
and its Pallas kernel ``_perm2_kernel``).  The schedule is that of
crypto/poseidon_opt.py at t = 3: constants folded onto lane 0 through the
57 partial rounds, 56 of which mix with a sparse (m00, v, w_hat) matrix
and the last with one dense matrix -- 604 Montgomery products per hash
against the plain schedule's 828.  The digest equals the plain
schedule's (crypto/poseidon_ref), bit for bit.

``hash2_mont_sparse`` launches ``zk_poseidon_sparse3`` (csrc/poseidon.cu,
launch name ``poseidon_sparse3``) for tensors on the card and runs
``plain_hash2_mont_sparse`` for tensors on the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..crypto import poseidon_opt as popt
from ..crypto.poseidon_ref import OUTPUT_INDEX
from ..utils import build
from . import field as F
from .poseidon import add16, mix16, mont_ints, mul16, sbox16, sum_mod16

T = 3
RP = 57
# entry offsets of the table (the layout csrc/poseidon.cuh reads)
C_INIT = 0
C_FULL = T
D_PARTIAL = 4 * T
C_RESUME = D_PARTIAL + RP
C_FULL2 = C_RESUME + T
SPARSE = C_FULL2 + 3 * T
ROW = 2 * T - 1
DENSE = SPARSE + (RP - 1) * ROW
MDS = DENSE + T * T
ENTRIES = MDS + T * T


@lru_cache(maxsize=None)
def table(device: str) -> torch.Tensor:
    """The sparse schedule's constants in Montgomery form, (ENTRIES, 8)."""
    p = popt.opt_params(T)
    vals = list(p["c_init"])
    vals += [v for c in p["c_full"] for v in c]
    vals += list(p["d_partial"])
    vals += list(p["c_resume"])
    vals += [v for c in p["c_full_2nd"] for v in c]
    for m00, v, w_hat in p["sparse"]:
        vals += [m00, *v, *w_hat]
    vals += [v for row in p["dense_last"] for v in row]
    vals += [v for row in p["mds"] for v in row]
    if len(vals) != ENTRIES:
        raise AssertionError("sparse Poseidon table has the wrong layout")
    return F.ints_to_tensor(mont_ints(vals), device)


@lru_cache(maxsize=None)
def _table16(device: str) -> torch.Tensor:
    return F._to16(table(device))


def plain_hash2_mont_sparse(a: torch.Tensor, b: torch.Tensor):
    """Plain version: (N, 8) x (N, 8) Montgomery rows -> (N, 8)."""
    k = _table16(str(a.device))
    mds = k[MDS:MDS + T * T].reshape(T, T, 16)
    a16 = F._to16(a)
    x = torch.stack([torch.zeros_like(a16), a16, F._to16(b)], 1)
    x = add16(x, k[C_INIT:C_INIT + T])

    def full(x, c_next):
        x = mix16(sbox16(x), mds)
        return x if c_next is None else add16(x, c_next)

    for r in range(3):
        x = full(x, k[C_FULL + T * r:C_FULL + T * (r + 1)])
    x = full(x, None)
    x = torch.cat([add16(x[:, :1], k[D_PARTIAL]), x[:, 1:]], 1)
    for i in range(RP):
        x0 = sbox16(x[:, 0])
        if i < RP - 1:
            row = k[SPARSE + ROW * i:SPARSE + ROW * (i + 1)]
            ops = torch.stack([x0, x[:, 1], x[:, 2], x0, x0], 1)
            prods = mul16(row.unsqueeze(0), ops)
            y0 = add16(sum_mod16(prods[:, :T]), k[D_PARTIAL + i + 1])
            x = torch.cat([y0[:, None], add16(x[:, 1:], prods[:, T:])], 1)
        else:
            dense = k[DENSE:DENSE + T * T].reshape(T, T, 16)
            x = mix16(torch.cat([x0[:, None], x[:, 1:]], 1), dense)
            x = add16(x, k[C_RESUME:C_RESUME + T])
    for r in range(3):
        x = full(x, k[C_FULL2 + T * r:C_FULL2 + T * (r + 1)])
    x = full(x, None)
    return F._from16(x[:, OUTPUT_INDEX])


def hash2_mont_sparse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Poseidon(a[i], b[i]) for (N, 8) int32 Montgomery rows.  a and b may
    be row-strided views with one row stride (a tree level's even and odd
    rows, ``level[0::2]`` and ``level[1::2]``), read in place."""
    for x in (a, b):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 8:
            raise ValueError("hash2_mont_sparse takes (N, 8) int32 rows")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_hash2_mont_sparse(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("operands must share one CUDA device")
    n = a.shape[0]
    stride = a.stride(0) if n > 1 else 8
    if (a.stride(1) != 1 or b.stride(1) != 1
            or (n > 1 and b.stride(0) != stride) or stride % 4
            or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("hash2_mont_sparse needs rows of 8 contiguous "
                         "limbs and one 16-byte-aligned row stride")
    out = torch.empty((n, 8), dtype=torch.int32, device=a.device)
    L = build.cuda_lib()
    build.check(L.zk_poseidon_sparse3(build.ptr(out), build.ptr(a),
                                      build.ptr(b), n, stride,
                                      build.ptr(table(str(a.device))),
                                      build.stream_ptr(a)),
                "poseidon_sparse3")
    F.count_launch("poseidon_sparse3", n)
    return out
