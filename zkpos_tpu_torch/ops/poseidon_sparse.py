"""Poseidon on the sparse-MDS schedule: the account tree's node hash at
t = 3, and the tables of every width that the hash chains run on.

Counterpart of zkpos_tpu/ops/poseidon_f32_pallas.py (``hash2_mont_f32p``
and its Pallas kernel ``_perm2_kernel``).  The schedule is that of
crypto/poseidon_opt.py: constants folded onto lane 0 through the R_P
partial rounds, all but the last of which mix with a sparse (m00, v,
w_hat) matrix and the last with one dense matrix -- at t = 3, 604
Montgomery products per hash against the plain schedule's 828; at t = 17,
5,424 against 22,576.  The digest equals the plain schedule's
(crypto/poseidon_ref), bit for bit.

``hash2_mont_sparse`` launches ``zk_poseidon_sparse3`` (csrc/poseidon.cu,
launch name ``poseidon_sparse3``, one hash a thread) for tensors
on the card and runs ``plain_hash2_mont_sparse`` for tensors on the CPU.
``table(device, t)`` is the constant table csrc/poseidon.cuh reads at
width t (``struct Sparse``; the chain kernel stages it in shared memory),
and ``plain_permute_sparse`` the schedule over it in plain PyTorch.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..crypto import poseidon_opt as popt
from ..crypto.poseidon_params import partial_rounds
from ..crypto.poseidon_ref import OUTPUT_INDEX
from ..utils import build
from . import field as F
from .poseidon import add16, mix16, mont_ints, mul16, sbox16, sum_mod16

# the tree's width
T = 3


class Layout:
    """Entry offsets of the width-t table (poseidon.cuh ``struct Sparse``):
    c_init (t) | c_full (3 x t) | d_partial (R_P) | c_resume (t) |
    c_full_2nd (3 x t) | rows (R_P - 1 x (m00, v, w_hat)) | dense_last
    (t x t) | mds (t x t)."""

    def __init__(self, t: int):
        self.t = t
        self.rp = partial_rounds(t)
        self.c_init = 0
        self.d_partial = 4 * t
        self.c_resume = 4 * t + self.rp
        self.rows = 8 * t + self.rp
        self.row = 2 * t - 1
        self.dense = self.rows + (self.rp - 1) * self.row
        self.mds = self.dense + t * t
        self.entries = self.mds + t * t

    def c_full(self, r: int) -> int:
        return self.t * (1 + r)

    def c_full2(self, r: int) -> int:
        return self.t * (5 + r) + self.rp


@lru_cache(maxsize=None)
def table(device: str, t: int = T) -> torch.Tensor:
    """The width-t sparse schedule's constants in Montgomery form,
    (Layout(t).entries, 8)."""
    p = popt.opt_params(t)
    vals = list(p["c_init"])
    vals += [v for c in p["c_full"] for v in c]
    vals += list(p["d_partial"])
    vals += list(p["c_resume"])
    vals += [v for c in p["c_full_2nd"] for v in c]
    for m00, v, w_hat in p["sparse"]:
        vals += [m00, *v, *w_hat]
    vals += [v for row in p["dense_last"] for v in row]
    vals += [v for row in p["mds"] for v in row]
    if len(vals) != Layout(t).entries:
        raise AssertionError("sparse Poseidon table has the wrong layout")
    return F.ints_to_tensor(mont_ints(vals), device)


@lru_cache(maxsize=None)
def _table16(device: str, t: int = T) -> torch.Tensor:
    return F._to16(table(device, t))


def plain_sparse_rounds16(x: torch.Tensor) -> torch.Tensor:
    """The sparse schedule on (B, t, 16) limbs in Montgomery form."""
    t = x.shape[1]
    L = Layout(t)
    k = _table16(str(x.device), t)
    mds = k[L.mds:L.mds + t * t].reshape(t, t, 16)
    x = add16(x, k[L.c_init:L.c_init + t])

    def full(x, c_next):
        x = mix16(sbox16(x), mds)
        return x if c_next is None else add16(x, k[c_next:c_next + t])

    for r in range(3):
        x = full(x, L.c_full(r))
    x = full(x, None)
    x = torch.cat([add16(x[:, :1], k[L.d_partial]), x[:, 1:]], 1)
    for i in range(L.rp):
        x0 = sbox16(x[:, :1])
        if i < L.rp - 1:
            row = k[L.rows + L.row * i:L.rows + L.row * (i + 1)]
            ops = torch.cat([x0, x[:, 1:], x0.expand(-1, t - 1, -1)], 1)
            prods = mul16(row.unsqueeze(0), ops)
            y0 = add16(sum_mod16(prods[:, :t]), k[L.d_partial + i + 1])
            x = torch.cat([y0[:, None], add16(x[:, 1:], prods[:, t:])], 1)
        else:
            dense = k[L.dense:L.dense + t * t].reshape(t, t, 16)
            x = mix16(torch.cat([x0, x[:, 1:]], 1), dense)
            x = add16(x, k[L.c_resume:L.c_resume + t])
    for r in range(3):
        x = full(x, L.c_full2(r))
    return full(x, None)


def plain_permute_sparse(state: torch.Tensor) -> torch.Tensor:
    """(B, t, 8) Montgomery states -> digest lane OUTPUT_INDEX (B, 8) of
    each permuted state, on the sparse schedule."""
    return F._from16(plain_sparse_rounds16(F._to16(state))[:, OUTPUT_INDEX])


def plain_hash2_mont_sparse(a: torch.Tensor, b: torch.Tensor):
    """Plain version: (N, 8) x (N, 8) Montgomery rows -> (N, 8)."""
    return plain_permute_sparse(torch.stack([torch.zeros_like(a), a, b], 1))


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
