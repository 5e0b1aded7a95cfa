"""QAP evaluation and H(X) for groth16.prove on the device.

Counterpart of zkpos_tpu/groth16/qap_device.py.  The per-constraint linear
combinations Az, Bz and Cz are one CSR row evaluation each
(ops/field.csr_eval over the flattened constraint matrices, the terms
split evenly over the card whatever rows they fall in); then the
seven NTTs of gnark's H pipeline (prover.go:269): 3 inverse, 3 coset
forward, the pointwise (A*B - C)/Z on the coset, 1 coset inverse.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..crypto.bn254 import R as MOD
from ..ops import field as F
from ..utils import trace
from .ntt_device import ntt_mont

# Cache keyed by the IDENTITY of the constraint data (FlatConstraints is
# shared between the compiled system and every per-batch solved system),
# not by the cs object: each solve makes a fresh cs, and a per-cs cache
# would flatten and upload the matrices again for every batch.  Strong
# refs are intentional: one entry per tier, as the proving key.
_MATRIX_CACHE: dict = {}


def _cs_cache(cs) -> dict:
    fc = cs.constraints
    key = id(fc)
    ent = _MATRIX_CACHE.get(key)
    if ent is None or ent[0] is not fc:
        ent = (fc, {})
        _MATRIX_CACHE[key] = ent
    return ent[1]


def _matrix_arrays(cs, which: int):
    """Flatten matrix `which` (0 = A, 1 = B, 2 = C) into term arrays
    (constraint row, variable, coefficient id into the pool), host numpy,
    cached per constraint data."""
    cache = _cs_cache(cs)
    if which not in cache:
        fc = cs.constraints
        lens = np.frombuffer(fc.lens, dtype=np.uint32).astype(np.int64)
        va = np.frombuffer(fc.vars, dtype=np.uint32)
        ca = np.frombuffer(fc.coeffs, dtype=np.uint32)
        ends = np.cumsum(lens)
        starts = ends - lens
        sel = np.arange(which, len(lens), 3)
        seg_starts = starts[sel]
        seg_lens = lens[sel]
        total = int(seg_lens.sum())
        intra = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(seg_lens)[:-1])), seg_lens)
        offs = np.repeat(seg_starts, seg_lens) + intra
        rows = np.repeat(np.arange(len(sel), dtype=np.int64), seg_lens)
        cache[which] = (rows, va[offs].astype(np.int32),
                        ca[offs].astype(np.int32))
    return cache[which]


def pool_mont(cs, device) -> torch.Tensor:
    """The coefficient pool in Montgomery form on `device` (cached)."""
    cache = _cs_cache(cs)
    key = ("pool", str(device))
    if key not in cache:
        pool = cs.constraints.pool
        cache[key] = F.ints_to_tensor(
            [c * F.RMONT % MOD for c in pool], device)
    return cache[key]


def _row_terms(cs, which: int, device):
    """The terms of matrix `which` on `device`: constraint row, variable
    and coefficient id, each (T,) int32, sorted by row."""
    cache = _cs_cache(cs)
    key = ("terms", which, str(device))
    if key not in cache:
        rows, vars_, cids = _matrix_arrays(cs, which)
        cache[key] = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                           for a in (rows, vars_, cids))
    return cache[key]


def eval_matrix_device(cs, z_mont: torch.Tensor, which: int,
                       d: int) -> torch.Tensor:
    """(d, 8) Montgomery: row c holds sum_i M[c, i] * z_i (0 past the last
    constraint)."""
    row, col, cid = _row_terms(cs, which, z_mont.device)
    return F.csr_eval(row, col, cid, pool_mont(cs, z_mont.device), z_mont, d)


@lru_cache(maxsize=None)
def _coset_tables(d: int, device: str):
    """(g^i) and (g^-i / Z(g)) for the coset g*H, g = 5, where
    Z(g x) = g^d - 1 is constant on the coset."""
    g = 5
    z_cos_inv = pow((pow(g, d, MOD) - 1) % MOD, MOD - 2, MOD)
    dev = torch.device(device)
    return (F.powers(g, d, dev),
            F.powers(pow(g, MOD - 2, MOD), d, dev, start=z_cos_inv))


def _h_fn(d: int, av, bv, cv) -> torch.Tensor:
    gp, gip = _coset_tables(d, str(av.device))
    a_cos = ntt_mont(F.mul(ntt_mont(av, inverse=True), gp))
    b_cos = ntt_mont(F.mul(ntt_mont(bv, inverse=True), gp))
    c_cos = ntt_mont(F.mul(ntt_mont(cv, inverse=True), gp))
    h_cos = F.sub(F.mul(a_cos, b_cos), c_cos)
    return F.mul(ntt_mont(h_cos, inverse=True), gip)


def compute_h_device(cs, z: torch.Tensor, d: int) -> torch.Tensor:
    """H(X) coefficients of (A*B - C)/Z from the standard-form witness
    (N, 8) tensor.  Returns (d - 1, 8) standard-form rows on z's device."""
    z_mont = F.to_mont(z)
    with trace.span("csr_eval", device=z.device):
        av = eval_matrix_device(cs, z_mont, 0, d)
        bv = eval_matrix_device(cs, z_mont, 1, d)
        cv = eval_matrix_device(cs, z_mont, 2, d)
    with trace.span("ntt", device=z.device):
        h = F.from_mont(_h_fn(d, av, bv, cv))
    with trace.wait("h_degree"):
        high = bool((h[d - 1] != 0).any())
    if high:
        raise ValueError("H degree too large — unsatisfied constraints?")
    return h[:d - 1].contiguous()
