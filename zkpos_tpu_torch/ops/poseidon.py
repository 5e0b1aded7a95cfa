"""Poseidon over BN254 Fr on tensors: the plain round schedule at every
width t = 2..17, hash chains, and batch hashing of host rows.

Counterpart of zkpos_tpu/ops/poseidon.py (the jnp permutation) and
zkpos_tpu/ops/poseidon_pallas.py (its Pallas kernel at t = 3).  Elements
are (N, 8) int32 Montgomery rows (ops/field.py); a batch of states is
(B, t, 8) and a batch of inputs (B, n, 8).  The digest of a permutation is
its lane OUTPUT_INDEX.

Wrappers and their kernels (csrc/poseidon.cu):

* ``permute`` / ``hash_n_mont`` / ``hash2_mont``: one thread per
  permutation; at t = 2, 3 on the plain schedule, ``zk_poseidon_plain``
  (launch name ``poseidon_plain_t{t}``), at t = 4..17 on the sparse one,
  ``zk_poseidon_sparse`` (``poseidon_sparse_t{t}``, plain version
  ops/poseidon_sparse.plain_permute_sparse);
* ``hash_chain_mont``: the chaining rule for more than 16 inputs as one
  ``permute`` per block, many columns side by side (the leaf commitments);
* ``chain_mont``: whole chains in one launch, one warp per chain, on the
  sparse-MDS schedule (``zk_poseidon_chain``, launch name
  ``poseidon_chain``) -- the long, sequential CEX commitments, all those
  of a run of batches side by side (``hash_chains_fast``).

Each launches its kernel for tensors on the card and runs its plain
version for tensors on the CPU.  The plain versions work on 16-bit limbs
in int64 (the representation of ops/field.py's plain versions) with a
fixed number of tensor calls per round whatever t is: one product for the
S-boxes of all lanes, one product over (B, t, t) for the MDS mix, and one
lazy limb sum over j followed by one reduction.  ``plain_chain_mont`` runs
the chain kernel's schedule, the sparse one of ops/poseidon_sparse.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import torch

from ..crypto import poseidon_params as pp
from ..crypto.bn254 import R as MOD
from ..crypto.poseidon_ref import MAX_INPUTS, OUTPUT_INDEX
from ..crypto.poseidon_ref import poseidon as host_poseidon
from ..utils import build
from ..utils.device import resolve
from . import field as F

HALF_FULL = pp.R_FULL // 2
# at or below this many inputs a host hash costs less than a launch
HOST_SHORTCUT = 48
_P_TOP = MOD >> 224
_P16 = F._limbs16(MOD, 17)


def mont_ints(values) -> List[int]:
    return [v * F.RMONT % MOD for v in values]


# --- constants ---------------------------------------------------------------

@lru_cache(maxsize=None)
def tables(t: int, device: str):
    """(C, M) of width t in Montgomery form as (N, 8) int32 rows: C has
    (8 + R_P) * t entries in round order, M the t x t MDS matrix by rows."""
    consts, mds = pp.generate_params(t)
    c = F.ints_to_tensor(mont_ints(consts), device)
    m = F.ints_to_tensor(mont_ints([v for row in mds for v in row]), device)
    return c, m


@lru_cache(maxsize=None)
def _tables16(t: int, device: str):
    c, m = tables(t, device)
    return F._to16(c).reshape(-1, t, 16), F._to16(m).reshape(t, t, 16)


# --- plain arithmetic on 16-bit limbs ----------------------------------------

def mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of broadcastable (..., 16) limb tensors, in
    chunks of rows that bound the plain product's memory."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2 = a.expand(shape).reshape(-1, 16)
    b2 = b.expand(shape).reshape(-1, 16)
    step = F._PLAIN_CHUNK
    out = [F._mul16(a2[i:i + step], b2[i:i + step], F.FR)
           for i in range(0, a2.shape[0], step)]
    return torch.cat(out).reshape(shape)


def add16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return F._add16(a, b, F.FR)


def sbox16(x: torch.Tensor) -> torch.Tensor:
    x2 = mul16(x, x)
    return mul16(mul16(x2, x2), x)


def sum_mod16(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 of canonical (..., k, 16) limbs, reduced mod r: one
    lazy limb sum, then the quotient estimated from the top 48 bits (never
    above the true one, and below it by at most 1) and one conditional
    subtraction."""
    s = x.sum(-2)
    s = F._norm(torch.cat([s, torch.zeros_like(s[..., :1])], -1))
    top = s[..., 14] | (s[..., 15] << 16) | (s[..., 16] << 32)
    q = top // (_P_TOP + 1)
    p16 = torch.tensor(_P16, dtype=torch.int64, device=x.device)
    s = F._norm(s - q.unsqueeze(-1) * p16)
    return F._cond_sub16(s[..., :16], F.FR)


def mix16(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (B, t, 16) -> m @ x with m (t, t, 16)."""
    return sum_mod16(mul16(m.unsqueeze(0), x.unsqueeze(1)))


def plain_rounds16(x: torch.Tensor) -> torch.Tensor:
    """The plain schedule (crypto/poseidon_ref.permutation) on (B, t, 16)
    limbs in Montgomery form."""
    t = x.shape[1]
    c, m = _tables16(t, str(x.device))
    rp = pp.partial_rounds(t)
    for r in range(pp.R_FULL + rp):
        x = add16(x, c[r])
        if HALF_FULL <= r < HALF_FULL + rp:
            x = torch.cat([sbox16(x[:, :1]), x[:, 1:]], 1)
        else:
            x = sbox16(x)
        x = mix16(x, m)
    return x


def plain_permute(state: torch.Tensor) -> torch.Tensor:
    """Plain version of ``permute``: (B, t, 8) -> digest (B, 8)."""
    return F._from16(plain_rounds16(F._to16(state))[:, OUTPUT_INDEX])


# --- kernel wrappers ---------------------------------------------------------

def _check_rows(x: torch.Tensor, dims: int) -> None:
    if (x.dtype != torch.int32 or x.dim() != dims or x.shape[-1] != 8
            or not x.is_contiguous()):
        raise ValueError(f"expected a contiguous int32 tensor of {dims} "
                         f"dims ending in 8 limbs, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


# widths at and above this run the sparse schedule (k_wide)
SPARSE_FROM = 4


def kernel_name(t: int) -> str:
    """The launch name of ``permute`` at width t."""
    kind = "sparse" if t >= SPARSE_FROM else "plain"
    return f"poseidon_{kind}_t{t}"


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of each (t, 8) state of a (B, t, 8) batch,
    Montgomery form, 2 <= t <= 17: returns the digest lane OUTPUT_INDEX of
    each permuted state, (B, 8).  The plain schedule at t = 2, 3, the
    sparse one above (the same digests)."""
    from .poseidon_sparse import plain_permute_sparse, table
    _check_rows(state, 3)
    t = state.shape[1]
    pp.partial_rounds(t)                          # raises on a bad width
    sparse = t >= SPARSE_FROM
    if state.device.type == "cpu":
        return plain_permute_sparse(state) if sparse else plain_permute(state)
    n = state.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=state.device)
    dev = str(state.device)
    L = build.cuda_lib()
    name = kernel_name(t)
    if sparse:
        rc = L.zk_poseidon_sparse(t, build.ptr(out), build.ptr(state), n,
                                  build.ptr(table(dev, t)),
                                  build.stream_ptr(state))
    else:
        c, m = tables(t, dev)
        rc = L.zk_poseidon_plain(t, build.ptr(out), build.ptr(state), n,
                                 build.ptr(c), build.ptr(m),
                                 build.stream_ptr(state))
    build.check(rc, name)
    F.count_launch(name, n)
    return out


def hash_n_mont(inputs: torch.Tensor) -> torch.Tensor:
    """(B, n, 8) -> (B, 8): one permutation of [0] + inputs, n <= 16."""
    n = inputs.shape[1]
    if not 1 <= n <= MAX_INPUTS:
        raise ValueError("hash_n_mont handles 1..16 inputs per permutation")
    zero = torch.zeros_like(inputs[:, :1])
    return permute(torch.cat([zero, inputs], 1))


def hash2_mont(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merkle node hash on the plain schedule: (B, 8) x (B, 8) -> (B, 8)."""
    return hash_n_mont(torch.stack([a, b], 1))


def _chain(inputs: torch.Tensor, perm) -> torch.Tensor:
    """The chaining rule of crypto/poseidon_ref.poseidon over (B, n, 8):
    the first 16 inputs, then 15 at a time after the running digest."""
    zero = torch.zeros_like(inputs[:, :1])
    digest = perm(torch.cat([zero, inputs[:, :MAX_INPUTS]], 1))
    for pos in range(MAX_INPUTS, inputs.shape[1], MAX_INPUTS - 1):
        chunk = inputs[:, pos:pos + MAX_INPUTS - 1]
        digest = perm(torch.cat([zero, digest[:, None], chunk], 1))
    return digest


def hash_chain_mont(inputs: torch.Tensor) -> torch.Tensor:
    """Variadic hash of each row of a (B, n, 8) batch, any n >= 1: one
    ``permute`` launch per block of the chain, all B chains side by
    side."""
    return _chain(inputs, permute)


def plain_chain_mont(inputs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``chain_mont``, on its schedule (the sparse one)."""
    from .poseidon_sparse import plain_permute_sparse
    return _chain(inputs, plain_permute_sparse)


def _tail_width(n: int) -> int:
    """Width of the one block of a chain of n inputs that is not 17 wide
    (17 if there is none)."""
    if n <= MAX_INPUTS:
        return n + 1
    rem = (n - MAX_INPUTS) % (MAX_INPUTS - 1)
    return rem + 2 if rem else MAX_INPUTS + 1


def chain_mont(inputs: torch.Tensor) -> torch.Tensor:
    """The same digests as ``hash_chain_mont``, all B chains of a (B, n, 8)
    batch in one launch, one warp per chain on the sparse schedule: for
    long chains, whose permutations are sequential."""
    from .poseidon_sparse import Layout, table
    _check_rows(inputs, 3)
    b, n = inputs.shape[:2]
    if n == 0:
        raise ValueError("poseidon requires at least one input")
    if inputs.device.type == "cpu":
        return plain_chain_mont(inputs)
    if inputs.data_ptr() % 16:
        raise ValueError("chain_mont needs 16-byte-aligned inputs")
    dev = str(inputs.device)
    tail = _tail_width(n)
    # the tables the chain's blocks use: width 17 if any block is 17 wide,
    # and the width of its one narrower block, if any
    k17, kt = table(dev, MAX_INPUTS + 1), table(dev, tail)
    e17 = Layout(MAX_INPUTS + 1).entries if n >= MAX_INPUTS else 0
    et = Layout(tail).entries if tail <= MAX_INPUTS else 0
    out = torch.empty((b, 8), dtype=torch.int32, device=inputs.device)
    L = build.cuda_lib()
    build.check(L.zk_poseidon_chain(build.ptr(out), build.ptr(inputs), b, n,
                                    build.ptr(k17), e17, build.ptr(kt), et,
                                    build.stream_ptr(inputs)),
                "poseidon_chain")
    F.count_launch("poseidon_chain", b * n)
    return out


# --- host-facing helpers (canonical ints) ------------------------------------

def mont_tensor(values: Sequence[int], device) -> torch.Tensor:
    """Canonical ints (reduced mod r here) -> (N, 8) Montgomery rows on
    `device`."""
    return F.to_mont(F.ints_to_tensor([v % MOD for v in values], device))


def hash_batch(inputs, device=None) -> List[int]:
    """inputs: n rows of B ints (input i of every hash in row i) -> the B
    digests as ints."""
    dev = resolve(device)
    n, b = len(inputs), len(inputs[0])
    x = mont_tensor([inputs[i][j] for j in range(b) for i in range(n)], dev)
    digest = hash_chain_mont(x.reshape(b, n, 8))
    return F.tensor_to_ints(F.from_mont(digest))


def hash_chains_fast(rows, device=None) -> List[int]:
    """Variadic Poseidon of each of several element lists of one length
    (the CEX commitments of a run of batches): every chain in one
    ``chain_mont`` launch, the inputs put in Montgomery form on the device
    in one call.  Lists of at most HOST_SHORTCUT elements take the host
    hash."""
    rows = [list(r) for r in rows]
    n = len(rows[0])
    if any(len(r) != n for r in rows):
        raise ValueError("hash_chains_fast takes lists of one length")
    if n <= HOST_SHORTCUT:
        return [host_poseidon(r) for r in rows]
    x = mont_tensor([v for r in rows for v in r], resolve(device))
    return F.tensor_to_ints(F.from_mont(chain_mont(
        x.reshape(len(rows), n, 8))))


def hash_chain_fast(elements, device=None) -> int:
    """One variadic Poseidon over a long element list (the 20 x AssetCounts
    CEX commitment, reference utils.go:779-800) in one launch; short
    inputs take the host hash."""
    return hash_chains_fast([elements], device)[0]
