"""The port's plain Poseidon versions (ops/poseidon.py, ops/poseidon_sparse.py)
against the JAX package, with exact equality of canonical digests:

* the sparse-MDS schedule against zkpos_tpu.ops.poseidon_f32_pallas
  .hash2_mont_f32p (its Pallas kernel _perm2_kernel, in interpret mode on
  the CPU) and against crypto/poseidon_opt.permutation_opt;
* the sparse tables of width 3, 11 and 17 (the chain kernel's schedule)
  against crypto/poseidon_ref.permutation on random states;
* the plain schedule at t = 11 and 17, and ``permute`` (the sparse
  schedule from t = 4), against crypto/poseidon_ref and poseidon_opt;
* the plain schedule at t = 6, batch hashing, and the t = 17 chain (the
  per-block one of hash_chain_mont on the plain schedule and the
  one-launch one of chain_mont on the sparse one) against
  crypto/poseidon_ref.

The plain schedule at t = 3 is held against zkpos_tpu.ops.poseidon
.hash2_mont in tests/test_torch_tree.py, beside the JAX tree that compiles
that function anyway.  The CUDA kernels' own arithmetic is checked by the
g++ rehearsal (tests/test_torch_rehearsal.py) and on the card by
chip_smoke.py.
"""
import random

import jax.numpy as jnp
import pytest
import torch

from zkpos_tpu.crypto import poseidon_opt as jopt
from zkpos_tpu.crypto.bn254 import R
from zkpos_tpu.crypto.poseidon_ref import permutation, poseidon
from zkpos_tpu.ops import fr_f32 as fd
from zkpos_tpu.ops.poseidon_f32_pallas import hash2_mont_f32p
from zkpos_tpu_torch.ops import field as F
from zkpos_tpu_torch.ops import poseidon as tpos
from zkpos_tpu_torch.ops import poseidon_sparse as tsparse

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)


def _rand(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(R) for _ in range(n)]


def _digests(t):
    return F.tensor_to_ints(F.from_mont(t))


def test_sparse_schedule_matches_f32_pallas_kernel():
    a = [0, R - 1] + _rand(2, 1)
    b = [R - 1, 0] + _rand(2, 2)
    got = _digests(tsparse.hash2_mont_sparse(tpos.mont_tensor(a, "cpu"),
                                             tpos.mont_tensor(b, "cpu")))
    da = fd.to_mont(jnp.asarray(fd.ints_to_digits(a)))
    db = fd.to_mont(jnp.asarray(fd.ints_to_digits(b)))
    want = fd.digits_to_ints(fd.from_mont(hash2_mont_f32p(da, db)))
    assert got == want
    assert got == [jopt.permutation_opt([0, x, y])[1] for x, y in zip(a, b)]


@pytest.mark.parametrize("t", [3, 11, 17])
def test_sparse_tables_match_permutation(t):
    states = [[0] * t, _rand(t, 60 + t)]
    x = tpos.mont_tensor([v for s in states for v in s], "cpu")
    got = _digests(tsparse.plain_permute_sparse(x.reshape(2, t, 8)))
    assert got == [permutation(s)[1] for s in states]


def test_plain_schedule_t6_matches_oracle():
    states = [[0] * 6, [0] + [R - 1] * 5] + [_rand(6, 10 + i)
                                             for i in range(2)]
    x = tpos.mont_tensor([v for s in states for v in s], "cpu")
    got = _digests(tpos.plain_permute(x.reshape(len(states), 6, 8)))
    assert got == [permutation(s)[1] for s in states]


@pytest.mark.parametrize("t", [11, 17])
def test_plain_schedule_matches_jax_permutations(t):
    """The plain wide permutation against the JAX package's permutation
    (crypto/poseidon_ref, the function its ops.poseidon.permute is held to;
    that XLA function itself compiles for 60-100 s a width on the CPU), and
    ``permute`` (the sparse schedule at t >= 4) against it and against
    the package's sparse schedule (crypto/poseidon_opt)."""
    states = [[0] * t, [R - 1] * t, _rand(t, 80 + t)]
    x = tpos.mont_tensor([v for s in states for v in s], "cpu")
    x = x.reshape(len(states), t, 8)
    want = [permutation(s)[1] for s in states]
    assert _digests(tpos.plain_permute(x)) == want
    assert _digests(tpos.permute(x)) == want
    assert [jopt.permutation_opt(s)[1] for s in states] == want
    assert tpos.kernel_name(t) == f"poseidon_sparse_t{t}"


def test_hash_batch_matches_oracle():
    rows = [_rand(2, 20 + i) for i in range(5)]
    assert tpos.hash_batch(rows, device="cpu") == [
        poseidon([rows[i][j] for i in range(5)]) for j in range(2)]


@pytest.mark.parametrize("n", [31, 40])
def test_chain_matches_oracle(n):
    """Two t = 17 blocks (n = 31), and two plus a t = 11 tail (n = 40),
    through the per-block path and the one-launch path."""
    vals = _rand(n, 30 + n)
    vals[-1] = R - 1
    x = tpos.mont_tensor(vals, "cpu").reshape(1, n, 8)
    want = [poseidon(vals)]
    assert _digests(tpos.hash_chain_mont(x)) == want
    assert _digests(tpos.chain_mont(x)) == want


def test_cex_commitment_matches_oracle():
    """compute_cex_assets_commitment at 3 assets x 20 elements: one chain
    of 60 inputs (beyond the host shortcut), against the JAX oracle."""
    import chip_smoke
    from zkpos_tpu.crypto.bn254 import fr_to_bytes
    from zkpos_tpu_torch.utils import commitments as cm
    from zkpos_tpu_torch.utils import constants as C
    from zkpos_tpu_torch.utils import types as T
    saved = (C.ASSET_COUNTS, C.TIER_COUNT, C.ACCOUNT_TREE_DEPTH)
    C.configure(asset_counts=3, tier_count=12)
    try:
        cex = chip_smoke.make_cex_assets(
            C, T.TierRatio, T.CexAssetInfo, cm.calculate_precomputed_value,
            cm.padding_tier_ratios)[:2]
        flat = [e for a in cm._pad_cex_assets(cex)
                for e in cm.cex_asset_elements(a)]
        assert len(flat) == 60
        assert cm.compute_cex_assets_commitment(cex, device="cpu") == \
            fr_to_bytes(poseidon(flat))
    finally:
        C.configure(*saved)


def test_chain_fast_takes_the_host_below_49_inputs():
    vals = _rand(48, 7)
    assert tpos.hash_chain_fast(vals, device="cpu") == poseidon(vals)
