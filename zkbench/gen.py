"""Seeded inputs, the same for the same seed.  Frozen copies of the
program's generators, so that later changes to the program do not move
what the benchmark feeds it:

  * ``cex_assets``: chip_smoke.py ``make_cex_assets`` (each asset two tier
    ratios, padded to the tier table by the program's own padding);
  * ``tier_accounts``: chip_smoke.py ``make_user_base`` restricted to one
    asset tier (each account's k assets drawn from the seed, with its
    equity, debt and collateral), the pattern of the reference's
    sample-data generator: every account valid, collateral above debt;
    the counts k are the same for every seed (``asset_counts``), so that a
    seed changes the values and not the amount of work;
  * ``leaves``: chip_smoke.py ``random_leaves`` (standard-form Fr values
    made on the device by a seeded generator in eight large calls).

The account and CEX records are the program's input types; the benchmark
builds them and hands them over.
"""

from __future__ import annotations

import random

import torch

E8 = 10 ** 8
SEED_MASK = (1 << 63) - 1


def sub_seed(seed: int, part: int) -> int:
    """A seed of its own for each part of a run's inputs."""
    return random.Random(f"{seed}:{part}").getrandbits(63)


def cex_assets(n_assets: int, TierRatio, CexAssetInfo, calc_pre, pad_tiers):
    out = []
    for i in range(n_assets):
        tiers = [TierRatio(boundary_value=10_000 * 10 ** 16, ratio=90),
                 TierRatio(boundary_value=50_000 * 10 ** 16, ratio=70)]
        calc_pre(tiers)
        out.append(CexAssetInfo(
            symbol=f"tok{i}", index=i, base_price=(i + 1) * E8,
            loan_ratios=pad_tiers(list(tiers)),
            margin_ratios=pad_tiers(list(tiers)),
            portfolio_margin_ratios=pad_tiers(list(tiers))))
    return out


def asset_counts(n_users: int, tier: int, rng: random.Random):
    """How many assets each account holds: 1 to `tier`, spread evenly over
    the accounts and shuffled, so that every seed has the same sizes in
    another order."""
    ks = [1 + (i * (tier - 1)) // max(n_users - 1, 1) for i in range(n_users)]
    rng.shuffle(ks)
    return ks


def tier_accounts(rng: random.Random, n_users: int, n_assets: int,
                  tier: int, cex, AccountAsset, AccountInfo, collateral):
    """n_users valid accounts of the `tier`-asset tier: each holds 1 to
    `tier` of the `n_assets` assets (asset_counts)."""
    coll = {}
    out = []
    for k in asset_counts(n_users, tier, rng):
        assets = []
        te = td = tc = 0
        for idx in sorted(rng.sample(range(n_assets), k)):
            eq = rng.randint(10, 1000) * E8
            de = rng.randint(0, 2) * E8
            lo = rng.randint(1, 3) * E8
            assets.append(AccountAsset(index=idx, equity=eq, debt=de,
                                       loan=lo, margin=lo,
                                       portfolio_margin=lo))
            price = cex[idx].base_price
            if (idx, lo) not in coll:
                coll[idx, lo] = collateral(lo, lo, lo, cex[idx])
            te += eq * price
            td += de * price
            tc += coll[idx, lo]
        out.append(AccountInfo(account_id=b"", total_equity=te,
                               total_debt=td, total_collateral=tc,
                               assets=assets))
    return out


def leaves(n: int, seed: int, device) -> torch.Tensor:
    """n standard-form leaves below r, (n, 8) int32 limbs: limbs 0-6
    uniform, the top limb uniform below r's top limb."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    for j in range(8):
        hi = 0x30644E72 if j == 7 else 1 << 32
        col = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int64,
                            device=device)
        out[:, j] = torch.where(col >= 1 << 31, col - (1 << 32), col)
        del col
    return out


def leaf_ints(rows: torch.Tensor):
    """(k, 8) int32 limb rows -> Python ints."""
    vals = rows.cpu().to(torch.int64) & 0xFFFFFFFF
    return [sum(int(v) << (32 * j) for j, v in enumerate(row))
            for row in vals.tolist()]
