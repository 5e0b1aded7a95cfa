"""Sample balance-sheet generator; counterpart of
zkpos_tpu/utils/sample_data.py (the same rows for the same seed).

Re-implementation of the reference's data generator
(reference src/sampledata/generate_user_files.py, sample_data_generation.sh)
with the same CSV schema and semantics, redesigned as a single vectoriz-
able pass:

  * schema: `rn,id,(e_X,d_X,X,vl_X,m_X,pm_X)*tokens,total_net_balance_usdt`
    (reference utils.go:521-525);
  * "special" 2-digit tokens (shib) use 10^2 number / 10^14 price scaling,
    others 10^8 / 10^8 (reference constants.go:45-100);
  * valid users: debt sized to 99% of the tier-haircut collateral value;
  * invalid type 0 (even rows): per-token collateral sum exceeds equity;
  * invalid type 1 (odd rows): debt exceeds haircut collateral value by 1%;
  * the tier haircut (`get_collateral_value`) mirrors
    CalculateAssetValueViaTiersRatio (reference utils.go:664-685).

Usage:
    python -m zkpos_tpu_torch.utils.sample_data <id> <count> <invalid_count> \
        [--cex cex_assets_info.csv] [--out-dir DIR] [--tokens t1,t2,...]
"""

from __future__ import annotations

import argparse
import csv
import os
import random
from typing import Dict, List, Tuple

SPECIAL_TOKENS = {"shib"}
SPECIAL_PRICE_MULT = 10 ** 14
SPECIAL_NUM_MULT = 10 ** 2
NORMAL_PRICE_MULT = 10 ** 8
NORMAL_NUM_MULT = 10 ** 8
TOKEN_VALUE_MULT = 10 ** 16


def _parse_tiers(data: str) -> List[Tuple[int, int]]:
    """'[0-100:90,100-200:80]'-style tier string -> [(boundary, ratio)]."""
    data = data.strip()
    if not data:
        return []
    out = []
    for part in data.strip("[]").split(","):
        rng, ratio = part.strip().split(":")
        upper = int(rng.split("-")[1])
        out.append((upper * TOKEN_VALUE_MULT, int(ratio)))
    return out


def read_cex_info(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    price: Dict[str, int] = {}
    tiers = {k: {} for k in ("vl", "m", "pm")}
    for r in rows:
        token = r[0]
        mult = SPECIAL_PRICE_MULT if token in SPECIAL_TOKENS \
            else NORMAL_PRICE_MULT
        price[token] = int(float(r[1]) * mult)
        tiers["vl"][token] = _parse_tiers(r[2])
        tiers["m"][token] = _parse_tiers(r[3])
        tiers["pm"][token] = _parse_tiers(r[4])
    return price, tiers


def write_cex_info(path: str, tokens: List[str],
                   seed: int | None = None) -> str:
    """A seeded CEX asset table in the layout read_cex_info reads (the
    reference's cex_assets_info.csv: symbol, price, then the loan, margin
    and portfolio-margin tier ratios as "[lo-hi:ratio,...]" in USDT), two
    tiers a list; whole-dollar prices, 10^-4 for the two-digit tokens."""
    rng = random.Random(seed)

    def tiers() -> str:
        b1 = rng.randint(1, 100) * 10_000
        b2 = b1 + rng.randint(1, 100) * 10_000
        r1 = rng.randint(50, 100)
        return f"[0-{b1}:{r1},{b1}-{b2}:{rng.randint(0, r1)}]"

    rows = [["symbol", "price", "loan_collateral", "margin_collateral",
             "portfolio_margin_collateral"]]
    for t in tokens:
        price = "0.0001" if t in SPECIAL_TOKENS else \
            f"{rng.randint(1, 50_000)}.0"
        rows.append([t, price, tiers(), tiers(), tiers()])
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def haircut_value(token: str, num: float, tier_list, price: Dict[str, int]) -> int:
    """Tier-ratio haircut of a collateral amount (reference
    generate_user_files.py:172-193 == utils.go:664-685 semantics)."""
    mult = SPECIAL_NUM_MULT if token in SPECIAL_TOKENS else NORMAL_NUM_MULT
    value = int(num * mult) * price[token]
    real, last = 0, 0
    idx = 0
    for bound, ratio in tier_list:
        if value <= bound:
            break
        real += (bound - last) * ratio // 100
        idx += 1
        last = bound
    if idx < len(tier_list):
        real += (value - last) * tier_list[idx][1] // 100
    return real


def _rnd(token: str, rng: random.Random, hi: float = 1000.0) -> float:
    prec = 2 if token in SPECIAL_TOKENS else 8
    return round(rng.uniform(0, hi), prec)


def _round(token: str, v: float) -> float:
    return round(v, 2 if token in SPECIAL_TOKENS else 8)


def generate_rows(file_id: int, count: int, invalid_count: int,
                  tokens: List[str], price, tiers,
                  seed: int | None = None) -> List[List[str]]:
    rng = random.Random(seed)
    header = ["rn", "id"]
    for t in tokens:
        header += [f"e_{t}", f"d_{t}", t, f"vl_{t}", f"m_{t}", f"pm_{t}"]
    header.append("total_net_balance_usdt")
    rows = [header]

    def debt_value_of(token, vl, m, pm) -> int:
        return (haircut_value(token, vl, tiers["vl"][token], price)
                + haircut_value(token, m, tiers["m"][token], price)
                + haircut_value(token, pm, tiers["pm"][token], price))

    for i in range(count):
        rn = i + file_id * count
        row: List[str] = [str(rn), format(rn, "064x")]
        if i < invalid_count and i % 2 == 0:
            # invalid 0: vl+m+pm > equity per token
            for t in tokens:
                e = _rnd(t, rng)
                d = _round(t, e / 2)
                row += [str(e), str(d), str(_round(t, e - d)),
                        str(_round(t, e / 2)), str(_round(t, e / 4)),
                        str(_round(t, e / 2))]
        elif i < invalid_count:
            # invalid 1: debt 1% above the haircut collateral value
            for t in tokens:
                tl = tiers["vl"][t]
                if tl:
                    cap = tl[-1][0] / price[t] / (
                        SPECIAL_NUM_MULT if t in SPECIAL_TOKENS
                        else NORMAL_NUM_MULT)
                    e = _round(t, rng.uniform(0, cap))
                else:
                    e = _rnd(t, rng)
                vl, m, pm = (_round(t, e / 2), _round(t, e / 4),
                             _round(t, e / 8))
                dv = 10 + debt_value_of(t, vl, m, pm)
                num_mult = (SPECIAL_NUM_MULT if t in SPECIAL_TOKENS
                            else NORMAL_NUM_MULT)
                d = _round(t, dv / price[t] / num_mult * 1.01)
                row += [str(e), str(d), str(_round(t, e - d)),
                        str(vl), str(m), str(pm)]
        else:
            # valid: aggregate haircut value, spread 99% of it as debt
            debt_value = 0
            cells = []
            for t in tokens:
                e = _rnd(t, rng)
                vl, m, pm = (_round(t, e / 2), _round(t, e / 4),
                             _round(t, e / 8))
                debt_value += debt_value_of(t, vl, m, pm)
                cells.append([str(e), "0", "0", str(vl), str(m), str(pm)])
            avg = debt_value // len(tokens)
            for t, cell in zip(tokens, cells):
                num_mult = (SPECIAL_NUM_MULT if t in SPECIAL_TOKENS
                            else NORMAL_NUM_MULT)
                d = _round(t, avg / price[t] / num_mult * 0.99)
                cell[1] = str(d)
                row += cell
        row.append("0.0")
        rows.append(row)
    return rows


def generate_file(file_id: int, count: int, invalid_count: int,
                  cex_path: str, out_dir: str = ".",
                  tokens: List[str] | None = None,
                  seed: int | None = None) -> str:
    price, tiers = read_cex_info(cex_path)
    tokens = tokens or [t for t in ("btc", "eth", "bnb", "shib")
                        if t in price]
    rows = generate_rows(file_id, count, invalid_count, tokens, price,
                         tiers, seed)
    path = os.path.join(out_dir, f"sample_users{file_id}.csv")
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("file_id", type=int)
    ap.add_argument("count", type=int)
    ap.add_argument("invalid_count", type=int)
    ap.add_argument("--cex", default="cex_assets_info.csv")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--tokens", default=None)
    ap.add_argument("--seed", type=int, default=None)
    a = ap.parse_args(argv)
    tokens = a.tokens.split(",") if a.tokens else None
    path = generate_file(a.file_id, a.count, a.invalid_count, a.cex,
                         a.out_dir, tokens, a.seed)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
