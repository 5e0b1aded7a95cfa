"""Per-service JSON config — parity with reference config/config.json
structs (witness config.go:3-7, prover config.go:3-12, verifier
config.go:8-24, dbtool config.go).

The reference's MysqlDataSource / Redis.Host map onto a storage DSN here:
a path ending in .db (or any path) selects the sqlite backend; a mysql://
DSN selects MySQL when a client library is available.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ServiceConfig:
    # shared
    db_path: str = "zkpos_data/zkpos.db"       # ~ MysqlDataSource
    db_suffix: str = ""                        # ~ DbSuffix
    # witness
    user_data_file: str = ""                   # ~ UserDataFile (directory)
    # prover
    zk_key_name: str = "zkpos_data/keys/zkpor"  # ~ ZkKeyName prefix
    asset_counts_tiers: Optional[Dict[int, int]] = None
    # verifier
    proof_table: str = ""                      # proof csv path
    cex_assets_info: str = ""                  # published cex assets json
    account_tree_root: str = ""                # hex root for user verify
    # task queue: "host:port" selects the real Redis list protocol
    # (reference Redis.Host, prover config.go:5-8); empty keeps the
    # sqlite-backed queue with identical LPUSH/BRPOP semantics
    redis_addr: str = ""
    redis_password: str = ""


def load_config(path: str) -> ServiceConfig:
    cfg = ServiceConfig()
    if path and os.path.exists(path):
        data = json.load(open(path))
        mapping = {
            "MysqlDataSource": "db_path", "DbSuffix": "db_suffix",
            "UserDataFile": "user_data_file", "ZkKeyName": "zk_key_name",
            "ProofTable": "proof_table", "CexAssetsInfo": "cex_assets_info",
            "AccountTreeRoot": "account_tree_root",
            # snake_case accepted too
            "db_path": "db_path", "db_suffix": "db_suffix",
            "user_data_file": "user_data_file", "zk_key_name": "zk_key_name",
            "proof_table": "proof_table",
        }
        for k, v in data.items():
            attr = mapping.get(k)
            if attr:
                setattr(cfg, attr, v)
        redis = data.get("Redis") or {}
        if isinstance(redis, dict) and redis.get("Host"):
            cfg.redis_addr = redis["Host"]
            cfg.redis_password = redis.get("Password", "")
        if data.get("redis_addr"):
            cfg.redis_addr = data["redis_addr"]
            cfg.redis_password = data.get("redis_password", "")
    return cfg
