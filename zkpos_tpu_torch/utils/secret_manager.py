"""Remote password injection — parity with reference src/utils/secret_manager.go;
counterpart of zkpos_tpu/utils/secret_manager.py.

The reference optionally fetches the MySQL password from AWS SecretsManager
when `-remote_password_config` is passed (secret_manager.go:13-53, used at
witness main.go:38-44, prover main.go:29-35).  The hook is kept with a
local-file provider and an AWS provider that activates when boto3 is
importable.
"""

from __future__ import annotations

import json


def get_db_source(data_source: str, remote_password_config: str) -> str:
    """Returns the data source with the password injected from the secret
    provider described by `remote_password_config` (JSON: {"provider":
    "file", "path": ...} or {"provider": "aws", "secretId": ...,
    "region": ...})."""
    cfg = json.load(open(remote_password_config))
    provider = cfg.get("provider", "file")
    if provider == "file":
        password = open(cfg["path"]).read().strip()
    elif provider == "aws":
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "the AWS secret provider requires boto3") from e
        client = boto3.client("secretsmanager",
                              region_name=cfg.get("region"))
        resp = client.get_secret_value(SecretId=cfg["secretId"])
        password = json.loads(resp["SecretString"])["password"]
    else:
        raise ValueError(f"unknown secret provider {provider!r}")
    return data_source.replace("${password}", password)
