"""Prover fleet watchdog; counterpart of check_prover_status.py (parity
with the reference's check_prover_status.py:21-59).

Polls the prover status counts (dbtool --check_prover_status,
services/dbtool.DbTool.check_prover_status); when the finished count has
not grown for --stall-secs while work is unfinished, relaunches the prover
in rerun mode, up to --max-retries times.  Exits 0 once every witness is
finished, 1 when the retries are spent.

  python -m zkpos_tpu_torch.services.watchdog [--config config/config.json]
      [--poll-secs 60] [--stall-secs 480] [--max-retries 3]
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time


def get_counts(config: str) -> dict:
    """dbtool --check_prover_status over `config`, on a connection opened
    for this poll and closed after it, as the reference opens one a poll.
    A connection kept across polls may go on reading its first snapshot
    (MySQL's REPEATABLE READ with autocommit off), and the finished count
    would never grow."""
    from .config import load_config
    from .dbtool import DbTool
    tool = DbTool(load_config(config))
    try:
        return tool.check_prover_status()
    finally:
        tool.close()


def relaunch_prover(config: str) -> None:
    """`python -m zkpos_tpu_torch.services.prover --rerun`, to its end."""
    subprocess.run([sys.executable, "-m", "zkpos_tpu_torch.services.prover",
                    "--config", config, "--rerun"], check=False)


def main(argv=None, poll=None, relaunch=relaunch_prover) -> int:
    """The watchdog's loop.  `poll()` returns the counts (published,
    received, finished); by default get_counts over --config.
    `relaunch(config)` restarts the prover."""
    ap = argparse.ArgumentParser("zkpos-watchdog")
    ap.add_argument("--config", default="config/config.json")
    ap.add_argument("--poll-secs", type=float, default=60.0)
    ap.add_argument("--stall-secs", type=float, default=480.0)
    ap.add_argument("--max-retries", type=int, default=3)
    args = ap.parse_args(argv)
    if poll is None:
        poll = functools.partial(get_counts, args.config)

    retries = 0
    last_finished = -1
    last_progress_t = time.monotonic()
    while True:
        counts = poll()
        print(f"watchdog: {counts}", flush=True)
        if counts["published"] + counts["received"] == 0:
            print("watchdog: all work finished", flush=True)
            return 0
        if counts["finished"] > last_finished:
            last_finished = counts["finished"]
            last_progress_t = time.monotonic()
        elif time.monotonic() - last_progress_t > args.stall_secs:
            if retries >= args.max_retries:
                print("watchdog: retries exhausted", file=sys.stderr)
                return 1
            retries += 1
            print(f"watchdog: stalled, launching prover --rerun "
                  f"(retry {retries}/{args.max_retries})", flush=True)
            relaunch(args.config)
            last_progress_t = time.monotonic()
        time.sleep(args.poll_secs)


if __name__ == "__main__":
    sys.exit(main())
