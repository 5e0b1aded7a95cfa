"""narrow_levels.tree: percent of the tree levels' device time (device
spans `level` of merkle/tree.py, one a k_sparse3 launch, attribute
`hashes`) spent in levels of fewer hashes than the card runs at once, over
the builds that start in the traced window."""

from zkbench import spans

# hashes an H100 holds at once in k_sparse3: one hash a thread, blocks of
# 1,024 threads at 64 registers each (the whole 65,536-register file of an
# SM), so one block on each of the 132 SMs
RESIDENT_HASHES = 132 * 1024


def read(ctx):
    levels = spans.named(spans.roots(ctx, "build"), "level")
    total = spans.device_seconds(levels)
    if not total:
        return None
    narrow = sum(r["device_s"] for r in levels
                 if r["attrs"]["hashes"] < RESIDENT_HASHES)
    return 100.0 * narrow / total
