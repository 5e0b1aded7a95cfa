"""poseidon_roofline.tree: the tree's node hash (kernel k_sparse3,
csrc/poseidon.cu, launch name poseidon_sparse3), percent of its device
time that the window's hashes would take at the card's published peaks
(counts.py: the sparse schedule's 604 products a hash at t = 3, or 96
bytes a hash, whichever takes longer)."""

from zkbench import counts

KERNELS = ("k_sparse3",)


def read(ctx):
    work = ctx.work.get("poseidon")
    if ctx.trace is None or not work:
        return None
    seconds = ctx.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * counts.least_seconds(work["muls"], work["bytes"]) / seconds
