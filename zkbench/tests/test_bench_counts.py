"""The roofline counts against hand counts on small cases."""

import numpy as np
import pytest

from zkbench import counts
from zkbench.reference.host import R


def rows(values):
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(values), 4)


def test_window_digits_little_endian():
    z = rows([0x1234_5678_9ABC, (1 << 200) + 7])
    d16 = counts.window_digits(z, 16)
    assert d16.shape == (16, 2)
    assert list(d16[:3, 0]) == [0x9ABC, 0x5678, 0x1234]
    assert d16[12, 1] == 1 << 8 and d16[0, 1] == 7
    d12 = counts.window_digits(z, 12)
    assert d12.shape == (22, 2)
    assert list(d12[:4, 0]) == [0xABC, 0x789, 0x456, 0x123]
    assert d12[16, 1] == 1 << 8                         # bit 200 = 12 * 16 + 8


def test_bucket_adds_by_hand():
    # c = 16: digits (window 0) 5, 5, 9, 0 and (window 1) 1, 0, 1, 1
    z = rows([5 + (1 << 16), 5, 9 + (1 << 16), 1 << 16])
    got = counts.bucket_adds(z, 16)
    # window 0: 3 non-zero digits in 2 buckets -> 1 add; window 1: 3 in 1 -> 2
    assert got == {"adds": 3, "digits": 6, "buckets": 3}
    assert counts.bucket_adds(rows([0, 0]), 16) == {"adds": 0, "digits": 0,
                                                    "buckets": 0}


def test_uniform_expectation_near_a_draw():
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(4096)]
    want = counts.bucket_adds(rows(vals), 8)
    got = counts.uniform_bucket_adds(4096, 8)
    assert got["digits"] == pytest.approx(want["digits"], rel=0.01)
    assert got["buckets"] == pytest.approx(want["buckets"], rel=0.01)


def test_poseidon_and_peaks():
    assert counts.poseidon_products(3, 57) == 604
    assert counts.MULS_PER_PRODUCT == 264
    w = counts.poseidon_work(1000)
    assert w == {"muls": 1000 * 604 * 264.0, "bytes": 96000.0}
    assert counts.INT32_MULS_PER_S == pytest.approx(1.672704e13)
    # the row-4 bound of PERF.md: 2^26 hashes in 639.737 ms
    w = counts.poseidon_work(1 << 26)
    t = counts.least_seconds(w["muls"], w["bytes"])
    assert t * 1e3 == pytest.approx(639.737, abs=1e-3)


def test_seg_sums_work_counts_each_curve():
    w = counts.seg_sums_work([("g1", {"adds": 10, "digits": 12,
                                      "buckets": 2}),
                              ("g2", {"adds": 1, "digits": 2, "buckets": 1})])
    assert w["muls"] == (10 * 12 + 1 * 42) * 264
    assert w["bytes"] == 14 * 96 + 3 * 192
