"""The port's chunked sorted-stream MSM (zkpos_tpu_torch/ops/msm_device.py)
and the proving key's budgeted residency, on the CPU.

The stream walked in chunks of 32 or 64 columns equals the one-pass MSM
and the host oracle, in G1 and G2 at c = 8: with buckets that span several
chunks, with chunks whose digits are all 0, and with a ragged last chunk;
in one case it also equals the JAX package's chunked engine
(ScalarPlan(chunk=32)).  The chunk and the key's residency are functions
of byte counts, tested at a few budgets; chip_smoke.py's closed-form
oracle for its 2^26-point MSMs and its inputs made on the device are held
against the host at N = 64.

The port's plans keep the two low window rows the scalars fill
(ScalarPlan(windows=2)): the plain versions' cost is the bucket fold over
W x 2^c points, about half a second a G1 MSM with two windows.
"""
import functools
import random

import pytest
import torch

from zkpos_tpu.crypto import bn254 as jbn
from zkpos_tpu.ops import msm_device as jmd

import chip_smoke
from zkpos_tpu_torch.crypto import bn254 as bn
from zkpos_tpu_torch.groth16 import groth16 as tg16
from zkpos_tpu_torch.ops import ec
from zkpos_tpu_torch.ops import msm_device as tmd

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)

N = 150          # Np = 160: five chunks of 32, or 64 + 64 + a ragged 32
CURVES = {"g1": (bn.G1_GEN, bn.g1_add, bn.g1_mul),
          "g2": (bn.G2_GEN, bn.g2_add, bn.g2_mul)}


def _scalars(kind, rng):
    """Scalars below 2^16 (two windows at c = 8)."""
    if kind == "duplicate_heavy":     # buckets 3 and 0 span several chunks
        return [rng.randrange(1 << 16) if i % 9 == 0 else
                rng.choice([0, 1, 1, 3, 3, 3, 7, 5]) for i in range(N)]
    if kind == "zero_chunks":         # the first 110 columns all digit 0
        return [0] * 100 + [rng.randrange(1, 1 << 16) for _ in range(50)]
    if kind == "random":
        return [rng.randrange(1 << 16) for _ in range(N)]
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def _case(curve, kind):
    """Bases P_i = (i + 1) Q for a random Q, the scalars, the oracle
    (sum_i s_i (i + 1)) Q, and the port's one-pass MSM."""
    rng = random.Random(f"{curve}-{kind}")
    gen, add, mul = CURVES[curve]
    q = mul(gen, rng.randrange(1, bn.R))
    pts, p = [], None
    for _ in range(N):
        p = add(p, q)
        pts.append(p)
    sc = _scalars(kind, rng)
    want = mul(q, sum(s * (i + 1) for i, s in enumerate(sc)) % bn.R)
    base = tmd.device_base(curve, pts, device="cpu")
    one_pass = tmd.msm(curve, base, plan=tmd.ScalarPlan(
        sc, c=8, device="cpu", windows=2))
    return pts, sc, want, base, one_pass


@pytest.mark.parametrize("curve,kind,chunk", [
    ("g1", "duplicate_heavy", 32), ("g1", "duplicate_heavy", 64),
    ("g1", "zero_chunks", 32), ("g1", "zero_chunks", 64),
    ("g1", "random", 64),
    ("g2", "duplicate_heavy", 32), ("g2", "duplicate_heavy", 64),
    ("g2", "zero_chunks", 32)])
def test_chunked_msm_equals_one_pass_and_oracle(curve, kind, chunk):
    _, sc, want, base, one_pass = _case(curve, kind)
    assert one_pass == want
    plan = tmd.ScalarPlan(sc, c=8, device="cpu", windows=2, chunk=chunk)
    stats = {}
    got = tmd.msm(curve, base, plan=plan, stats=stats)
    assert got == want
    assert stats == {"columns": chunk, "chunks": -(-160 // chunk)}
    if kind == "zero_chunks":         # whole chunks of digit 0 in both rows
        assert bool((plan.dig[:, :110] == 0).all())


def test_chunked_msm_equals_jax_chunked_engine():
    """The same G1 MSM through the JAX package's engine with
    ScalarPlan(chunk=32) (its CPU path: three chunks at 96 scalars) and
    the port's at chunk=32, both against the host oracle."""
    rng = random.Random(32)
    n = 96
    pts = [jbn.g1_mul(jbn.G1_GEN, rng.randrange(1, jbn.R)) for _ in range(n)]
    sc = [rng.choice([3, 3, 3, 7, 0, 1]) if i % 7 else rng.randrange(1 << 16)
          for i in range(n)]
    want = None
    for p, s in zip(pts, sc):
        want = jbn.g1_add(want, jbn.g1_mul(p, s))
    jax_got = jmd.msm("g1", jmd.device_base("g1", pts),
                      plan=jmd.ScalarPlan(sc, c=8, chunk=32))
    stats = {}
    port = tmd.msm("g1", tmd.device_base("g1", pts, device="cpu"),
                   plan=tmd.ScalarPlan(sc, c=8, device="cpu", windows=2,
                                       chunk=32), stats=stats)
    assert stats["chunks"] == 3
    assert jax_got == want and port == want


# --- the chunk and the key's residency from byte counts -----------------------

W16, W12 = tmd.windows_count(16), tmd.windows_count(12)
NP = 1924704            # the repo-size prove's padded witness


@pytest.mark.parametrize("W,na,c,budget,chunks", [
    (W16, 3, 16, None, 1),
    (W16, 3, 16, tmd.chunk_bytes(W16, NP, 3, 16), 1),
    (W16, 3, 16, tmd.chunk_bytes(W16, NP, 3, 16) - 1, 2),
    (W12, 6, 12, tmd.chunk_bytes(W12, NP // 5, 6, 12), 6),
    (W12, 6, 12, 10 << 30, 1),
    (W12, 6, 12, 1 << 30, 9)])
def test_chunk_columns_from_byte_counts(W, na, c, budget, chunks):
    """The fewest chunks whose columns fit the budget, as even as
    multiples of PAD_QUANTUM allow: one whenever the stream fits."""
    Cn = tmd.chunk_columns(W, NP, na, c, budget)
    assert -(-NP // Cn) == chunks
    assert Cn == NP or Cn % tmd.PAD_QUANTUM == 0
    assert budget is None or tmd.chunk_bytes(W, Cn, na, c) <= budget


def test_chunk_columns_raises_below_one_quantum():
    small = tmd.chunk_bytes(W16, tmd.PAD_QUANTUM, 3, 16) - 1
    with pytest.raises(RuntimeError, match="device bytes"):
        tmd.chunk_columns(W16, NP, 3, 16, small)


def test_env_chunk_counts_stream_entries(monkeypatch):
    """ZKPOS_MSM_CHUNK as the JAX package's _chunk_cols reads it: entries
    over W, at least 256, down to a power of two; it overrides the plan's
    automatic chunk, and the plan's own chunk overrides it."""
    monkeypatch.delenv("ZKPOS_MSM_CHUNK", raising=False)
    assert tmd.env_chunk_columns(W16) is None
    monkeypatch.setenv("ZKPOS_MSM_CHUNK", str(1 << 21))
    assert tmd.env_chunk_columns(W16) == jmd._chunk_cols(W16) == 1 << 17
    assert tmd.env_chunk_columns(W12) == jmd._chunk_cols(W12) == 1 << 16
    monkeypatch.setenv("ZKPOS_MSM_CHUNK", "64")
    assert tmd.env_chunk_columns(W12) == 256
    plan = tmd.ScalarPlan(list(range(1000)), c=8, device="cpu", windows=2)
    assert tmd.plan_columns(plan, 3, "cpu") == 256
    plan.chunk = 64
    assert tmd.plan_columns(plan, 3, "cpu") == 64
    monkeypatch.delenv("ZKPOS_MSM_CHUNK")
    plan.chunk = 0
    assert tmd.plan_columns(plan, 3, "cpu") == plan.Np   # no CPU budget


G1_WIRES = 1924679 * 96
SIZES = {"a_g1": G1_WIRES, "b1_g1": G1_WIRES, "k_g1": G1_WIRES - 96 * 2,
         "z_g1": ((1 << 21) - 1) * 96, "b_g2": 1924679 * 192}


@pytest.mark.parametrize("budget,keep", [
    (None, set(SIZES)),
    (0, set()),
    (sum(SIZES.values()), set(SIZES)),
    (sum(SIZES.values()) - 1, {"a_g1", "b1_g1", "k_g1", "z_g1"}),
    (2 * G1_WIRES, {"a_g1", "b1_g1"}),
    (G1_WIRES + SIZES["k_g1"], {"a_g1", "k_g1"}),
    (SIZES["z_g1"], {"a_g1"}),
    (G1_WIRES - 1, {"k_g1"}),
])
def test_resident_bases_from_byte_counts(budget, keep):
    """The MSM bases kept on the device, in MSM_BASES order, each that
    still fits beside those before it (the repo-size prove's bytes)."""
    assert tg16.resident_bases(SIZES, budget) == keep


def test_key_budget_env_and_cpu(monkeypatch):
    monkeypatch.delenv("ZKPOS_PK_DEVCACHE_GB", raising=False)
    assert tg16.key_budget("cpu", 1924679, 1 << 21) is None
    monkeypatch.setenv("ZKPOS_PK_DEVCACHE_GB", "0.5")
    assert tg16.key_budget("cpu", 1924679, 1 << 21) == 1 << 29


# --- the 2^26-point MSMs' oracle and inputs ------------------------------------

@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_progression_oracle_equals_host_msm(curve):
    """chip_smoke.progression_inputs at N = 64 on the CPU: the bases are
    aG, aG + bG, ... (host adds), the scalars c + i d mod r; the host MSM
    over them (G1; in G2 its scalar, the bases' discrete logs being
    known) equals progression_msm_scalar's closed form."""
    n = 64
    a, b, c, d = chip_smoke.progression_seeds(curve)
    gen, add, mul = CURVES[curve]
    base, sc = chip_smoke.progression_inputs(curve, n, a, b, c, d, "cpu")
    pts = ec.to_affine(base)
    ints = [int.from_bytes(r.tobytes(), "little") for r in sc.numpy()]
    assert ints == [(c + i * d) % bn.R for i in range(n)]
    bg, p = mul(gen, b), mul(gen, a)
    for got in pts:
        assert got == p
        p = add(p, bg)
    k = chip_smoke.progression_msm_scalar(n, a, b, c, d)
    assert k == sum(s * (a + i * b) for i, s in enumerate(ints)) % bn.R
    assert k != chip_smoke.progression_msm_scalar(n - 1, a, b, c, d)
    if curve == "g1":
        host = None
        for p, s in zip(pts, ints):
            host = add(host, mul(p, s))
        assert host == mul(gen, k)
