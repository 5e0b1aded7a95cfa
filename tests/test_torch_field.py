"""The port's field core (zkpos_tpu_torch/ops/field.py, the plain versions
of csrc/fr_kernels.cu) against the JAX package's FR / FP engines
(zkpos_tpu/ops/fd32.py), its NTT (groth16/ntt_device.py, groth16/ntt.py)
and Python ints.  Exact: canonical standard-form values compared with ==.
"""
import numpy as np
import pytest
import torch

from zkpos_tpu.crypto import bn254 as bn
from zkpos_tpu.groth16 import ntt as jntt
from zkpos_tpu.groth16 import ntt_device as jntt_dev
from zkpos_tpu.ops import fd32

from zkpos_tpu_torch.ops import field as F
from zkpos_tpu_torch.groth16 import ntt_device as tntt

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)

R272 = 1 << 272


def _values(mod, n, seed):
    rng = np.random.default_rng(seed)
    vals = [0, 1, mod - 1, mod - 2]
    vals += [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]
    return vals


def _jax_op(eng, op, xs, ys):
    """xs op ys on the JAX digit engine, back to standard-form ints."""
    import jax.numpy as jnp
    m = eng.modulus
    a = jnp.asarray(eng.ints_to_digits([x * R272 % m for x in xs]))
    b = jnp.asarray(eng.ints_to_digits([y * R272 % m for y in ys]))
    out = {"mul": eng.mont_mul, "add": eng.add, "sub": eng.sub}[op](a, b)
    rinv = pow(R272, -1, m)
    return [v * rinv % m for v in eng.digits_to_ints(np.asarray(out))]


def _port_op(field, op, xs, ys):
    a = F.to_mont(F.ints_to_tensor(xs), field)
    b = F.to_mont(F.ints_to_tensor(ys), field)
    out = {"mul": F.mul, "add": F.add, "sub": F.sub}[op](a, b, field)
    return F.tensor_to_ints(F.from_mont(out, field))


@pytest.mark.parametrize("field,op", [(f, o) for f in ("fr", "fp")
                                      for o in ("mul", "add", "sub")])
def test_field_ops_match_fd32_and_ints(field, op):
    fid, eng = (F.FR, fd32.FR) if field == "fr" else (F.FP, fd32.FP)
    m = eng.modulus
    xs = _values(m, 40, 1)
    ys = list(reversed(_values(m, 40, 2)))
    want = {"mul": lambda x, y: x * y % m, "add": lambda x, y: (x + y) % m,
            "sub": lambda x, y: (x - y) % m}[op]
    ref = [want(x, y) for x, y in zip(xs, ys)]
    assert _port_op(fid, op, xs, ys) == ref
    assert _jax_op(eng, op, xs, ys) == ref


def test_montgomery_form_and_broadcast_constant():
    xs = _values(bn.R, 20, 3)
    t = F.ints_to_tensor(xs)
    mont = F.to_mont(t)
    assert F.tensor_to_ints(mont) == [x * (1 << 256) % bn.R for x in xs]
    assert F.tensor_to_ints(F.from_mont(mont)) == xs
    seven = F.const(7, F.FR)
    assert F.tensor_to_ints(F.from_mont(F.mul(mont, seven))) == \
        [7 * x % bn.R for x in xs]


def test_inverse_and_powers():
    xs = [1, 2, bn.P - 1] + _values(bn.P, 5, 4)[4:]
    inv = F.inverse(F.to_mont(F.ints_to_tensor(xs), F.FP), F.FP)
    assert F.tensor_to_ints(F.from_mont(inv, F.FP)) == \
        [pow(x, -1, bn.P) for x in xs]
    pw = F.from_mont(F.powers(5, 37, "cpu", start=3))
    assert F.tensor_to_ints(pw) == [3 * pow(5, i, bn.R) % bn.R
                                    for i in range(37)]


def test_u64_rows_are_a_view_of_the_limbs():
    xs = _values(bn.R, 6, 5)
    rows = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs),
                         dtype=np.uint64).reshape(-1, 4)
    t = F.u64_to_tensor(rows)
    assert F.tensor_to_ints(t) == xs
    assert np.array_equal(t.numpy().view(np.uint64), rows)


def test_csr_eval_matches_python():
    rng = np.random.default_rng(6)
    n_rows, n_x = 9, 12
    lens = rng.integers(0, 6, n_rows)
    lens[3] = 40                                    # one wide row
    row = torch.from_numpy(np.repeat(np.arange(n_rows), lens).astype(np.int32))
    T = int(lens.sum())
    col = torch.from_numpy(rng.integers(0, n_x, T).astype(np.int32))
    cid = torch.from_numpy(rng.integers(0, 4, T).astype(np.int32))
    xs = _values(bn.R, n_x, 7)[:n_x]
    pool = [1, bn.R - 1, 12345, _values(bn.R, 1, 8)[-1]]
    out = F.csr_eval(row, col, cid, F.to_mont(F.ints_to_tensor(pool)),
                     F.to_mont(F.ints_to_tensor(xs)), n_rows)
    want = [0] * n_rows
    for t in range(T):
        want[row[t]] = (want[row[t]] + pool[cid[t]] * xs[col[t]]) % bn.R
    assert F.tensor_to_ints(F.from_mont(out)) == want


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_and_host(inverse):
    import jax.numpy as jnp
    n = 64
    xs = _values(bn.R, n, 9)[:n]
    port = F.tensor_to_ints(F.from_mont(
        tntt.ntt_mont(F.to_mont(F.ints_to_tensor(xs)), inverse=inverse)))
    jd = jnp.asarray(fd32.FR.ints_to_digits([x * R272 % bn.R for x in xs]))
    jout = jntt_dev.ntt_mont(jd, inverse=inverse)
    rinv = pow(R272, -1, bn.R)
    jax_vals = [v * rinv % bn.R
                for v in fd32.FR.digits_to_ints(np.asarray(jout))]
    host = jntt.ntt(xs, inverse=inverse)
    assert port == host
    assert jax_vals == host
