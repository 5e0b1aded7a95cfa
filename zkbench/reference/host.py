"""The benchmark's host reference: BN254's fields, its G1 and G2 groups,
the Groth16 domain's root of unity and Poseidon at width 3, in Python
integers.  Imports nothing of the program.

Frozen copies, so that later changes to the program do not move the
yardstick:
  * the curve and field constants and the affine group law follow
    zkpos_tpu_torch/crypto/bn254.py (gnark-crypto's ecc/bn254), here in
    Jacobian coordinates for speed;
  * the two-adic root follows zkpos_tpu_torch/groth16/ntt.py
    (``_two_adic_root``, ``root_of_unity``): the domain's generator is part
    of the statement a Groth16 key is made for;
  * the Poseidon parameters follow zkpos_tpu_torch/crypto/poseidon_params.py
    (the Grain LFSR of the Poseidon paper, circomlib's R_F = 8 and R_P
    table, digest at state[1] as the bnb-chain gnark-crypto fork returns
    it), the permutation zkpos_tpu_torch/crypto/poseidon_ref.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

TWO_ADICITY = 28

G1_GEN = (1, 2)
G2_GEN = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
           11559732032986387107991004021392285783925812861821192530917403151452391805634),
          (8495653923123431417604973247489272438418190587263600148770280649306958101930,
           4082367875863433681332203403145435568316851327593401208105741076214120093531))


# --- the domain ----------------------------------------------------------------

@lru_cache(maxsize=None)
def two_adic_root() -> int:
    """An element of Fr of exact order 2^28: w^((r-1)/2^28) for the least
    g >= 2 whose power has that order."""
    odd = (R - 1) >> TWO_ADICITY
    g = 2
    while True:
        w = pow(g, odd, R)
        if pow(w, 1 << (TWO_ADICITY - 1), R) != 1:
            return w
        g += 1


def root_of_unity(log_n: int) -> int:
    return pow(two_adic_root(), 1 << (TWO_ADICITY - log_n), R)


# --- Fp2 as pairs, and the groups in Jacobian coordinates ------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    ac, bd = a[0] * b[0], a[1] * b[1]
    return ((ac - bd) % P, ((a[0] + a[1]) * (b[0] + b[1]) - ac - bd) % P)


def f2_inv(a):
    t = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return (a[0] * t % P, -a[1] * t % P)


class _Fp:
    zero, one = 0, 1
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    inv = staticmethod(lambda a: pow(a, P - 2, P))


class _Fp2:
    zero, one = (0, 0), (1, 0)
    add, sub, mul, inv = (staticmethod(f2_add), staticmethod(f2_sub),
                          staticmethod(f2_mul), staticmethod(f2_inv))


def _jac_double(F, p):
    x, y, z = p
    if z == F.zero:
        return p
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul(b, b)
    d = F.sub(F.mul(F.add(x, b), F.add(x, b)), F.add(a, c))
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    x3 = F.sub(F.mul(e, e), F.add(d, d))
    c8 = F.add(c, c)
    c8 = F.add(c8, c8)
    c8 = F.add(c8, c8)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.mul(F.add(y, y), z)
    return (x3, y3, z3)


def _jac_add_affine(F, p, q):
    """p (Jacobian) + q (affine, not the identity)."""
    x1, y1, z1 = p
    if z1 == F.zero:
        return (q[0], q[1], F.one)
    z1z1 = F.mul(z1, z1)
    u2 = F.mul(q[0], z1z1)
    s2 = F.mul(F.mul(q[1], z1), z1z1)
    h = F.sub(u2, x1)
    rr = F.sub(s2, y1)
    if h == F.zero:
        if rr == F.zero:
            return _jac_double(F, p)
        return (F.one, F.one, F.zero)
    hh = F.mul(h, h)
    hhh = F.mul(h, hh)
    v = F.mul(x1, hh)
    x3 = F.sub(F.sub(F.mul(rr, rr), hhh), F.add(v, v))
    y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.mul(y1, hhh))
    z3 = F.mul(z1, h)
    return (x3, y3, z3)


def _mul(F, pt, k: int):
    """k * pt for an affine pt; the affine result, None for the identity."""
    k %= R
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:] if k else "":
        acc = _jac_double(F, acc)
        if bit == "1":
            acc = _jac_add_affine(F, acc, pt)
    x, y, z = acc
    if z == F.zero:
        return None
    zi = F.inv(z)
    zi2 = F.mul(zi, zi)
    return (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))


def g1_mul(pt, k: int):
    return _mul(_Fp, pt, k)


def g2_mul(pt, k: int):
    return _mul(_Fp2, pt, k)


def g1_on_curve(pt) -> bool:
    x, y = pt
    return (y * y - x * x * x - 3) % P == 0


# --- Poseidon ----------------------------------------------------------------------

N_BITS = 254
R_FULL = 8
_R_P_TABLE = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
OUTPUT_INDEX = 1


def partial_rounds(t: int) -> int:
    return _R_P_TABLE[t - 2]


class _Grain:
    """The 80-bit Grain LFSR in self-shrinking mode
    (generate_parameters_grain.sage)."""

    def __init__(self, t: int, r_p: int):
        bits: List[int] = []
        for value, width in ((1, 2), (0, 4), (N_BITS, 12), (t, 12),
                             (R_FULL, 10), (r_p, 10)):
            bits.extend(int(b) for b in bin(value)[2:].zfill(width))
        bits.extend([1] * 30)
        self.state = bits
        for _ in range(160):
            self._raw()

    def _raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def bit(self) -> int:
        while True:
            b1, b2 = self._raw(), self._raw()
            if b1 == 1:
                return b2

    def raw_element(self) -> int:
        v = 0
        for _ in range(N_BITS):
            v = (v << 1) | self.bit()
        return v


@lru_cache(maxsize=None)
def poseidon_params(t: int) -> Tuple[tuple, tuple]:
    """(round constants, flat in round order; the t x t Cauchy MDS)."""
    r_p = partial_rounds(t)
    g = _Grain(t, r_p)
    consts = []
    while len(consts) < (R_FULL + r_p) * t:
        v = g.raw_element()
        if v < R:
            consts.append(v)
    while True:
        samples = [g.raw_element() % R for _ in range(2 * t)]
        if len(set(samples)) == 2 * t:
            break
    xs, ys = samples[:t], samples[t:]
    mds = tuple(tuple(pow((xs[i] + ys[j]) % R, R - 2, R) for j in range(t))
                for i in range(t))
    return tuple(consts), mds


def permutation(state: List[int], r_p: int | None = None) -> List[int]:
    """The Poseidon permutation of a width-t state; `r_p` partial rounds
    (the parameters' own by default)."""
    t = len(state)
    consts, mds = poseidon_params(t)
    r_p = partial_rounds(t) if r_p is None else r_p
    half = R_FULL // 2
    for rnd in range(R_FULL + r_p):
        state = [(s + consts[rnd * t + i]) % R for i, s in enumerate(state)]
        if rnd < half or rnd >= half + r_p:
            state = [pow(s, 5, R) for s in state]
        else:
            state[0] = pow(state[0], 5, R)
        state = [sum(mds[i][j] * state[j] for j in range(t)) % R
                 for i in range(t)]
    return state


def hash2(a: int, b: int) -> int:
    """The tree's node hash: Poseidon(a, b)."""
    return permutation([0, a % R, b % R])[OUTPUT_INDEX]
