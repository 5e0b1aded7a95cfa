"""The prove cell's reference: each proof's three points worked out from
the key's toxic waste, which the benchmark itself drew.

Groth16 with alpha, beta, gamma, delta and tau known gives every proof in
closed form.  With a(X), b(X), c(X) the polynomials that take the rows'
values a_c = <A_c, z>, b_c, c_c at w^c on the domain of d points,
L_c(tau) = Z(tau) w^c / (d (tau - w^c)) and Z(tau) = tau^d - 1:

  A = (alpha + a(tau) + r delta) G1
  B = (beta + b(tau) + s delta) G2
  C = ((beta a_S(tau) + alpha b_S(tau) + c_S(tau) + a(tau) b(tau) - c(tau))
       / delta + s a_s + r b_s - r s delta) G1

where a_S, b_S, c_S take only the wires the key's K MSM weighs (private,
outside the commitment's gamma column), and a(tau) b(tau) - c(tau) is
H(tau) Z(tau) for a witness that satisfies every constraint: a witness that
does not, or an H or MSM that is wrong, gives other points (Schwartz-Zippel
over tau).  So the check covers the five MSMs, H and the assembly, with no
MSM, NTT or key of its own.

The reference follows the program from two of its own products, as it
must: the compiled constraint system (the statement) and the solved
witness.  Their satisfaction is checked by this same comparison.  Rows are
evaluated as exact wide integers on the device (fr.wide, no reduction per
term) and reduced once per dot product.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import fr
from .host import G1_GEN, G2_GEN, R, g1_mul, g2_mul, root_of_unity

TERM_BLOCK = 1 << 22


def matrix_terms(constraints, which: int):
    """Row, wire and coefficient id of each term of matrix `which` (0 A,
    1 B, 2 C) of a flat constraint store (3 term counts a constraint; wire
    ids and coefficient ids by term; a coefficient pool)."""
    lens = np.frombuffer(constraints.lens, dtype=np.uint32).astype(np.int64)
    wires = np.frombuffer(constraints.vars, dtype=np.uint32)
    cids = np.frombuffer(constraints.coeffs, dtype=np.uint32)
    starts = np.cumsum(lens) - lens
    sel = np.arange(which, len(lens), 3)
    seg_lens = lens[sel]
    first = np.repeat(starts[sel], seg_lens)
    within = np.arange(int(seg_lens.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(seg_lens) - seg_lens, seg_lens)
    at = first + within
    rows = np.repeat(np.arange(len(sel), dtype=np.int64), seg_lens)
    return rows, wires[at].astype(np.int64), cids[at].astype(np.int64)


class ProveReference:
    """Everything of the closed form that does not depend on the witness,
    r or s: the domain, L_c(tau), the matrices' terms and the weighed
    wires.  `toxic`: alpha, beta, gamma, delta, tau."""

    def __init__(self, constraints, num_vars: int, num_public: int,
                 commitment: Optional[dict], toxic: Dict[str, int], device):
        self.dev = torch.device(device)
        self.toxic = toxic
        self.n_cons = len(constraints.lens) // 3
        d = 2
        while d < self.n_cons:
            d *= 2
        self.d = d
        self.terms = []
        for which in range(3):
            self.terms.append(tuple(torch.from_numpy(a).to(self.dev)
                                    for a in matrix_terms(constraints, which)))
        self.pool = fr.limbs_of(list(constraints.pool), self.dev)
        weighed = np.ones(num_vars, dtype=np.int64)
        weighed[:num_public] = 0
        if commitment:
            extra = list(commitment["wires"])
            if commitment.get("challenge") is not None:
                extra.append(commitment["challenge"])
            weighed[extra] = 0
        self.weighed = torch.from_numpy(weighed).to(self.dev)
        self.lagrange = self._lagrange()

    def _lagrange(self) -> torch.Tensor:
        """L_c(tau) for c < n_cons, standard-form limbs."""
        tau, d, n = self.toxic["tau"], self.d, self.n_cons
        w = root_of_unity(d.bit_length() - 1)
        z_tau = (pow(tau, d, R) - 1) % R
        if z_tau == 0:
            raise ValueError("tau lies in the domain")
        wp = fr.powers_mont(w, n, self.dev)
        den = fr.sub_mod(fr.const(tau * fr.RMONT % R, n, self.dev), wp)
        lag = fr.mont_mul(fr.batch_inverse_mont(den), wp)
        k = z_tau * pow(d, -1, R) % R
        lag = fr.mont_mul(lag, fr.const(k * fr.RMONT % R, n, self.dev))
        return fr.from_mont(lag)

    def evaluate(self, z_u64: np.ndarray) -> Dict[str, int]:
        """a(tau), b(tau), c(tau) and their weighed parts for a witness
        given as (N, 4) uint64 standard-form rows."""
        z = fr.limbs_of_u64(z_u64, self.dev)
        out = {}
        for name, (rows, wires, cids) in zip("abc", self.terms):
            acc = torch.zeros((self.n_cons, 2 * fr.LIMBS - 1),
                              dtype=torch.int64, device=self.dev)
            acc_w = torch.zeros_like(acc)
            for lo in range(0, rows.shape[0], TERM_BLOCK):
                r_ = rows[lo:lo + TERM_BLOCK]
                w_ = wires[lo:lo + TERM_BLOCK]
                prod = fr.wide(z[w_], self.pool[cids[lo:lo + TERM_BLOCK]])
                acc.index_add_(0, r_, prod)
                acc_w.index_add_(0, r_, prod * self.weighed[w_, None])
                del prod
            out[name] = fr.dot_int(fr.normalize(acc, 3), self.lagrange) % R
            del acc
            out[name + "_w"] = fr.dot_int(fr.normalize(acc_w, 3),
                                          self.lagrange) % R
            del acc_w
        return out

    def scalars(self, ev: Dict[str, int], r: int, s: int,
                hz: Optional[int] = None) -> Tuple[int, int, int]:
        """The discrete logs of A, B and C.  `hz` replaces H(tau) Z(tau)
        (a(tau) b(tau) - c(tau) of `ev` by default)."""
        t = self.toxic
        alpha, beta, delta = t["alpha"], t["beta"], t["delta"]
        if hz is None:
            hz = ev["a"] * ev["b"] - ev["c"]
        a_s = (alpha + ev["a"] + r * delta) % R
        b_s = (beta + ev["b"] + s * delta) % R
        k = beta * ev["a_w"] + alpha * ev["b_w"] + ev["c_w"] + hz
        c_s = (k * pow(delta, -1, R) + s * a_s + r * b_s - r * s * delta) % R
        return a_s, b_s, c_s

    @staticmethod
    def points(a_s: int, b_s: int, c_s: int):
        """(A, B, C) as affine points: G1 (x, y), G2 ((x0, x1), (y0, y1))."""
        return g1_mul(G1_GEN, a_s), g2_mul(G2_GEN, b_s), g1_mul(G1_GEN, c_s)


def hz_of(ev: Dict[str, int]) -> int:
    return (ev["a"] * ev["b"] - ev["c"]) % R
