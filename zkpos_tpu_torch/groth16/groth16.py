"""Groth16 over BN254 — Setup / Prove / Verify on the port's device engine.

Counterpart of zkpos_tpu/groth16/groth16.py (gnark's backend/groth16;
reference keygen main.go:42, prover.go:269-276, verifier main.go:284).
Setup evaluates the QAP at tau on the device (vectorised over the flat
constraint arrays) and builds the proving-key bases with the fixed-base
batch; the bases stay device tensors.  Prove computes H(X) with the device
NTT pipeline and runs the five MSMs on the sorted-stream engine.
Verification is the pairing check on the host oracle.

Proof system (standard Groth16):
  A = alpha + sum z_i A_i(tau) + r delta                       (G1)
  B = beta + sum z_i B_i(tau) + s delta                        (G2; B1 in G1)
  C = sum_priv z_i K_i + H(tau) Z(tau)/delta + s A + r B1 - r s delta  (G1)
  check: e(A, B) = e(alpha, beta) e(sum_pub z_i Kgamma_i, gamma) e(C, delta)
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..crypto import bn254 as bn
from ..crypto.bn254 import R as MOD
from ..ops import ec
from ..ops import field as F
from ..ops import msm_device as md
from ..ops.msm import fixed_base_batch
from ..utils.device import resolve
from .ntt import root_of_unity
from .qap_device import _cs_cache, _matrix_arrays, compute_h_device, pool_mont


@dataclass
class ProvingKey:
    alpha_g1: tuple
    beta_g1: tuple
    delta_g1: tuple
    a_g1: torch.Tensor                   # [A_i(tau)]_1 per wire, (N, 3, 8)
    b1_g1: torch.Tensor                  # [B_i(tau)]_1 per wire
    k_g1: torch.Tensor                   # [(beta A_i + alpha B_i + C_i)/delta]_1
    z_g1: torch.Tensor                   # [tau^i Z(tau)/delta]_1, i < d - 1
    beta_g2: tuple
    delta_g2: tuple
    b_g2: torch.Tensor                   # [B_i(tau)]_2 per wire, (N, 6, 8)
    num_public: int = 1
    domain_size: int = 0
    # Pedersen-commitment key (gnark bsb22 analog): bases for the committed
    # wires in cs.commitment["wires"] order, plus sigma-scaled bases for
    # the proof of knowledge.  None when the circuit has no commitment.
    commit_wires: Optional[List[int]] = None
    challenge_wire: Optional[int] = None
    ck_bases: Optional[torch.Tensor] = None
    ck_sigma_bases: Optional[torch.Tensor] = None
    # MSM bases with the identity row prepended, built on first prove
    dev_bases: dict = field(default_factory=dict, repr=False)


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    k_gamma_g1: List[Optional[tuple]]    # [(beta A_i + alpha B_i + C_i)/gamma]_1
    num_public: int = 1
    kc_g1: Optional[tuple] = None
    sigma_g2: Optional[tuple] = None
    beta_g1: Optional[tuple] = None
    delta_g1: Optional[tuple] = None
    public_and_commitment_committed: Optional[List[List[int]]] = None


@dataclass
class Proof:
    ar: tuple
    bs: tuple       # G2
    krs: tuple
    d: Optional[tuple] = None        # Pedersen commitment over committed wires
    pok: Optional[tuple] = None      # sigma-scaled proof of knowledge for d


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _by_var(cs, which: int, device):
    """The terms of matrix `which` by VARIABLE, for setup's A_i(tau) = sum
    over the constraints c using wire i of coeff * L_c(tau): variable,
    constraint and coefficient id, each (T,) int32, sorted by variable."""
    cache = _cs_cache(cs)
    key = ("vars", which, str(device))
    if key not in cache:
        rows, vars_, cids = _matrix_arrays(cs, which)
        order = np.argsort(vars_, kind="stable")
        cache[key] = tuple(torch.from_numpy(a[order].astype(np.int32))
                           .to(device) for a in (vars_, rows, cids))
    return cache[key]


def _qap_evals(cs, tau: int, device):
    """A_i(tau), B_i(tau), C_i(tau) per wire ((nv, 8) Montgomery tensors)
    via the Lagrange basis over the radix-2 domain:
    L_c(tau) = Z(tau) w^c / (n (tau - w^c))."""
    n_cons = len(cs.constraints)
    d = _next_pow2(max(n_cons, 2))
    log_d = d.bit_length() - 1
    z_tau = (pow(tau, d, MOD) - 1) % MOD
    if z_tau == 0:
        raise ValueError("tau in domain; resample")
    wpow = F.powers(root_of_unity(log_d), d, device)
    inv_den = F.inverse(F.sub(F.const(tau, F.FR, device), wpow))
    lag = F.mul(F.mul(inv_den, wpow),
                F.const(z_tau * pow(d, MOD - 2, MOD) % MOD, F.FR, device))
    pool = pool_mont(cs, device)
    nv = cs.num_vars
    evals = [F.csr_eval(*_by_var(cs, which, device), pool, lag, nv)
             for which in range(3)]
    return evals[0], evals[1], evals[2], z_tau, d


def _fb(curve: str, scalars_mont: torch.Tensor) -> torch.Tensor:
    return fixed_base_batch(curve, F.from_mont(scalars_mont))


def setup(cs, rng=None, device=None):
    """groth16.Setup (keygen main.go:42): toxic waste from `rng` (five
    draws: alpha, beta, gamma, delta, tau; then sigma for a commitment), the
    QAP at tau, and the key bases as device tensors."""
    dev = resolve(device)
    cs.finalize()   # deferred gadget constraints (logUp tables) belong in
    # the QAP, or the pk is built on a smaller system than prove() solves
    rand = rng or (lambda: secrets.randbelow(MOD - 1) + 1)
    alpha, beta, gamma, delta, tau = (rand() for _ in range(5))
    A, B, Cv, z_tau, d = _qap_evals(cs, tau, dev)
    npub = cs.num_public
    gamma_inv = pow(gamma, MOD - 2, MOD)
    delta_inv = pow(delta, MOD - 2, MOD)
    c = lambda v: F.const(v % MOD, F.FR, dev)

    k = F.add(F.add(F.mul(A, c(beta)), F.mul(B, c(alpha))), Cv)
    k_gamma = F.mul(k[:npub].contiguous(), c(gamma_inv))

    # Pedersen-commitment layout (gnark bsb22 analog): committed wires and
    # the challenge wire move from the delta column to the gamma column
    commit = cs.commitment
    commit_wires: List[int] = commit["wires"] if commit else []
    challenge_wire = commit["challenge"] if commit else None
    gamma_extra = set(commit_wires)
    if challenge_wire is not None:
        gamma_extra.add(challenge_wire)
    k_delta = F.mul(k[npub:].contiguous(), c(delta_inv))
    if gamma_extra:
        rows = torch.tensor(sorted(gamma_extra), dtype=torch.int64,
                            device=dev) - npub
        k_delta[rows] = 0
    if commit:
        cw = torch.tensor(commit_wires, dtype=torch.int64, device=dev)
        ck_scalars = F.mul(k[cw].contiguous(), c(gamma_inv))
        sigma = rand()
        ck_sigma_scalars = F.mul(ck_scalars, c(sigma))
        kc_scalar = F.mul(k[challenge_wire:challenge_wire + 1].contiguous(),
                          c(gamma_inv))

    # [tau^i Z(tau)/delta] for i < d - 1
    z_scalars = F.powers(tau, d - 1, dev, start=z_tau * delta_inv % MOD)

    pk = ProvingKey(
        alpha_g1=bn.g1_mul(bn.G1_GEN, alpha),
        beta_g1=bn.g1_mul(bn.G1_GEN, beta),
        delta_g1=bn.g1_mul(bn.G1_GEN, delta),
        a_g1=_fb("g1", A), b1_g1=_fb("g1", B), k_g1=_fb("g1", k_delta),
        z_g1=_fb("g1", z_scalars),
        beta_g2=bn.g2_mul(bn.G2_GEN, beta),
        delta_g2=bn.g2_mul(bn.G2_GEN, delta),
        b_g2=_fb("g2", B), num_public=npub, domain_size=d,
        commit_wires=commit_wires if commit else None,
        challenge_wire=challenge_wire,
        ck_bases=_fb("g1", ck_scalars) if commit else None,
        ck_sigma_bases=_fb("g1", ck_sigma_scalars) if commit else None)
    vk = VerifyingKey(
        alpha_g1=pk.alpha_g1,
        beta_g2=pk.beta_g2,
        gamma_g2=bn.g2_mul(bn.G2_GEN, gamma),
        delta_g2=pk.delta_g2,
        k_gamma_g1=ec.to_affine(_fb("g1", k_gamma)), num_public=npub,
        kc_g1=ec.to_affine(_fb("g1", kc_scalar))[0] if commit else None,
        sigma_g2=bn.g2_mul(bn.G2_GEN, sigma) if commit else None,
        beta_g1=pk.beta_g1, delta_g1=pk.delta_g1,
        public_and_commitment_committed=[[]] if commit else [])
    return pk, vk


def _bases(pk: ProvingKey) -> dict:
    """MSM bases with the identity row, built once per pk (the analog of
    gnark's LoadSnarkParamsOnce, reference prover.go:285-367)."""
    if not pk.dev_bases:
        for name, curve, pts in (("a", "g1", pk.a_g1), ("b1", "g1", pk.b1_g1),
                                 ("k", "g1", pk.k_g1), ("z", "g1", pk.z_g1),
                                 ("b2", "g2", pk.b_g2)):
            pk.dev_bases[name] = md.device_base(curve, pts)
    return pk.dev_bases


def prove(cs, pk: ProvingKey, rng=None, spans: Optional[dict] = None) -> Proof:
    """groth16.Prove (prover.go:269): witness from the solved system, H via
    the device NTT pipeline, five MSMs on the sorted-stream engine.  The
    witness's scalar plan is built once and shared by the A and B1 MSMs.
    With a `spans` dict, the seconds of each stage are recorded in it (the
    device is synchronized at each stage boundary)."""
    if not cs.solve:
        raise ValueError("prove requires a solved constraint system")
    if pk.commit_wires is not None and cs._commit_key is None:
        cs.set_commitment_key({"bases": pk.ck_bases,
                               "sigma_bases": pk.ck_sigma_bases})
    z = cs.witness_vector()
    rand = rng or (lambda: secrets.randbelow(MOD))
    r, s = rand(), rand()

    dev = pk.a_g1.device
    t0 = [time.perf_counter()]

    def span(name):
        if spans is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            spans[name] = spans.get(name, 0.0) + t - t0[0]
            t0[0] = t

    zt = md.scalars_tensor(z, dev)
    h = compute_h_device(cs, zt, pk.domain_size)
    span("compute_h")
    bases = _bases(pk)
    plan_z = md.ScalarPlan(zt, device=dev)
    span("plan_z")
    sum_a = md.msm("g1", bases["a"], plan=plan_z)
    span("msm_a")
    sum_b1 = md.msm("g1", bases["b1"], plan=plan_z)
    span("msm_b1")
    # G2: narrower windows at scale (16x smaller bucket grid over six
    # coordinates), as the reference engine
    plan_z2 = md.ScalarPlan(zt, c=12, device=dev) if zt.shape[0] > (1 << 17) \
        else plan_z
    del plan_z
    sum_b2 = md.msm("g2", bases["b2"], plan=plan_z2)
    del plan_z2
    span("msm_b2")
    krs_priv = md.msm("g1", bases["k"], scalars=zt[pk.num_public:])
    span("msm_k")
    krs_h = md.msm("g1", bases["z"], scalars=h)
    span("msm_z")

    ar = bn.g1_add(bn.g1_add(pk.alpha_g1, sum_a),
                   bn.g1_mul(pk.delta_g1, r))
    bs = bn.g2_add(bn.g2_add(pk.beta_g2, sum_b2),
                   bn.g2_mul(pk.delta_g2, s))
    b1 = bn.g1_add(bn.g1_add(pk.beta_g1, sum_b1),
                   bn.g1_mul(pk.delta_g1, s))
    krs = bn.g1_add(krs_priv, krs_h)
    krs = bn.g1_add(krs, bn.g1_mul(ar, s))
    krs = bn.g1_add(krs, bn.g1_mul(b1, r))
    krs = bn.g1_add(krs, bn.g1_neg(bn.g1_mul(pk.delta_g1, r * s % MOD)))
    d_pt = pok = None
    if pk.commit_wires is not None:
        if cs._commit_result is None:
            raise RuntimeError("commitment circuit solved without key")
        d_pt, pok, _cval = cs._commit_result
    span("assemble")
    return Proof(ar=ar, bs=bs, krs=krs, d=d_pt, pok=pok)


def commitment_challenge(d_pt) -> int:
    """Challenge value bound to the commitment point (gnark bsb22 SHA-256
    hash-to-field over the marshalled point)."""
    from .hash_to_field import bsb22_challenge
    return bsb22_challenge(d_pt)


def verify(proof: Proof, vk: VerifyingKey, public_inputs: List[int]) -> bool:
    """groth16.Verify (verifier main.go:284): the pairing check on the
    host.  Circuits with a Pedersen commitment add the D term on the gamma
    side plus the PoK check e(pok, G2) == e(D, sigma G2)."""
    z_pub = [1] + [v % MOD for v in public_inputs]
    if len(z_pub) != vk.num_public:
        return False
    for g1_pt in (proof.ar, proof.krs):
        if not bn.g1_is_on_curve(g1_pt):
            return False
    if not bn.g2_is_on_curve(proof.bs):
        return False
    acc = None
    for p, s in zip(vk.k_gamma_g1, z_pub):
        acc = bn.g1_add(acc, bn.g1_mul(p, s))
    if vk.kc_g1 is not None:
        if proof.d is None or proof.pok is None:
            return False
        if not (bn.g1_is_on_curve(proof.d)
                and bn.g1_is_on_curve(proof.pok)):
            return False
        c = commitment_challenge(proof.d)
        acc = bn.g1_add(acc, bn.g1_mul(vk.kc_g1, c))
        acc = bn.g1_add(acc, proof.d)
        pok_ok = bn.multi_pairing([
            (proof.pok, bn.G2_GEN),
            (bn.g1_neg(proof.d), vk.sigma_g2),
        ]) == bn.Fp12.ONE
        if not pok_ok:
            return False
    elif proof.d is not None or proof.pok is not None:
        return False
    lhs = bn.multi_pairing([
        (proof.ar, proof.bs),
        (bn.g1_neg(acc), vk.gamma_g2),
        (bn.g1_neg(proof.krs), vk.delta_g2),
        (bn.g1_neg(vk.alpha_g1), vk.beta_g2),
    ])
    return lhs == bn.Fp12.ONE


# --- carrying keys and proofs across packages ------------------------------------
#
# Points cross as numpy arrays: an (N, k, 4) uint64 array of standard-form
# affine coordinates (k = 2 for G1: x, y; k = 4 for G2: x.c0, x.c1, y.c0,
# y.c1) and an (N,) bool mask that is False where the point is None.

_PK_POINTS = {"alpha_g1": "g1", "beta_g1": "g1", "delta_g1": "g1",
              "beta_g2": "g2", "delta_g2": "g2"}
_PK_BASES = {"a_g1": "g1", "b1_g1": "g1", "k_g1": "g1", "z_g1": "g1",
             "b_g2": "g2", "ck_bases": "g1", "ck_sigma_bases": "g1"}
_VK_POINTS = {"alpha_g1": "g1", "beta_g2": "g2", "gamma_g2": "g2",
              "delta_g2": "g2", "kc_g1": "g1", "sigma_g2": "g2",
              "beta_g1": "g1", "delta_g1": "g1"}


def points_to_arrays(points):
    """Affine points (objects with .c0/.c1 for Fp2, None for the
    identity) -> (coords, mask)."""
    rows, mask = [], []
    for p in points:
        if p is None:
            rows.append(None)
            mask.append(False)
            continue
        if isinstance(p[0], int):
            rows.append([p[0], p[1]])
        else:
            rows.append([p[0].c0, p[0].c1, p[1].c0, p[1].c1])
        mask.append(True)
    k = next((len(r) for r in rows if r is not None), 2)
    flat = [v for r in rows for v in (r if r is not None else [0] * k)]
    buf = b"".join(int(v).to_bytes(32, "little") for v in flat)
    coords = np.frombuffer(buf, dtype=np.uint64).reshape(len(points), k, 4)
    return coords.copy(), np.asarray(mask, dtype=bool)


def arrays_to_points(coords: np.ndarray, mask: np.ndarray) -> list:
    """(coords, mask) -> affine host points of this package."""
    out = []
    for row, present in zip(coords, mask):
        if not present:
            out.append(None)
            continue
        v = [int.from_bytes(c.tobytes(), "little") for c in row]
        out.append((v[0], v[1]) if len(v) == 2 else
                   (bn.Fp2(v[0], v[1]), bn.Fp2(v[2], v[3])))
    return out


def _arrays_to_tensor(coords: np.ndarray, mask: np.ndarray, curve: str,
                      device) -> torch.Tensor:
    """(coords, mask) -> projective (N, na, 8) device points, vectorised:
    Montgomery conversion on the device, Z = 1, identity where masked."""
    n, k = coords.shape[0], coords.shape[1]
    na = 3 if curve == "g1" else 6
    xy = F.to_mont(F.u64_to_tensor(coords.reshape(n * k, 4), device),
                   F.FP).reshape(n, k, 8)
    out = ec.identity(na, n, device)
    m = torch.from_numpy(np.asarray(mask, dtype=bool)).to(device)
    one = F.const(1, F.FP, device).reshape(8)
    sel = out[m]
    sel[:, :k] = xy[m]
    sel[:, k] = one
    if na == 6:
        sel[:, 5] = 0
    out[m] = sel
    return out


def keys_from_arrays(pk_arrays: dict, vk_arrays: dict, device=None):
    """The JAX package's keys, carried across as arrays, as this package's
    (ProvingKey, VerifyingKey).  Point fields map to (coords, mask) pairs;
    the rest (num_public, domain_size, commit_wires, challenge_wire,
    public_and_commitment_committed, and vk.k_gamma_g1 as a base) are as
    in the dataclasses."""
    dev = resolve(device)
    pk_kw = {}
    for name, val in pk_arrays.items():
        if name in _PK_POINTS:
            pk_kw[name] = arrays_to_points(*val)[0]
        elif name in _PK_BASES:
            pk_kw[name] = (None if val is None else
                           _arrays_to_tensor(*val, _PK_BASES[name], dev))
        else:
            pk_kw[name] = val
    vk_kw = {}
    for name, val in vk_arrays.items():
        if name in _VK_POINTS:
            vk_kw[name] = None if val is None else arrays_to_points(*val)[0]
        elif name == "k_gamma_g1":
            vk_kw[name] = arrays_to_points(*val)
        else:
            vk_kw[name] = val
    return ProvingKey(**pk_kw), VerifyingKey(**vk_kw)


def proof_to_arrays(proof: Proof) -> dict:
    """The reverse for a proof: field name -> (coords, mask), None for an
    absent commitment, so the JAX package can rebuild and verify it."""
    return {name: (None if getattr(proof, name) is None else
                   points_to_arrays([getattr(proof, name)]))
            for name in ("ar", "bs", "krs", "d", "pok")}
