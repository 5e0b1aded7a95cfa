"""Serialization: gnark-crypto-style compressed points + proof/vk layouts.

Counterpart of zkpos_tpu/groth16/serialize.py, on this package's host
affine points (the fields of groth16.Proof and groth16.VerifyingKey);
the bytes are the same.

Encodings follow gnark-crypto's bn254 marshalling conventions
(flag bits in the two MSBs of the first byte):
    00 uncompressed, 10 compressed y-smallest, 11 compressed y-largest,
    01 compressed infinity.
G1: 32 bytes (X).  G2: 64 bytes (X.A1 || X.A0).

Proof layout (gnark groth16 bn254 WriteTo order): Ar(G1) | Bs(G2) | Krs(G1)
| uint32 #commitments | commitments... | commitmentPok(G1).
VK layout (gnark marshal.go order): Alpha(G1) | Beta(G1) | Beta(G2) |
Gamma(G2) | Delta(G1) | Delta(G2) | uint32 #K | K points.

The byte layouts were reconstructed from the public gnark source
conventions and cannot be byte-tested offline (see COMPAT.md); the field
order lives in this one module so corrections are single-line.
"""

from __future__ import annotations

import base64
import struct
from typing import List, Optional, Tuple

from ..crypto import bn254 as bn

_M_UNCOMPRESSED = 0b00 << 6
_M_INFINITY = 0b01 << 6
_M_SMALLEST = 0b10 << 6
_M_LARGEST = 0b11 << 6
_FLAG_MASK = 0b11 << 6


def _sqrt_fp(a: int) -> Optional[int]:
    """Square root in Fp (p % 4 == 3)."""
    r = pow(a, (bn.P + 1) // 4, bn.P)
    return r if r * r % bn.P == a % bn.P else None


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(32)
        out[0] = _M_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x.to_bytes(32, "big"))
    flag = _M_LARGEST if y > bn.P - y else _M_SMALLEST
    out[0] |= flag
    return bytes(out)


def g1_from_bytes(data: bytes):
    flag = data[0] & _FLAG_MASK
    if flag == _M_INFINITY:
        return None
    x_bytes = bytearray(data[:32])
    x_bytes[0] &= ~_FLAG_MASK & 0xFF
    x = int.from_bytes(bytes(x_bytes), "big")
    y2 = (x * x * x + 3) % bn.P
    y = _sqrt_fp(y2)
    if y is None:
        raise ValueError("invalid G1 point")
    is_larger = y > bn.P - y
    if (flag == _M_LARGEST) != is_larger:
        y = bn.P - y
    return (x, y)


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(64)
        out[0] = _M_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x.c1.to_bytes(32, "big") + x.c0.to_bytes(32, "big"))
    # lexicographic order on (c1, c0)
    neg = bn.Fp2(bn.P - y.c0 if y.c0 else 0, bn.P - y.c1 if y.c1 else 0)
    larger = (y.c1, y.c0) > (neg.c1, neg.c0)
    out[0] |= _M_LARGEST if larger else _M_SMALLEST
    return bytes(out)


def g2_from_bytes(data: bytes):
    flag = data[0] & _FLAG_MASK
    if flag == _M_INFINITY:
        return None
    b = bytearray(data[:64])
    b[0] &= ~_FLAG_MASK & 0xFF
    x = bn.Fp2(int.from_bytes(bytes(b[32:64]), "big"),
               int.from_bytes(bytes(b[:32]), "big"))
    y2 = x.square() * x + bn.B2
    y = _sqrt_fp2(y2)
    if y is None:
        raise ValueError("invalid G2 point")
    neg = bn.Fp2((bn.P - y.c0) % bn.P, (bn.P - y.c1) % bn.P)
    larger = (y.c1, y.c0) > (neg.c1, neg.c0)
    if (flag == _M_LARGEST) != larger:
        y = neg
    return (x, y)


def _sqrt_fp2(a: "bn.Fp2") -> Optional["bn.Fp2"]:
    """Square root in Fp2 via the norm trick."""
    if a.is_zero():
        return bn.Fp2(0, 0)
    norm = (a.c0 * a.c0 + a.c1 * a.c1) % bn.P
    n = _sqrt_fp(norm)
    if n is None:
        return None
    for sign in (1, -1):
        lam = (a.c0 + sign * n) * bn.fp_inv(2) % bn.P
        x0 = _sqrt_fp(lam)
        if x0 is None:
            continue
        if x0 == 0:
            continue
        x1 = a.c1 * bn.fp_inv(2 * x0) % bn.P
        cand = bn.Fp2(x0, x1)
        if cand.square() == a:
            return cand
    return None


# --- proof / vk --------------------------------------------------------------

def proof_to_bytes(proof) -> bytes:
    out = g1_to_bytes(proof.ar)
    out += g2_to_bytes(proof.bs)
    out += g1_to_bytes(proof.krs)
    d = getattr(proof, "d", None)
    if d is None and getattr(proof, "pok", None) is None:
        out += struct.pack(">I", 0)      # no commitments (plain circuits)
        out += g1_to_bytes(None)         # commitment PoK
    else:
        out += struct.pack(">I", 1)
        out += g1_to_bytes(d)
        out += g1_to_bytes(proof.pok)
    return out


def proof_from_bytes(data: bytes):
    from .groth16 import Proof
    ar = g1_from_bytes(data[0:32])
    bs = g2_from_bytes(data[32:96])
    krs = g1_from_bytes(data[96:128])
    (ncomm,) = struct.unpack(">I", data[128:132])
    d = pok = None
    if ncomm:
        if ncomm != 1:
            raise ValueError("only single-commitment proofs supported")
        d = g1_from_bytes(data[132:164])
        pok = g1_from_bytes(data[164:196])
    return Proof(ar=ar, bs=bs, krs=krs, d=d, pok=pok)


def proof_to_base64(proof) -> str:
    return base64.b64encode(proof_to_bytes(proof)).decode()


def proof_from_base64(s: str):
    return proof_from_bytes(base64.b64decode(s))


def vk_to_bytes(vk) -> bytes:
    """gnark v0.10 bn254 VerifyingKey.WriteTo reconstruction (keygen
    main.go:46-66 writes these bytes; reference verifier main.go:284
    reads them):

      [α]₁ [β]₁ [β]₂ [γ]₂ [δ]₁ [δ]₂
      uint32 len(K) | K...                (public wires + one commitment
                                           slot per commitment — gnark
                                           appends the commitment-challenge
                                           K entries to G1.K)
      uint32 nbCommitments
      per commitment: pedersen.VerifyingKey = G (G₂) | GSigmaNeg (G₂)
      PublicAndCommitmentCommitted: uint32 outer len; per inner:
        uint32 len | uint64 big-endian values

    [β]₁/[δ]₁ are the real setup values (a gnark decoder subgroup-checks
    these slots).  GSigmaNeg = -σ[G]₂ per gnark's
    pedersen key convention (PoK check e(pok, G)·e(D, GSigmaNeg) == 1).
    Byte layout reconstructed from public gnark conventions; offline
    byte-testing is blocked (COMPAT.md), round-trip + frozen-vector
    tested."""
    from ..crypto import bn254 as bn
    out = g1_to_bytes(vk.alpha_g1)
    out += g1_to_bytes(getattr(vk, "beta_g1", None))
    out += g2_to_bytes(vk.beta_g2)
    out += g2_to_bytes(vk.gamma_g2)
    out += g1_to_bytes(getattr(vk, "delta_g1", None))
    out += g2_to_bytes(vk.delta_g2)
    k_pts = list(vk.k_gamma_g1)
    has_commit = vk.kc_g1 is not None
    if has_commit:
        k_pts.append(vk.kc_g1)
    out += struct.pack(">I", len(k_pts))
    for p in k_pts:
        out += g1_to_bytes(p)
    out += struct.pack(">I", 1 if has_commit else 0)
    if has_commit:
        out += g2_to_bytes(bn.G2_GEN)                    # pedersen G
        neg = (vk.sigma_g2[0], bn.Fp2((bn.P - vk.sigma_g2[1].c0) % bn.P,
                                      (bn.P - vk.sigma_g2[1].c1) % bn.P))
        out += g2_to_bytes(neg)                          # GSigmaNeg
    pcc = getattr(vk, "public_and_commitment_committed", None)
    if pcc is None:
        pcc = [[]] if has_commit else []
    out += struct.pack(">I", len(pcc))
    for inner in pcc:
        out += struct.pack(">I", len(inner))
        for v in inner:
            out += struct.pack(">Q", v)
    return out


def vk_from_bytes(data: bytes):
    from ..crypto import bn254 as bn
    from .groth16 import VerifyingKey
    off = 0
    alpha = g1_from_bytes(data[off:off + 32]); off += 32
    beta1 = g1_from_bytes(data[off:off + 32]); off += 32
    beta2 = g2_from_bytes(data[off:off + 64]); off += 64
    gamma2 = g2_from_bytes(data[off:off + 64]); off += 64
    delta1 = g1_from_bytes(data[off:off + 32]); off += 32
    delta2 = g2_from_bytes(data[off:off + 64]); off += 64
    (n,) = struct.unpack(">I", data[off:off + 4]); off += 4
    k = []
    for _ in range(n):
        k.append(g1_from_bytes(data[off:off + 32])); off += 32
    (ncomm,) = struct.unpack(">I", data[off:off + 4]); off += 4
    kc = sigma2 = None
    if ncomm:
        if ncomm != 1:
            raise ValueError("only single-commitment vks supported")
        g = g2_from_bytes(data[off:off + 64]); off += 64
        if g != bn.G2_GEN:
            raise ValueError("pedersen G is not the canonical generator")
        gsn = g2_from_bytes(data[off:off + 64]); off += 64
        sigma2 = (gsn[0], bn.Fp2((bn.P - gsn[1].c0) % bn.P,
                                 (bn.P - gsn[1].c1) % bn.P))
        kc = k.pop()                       # the appended commitment slot
        n -= 1
    pcc = None
    if off < len(data):
        (outer,) = struct.unpack(">I", data[off:off + 4]); off += 4
        pcc = []
        for _ in range(outer):
            (ln,) = struct.unpack(">I", data[off:off + 4]); off += 4
            inner = []
            for _ in range(ln):
                (v,) = struct.unpack(">Q", data[off:off + 8]); off += 8
                inner.append(v)
            pcc.append(inner)
    return VerifyingKey(alpha_g1=alpha, beta_g2=beta2, gamma_g2=gamma2,
                        delta_g2=delta2, k_gamma_g1=k, num_public=n,
                        kc_g1=kc, sigma_g2=sigma2,
                        beta_g1=beta1, delta_g1=delta1,
                        public_and_commitment_committed=pcc)
