"""Versioned binary key / R1CS artifacts.

Counterpart of zkpos_tpu/groth16/artifact.py: the same `ZKPOSAR1`
container, version and section names, so a key written by either package
loads in the other (reference keygen main.go:46-66 writes
`zkpor<assets>_<batch>.pk/.vk/.r1cs`; prover.go:302-343 reads them).

  * `.vk` — exactly the gnark-layout bytes (serialize.vk_to_bytes).
  * `.pk` / `.r1cs` — a JSON header (scalars, shapes, section table) and
    raw little-endian numpy sections.

The proving key's bases are tensors here (projective, Montgomery form;
groth16.ProvingKey), on the device or, past its budget, in host memory
(groth16.place_bases).  A save normalises them on the device: the
affine coordinates from one batched inverse, out of Montgomery form, as
(n, 2, 4) / (n, 4, 4) uint64 limbs with a u8 mask that is 0 at the
identity, then one copy to the host (groth16.tensor_to_arrays).  A load
maps the file, makes one host-to-device copy of each section and converts
it to Montgomery form on the device (groth16.arrays_to_tensor).  No point
passes through Python ints.

The JAX package also reads its legacy gzip-pickle artifacts; this package
never wrote pickles, so it has no such reader.

Container layout:
  b"ZKPOSAR1" | u32 version | u64 header_len | header JSON | sections
Section entries: {"name", "dtype", "shape", "offset", "nbytes"}, offsets
relative to the end of the header, 64-byte aligned.
"""

from __future__ import annotations

import json
import os
from array import array
from typing import Dict, Optional

import numpy as np

from ..crypto import bn254 as bn
from ..utils import native
from ..utils.device import resolve
from . import groth16 as g16
from .serialize import vk_from_bytes, vk_to_bytes

MAGIC = b"ZKPOSAR1"
VERSION = 1
_ALIGN = 64


# --- container io ------------------------------------------------------------

def _write_container(path: str, meta: dict,
                     sections: Dict[str, np.ndarray]) -> None:
    table = []
    off = 0
    for name, arr in sections.items():
        arr = np.ascontiguousarray(arr)
        sections[name] = arr
        off = -(-off // _ALIGN) * _ALIGN
        table.append({"name": name, "dtype": str(arr.dtype),
                      "shape": list(arr.shape), "offset": off,
                      "nbytes": arr.nbytes})
        off += arr.nbytes
    header = json.dumps({"meta": meta, "sections": table}).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(VERSION.to_bytes(4, "little"))
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        base = f.tell()
        for entry, arr in zip(table, sections.values()):
            f.seek(base + entry["offset"])
            f.write(arr.data)
    os.replace(tmp, path)


def _read_container(path: str):
    """(meta, {name: np.ndarray}): the arrays are copy-on-write views of
    the mapped file, read as they are used."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 12)
        if head[:len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a ZKPOS artifact")
        version = int.from_bytes(head[8:12], "little")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported artifact version "
                             f"{version}")
        hlen = int.from_bytes(head[12:20], "little")
        header = json.loads(f.read(hlen))
        base = f.tell()
        f.seek(0, 2)
        end = f.tell()
    buf = np.memmap(path, dtype=np.uint8, mode="c", offset=base,
                    shape=(end - base,))
    out = {}
    for s in header["sections"]:
        raw = buf[s["offset"]:s["offset"] + s["nbytes"]]
        out[s["name"]] = np.asarray(raw).view(np.dtype(s["dtype"])) \
            .reshape(s["shape"])
    return header["meta"], out


# --- pk ----------------------------------------------------------------------

def _pt_hex(p) -> Optional[list]:
    if p is None:
        return None
    if isinstance(p[0], bn.Fp2):
        return [hex(p[0].c0), hex(p[0].c1), hex(p[1].c0), hex(p[1].c1)]
    return [hex(p[0]), hex(p[1])]


def _pt_unhex(v, curve: str):
    if v is None:
        return None
    ints = [int(x, 16) for x in v]
    if curve == "g1":
        return (ints[0], ints[1])
    return (bn.Fp2(ints[0], ints[1]), bn.Fp2(ints[2], ints[3]))


def save_pk(path: str, pk: g16.ProvingKey) -> None:
    meta = {
        "kind": "pk",
        "num_public": pk.num_public,
        "domain_size": pk.domain_size,
        "commit_wires": pk.commit_wires,
        "challenge_wire": pk.challenge_wire,
        "alpha_g1": _pt_hex(pk.alpha_g1),
        "beta_g1": _pt_hex(pk.beta_g1),
        "delta_g1": _pt_hex(pk.delta_g1),
        "beta_g2": _pt_hex(pk.beta_g2),
        "delta_g2": _pt_hex(pk.delta_g2),
    }
    sections: Dict[str, np.ndarray] = {}
    for name, curve in g16._PK_BASES.items():
        pts = getattr(pk, name)
        if pts is None:
            meta[name] = None
            continue
        coords, mask = g16.tensor_to_arrays(pts.to(pk.device))
        meta[name] = curve
        sections[name + ".limbs"] = coords
        sections[name + ".mask"] = mask.astype(np.uint8)
    _write_container(path, meta, sections)


def load_pk(path: str, device=None) -> g16.ProvingKey:
    """The proving key with its bases as tensors on `device` (the card
    unless the caller asks for the CPU), each MSM base there or in host
    memory as groth16.resident_bases decides from the sections' bytes and
    the device's budget (groth16.key_budget), one base at a time."""
    dev = resolve(device)
    meta, sec = _read_container(path)
    na = {"g1": 3, "g2": 6}
    sizes = {name: sec[name + ".limbs"].shape[0] * na[curve] * 32
             for name, curve in g16.MSM_BASES}
    keep = g16.resident_bases(sizes, g16.key_budget(
        dev, sec["a_g1.limbs"].shape[0], meta["domain_size"]))
    bases = {}
    for name, curve in g16._PK_BASES.items():
        pts = None if meta.get(name) is None else g16.arrays_to_tensor(
            sec[name + ".limbs"], sec[name + ".mask"], curve, dev)
        bases[name] = (g16.to_host(pts, dev) if name in sizes
                       and name not in keep else pts)
    return g16.ProvingKey(
        device=dev, streamed=frozenset(sizes) - keep,
        alpha_g1=_pt_unhex(meta["alpha_g1"], "g1"),
        beta_g1=_pt_unhex(meta["beta_g1"], "g1"),
        delta_g1=_pt_unhex(meta["delta_g1"], "g1"),
        beta_g2=_pt_unhex(meta["beta_g2"], "g2"),
        delta_g2=_pt_unhex(meta["delta_g2"], "g2"),
        num_public=meta["num_public"],
        domain_size=meta["domain_size"],
        commit_wires=meta["commit_wires"],
        challenge_wire=meta["challenge_wire"], **bases)


# --- vk ----------------------------------------------------------------------

def save_vk(path: str, vk: g16.VerifyingKey) -> None:
    """The .vk artifact is the gnark-layout bytes (keygen main.go:56-60
    writes vk.WriteTo)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(vk_to_bytes(vk))
    os.replace(tmp, path)


def load_vk(path: str) -> g16.VerifyingKey:
    with open(path, "rb") as f:
        return vk_from_bytes(f.read())


# --- r1cs --------------------------------------------------------------------

def save_r1cs(path: str, meta_dict: dict) -> None:
    """meta_dict: the keygen dict (num_vars/num_public/num_constraints/
    range_bits/commitment/constraints/solver_program)."""
    fc = meta_dict["constraints"]
    if not hasattr(fc, "lens"):
        raise ValueError("r1cs artifact requires FlatConstraints")
    meta = {
        "kind": "r1cs",
        "num_vars": meta_dict["num_vars"],
        "num_public": meta_dict["num_public"],
        "num_constraints": meta_dict["num_constraints"],
        "range_bits": meta_dict["range_bits"],
        "commitment": meta_dict.get("commitment"),
    }
    sections: Dict[str, np.ndarray] = {
        "fc.vars": np.frombuffer(fc.vars, dtype=np.uint32),
        "fc.coeffs": np.frombuffer(fc.coeffs, dtype=np.uint32),
        "fc.lens": np.frombuffer(fc.lens, dtype=np.uint32),
        "fc.pool": native.ints_to_limbs(list(fc.pool), bn.R),
    }
    prog = meta_dict.get("solver_program")
    if prog is not None:
        meta["solver_program"] = {
            "n_cons": prog["n_cons"], "n_vars": prog["n_vars"],
            "boundary": prog["boundary"],
            "hint_boundary": prog["hint_boundary"],
            "commit_wires": prog["commit_wires"],
            "challenge_wire": prog["challenge_wire"],
            "arrays": sorted(prog["arrays"].keys()),
        }
        for k, arr in prog["arrays"].items():
            sections["sp." + k] = np.asarray(arr)
    _write_container(path, meta, sections)


def load_r1cs(path: str) -> dict:
    from ..circuit.cs import FlatConstraints
    meta, sec = _read_container(path)
    fc = FlatConstraints()
    fc.vars = array("I", sec["fc.vars"].tobytes())
    fc.coeffs = array("I", sec["fc.coeffs"].tobytes())
    fc.lens = array("I", sec["fc.lens"].tobytes())
    fc.pool = native.limbs_to_ints(sec["fc.pool"])
    fc._pool_idx = {c: i for i, c in enumerate(fc.pool)}
    out = {
        "num_vars": meta["num_vars"],
        "num_public": meta["num_public"],
        "num_constraints": meta["num_constraints"],
        "range_bits": meta["range_bits"],
        "commitment": meta["commitment"],
        "constraints": fc,
        "solver_program": None,
    }
    sp = meta.get("solver_program")
    if sp is not None:
        arrays = {k: np.ascontiguousarray(sec["sp." + k])
                  for k in sp["arrays"]}
        out["solver_program"] = {
            "arrays": arrays, "n_cons": sp["n_cons"],
            "n_vars": sp["n_vars"], "boundary": sp["boundary"],
            "hint_boundary": sp["hint_boundary"],
            "commit_wires": sp["commit_wires"],
            "challenge_wire": sp["challenge_wire"],
        }
    return out


# --- dispatch (keygen / prover / verifier entry points) -----------------------

def save(path: str, obj) -> None:
    if isinstance(obj, g16.ProvingKey):
        save_pk(path, obj)
    elif isinstance(obj, g16.VerifyingKey):
        save_vk(path, obj)
    elif isinstance(obj, dict) and "constraints" in obj:
        save_r1cs(path, obj)
    else:
        raise TypeError(f"no artifact writer for {type(obj)!r}")


def load(path: str, device=None):
    """Any artifact: a container by its kind (a pk's bases on `device`),
    anything else as gnark-layout vk bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == MAGIC:
        meta, _ = _read_container(path)
        kind = meta.get("kind")
        if kind == "pk":
            return load_pk(path, device)
        if kind == "r1cs":
            return load_r1cs(path)
        raise ValueError(f"{path}: unknown artifact kind {kind!r}")
    if head[:2] == b"\x1f\x8b":
        raise ValueError(f"{path}: a legacy gzip-pickle artifact; this "
                         "package reads only ZKPOSAR1 containers and vk "
                         "bytes")
    return load_vk(path)
