"""Two-pass native witness solver.

Pass 1 (once per tier): the circuit is COMPILED (structure only) and its
solve schedule — constraints in order, hint positions, hint kinds, lookup
tables — is recorded into flat numpy arrays.

Pass 2 (per batch): the C++ VM (csrc/host/zkpos_native.cpp zk_solver_*)
replays the schedule against the batch's input values at memory speed,
solving each defining constraint's single unknown wire gnark-style
(frontend.NewWitness + the R1CS solver inside groth16.Prove, reference
prover.go:260-269).  The commitment challenge splits the run in two: the
VM solves up to the commit boundary, the host computes the Pedersen
commitment over the committed wires (the port's MSM) and the bsb22 challenge,
injects it, and the VM finishes.

This replaces the eager per-wire Python solve (59.7 s at 306K constraints,
VERDICT r3 missing #2) for proving; the Python path remains the oracle and
the fallback for circuits with untagged (pure-Python) hints.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..crypto.bn254 import R as MOD
from ..utils import native, trace
from .cs import LC, ConstraintSystem

_KINDS = {"bits": 0, "limbs": 1, "iszero": 2, "divmod": 3,
          "table_out": 4, "table_mult": 5, "invfrac_batch": 6}


class UnsupportedCircuit(Exception):
    """Raised when the circuit carries hints the VM cannot replay."""


class _Program:
    __slots__ = ("arrays", "n_cons", "n_vars", "boundary", "hint_boundary",
                 "commit_wires", "challenge_wire", "keep")


def _i64(x):
    return np.asarray(x, dtype=np.int64)


def record_program(cs: ConstraintSystem) -> _Program:
    """Flatten a finalized compile-mode system into VM arrays (cached on
    the cs object)."""
    cached = getattr(cs, "_native_program", None)
    if cached is not None:
        return cached
    if cs.solve:
        raise ValueError("record_program requires a compile-mode system")
    cs.finalize()
    fc = cs.constraints
    if not hasattr(fc, "lens"):
        raise UnsupportedCircuit("native solver needs FlatConstraints")

    lens = np.frombuffer(fc.lens, dtype=np.uint32).copy()
    term_vars = np.frombuffer(fc.vars, dtype=np.uint32).copy()
    term_cids = np.frombuffer(fc.coeffs, dtype=np.uint32).copy()

    # --- LC stream (hint inputs + table entries share it) -------------------
    lc_terms_start: List[int] = []
    lc_terms_count: List[int] = []
    lc_const_cid: List[int] = []
    lc_vars: List[int] = []
    lc_cids: List[int] = []

    def add_lc(lc: LC) -> int:
        lc_terms_start.append(len(lc_vars))
        lc_terms_count.append(len(lc.terms))
        for v, c in lc.terms.items():
            lc_vars.append(v)
            lc_cids.append(fc._cid(c))
        lc_const_cid.append(fc._cid(lc.const) if lc.const else 0xFFFFFFFF)
        return len(lc_terms_start) - 1

    # --- hints --------------------------------------------------------------
    h_pos, h_kind, h_p0, h_p1 = [], [], [], []
    h_in_start, h_in_count, h_out_start, h_out_count = [], [], [], []
    out_wires: List[int] = []
    for rec in cs.hints:
        fn, in_lcs, outs = rec[0], rec[1], rec[2]
        pos = rec[3] if len(rec) > 3 else 0
        tag = getattr(fn, "_native", None)
        if tag is None:
            raise UnsupportedCircuit(
                f"untagged hint {getattr(fn, '__name__', fn)}")
        kind = _KINDS[tag[0]]
        p0 = p1 = 0
        if tag[0] in ("bits", "limbs"):
            p0 = tag[1]
        elif tag[0] in ("table_out", "table_mult"):
            p0 = tag[1]         # table id
            p1 = tag[2]         # entry bound / T
        h_pos.append(pos)
        h_kind.append(kind)
        h_p0.append(p0)
        h_p1.append(p1)
        h_in_start.append(len(lc_terms_start))
        h_in_count.append(len(in_lcs))
        for lc in in_lcs:
            add_lc(lc)
        h_out_start.append(len(out_wires))
        h_out_count.append(len(outs))
        out_wires.extend(outs)

    # --- tables -------------------------------------------------------------
    tbl_start = [0]
    tbl_lc_ids: List[int] = []
    for t in getattr(cs, "_tables", []):
        for e in t.entries:
            tbl_lc_ids.append(add_lc(e))
        tbl_start.append(len(tbl_lc_ids))

    pool = native.ints_to_limbs(list(fc.pool), MOD)

    p = _Program()
    p.n_cons = len(fc)
    p.n_vars = cs.num_vars
    p.boundary = getattr(cs, "_solver_commit_boundary", p.n_cons)
    p.hint_boundary = getattr(cs, "_solver_commit_hint_boundary",
                              len(cs.hints))
    p.commit_wires = (cs.commitment["wires"] if cs.commitment else [])
    p.challenge_wire = (cs.commitment["challenge"] if cs.commitment
                        else None)
    arrays = dict(
        lens=lens, term_vars=term_vars, term_cids=term_cids, pool=pool,
        h_pos=_i64(h_pos), h_kind=np.asarray(h_kind, dtype=np.int32),
        h_p0=_i64(h_p0), h_p1=_i64(h_p1),
        h_in_start=_i64(h_in_start), h_in_count=_i64(h_in_count),
        h_out_start=_i64(h_out_start), h_out_count=_i64(h_out_count),
        out_wires=np.asarray(out_wires, dtype=np.uint32),
        lc_terms_start=_i64(lc_terms_start),
        lc_terms_count=_i64(lc_terms_count),
        lc_const_cid=np.asarray(lc_const_cid, dtype=np.uint32),
        lc_vars=np.asarray(lc_vars, dtype=np.uint32),
        lc_cids=np.asarray(lc_cids, dtype=np.uint32),
        tbl_start=_i64(tbl_start), tbl_lc_ids=_i64(tbl_lc_ids))
    p.arrays = arrays
    cs._native_program = p
    return p


def program_to_dict(p: _Program) -> dict:
    """Picklable form for the keygen .r1cs artifact (the gnark .r1cs
    stores exactly this: constraints + solver schedule)."""
    return {"arrays": p.arrays, "n_cons": p.n_cons, "n_vars": p.n_vars,
            "boundary": p.boundary, "hint_boundary": p.hint_boundary,
            "commit_wires": p.commit_wires,
            "challenge_wire": p.challenge_wire}


def program_from_dict(d: dict) -> _Program:
    p = _Program()
    p.arrays = d["arrays"]
    p.n_cons = d["n_cons"]
    p.n_vars = d["n_vars"]
    p.boundary = d["boundary"]
    p.hint_boundary = d["hint_boundary"]
    p.commit_wires = d["commit_wires"]
    p.challenge_wire = d["challenge_wire"]
    return p


class CompiledSystem:
    """Artifact-backed compiled circuit (prover side): quacks like a
    compile-mode ConstraintSystem for solve() + groth16.prove without
    re-running define() (reference LoadSnarkParamsOnce, prover.go:285)."""

    def __init__(self, meta: dict):
        self.constraints = meta["constraints"]
        self.num_vars = meta["num_vars"]
        self.num_public = meta["num_public"]
        self.commitment = meta.get("commitment")
        self.range_bits = meta.get("range_bits", 8)
        self.solve = False
        self.hints: list = []
        prog = meta.get("solver_program")
        if prog is not None:
            self._native_program = program_from_dict(prog)

    def finalize(self):
        pass


def _declare(L):
    if getattr(L, "_solver_declared", False):
        return
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    i32p = ctypes.POINTER(ctypes.c_int)
    L.zk_solver_load.argtypes = [
        ctypes.c_longlong, u32p, u32p, u32p, u64p, ctypes.c_longlong,
        ctypes.c_longlong, i64p, i32p, i64p, i64p, i64p, i64p, i64p, i64p,
        u32p, i64p, i64p, u32p, u32p, u32p, i64p, i64p,
        ctypes.c_longlong, ctypes.c_longlong]
    L.zk_solver_set_inputs.argtypes = [u64p, ctypes.c_longlong,
                                       ctypes.c_longlong]
    L.zk_solver_set_wire.argtypes = [ctypes.c_longlong, u64p]
    L.zk_solver_run.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    L.zk_solver_run.restype = ctypes.c_int
    L.zk_solver_run_hints_until.argtypes = [ctypes.c_longlong]
    L.zk_solver_run_hints_until.restype = ctypes.c_int
    L.zk_solver_err_index.restype = ctypes.c_longlong
    L.zk_solver_get.argtypes = [ctypes.c_longlong, ctypes.c_longlong, u64p]
    L.zk_solver_gather.argtypes = [i64p, ctypes.c_longlong, u64p]
    L._solver_declared = True


def _pp(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class SolvedSystem:
    """Result of a native solve: quacks enough like a solved
    ConstraintSystem for groth16.prove (witness vector as (N,4) u64
    limbs, constraint iteration from the compiled system)."""

    def __init__(self, cs: ConstraintSystem, values_u64: np.ndarray,
                 commit_result):
        self._cs = cs
        self.values_u64 = values_u64
        self.solve = True
        self.num_vars = cs.num_vars
        self.num_public = cs.num_public
        self.constraints = cs.constraints
        self.commitment = cs.commitment
        self._commit_result = commit_result
        self._commit_key = getattr(cs, "_commit_key", None)
        # share the QAP flattening cache with the compiled system so
        # repeated batches of one tier flatten the matrices once
        if getattr(cs, "_qap_dev_cache", None) is None:
            cs._qap_dev_cache = {}
        self._qap_dev_cache = cs._qap_dev_cache

    def finalize(self):
        pass

    def set_commitment_key(self, key):
        self._commit_key = key

    def witness_vector(self) -> np.ndarray:
        return self.values_u64

    def public_values(self) -> List[int]:
        return [int.from_bytes(self.values_u64[i].tobytes(), "little")
                for i in range(1, self.num_public)]

    def __getattr__(self, name):
        return getattr(self._cs, name)


def solve(cs: ConstraintSystem, inputs: List[int],
          commit_key: Optional[dict] = None) -> SolvedSystem:
    """Run the native solve of compiled system `cs` with the given input
    wire values (wires 1..len(inputs)); returns a SolvedSystem ready for
    groth16.prove."""
    L = native.lib()
    if L is None:
        raise UnsupportedCircuit("native library unavailable")
    _declare(L)
    p = record_program(cs)
    a = p.arrays
    L.zk_solver_load(
        p.n_cons, _pp(a["lens"], ctypes.c_uint32),
        _pp(a["term_vars"], ctypes.c_uint32),
        _pp(a["term_cids"], ctypes.c_uint32),
        _pp(a["pool"], ctypes.c_uint64), len(a["pool"]),
        len(a["h_pos"]), _pp(a["h_pos"], ctypes.c_longlong),
        _pp(a["h_kind"], ctypes.c_int),
        _pp(a["h_p0"], ctypes.c_longlong), _pp(a["h_p1"], ctypes.c_longlong),
        _pp(a["h_in_start"], ctypes.c_longlong),
        _pp(a["h_in_count"], ctypes.c_longlong),
        _pp(a["h_out_start"], ctypes.c_longlong),
        _pp(a["h_out_count"], ctypes.c_longlong),
        _pp(a["out_wires"], ctypes.c_uint32),
        _pp(a["lc_terms_start"], ctypes.c_longlong),
        _pp(a["lc_terms_count"], ctypes.c_longlong),
        _pp(a["lc_const_cid"], ctypes.c_uint32),
        _pp(a["lc_vars"], ctypes.c_uint32),
        _pp(a["lc_cids"], ctypes.c_uint32),
        _pp(a["tbl_start"], ctypes.c_longlong),
        _pp(a["tbl_lc_ids"], ctypes.c_longlong),
        len(a["tbl_start"]) - 1, p.n_vars)
    inp = native.ints_to_limbs([int(v) for v in inputs], MOD)
    L.zk_solver_set_inputs(_pp(inp, ctypes.c_uint64), len(inputs), 1)

    def run(frm, to):
        rc = L.zk_solver_run(frm, to)
        if rc:
            idx = L.zk_solver_err_index()
            raise RuntimeError(
                f"native solve failed: code {rc} at constraint {idx}")

    # traced: solve.phase1 up to the commitment, solve.commit_msm, and
    # solve.phase2 after it (the whole run when there is no commitment)
    commit_result = None
    with trace.span("solve"):
        if p.challenge_wire is None:
            with trace.span("solve.phase2"):
                run(0, p.n_cons)
        else:
            with trace.span("solve.phase1"):
                run(0, p.boundary)
                rc = L.zk_solver_run_hints_until(p.hint_boundary)
                if rc:
                    raise RuntimeError(
                        f"native solve failed draining hints: {rc}")
            with trace.span("solve.commit_msm"):
                wires = _i64(p.commit_wires)
                zs = np.empty((len(wires), 4), dtype=np.uint64)
                L.zk_solver_gather(_pp(wires, ctypes.c_longlong),
                                   len(wires), _pp(zs, ctypes.c_uint64))
                d_pt, pok = commit_msm(commit_key, zs)
                from ..groth16.hash_to_field import bsb22_challenge
                cval = bsb22_challenge(d_pt)
                cv = native.ints_to_limbs([cval], MOD)
                L.zk_solver_set_wire(p.challenge_wire,
                                     _pp(cv, ctypes.c_uint64))
                commit_result = (d_pt, pok, cval)
            with trace.span("solve.phase2"):
                run(p.boundary, p.n_cons)

    values = np.empty((p.n_vars, 4), dtype=np.uint64)
    L.zk_solver_get(0, p.n_vars, _pp(values, ctypes.c_uint64))
    out = SolvedSystem(cs, values, commit_result)
    if commit_key is not None:
        out._commit_key = commit_key
    return out


def commit_msm(commit_key, zs):
    """Pedersen commitment D and PoK over committed wire values (a list of
    ints or (N, 4) uint64 standard-form rows), as two G1 MSMs on the
    port's device engine.  The bases are uploaded once and cached on the
    commitment key."""
    if commit_key is None:
        raise ValueError("commitment circuit solved without key")
    from ..ops import msm_device as md
    db = commit_key.get("_dev_bases")
    if db is None:
        db = (md.device_base("g1", commit_key["bases"]),
              md.device_base("g1", commit_key["sigma_bases"]))
        commit_key["_dev_bases"] = db
    plan = md.ScalarPlan(zs, device=db[0].device)
    return (md.msm("g1", db[0], plan=plan),
            md.msm("g1", db[1], plan=plan))
