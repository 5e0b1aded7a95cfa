"""Go `encoding/gob` codec (pure Python) for the witness struct family.

The reference serializes BatchCreateUserWitness with gob before s2 +
base64 (witness.go:219-228; decoded by utils.go:704-742).  gob's wire
format is fully documented (go.dev/blog/gob, pkg.go.dev/encoding/gob
"Encoding details"); this module implements the subset the witness
structs exercise, in both directions:

  * unsigned ints: <=0x7f one byte, else one byte holding -(byte count)
    (two's complement) followed by big-endian bytes
  * signed ints: bit 0 is the complement flag (i>=0 -> i<<1, else ~(i<<1))
  * strings/[]byte: unsigned count + bytes
  * slices: unsigned count + elements; arrays: count must equal the
    declared length
  * structs: (unsigned field-number delta, value)* terminated by delta 0;
    zero-valued fields are omitted
  * messages: unsigned byte count, then either (-typeId, wireType value)
    defining a type, or (typeId, value).  User type ids start at 65.
  * GobEncoder types (math/big.Int): value is a byte slice; big.Int's
    GobEncode layout is [version<<1|sign] + abs big-endian
    (math/big/intmarsh.go, version 1)

The decoder is registry-driven — it accepts any self-consistent id
assignment, exactly like Go's decoder, and matches struct fields by
name, so blobs produced by the reference Go services decode here and
vice versa.  Go types covered: struct/slice/array/uint/string/bytes/
GobEncoder (sufficient for BatchCreateUserWitness, types.go:5-60).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

# bootstrap type ids (encoding/gob/type.go)
T_BOOL, T_INT, T_UINT, T_FLOAT, T_BYTES, T_STRING = 1, 2, 3, 4, 5, 6
FIRST_USER_ID = 65

# wireType's fields, in declaration order (encoding/gob/type.go)
_WIRE_FIELDS = ("ArrayT", "SliceT", "StructT", "MapT",
                "GobEncoderT", "BinaryMarshalerT", "TextMarshalerT")


# --- primitive encoders -------------------------------------------------------

def put_uint(n: int) -> bytes:
    if n <= 0x7F:
        return bytes([n])
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([256 - len(raw)]) + raw


def put_int(i: int) -> bytes:
    u = (i << 1) if i >= 0 else ~(i << 1)
    return put_uint(u)


def _read_uint(buf: bytes, pos: int) -> Tuple[int, int]:
    b = buf[pos]
    if b <= 0x7F:
        return b, pos + 1
    nb = 256 - b
    if nb > 8:
        raise ValueError("gob: invalid uint byte count")
    return int.from_bytes(buf[pos + 1:pos + 1 + nb], "big"), pos + 1 + nb


def _read_int(buf: bytes, pos: int) -> Tuple[int, int]:
    u, pos = _read_uint(buf, pos)
    return (~(u >> 1) if u & 1 else u >> 1), pos


def big_int_gob(v: int) -> bytes:
    """math/big.Int.GobEncode: [1<<1 | sign] + abs big-endian."""
    sign = 1 if v < 0 else 0
    a = abs(v)
    raw = a.to_bytes((a.bit_length() + 7) // 8, "big") if a else b""
    return bytes([2 | sign]) + raw


def big_int_ungob(raw: bytes) -> int:
    if not raw:
        return 0
    if raw[0] >> 1 != 1:
        raise ValueError("gob: unknown big.Int version")
    v = int.from_bytes(raw[1:], "big")
    return -v if raw[0] & 1 else v


# --- type graph of the witness family -----------------------------------------
# (name, kind, spec); ids are fixed here but the decoder accepts any.

BIG_INT = FIRST_USER_ID            # 65
TIER_RATIO = 66
TIER_ARR = 67
CEX_INFO = 68
CEX_SLICE = 69
ACC_ASSET = 70
ASSET_SLICE = 71
PROOF_ARR = 72
USER_OP = 73
OP_SLICE = 74
BATCH_WITNESS = 75

def _type_graph(tier_count: int, tree_depth: int) -> Dict[int, dict]:
    return {
        BIG_INT: {"kind": "gobencoder", "name": "Int"},
        TIER_RATIO: {"kind": "struct", "name": "TierRatio", "fields": [
            ("BoundaryValue", BIG_INT), ("Ratio", T_UINT),
            ("PrecomputedValue", BIG_INT)]},
        TIER_ARR: {"kind": "array", "name": "", "elem": TIER_RATIO,
                   "len": tier_count},
        CEX_INFO: {"kind": "struct", "name": "CexAssetInfo", "fields": [
            ("TotalEquity", T_UINT), ("TotalDebt", T_UINT),
            ("BasePrice", T_UINT), ("Symbol", T_STRING),
            ("Index", T_UINT), ("LoanCollateral", T_UINT),
            ("MarginCollateral", T_UINT),
            ("PortfolioMarginCollateral", T_UINT),
            ("LoanRatios", TIER_ARR), ("MarginRatios", TIER_ARR),
            ("PortfolioMarginRatios", TIER_ARR)]},
        CEX_SLICE: {"kind": "slice", "name": "", "elem": CEX_INFO},
        ACC_ASSET: {"kind": "struct", "name": "AccountAsset", "fields": [
            ("Index", T_UINT), ("Equity", T_UINT), ("Debt", T_UINT),
            ("Loan", T_UINT), ("Margin", T_UINT),
            ("PortfolioMargin", T_UINT)]},
        ASSET_SLICE: {"kind": "slice", "name": "", "elem": ACC_ASSET},
        PROOF_ARR: {"kind": "array", "name": "", "elem": T_BYTES,
                    "len": tree_depth},
        USER_OP: {"kind": "struct", "name": "CreateUserOperation",
                  "fields": [
            ("Assets", ASSET_SLICE), ("AccountIndex", T_UINT),
            ("AccountIdHash", T_BYTES), ("AccountProof", PROOF_ARR)]},
        OP_SLICE: {"kind": "slice", "name": "", "elem": USER_OP},
        BATCH_WITNESS: {"kind": "struct", "name": "BatchCreateUserWitness",
                        "fields": [
            ("BatchCommitment", T_BYTES), ("AccountTreeRoot", T_BYTES),
            ("BeforeCEXAssetsCommitment", T_BYTES),
            ("AfterCEXAssetsCommitment", T_BYTES),
            ("MinAccountIndex", T_UINT), ("MaxAccountIndex", T_UINT),
            ("BeforeCexAssets", CEX_SLICE), ("CreateUserOps", OP_SLICE)]},
    }


# --- value encoding ------------------------------------------------------------

def _is_zero(v: Any) -> bool:
    return (v is None or v == 0 or v == "" or v == b""
            or (isinstance(v, (list, tuple)) and len(v) == 0))


def _enc_value(tid: int, v: Any, types: Dict[int, dict],
               out: bytearray) -> None:
    if tid == T_UINT or tid == T_BOOL:
        out += put_uint(int(v))
    elif tid == T_INT:
        out += put_int(int(v))
    elif tid in (T_BYTES, T_STRING):
        raw = v.encode() if isinstance(v, str) else bytes(v)
        out += put_uint(len(raw))
        out += raw
    else:
        t = types[tid]
        kind = t["kind"]
        if kind == "gobencoder":
            raw = big_int_gob(int(v))
            out += put_uint(len(raw))
            out += raw
        elif kind in ("slice", "array"):
            if kind == "array" and len(v) != t["len"]:
                raise ValueError(
                    f"gob: array length {len(v)} != {t['len']}")
            out += put_uint(len(v))
            for e in v:
                _enc_value(t["elem"], e, types, out)
        elif kind == "struct":
            _enc_struct(t["fields"], v, types, out)
        else:
            raise ValueError(f"gob: cannot encode kind {kind}")


def _enc_struct(fields, obj: Dict[str, Any], types, out: bytearray) -> None:
    last = -1
    for num, (name, ftid) in enumerate(fields):
        v = obj.get(name)
        # Go's encoder omits only nil *big.Int pointers, not non-nil ones
        # holding 0 — omitting a zero-valued gobencoder field would leave
        # it nil on the Go side and nil-panic TierRatio consumers
        # (reference utils.go:36,671; ADVICE r3).
        is_gobenc = (ftid in types
                     and types[ftid].get("kind") == "gobencoder")
        if v is None or (not is_gobenc and _is_zero(v)):
            continue
        out += put_uint(num - last)
        last = num
        _enc_value(ftid, v, types, out)
    out += put_uint(0)


def _wiretype_value(tid: int, t: dict, types: Dict[int, dict]) -> bytes:
    """Encode one wireType struct describing type `tid`."""
    common = bytearray()           # CommonType{Name, Id}
    last = -1
    if t["name"]:
        common += put_uint(0 - last)
        last = 0
        common += put_uint(len(t["name"]))
        common += t["name"].encode()
    common += put_uint(1 - last)
    common += put_int(tid)
    common += put_uint(0)

    inner = bytearray()
    kind = t["kind"]
    if kind == "struct":
        inner += put_uint(1)       # CommonType (field 0)
        inner += common
        if t["fields"]:
            inner += put_uint(1)   # Field []fieldType (field 1)
            inner += put_uint(len(t["fields"]))
            for name, ftid in t["fields"]:
                f = bytearray()
                f += put_uint(1)   # Name
                f += put_uint(len(name))
                f += name.encode()
                f += put_uint(1)   # Id
                f += put_int(ftid)
                f += put_uint(0)
                inner += f
        inner += put_uint(0)
        wire_field = _WIRE_FIELDS.index("StructT")
    elif kind == "slice":
        inner += put_uint(1)
        inner += common
        inner += put_uint(1)       # Elem
        inner += put_int(t["elem"])
        inner += put_uint(0)
        wire_field = _WIRE_FIELDS.index("SliceT")
    elif kind == "array":
        inner += put_uint(1)
        inner += common
        inner += put_uint(1)       # Elem
        inner += put_int(t["elem"])
        inner += put_uint(1)       # Len (int)
        inner += put_int(t["len"])
        inner += put_uint(0)
        wire_field = _WIRE_FIELDS.index("ArrayT")
    elif kind == "gobencoder":
        inner += put_uint(1)
        inner += common
        inner += put_uint(0)
        wire_field = _WIRE_FIELDS.index("GobEncoderT")
    else:
        raise ValueError(kind)

    out = bytearray()
    out += put_uint(wire_field + 1)   # delta from -1 into wireType
    out += inner
    out += put_uint(0)                # end wireType
    return bytes(out)


def encode_stream(obj: Dict[str, Any], tier_count: int,
                  tree_depth: int) -> bytes:
    """gob stream: one type-def message per type (referenced-first order,
    like Go's encoder), then the BatchCreateUserWitness value message."""
    types = _type_graph(tier_count, tree_depth)
    out = bytearray()
    for tid in sorted(types):                    # 65..75 = bottom-up
        body = put_int(-tid) + _wiretype_value(tid, types[tid], types)
        out += put_uint(len(body))
        out += body
    val = bytearray()
    val += put_int(BATCH_WITNESS)
    _enc_value(BATCH_WITNESS, obj, types, val)
    out += put_uint(len(val))
    out += bytes(val)
    return bytes(out)


# --- decoding ------------------------------------------------------------------

def _dec_value(tid: int, buf: bytes, pos: int,
               reg: Dict[int, dict]) -> Tuple[Any, int]:
    if tid in (T_UINT, T_BOOL):
        return _read_uint(buf, pos)
    if tid == T_INT:
        return _read_int(buf, pos)
    if tid in (T_BYTES, T_STRING):
        n, pos = _read_uint(buf, pos)
        raw = buf[pos:pos + n]
        return (raw if tid == T_BYTES else raw.decode()), pos + n
    if tid == T_FLOAT:
        u, pos = _read_uint(buf, pos)
        import struct as _s
        return _s.unpack("<d", u.to_bytes(8, "big"))[0], pos
    t = reg[tid]
    kind = t["kind"]
    if kind == "gobencoder":
        n, pos = _read_uint(buf, pos)
        raw = buf[pos:pos + n]
        pos += n
        return (big_int_ungob(raw) if t["name"].endswith("Int")
                else raw), pos
    if kind in ("slice", "array"):
        n, pos = _read_uint(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _dec_value(t["elem"], buf, pos, reg)
            out.append(v)
        return out, pos
    if kind == "struct":
        obj: Dict[str, Any] = {}
        fnum = -1
        while True:
            delta, pos = _read_uint(buf, pos)
            if delta == 0:
                return obj, pos
            fnum += delta
            if fnum >= len(t["fields"]):
                raise ValueError(f"gob: field {fnum} out of range "
                                 f"for {t['name']}")
            name, ftid = t["fields"][fnum]
            obj[name], pos = _dec_value(ftid, buf, pos, reg)
    raise ValueError(f"gob: cannot decode kind {kind}")


def _parse_wiretype(buf: bytes, pos: int) -> Tuple[dict, int]:
    """Parse one wireType value (bootstrap-known layout) into a registry
    entry."""
    fnum = -1
    t: dict = {}
    while True:
        delta, pos = _read_uint(buf, pos)
        if delta == 0:
            return t, pos
        fnum += delta
        field = _WIRE_FIELDS[fnum]
        inner_num = -1
        common: dict = {"name": "", "id": 0}
        spec: dict = {}
        while True:
            d, pos = _read_uint(buf, pos)
            if d == 0:
                break
            inner_num += d
            if inner_num == 0:                 # CommonType{Name, Id}
                cnum = -1
                while True:
                    cd, pos = _read_uint(buf, pos)
                    if cd == 0:
                        break
                    cnum += cd
                    if cnum == 0:
                        n, pos = _read_uint(buf, pos)
                        common["name"] = buf[pos:pos + n].decode()
                        pos += n
                    else:
                        common["id"], pos = _read_int(buf, pos)
            elif field == "StructT" and inner_num == 1:   # Field []fieldType
                n, pos = _read_uint(buf, pos)
                fields = []
                for _ in range(n):
                    fn = ""
                    fid = 0
                    fnum2 = -1
                    while True:
                        fd, pos = _read_uint(buf, pos)
                        if fd == 0:
                            break
                        fnum2 += fd
                        if fnum2 == 0:
                            ln, pos = _read_uint(buf, pos)
                            fn = buf[pos:pos + ln].decode()
                            pos += ln
                        else:
                            fid, pos = _read_int(buf, pos)
                    fields.append((fn, fid))
                spec["fields"] = fields
            elif field in ("ArrayT", "SliceT", "MapT") and inner_num == 1:
                spec["elem"], pos = _read_int(buf, pos)    # Elem (or Key)
            elif field == "ArrayT" and inner_num == 2:
                spec["len"], pos = _read_int(buf, pos)
            elif field == "MapT" and inner_num == 2:
                spec["velem"], pos = _read_int(buf, pos)
            else:
                raise ValueError(
                    f"gob: unexpected wireType field {field}.{inner_num}")
        kind = {"ArrayT": "array", "SliceT": "slice", "StructT": "struct",
                "MapT": "map", "GobEncoderT": "gobencoder",
                "BinaryMarshalerT": "gobencoder",
                "TextMarshalerT": "gobencoder"}[field]
        t.update({"kind": kind, "name": common["name"],
                  "id": common["id"], **spec})
        if kind == "struct":
            t.setdefault("fields", [])


def decode_stream(data: bytes) -> Dict[str, Any]:
    """Decode a gob stream; returns the first top-level value (a dict of
    Go field names for struct values)."""
    reg: Dict[int, dict] = {}
    pos = 0
    while pos < len(data):
        mlen, pos = _read_uint(data, pos)
        end = pos + mlen
        tid, pos = _read_int(data, pos)
        if tid < 0:                             # type definition
            t, pos = _parse_wiretype(data, pos)
            reg[-tid] = t
            if pos != end:
                raise ValueError("gob: trailing bytes in type def")
            continue
        if tid not in reg and tid >= FIRST_USER_ID:
            raise ValueError(f"gob: undefined type id {tid}")
        if tid < FIRST_USER_ID or reg[tid]["kind"] != "struct":
            # non-struct top-level values carry a leading zero byte
            z, pos = _read_uint(data, pos)
            if z != 0:
                raise ValueError("gob: missing zero byte")
        v, pos = _dec_value(tid, data, pos, reg)
        if pos != end:
            raise ValueError("gob: trailing bytes in value message")
        return v
    raise ValueError("gob: no value message in stream")
