"""Snappy / S2 block-format codec in pure Python.

The reference compresses gob-serialized witness blobs with
`github.com/klauspost/compress/s2` block encoding before base64-ing them
into the witness table (witness.go:219-228 `s2.Encode`, utils.go:704-742
`s2.Decode`).  S2's block format is a documented superset of Google
Snappy's block format:

  preamble: uvarint uncompressed length
  ops:      tag in the low 2 bits of the first byte
    00 literal  len-1 in bits 2..7; 60..63 escape to 1..4 extra LE bytes
    01 copy1    len-4 in bits 2..4 (4..10), 11-bit offset (bits 5..7 high,
                next byte low)
    10 copy2    len-1 in bits 2..7 (1..64), 2-byte LE offset
    11 copy4    len-1 in bits 2..7 (1..64), 4-byte LE offset

  S2 extension — repeat ops (reuse the previous copy offset): a copy1
  whose 11-bit offset field is zero (invalid in snappy).  The 3-bit
  length field L encodes:
    L in 0..4:  length = L + 4
    L == 5:     1 extra byte  e,      length = e + 8
    L == 6:     2 extra bytes e (LE), length = e + 4 + 256
    L == 7:     3 extra bytes e (LE), length = e + 4 + 65536
  (inverse of s2's emitRepeat; offset-0 copy2/copy4 are likewise treated
  as repeats with their standard lengths.)

`compress` emits pure Snappy ops (greedy 4-byte hash matcher) — a strict
subset of S2, so reference `s2.Decode` accepts our blobs; `decompress`
accepts both Snappy and S2 streams, so we accept reference blobs.
"""

from __future__ import annotations


def _uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _put_uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def decompress(src: bytes) -> bytes:
    """Decode one snappy/S2 block."""
    dlen, s = _uvarint(src, 0)
    dst = bytearray()
    last_offset = 0
    n = len(src)
    while s < n:
        tag = src[s]
        kind = tag & 3
        if kind == 0:                                   # literal
            ln = tag >> 2
            s += 1
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(src[s:s + nb], "little")
                s += nb
            ln += 1
            dst += src[s:s + ln]
            s += ln
            continue
        if kind == 1:                                   # copy1 / repeat
            ln = (tag >> 2) & 0x7
            offset = ((tag & 0xE0) << 3) | src[s + 1]
            s += 2
            if offset == 0:                             # S2 repeat
                if ln <= 4:
                    length = ln + 4
                elif ln == 5:
                    length = src[s] + 8
                    s += 1
                elif ln == 6:
                    length = int.from_bytes(src[s:s + 2], "little") + 4 + 256
                    s += 2
                else:
                    length = (int.from_bytes(src[s:s + 3], "little")
                              + 4 + 65536)
                    s += 3
                offset = last_offset
            else:
                length = ln + 4
        elif kind == 2:                                 # copy2
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[s + 1:s + 3], "little")
            s += 3
            if offset == 0:
                offset = last_offset
        else:                                           # copy4
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[s + 1:s + 5], "little")
            s += 5
            if offset == 0:
                offset = last_offset
        if offset == 0 or offset > len(dst):
            raise ValueError("s2: corrupt copy offset")
        last_offset = offset
        start = len(dst) - offset
        if offset >= length:
            # non-overlapping: one slice copy (multi-MB 2^21-tier blobs
            # took seconds under the old per-byte loop — ADVICE r3)
            dst += dst[start:start + length]
        else:
            # overlapping copies are defined byte-serially, which equals
            # repeating the last `offset` bytes cyclically
            pattern = bytes(dst[start:])
            reps = -(-length // offset)
            dst += (pattern * reps)[:length]
    if len(dst) != dlen:
        raise ValueError(f"s2: length mismatch {len(dst)} != {dlen}")
    return bytes(dst)


def _emit_literal(out: bytearray, lit: bytes) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out.append(n)
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += lit


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    while length > 0:
        ln = min(length, 64)
        if ln < 4:                  # tail shorter than min copy1 length
            ln = length
        if 4 <= ln <= 11 and offset < 2048:
            out.append(((offset >> 8) << 5) | ((ln - 4) << 2) | 1)
            out.append(offset & 0xFF)
        elif offset < (1 << 16):
            out.append(((ln - 1) << 2) | 2)
            out += offset.to_bytes(2, "little")
        else:
            out.append(((ln - 1) << 2) | 3)
            out += offset.to_bytes(4, "little")
        length -= ln


def compress(src: bytes) -> bytes:
    """Greedy snappy-subset block encoder (4-byte hash chaining)."""
    out = bytearray(_put_uvarint(len(src)))
    n = len(src)
    if n < 4:
        if n:
            _emit_literal(out, src)
        return bytes(out)
    table: dict[bytes, int] = {}
    i = 0
    lit_start = 0
    while i + 4 <= n:
        key = src[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand >= (1 << 31):
            i += 1
            continue
        # extend the match
        length = 4
        while (i + length < n and length < 1 << 16
               and src[cand + length] == src[i + length]):
            length += 1
        if i > lit_start:
            _emit_literal(out, src[lit_start:i])
        _emit_copy(out, i - cand, length)
        i += length
        lit_start = i
    if lit_start < n:
        _emit_literal(out, src[lit_start:])
    return bytes(out)
