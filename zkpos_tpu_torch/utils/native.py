"""ctypes loader for the port's copy of the native host runtime
(csrc/host/zkpos_native.cpp): the witness solver VM.

The library is built with g++ at first use by utils/build.py into the
package's build directory.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build


def lib() -> ctypes.CDLL:
    return build.host_lib()


def ints_to_limbs(values, mod: int) -> np.ndarray:
    """list[int] -> (N, 4) uint64 little-endian limb rows."""
    buf = b"".join(int(v % mod).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4).copy()



def limbs_to_ints(a: np.ndarray) -> list:
    """(N, 4) uint64 little-endian limb rows -> list[int]."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return [int.from_bytes(row.tobytes(), "little") for row in a]
