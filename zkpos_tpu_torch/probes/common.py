"""What the probes share: the card's data-sheet rates, timing, the card's
name and power limit, kernel resources from ptxas, and the row each probe
variant reports."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import time

import torch

from ..utils import build

SOURCE = "zkpos_tpu_torch/csrc/probes.cu"

# H100 SXM data sheet (dense, 700 W): HBM3 at 3.35 TB/s; 132 SMs at
# 1.98 GHz with 64 INT32 and 128 FP32 lanes each; TF32 tensor cores at
# 495 TFLOP/s.  Rates are in operations a second: one FMA is one operation.
HBM_BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
INT32_OPS_PER_S = SMS * 64 * CLOCK_HZ
FP32_FMA_PER_S = SMS * 128 * CLOCK_HZ
TF32_FMA_PER_S = 495e12 / 2
# 32-bit multiplies (a wide product counts its low and high word) of one
# 8-limb CIOS Montgomery product: 8 x (16 + 1 + 16), as chip_smoke.py counts
MULS_PER_MONT = 8 * (16 + 1 + 16)


def smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def time_ms(fn, device, reps: int = 1, warm=None) -> float:
    """Mean milliseconds of fn() over reps calls after one call of warm()
    (fn itself if not given): CUDA events on the card, the host clock on
    the CPU (a CPU time is no device metric)."""
    (warm or fn)()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def timed(fn, device):
    """fn() once: (its result, its milliseconds)."""
    out = None

    def call():
        nonlocal out
        out = fn()
    ms = time_ms(call, device, reps=1, warm=lambda: None)
    return out, ms


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    if not a.numel():
        return 0
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


def max_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / |b| over the elements (b the plain version)."""
    d = (a.double() - b.double()).abs()
    return float((d / b.double().abs().clamp_min(1e-30)).max())


def variant_sources(script: str, name: str, csrc: str, subs=()) -> str:
    """A directory (under the build directory, by script and variant name)
    with csrc's headers and sources, each (file, old, new) of `subs`
    substituted; raises unless `file` holds `old` exactly once."""
    out = os.path.join(build.BUILD, script, name)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(csrc, f), out)
    for source, old, new in subs:
        path = os.path.join(out, source)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{source} no longer holds {old!r} once")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return out


def build_variant(src: str, source: str, done: dict, name: str) -> None:
    """nvcc `source` of the directory `src` alone into a shared library:
    done[name] = (return code, ptxas log, seconds, library path)."""
    so = os.path.join(src, os.path.splitext(source)[0] + ".so")
    t0 = time.time()
    p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        "-I", src, "-o", so, os.path.join(src, source)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    done[name] = (p.returncode, p.stdout, time.time() - t0, so)


def kernel_resources(pattern: str, log: str = None) -> dict:
    """Registers, stack frame and spill stores and loads of each kernel
    whose mangled name contains `pattern`, from a ptxas report (`log`, by
    default the last build's)."""
    out, name, props = {}, None, None
    for line in (build.PTXAS_LOG if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == name:     # not a function the kernel calls
            out.setdefault(name, {}).update(stack=int(m.group(1)),
                                            spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def row(name, replaces, n, ms, plain_ms, plain_n, bytes_, op_seconds,
        err, rel_err=None, tol=None, library_ms=None, **metrics):
    """One probe variant's entry of chip_smoke.py's kernels line.
    `op_seconds` is the least time its operations take at the data-sheet
    rates; the bound is the larger of that and its bytes over the memory
    rate.  `launches` is filled in by probes.run_probe.  Integer probes are
    exact (err == 0); float probes hold rel_err within tol."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = op_seconds * 1e3
    ok = err == 0 if tol is None else rel_err <= tol
    r = {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": 0,
         "max_abs_err": err, "ms": round(ms, 4), "n": n,
         "plain_ms": round(plain_ms, 4), "plain_n": plain_n,
         "bound_ms": round(max(t_bytes, t_ops), 4),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": None if library_ms is None else round(library_ms, 4),
         "ok": bool(ok)}
    if tol is not None:
        r["max_rel_err"] = rel_err
        r["tol"] = tol
    r.update(metrics)
    return r


def check_device(*ts) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one device; raises
    otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError("operands must share one device")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind}")
    return kind
