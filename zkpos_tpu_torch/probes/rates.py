"""Instruction rates of the card, from chains of dependent steps.

Counterpart of scripts/micro_probe2.py:70 (``chain_kernel``, the TPU's VPU
rate inside a Pallas kernel) and scripts/micro_probe3.py:44-102
(``mk_loop`` over ``k_u32mul``, ``k_u32ma``, ``k_f32fma``, ``k_f32floor``).
The TPU probes ran CH = 64 dependent steps per load on (16, TILE) tiles;
here ``k_rate`` (csrc/probes.cu) runs one chain per element, iters x 64
steps, over enough elements (2^22) to keep every SM's schedulers full, so
that the issue rate and not the latency of one chain is measured.

Bodies: the TPU's own -- ``(x*b + b) & 0xFFFF``, ``(x*b) & 0xFFFF`` and
``x*b + b`` on u32 with wrap-around, ``x*b + b`` on f32 and the
floor-ripple ``f = floor(x/256); x = (x - 256 f) + b`` on f32 -- and the
one instruction class the port's field core issues, the 64-bit wide
multiply-add ``s = a*b + t + c`` of csrc/field.cuh:127.

What bounds each: the instructions its compiled loop issues, each class on
its own pipe at the CUDA programming guide's rate for compute capability
9.0 (lanes per SM per clock, 132 SMs at 1.98 GHz): FFMA, FMUL and FADD at
128; IMAD and IMAD.WIDE at 64; IADD3, LOP3 and the other integer ALU
instructions at 64 on a pipe of their own; FRND among the conversions at
16; and all of them together at the issue rate, one warp instruction per
scheduler per clock (128).  The bound is the slowest pipe, not the sum.
The counts are those of ``cuobjdump -sass`` of the built library: the
loop's instructions (one pass is kChain steps) times the passes, plus the
rest of the function once; where cuobjdump is absent, the instructions
the source names for each step.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from collections import Counter

import numpy as np
import torch

from ..ops import field as F
from ..utils import build
from ..utils.device import resolve
from . import common as C

CHAIN = 64            # CH: dependent steps per load (probes.cuh kChain)
N = 1 << 22           # elements: one chain each
ITERS = 1024          # x 64 steps: >= 8 ms a launch for every body
CHECK_ITERS = 2       # chains the check runs against the plain version
M32 = 0xFFFFFFFF
# f32 chains against the plain version: nvcc contracts x*b + b to one FMA
# where PyTorch rounds twice; each step contracts the error (|b| < 1e-3),
# so one rounding's worth (6e-8) is all that separates the two
F32_TOL = 1e-5

# name, body index in zk_probe_rate, TPU source, struct in probes.cuh,
# the SASS the source names for one step (used without cuobjdump)
BODIES = (
    ("rate_u32_chain", 0, "scripts/micro_probe2.py:70", "U32Chain",
     {"IMAD": 1, "LOP3": 1}),
    ("rate_u32_mulmask", 1, "scripts/micro_probe3.py:69", "U32MulMask",
     {"IMAD": 1, "LOP3": 1}),
    ("rate_u32_muladd", 2, "scripts/micro_probe3.py:79", "U32MulAdd",
     {"IMAD": 1}),
    ("rate_f32_fma", 3, "scripts/micro_probe3.py:92", "F32Fma", {"FFMA": 1}),
    ("rate_f32_floor", 4, "scripts/micro_probe3.py:102", "F32Floor",
     {"FMUL": 1, "FRND": 1, "FFMA": 1, "FADD": 1}),
    ("rate_u64_widemad", 5, "scripts/micro_probe3.py:44 (mk_loop; the "
     "field core's step, field.cuh:127, has no TPU body)", "U64WideMad",
     {"IMAD.WIDE": 1, "IADD3": 2}),
)
# pipe: (lanes per SM per clock, the opcodes it runs); "issue" takes every
# instruction
PIPES = {
    "fp32": (128, ("FFMA", "FMUL", "FADD")),
    "imad": (64, ("IMAD", "IMAD.WIDE")),
    "alu": (64, ("IADD3", "LOP3", "ISETP", "SHF", "LEA", "SEL", "MOV",
                 "IMNMX", "PLOP3", "FSETP", "FSEL")),
    "conv": (16, ("FRND", "F2F", "F2I", "I2F")),
    "issue": (128, ()),
}
# instructions whose count per body the probe logs
SASS_OPS = ("IMAD.WIDE", "IMAD", "LOP3", "IADD3", "FFMA", "FMUL", "FADD",
            "FRND")


def _mul32(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x * b mod 2^32 for int64 tensors in [0, 2^32), without overflow."""
    return (x * (b & 0xFFFF) + (((x * (b >> 16)) & 0xFFFF) << 16)) & M32


def _step(body: int, x, b):
    if body == 0:
        return (_mul32(x, b) + b) & 0xFFFF
    if body == 1:
        return _mul32(x, b) & 0xFFFF
    if body == 2:
        return (_mul32(x, b) + b) & M32
    if body == 3:
        return x * b + b
    if body == 4:
        f = torch.floor(x * (1.0 / 256.0))
        return (x - 256.0 * f) + b
    return (x & M32) * b + b + (x >> 32)


def dtype_of(body: int) -> torch.dtype:
    """The tensor type of a body's state: u32 bit patterns in int32, f32,
    or the wide body's 64-bit state (carry, limb) in int64."""
    return (torch.int32, torch.int32, torch.int32, torch.float32,
            torch.float32, torch.int64)[body]


def plain_rate(body: int, x: torch.Tensor, b: torch.Tensor,
               iters: int) -> torch.Tensor:
    """iters x 64 steps of the body, elementwise, in PyTorch.  u32 work in
    int64 masked to 32 bits; the wide body's b must be below 2^30 (its
    state then stays below 2^63)."""
    if body in (0, 1, 2):
        v, w = x.long() & M32, b.long() & M32
    else:
        v, w = x, b if body != 5 else b.long()
    for _ in range(iters * CHAIN):
        v = _step(body, v, w)
    if body in (0, 1, 2):
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return v


def rate(body: int, x: torch.Tensor, b: torch.Tensor,
         iters: int) -> torch.Tensor:
    """k_rate on the card (counted under the body's name), the plain
    version on the CPU.  x: (n,) of the body's state type; b: (n,) of the
    same type (int32 for the wide body)."""
    want = dtype_of(body)
    bt = torch.int32 if body == 5 else want
    if (x.dtype != want or b.dtype != bt or x.dim() != 1
            or x.shape != b.shape or not x.is_contiguous()
            or not b.is_contiguous()):
        raise ValueError(f"rate body {body}: x ({want}) and b ({bt}) must "
                         "be contiguous 1-d tensors of one length")
    if C.check_device(x, b) == "cpu":
        return plain_rate(body, x, b, iters)
    out = torch.empty_like(x)
    build.check(build.cuda_lib().zk_probe_rate(
        body, build.ptr(out), build.ptr(x), build.ptr(b), x.shape[0], iters,
        build.stream_ptr(x)), BODIES[body][0])
    F.count_launch(BODIES[body][0], x.shape[0])
    return out


def inputs(body: int, n: int, seed: int, device):
    """The TPU probes' operands: u32 below 2^16 (micro_probe2) or in
    [1, 256) (micro_probe3), f32 x in [0.5, 1.5) and b in [0, 1e-3); the
    wide body any 32-bit x and b below 2^30."""
    rng = np.random.default_rng(seed)
    if body == 0:
        x, b = rng.integers(0, 1 << 16, (2, n))
    elif body in (1, 2):
        x, b = rng.integers(1, 1 << 8, (2, n))
    elif body in (3, 4):
        x = rng.random(n, np.float32) + 0.5
        b = rng.random(n, np.float32) * 1e-3
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(b.astype(np.float32)).to(device))
    else:
        x = rng.integers(0, 1 << 32, n)
        b = rng.integers(0, 1 << 30, n)
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(b.astype(np.int32)).to(device))
    return (torch.from_numpy(x.astype(np.int32)).to(device),
            torch.from_numpy(b.astype(np.int32)).to(device))


def _base(op: str) -> str:
    """An opcode's name up to its first modifier (IMAD.WIDE kept whole)."""
    return "IMAD.WIDE" if op.startswith("IMAD.WIDE") else op.split(".")[0]


def parse_sass(text: str) -> dict:
    """{struct name: (loop, rest)} for each k_rate body in cuobjdump -sass
    text: Counters of the base opcodes in the function's longest loop (the
    span from a branch's earlier target to the branch) and in the rest of
    the function."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = next((b[3] for b in BODIES if "k_rate" in name
                        and f"probe{len(b[3])}{b[3]}" in name), None)
            if cur:
                funcs[cur] = []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            funcs[cur].append(("label", m.group(1)))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)(.*)", line)
        if m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for struct, items in funcs.items():
        ops, at = [], {}            # label or address -> instruction index
        for it in items:
            if it[0] == "label":
                at[it[1]] = len(ops)
            else:
                at[hex(it[0])] = len(ops)
                ops.append(it)
        loop = (0, -1)
        for i, (_, op, rest) in enumerate(ops):
            if _base(op) != "BRA":
                continue
            m = re.search(r"\((\.L_x_\d+)\)|(0x[0-9a-f]+)", rest)
            t = at.get(m.group(1) or hex(int(m.group(2), 16))) if m else None
            if t is not None and t <= i and i - t > loop[1] - loop[0]:
                loop = (t, i)
        inside = Counter(_base(op) for _, op, _r in ops[loop[0]:loop[1] + 1])
        outside = Counter(_base(op) for _, op, _r in ops) - inside
        out[struct] = (inside, outside) if sum(inside.values()) else None
    return out


def sass_counts():
    """parse_sass of the built probes object; None when cuobjdump is
    absent."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    obj = os.path.join(build.cuda_objects_dir(), "probes.cu.o")
    if not os.path.exists(tool):
        return None
    return parse_sass(subprocess.run([tool, "-sass", obj], capture_output=True,
                                     text=True, check=True).stdout)


def issued(struct: str, iters: int, sass):
    """(instructions one chain of iters x 64 steps issues, by base opcode;
    whether they were read from the SASS).  The SASS is used where its
    loop holds the body's first named instruction kChain times, that is,
    where the loop found is one pass of the chain; else the instructions
    the source names."""
    decl = next(b[4] for b in BODIES if b[3] == struct)
    key = next(iter(decl))
    if sass and sass.get(struct):
        loop, rest = sass[struct]
        if loop[key] == CHAIN * decl[key]:
            ops = Counter({k: v * iters for k, v in loop.items()}) + rest
            return ops, True
    return Counter({k: v * iters * CHAIN for k, v in decl.items()}), False


def pipe_seconds(ops: Counter, n: int) -> dict:
    """{pipe: least seconds} for n chains issuing ops each."""
    out = {}
    for pipe, (lanes, names) in PIPES.items():
        count = sum(v for k, v in ops.items()
                    if pipe == "issue" or k in names)
        out[pipe] = n * count / (lanes * C.SMS * C.CLOCK_HZ)
    return out


def run(device=None, log=print):
    """Times every body at N chains of ITERS x 64 steps and returns
    ``check``, which holds each against its plain version at CHECK_ITERS x
    64 steps on the same inputs and returns the rows."""
    dev = resolve(device)
    sass = sass_counts() if dev.type == "cuda" else None
    if dev.type == "cuda" and sass is None:
        log("rates: cuobjdump not found; instruction counts not logged, "
            "the bound from the source's instructions")
    times = {}
    for name, body, *_ in BODIES:
        x, b = inputs(body, N, 100 + body, dev)
        times[name] = C.time_ms(lambda: rate(body, x, b, ITERS), dev, reps=3)
        del x, b

    def check():
        rows = []
        for name, body, replaces, struct, _decl in BODIES:
            x, b = inputs(body, N, 100 + body, dev)
            ms = times[name]
            k = rate(body, x, b, CHECK_ITERS)
            p, plain_ms = C.timed(lambda: plain_rate(body, x, b,
                                                     CHECK_ITERS), dev)
            ops, from_sass = issued(struct, ITERS, sass)
            secs = pipe_seconds(ops, N)
            pipe = max(secs, key=secs.get)
            steps = N * ITERS * CHAIN
            per_step = {k_: round(v * N / steps, 4) for k_, v in ops.items()
                        if k_ in SASS_OPS}
            floats = x.dtype.is_floating_point
            r = C.row(name, replaces, N, ms, plain_ms, N,
                      2 * x.element_size() * N + b.element_size() * N,
                      secs[pipe], C.max_abs_err(k, p),
                      rel_err=C.max_rel_err(k, p) if floats else None,
                      tol=F32_TOL if floats else None, steps=steps,
                      steps_per_s=round(steps / ms * 1e3), pipe=pipe,
                      share_of_peak=round(secs[pipe] * 1e3 / ms, 4),
                      per_step=per_step,
                      sass_read=from_sass,
                      check_steps=CHECK_ITERS * CHAIN, device=dev.type)
            log(f"probe {name}: {r['steps_per_s'] / 1e12:.3f} T steps/s, "
                f"{100 * r['share_of_peak']:.1f} % of its {pipe} bound, "
                f"per step {per_step}")
            rows.append(r)
            del x, b, k, p
        return rows
    return check
