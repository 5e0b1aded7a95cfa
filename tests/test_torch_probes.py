"""The probes' plain versions (zkpos_tpu_torch/probes, the counterparts of
the TPU probes in scripts/) against the JAX functions they replace, on
the CPU at small sizes from a numpy seed:

* scripts/probe_conv.py's conv_padloop / conv_grouped / conv_triangle
  (imported from the script) exactly, and the probe kernel's REPS-round
  fold (probe_conv.py:66-71, restated) at rtol 1e-6;
* the TPU rate bodies of micro_probe2.py:70-75 and micro_probe3.py:69-112,
  closures inside main() restated here: u32 exactly, f32 at rtol 1e-6;
* the weights-first chains of micro_probe3.py:117-124 and :146-156,
  restated at precision HIGHEST: rtol 1e-5;
* the f32p product's stages (poseidon_f32_pallas._conv and _reduce, what
  debug_f32p.py runs) against the port's product and REDC, compared as
  canonical values: both products equal a*b, and reduce * 2^272 = a*b =
  REDC * 2^256 mod r;
* the `full` Poseidon ablation against crypto/poseidon_ref.poseidon;
* the `full` scan stage against msm_device._seg_scan_hs.

Beside those, what the card run holds the probes to: the rate probe's
bound read from a SASS listing (each class on its own pipe), the dot
probe's tolerances (a TF32 product passes, a wrong one fails), and each
cheap probe's run and check at a few elements (the launch counts of
run_probe cover the timed launches only).

The kernels themselves run on the card only (chip_smoke.py); the g++
rehearsal (tests/test_torch_rehearsal.py) holds csrc/probes.cuh to these
plain versions.
"""
import importlib.util
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkpos_tpu.crypto import bn254 as bn
from zkpos_tpu.crypto.poseidon_ref import poseidon
from zkpos_tpu.ops import fr_f32 as fd
from zkpos_tpu.ops import msm_device as jmd
from zkpos_tpu.ops import poseidon_f32_pallas as pk

from zkpos_tpu_torch.ops import ec
from zkpos_tpu_torch.ops import field as F
from zkpos_tpu_torch import probes
from zkpos_tpu_torch.probes import conv_variants as pcv
from zkpos_tpu_torch.probes import debug_product as pprod
from zkpos_tpu_torch.probes import dot_variants as pdv
from zkpos_tpu_torch.probes import latency as platency
from zkpos_tpu_torch.probes import probe_conv as pconv
from zkpos_tpu_torch.probes import probe_dot as pdot
from zkpos_tpu_torch.probes import probe_kernel_split as psplit
from zkpos_tpu_torch.probes import probe_segscan as pscan
from zkpos_tpu_torch.probes import common as C
from zkpos_tpu_torch.probes import rates as prates

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RM = 1 << 256


@pytest.fixture(scope="module")
def tpu_conv():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_conv", os.path.join(ROOT, "scripts", "probe_conv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digits(seed, t=16):
    a, b = pconv.inputs(t, seed, "cpu")
    return a, b


@pytest.mark.parametrize("form", pconv.FORMS)
def test_conv_forms_match_tpu_script(tpu_conv, form):
    a, b = _digits(1)
    f = getattr(tpu_conv, f"conv_{form}")
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    want = np.asarray(f(ja) if form == "triangle" else f(ja, jb))
    got = pconv.plain_conv(form, a, b).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("form", pconv.FORMS)
def test_conv_rounds_match_tpu_kernel_body(tpu_conv, form):
    a, b = _digits(2)
    f = getattr(tpu_conv, f"conv_{form}")
    x, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    for _ in range(tpu_conv.REPS):           # probe_conv.py:68-71
        c = f(x) if form == "triangle" else f(x, jb)
        x = (c[:tpu_conv.ND] * 1e-7
             + jnp.pad(c[tpu_conv.ND:], ((0, 1), (0, 0))) * 1e-7 + jb)
    np.testing.assert_allclose(pconv.plain_rounds(form, a, b).numpy(),
                               np.asarray(x), rtol=1e-6)


@pytest.mark.parametrize("form", pconv.FORMS)
def test_conv_library_matches_plain(form):
    """The library yardstick (each round's convolution one conv1d over
    the columns as groups) computes the probe's rounds and fold."""
    a, b = pconv.inputs(48, 5, "cpu")
    err = C.max_rel_err(pconv.library_rounds(form, a, b),
                        pconv.plain_rounds(form, a, b))
    assert err <= pconv.TOL


# the TPU kernels' loop bodies, restated (closures inside the scripts' main)
JAX_BODIES = {
    0: lambda x, b: (x * b + b) & 0xFFFF,                  # micro_probe2:74
    1: lambda x, b: (x * b) & 0xFFFF,                      # micro_probe3:72
    2: lambda x, b: x * b + b,                             # micro_probe3:82
    3: lambda x, b: x * b + b,                             # micro_probe3:95
    4: lambda x, b: (x - 256.0 * jnp.floor(x * (1.0 / 256.0))) + b,
}


@pytest.mark.parametrize("body", sorted(JAX_BODIES))
def test_rate_bodies_match_tpu_bodies(body):
    x, b = prates.inputs(body, 64, 300 + body, "cpu")
    if body < 3:
        xj = jnp.asarray(x.numpy().view(np.uint32))
        bj = jnp.asarray(b.numpy().view(np.uint32))
    else:
        xj, bj = jnp.asarray(x.numpy()), jnp.asarray(b.numpy())
    step = jax.jit(JAX_BODIES[body])
    for _ in range(prates.CHAIN):
        xj = step(xj, bj)
    got = prates.plain_rate(body, x, b, 1).numpy()
    if body < 3:
        assert np.array_equal(got.view(np.uint32), np.asarray(xj))
    else:
        np.testing.assert_allclose(got, np.asarray(xj), rtol=1e-6)


def test_wide_mad_body_matches_python_ints():
    x, b = prates.inputs(5, 16, 305, "cpu")
    got = prates.plain_rate(5, x, b, 1).tolist()
    for s, w, g in zip(x.tolist(), b.tolist(), got):
        for _ in range(prates.CHAIN):          # field.cuh:127's step
            s = (s & 0xFFFFFFFF) * w + w + (s >> 32)
        assert s == g


@pytest.mark.parametrize("kind", pdot.KINDS)
def test_dot_chains_match_tpu_bodies(kind):
    w, x = pdot.inputs(128, 7, "cpu")
    wj, xj = jnp.asarray(w.numpy()), jnp.asarray(x.numpy())
    dot = lambda a, v: jax.lax.dot_general(
        a, v, (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    if kind == "dot":                          # micro_probe3.py:117-124
        for _ in range(8):
            xj = dot(wj, xj) * 1e-2
    else:                                      # micro_probe3.py:146-156
        for _ in range(4):
            y = dot(wj, xj)
            xj = xj * 1e-2 + y * 1e-3
            for _ in range(16):
                xj = xj * 0.999 + 1.0
    np.testing.assert_allclose(pdot.plain_chain(kind, w, x).numpy(),
                               np.asarray(xj), rtol=1e-5)


def _value(digits):
    """Integer value of (34, T) digit columns, lazy digits allowed."""
    d = np.asarray(digits, dtype=np.float64)
    out = []
    for j in range(d.shape[1]):
        v = 0
        for i in reversed(range(d.shape[0])):
            v = v * 256 + int(d[i, j])
        out.append(v)
    return out


def test_product_stages_match_f32p_stages():
    rng = np.random.default_rng(9)
    xs = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(16)]
    ys = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(16)]
    xs[:2], ys[:2] = [0, bn.R - 1], [bn.R - 1, bn.R - 1]
    consts = pk._consts(3)
    w_n3, w_p_hi, w_c = (jnp.asarray(c, jnp.bfloat16) for c in consts[9:12])
    t = pk._conv(jnp.asarray(fd.ints_to_digits(xs)),
                 jnp.asarray(fd.ints_to_digits(ys)))
    red = pk._reduce(t, w_n3, w_p_hi, w_c)
    a, b = F.ints_to_tensor(xs), F.ints_to_tensor(ys)
    prod = pprod.plain_product(a, b)
    port = [int.from_bytes(r.numpy().tobytes(), "little") for r in prod]
    assert port == _value(t) == [x * y for x, y in zip(xs, ys)]
    redc = F.tensor_to_ints(pprod.plain_reduce(prod))
    for j, (x, y) in enumerate(zip(xs, ys)):
        assert _value(red)[j] * (1 << 272) % bn.R == x * y % bn.R
        assert redc[j] * RM % bn.R == x * y % bn.R
    assert redc == F.tensor_to_ints(pprod.plain_cios(a, b))


@pytest.mark.parametrize("steps", [0, 1, 37])
def test_mont_chain_matches_ints(steps):
    """The latency probe's plain version: steps Montgomery products by b,
    a b^steps / R^steps mod r."""
    gen = torch.Generator().manual_seed(7)
    a, b = (platency.random_fr(5, gen, "cpu") for _ in range(2))
    rinv = pow(RM, -1, bn.R)
    want = [x * pow(y * rinv, steps, bn.R) % bn.R for x, y in
            zip(F.tensor_to_ints(a), F.tensor_to_ints(b))]
    assert F.tensor_to_ints(platency.plain_mont_chain(a, b, steps)) == want


def test_full_split_matches_poseidon_ref():
    rng = np.random.default_rng(11)
    xs = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(6)]
    ys = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(6)]
    xs[0], ys[0] = 0, bn.R - 1
    am = F.ints_to_tensor([x * RM % bn.R for x in xs])
    bm = F.ints_to_tensor([y * RM % bn.R for y in ys])
    got = F.tensor_to_ints(psplit.plain_split("full", am, bm))
    rinv = pow(RM, -1, bn.R)
    assert [g * rinv % bn.R for g in got] == [poseidon([x, y])
                                              for x, y in zip(xs, ys)]


def test_fixup_elements():
    """The elements before each 64-element lane's first head: none in the
    stream's first lane (position 0 counts as a head), 6 and 2 in lanes
    with one, all 64 in a lane without, and the 8 of a short last lane."""
    h = torch.zeros(264, dtype=torch.uint8)
    h[[5, 70, 130]] = 1
    assert pscan.fixup_elements(h) == 0 + 6 + 2 + 64 + 8


@pytest.mark.parametrize("tpc", [1, 2])
@pytest.mark.parametrize("at,want", [
    ([5, 13], {"local": 10, "local_agg": 11, "full": 17, "three_pass": 13}),
    ([], {"local": 12, "local_agg": 16, "full": 28, "three_pass": 15})])
def test_stage_adds(tpc, at, want):
    """The single pass's adds at 2 lanes x 4 elements a tile (lanes 0-3,
    4-7, 8-11, 12-15), in chunks of one and of two tiles.  Heads at 0, 5
    and 13: local 3 + 2 + 3 + 2 (no head, no lane's first element); no
    scan round adds (lanes 0, 1 and 3 hold heads); a tile a chunk, the
    second chunk starts inside a segment and its second lane waits for the
    prefix, two tiles a chunk, lane 12-15's carry joins the running prefix
    (1 add either way); full adds the 0 + 1 + 4 + 1 elements before each
    lane's first head.  A head at 0 only: local 12; one scan round add a
    tile; a tile a chunk, the second chunk's inclusive prefix and its
    second lane's carry, two tiles a chunk, lane 12-15's carry and the
    prefix's extension by the second tile (2 adds either way); full 12
    elements more."""
    h = torch.zeros(16, dtype=torch.uint8)
    h[at] = 1
    got = {st: pscan.stage_adds(st, h, tpc, lane_k=4, lanes=2)
           for st in want}
    assert got == want
    assert pscan.stage_adds("copy", h, tpc) == 0
    assert pscan.fixup_elements(h, 4) == want["full"] - want["local_agg"]


@pytest.mark.parametrize("mean", [3.0, 40.0])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_lane_carries_equal_plain_carries(curve, mean):
    """The card check's carries, a scan over the lanes of the lanes'
    passes, equal plain_stage's, the full scan at the element before each
    open lane, by affine value: on short segments and on segments longer
    than many lanes (lanes of 4, a short last lane)."""
    pts, heads = pscan.stream(curve, 203, mean, 7, "cpu")
    local, carries = pscan.plain_stage("local_agg", pts, heads, lane_k=4)
    got = pscan.lane_carries(local, heads, 4)
    assert got.shape == carries.shape
    assert pscan._same_points(got, carries)
    assert bool(pscan.open_lanes(heads, 4).any())


def test_full_scan_stage_matches_jax_hs():
    from zkpos_tpu.ops import ec_f32 as ecf
    from zkpos_tpu_torch.groth16.groth16 import (arrays_to_points,
                                                 points_to_arrays)
    rng = np.random.default_rng(15)
    P = [bn.g1_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)))
         for _ in range(5)] + [None]
    L = 48
    pts = [P[i] for i in rng.integers(0, len(P), L)]
    heads = np.zeros(L, dtype=bool)
    heads[[0, 5, 16, L - 3]] = True           # 16..L-3: one segment, 2 blocks
    port = pscan.plain_stage(
        "full", ec.from_affine(arrays_to_points(*points_to_arrays(pts)),
                               "g1"),
        torch.from_numpy(heads.astype(np.uint8)))[0]
    arrs = tuple(a.reshape(34, L) for a in jmd._unwrap(3, ecf.g1_to_device(
        pts)))
    _, jout = jmd._seg_scan_hs(3, jnp.asarray(heads), arrs, axis=1)
    jax_pts = ecf.g1_from_device(jmd._wrap(3, jmd._finalize_pt(jout)))
    ca, ma = points_to_arrays(ec.to_affine(port))
    cb, mb = points_to_arrays(jax_pts)
    assert np.array_equal(ma, mb) and np.array_equal(ca[ma], cb[mb])


# --- what the card run holds the probes to ----------------------------------

def _listing(struct, step, labels):
    """A cuobjdump -sass listing of one k_rate body: a prologue, a loop of
    kChain steps closed by a backward branch (to a label or an address),
    and an epilogue."""
    fn = (f"\t\tFunction : _ZN6anon6k_rateIN5probe{len(struct)}{struct}"
          "EEEvPNT_1TEPKS3_xi")
    ops = ["S2R R0, SR_TID.X", "IMAD.WIDE R2, R0, 0x4, R2",
           "IADD3 R8, R0, 1, RZ"]
    lines = [fn] + [f"        /*{16 * i:04x}*/  {op} ;" for i, op in
                    enumerate(ops)]
    top = 16 * len(ops)
    if labels:
        lines.append(".L_x_0:")
    body = [op for k in range(prates.CHAIN) for op in step(k)]
    body += ["IADD3 R6, R6, 0x1, RZ", "ISETP.GE.AND P0, PT, R6, R7, PT",
             "@!P0 BRA " + ("`(.L_x_0)" if labels else hex(top))]
    body += ["STG.E [R2.64], R5", "EXIT"]
    lines += [f"        /*{top + 16 * i:04x}*/  {op} ;  /* 0x0 */"
              for i, op in enumerate(body)]
    return "\n".join(lines)


STEPS = {
    "U32Chain": lambda k: ["IMAD R5, R5, R4, R4"]
    + (["LOP3.LUT R5, R5, 0xffff, RZ, 0xc0, !PT"] if k % 3 == 0 else []),
    "F32Floor": lambda k: ["FMUL R6, R5, 0.00390625", "FRND.FLOOR R6, R6",
                           "FFMA R5, R6, -256, R5", "FADD R5, R5, R4"],
}


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("struct,pipe", [("U32Chain", "imad"),
                                         ("F32Floor", "conv")])
def test_rate_bound_from_sass_loop(struct, pipe, labels):
    sass = prates.parse_sass(_listing(struct, STEPS[struct], labels))
    loop, rest = sass[struct]
    assert rest == {"S2R": 1, "IMAD.WIDE": 1, "IADD3": 1, "STG": 1,
                    "EXIT": 1}
    ops, from_sass = prates.issued(struct, 10, sass)
    assert from_sass
    assert ops == Counter({k: 10 * v for k, v in loop.items()}) + rest
    secs = prates.pipe_seconds(ops, 1000)
    assert max(secs, key=secs.get) == pipe
    # the slowest pipe: a chain's 640 IMADs (and the prologue's IMAD.WIDE)
    # at 64 a clock, or its 640 FRNDs at 16; the masks go to the ALU pipe
    lanes = prates.PIPES[pipe][0]
    want = 1000 * (640 + (pipe == "imad")) / (lanes * C.SMS * C.CLOCK_HZ)
    assert secs[pipe] == pytest.approx(want, rel=1e-3)
    if struct == "U32Chain":
        assert loop["LOP3"] == 22 and secs["alu"] < secs["imad"]


def test_rate_bound_without_sass():
    """The source's own instructions: the wide multiply-add's two IADD3s a
    step bind on the ALU pipe."""
    ops, from_sass = prates.issued("U64WideMad", 2, None)
    assert not from_sass and ops == {"IMAD.WIDE": 128, "IADD3": 256}
    secs = prates.pipe_seconds(ops, 1)
    assert max(secs, key=secs.get) == "alu"


def _tf32(v):
    """Operands as mma.sync sees them after cvt.rna.tf32: 10 bits of
    mantissa, rounded to nearest, ties away (v >= 0 here)."""
    u = v.view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _chain(kind, route, w, x, fault=None):
    """The chain as a kernel of the route computes it, or with a product
    that is off by 0.3 % or has two rows swapped."""
    rnd = _tf32 if route == "tf32" else (lambda v: v)
    for _ in range(8 if kind == "dot" else 4):
        y = (rnd(w).double() @ rnd(x).double()).float()
        if fault == "scaled":
            y = y * (1 + 3e-3)
        elif fault == "rows_swapped":
            y = y[torch.arange(pdot.NF) ^ 1]
        if kind == "dot":
            x = y * 1e-2
        else:
            x = x * 1e-2 + y * 1e-3
            for _ in range(16):
                x = x * 0.999 + 1.0
    return x


@pytest.mark.parametrize("fault", [None, "scaled", "rows_swapped"])
@pytest.mark.parametrize("route", pdot.ROUTES)
@pytest.mark.parametrize("kind", pdot.KINDS)
def test_dot_tolerance_holds_the_product(kind, route, fault):
    w, x = pdot.inputs(256, 13, "cpu")
    err = C.max_rel_err(_chain(kind, route, w, x, fault),
                        pdot.plain_chain(kind, w, x))
    assert (err <= pdot.TOL[kind, route]) == (fault is None)


CHEAP = {"rates": {"N": 64, "ITERS": 1, "CHECK_ITERS": 1},
         "probe_conv": {"N": 64, "CHECK_N": 32},
         "debug_product": {"N": 64, "CHECK_N": 32},
         "latency": {"STEPS": 64},
         "probe_dot": {"N": 128}}


@pytest.mark.parametrize("name", sorted(CHEAP))
def test_run_probe_rows(monkeypatch, name):
    mod = dict(probes.PROBES)[name]
    for k, v in CHEAP[name].items():
        monkeypatch.setattr(mod, k, v)
    F.LAUNCHES["earlier_path_kernel"] += 1
    rows, counted = probes.run_probe(mod, "cpu", log=lambda *a: None)
    assert counted == {}          # no kernel is launched for CPU tensors
    assert [r["name"] for r in rows] == [
        k for k in probes.kernel_names() if k.startswith(rows[0]["name"][:4])]
    for r in rows:
        assert r["ok"] and r["launches"] == 0 and r["n"] == mod.N
        assert r["bound_by"] in ("bytes", "operations")


def test_ec_variants_sources():
    """The add-variants script's copies of csrc: the G2 add's launch
    bound substituted where the script says (so a change to ec_add.cu that
    moves it fails here, not on the card), every other file unchanged."""
    from zkpos_tpu_torch.probes import ec_variants as ev
    from zkpos_tpu_torch.utils import build
    out = ev._sources("test_kmin3", build.CSRC, 3)
    with open(os.path.join(out, "ec_add.cu")) as f:
        text = f.read()
    assert ev.KMIN.replace("kMin = 2", "kMin = 3") in text
    assert ev.KMIN not in text
    with open(os.path.join(build.CSRC, "fp_ec.cuh")) as f, \
            open(os.path.join(out, "fp_ec.cuh")) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("variant", ["products_only", "sum_loads_only",
                                     "exchange_only", "no_trade"])
def test_horner_variants_sources(variant):
    """The Horner ablation script's copies of csrc: each substitution made
    where the script says (so a change to ec.cuh that moves the text fails
    here, not on the card), every other file unchanged."""
    from zkpos_tpu_torch.probes import horner_variants as hv
    from zkpos_tpu_torch.utils import build
    subs = hv.VARIANTS[variant]
    out = hv.variant_sources("horner_variants", "test_" + variant,
                             build.CSRC, subs)
    with open(os.path.join(out, "ec.cuh")) as g:
        text = g.read()
    for _, old, new in subs:
        assert new in text and old not in text.replace(new, "")
    for f in ("ec_add.cu", "fp_ec.cuh", "field.cuh"):
        with open(os.path.join(build.CSRC, f)) as g, \
                open(os.path.join(out, f)) as h:
            assert g.read() == h.read()


@pytest.mark.parametrize("variant", sorted(pdv.VARIANTS))
def test_dot_variants_sources(variant):
    """The product variants script's copies of csrc: each substitution
    made where the script says (so a change that moves the text fails
    here, not on the card), every other file unchanged."""
    from zkpos_tpu_torch.utils import build
    subs = tuple(("probes.cu", o, n) for o, n in pdv.VARIANTS[variant])
    out = pdv.variant_sources("dot_variants", "test_" + variant, build.CSRC,
                              subs)
    with open(os.path.join(out, "probes.cu")) as g:
        text = g.read()
    for _, old, new in subs:
        assert new in text and old not in text
    for f in ("probes.cuh", "seg_scan.cuh"):
        with open(os.path.join(build.CSRC, f)) as g, \
                open(os.path.join(out, f)) as h:
            assert g.read() == h.read()


@pytest.mark.parametrize("variant", sorted(pcv.VARIANTS))
def test_conv_variants_sources(variant):
    """The grouped convolution's variants script's copies of csrc: each
    substitution made where the script says (so a change that moves the
    text fails here, not on the card), every other file unchanged."""
    from zkpos_tpu_torch.utils import build
    subs = pcv.VARIANTS[variant]
    out = pcv.variant_sources("conv_variants", "test_" + variant, build.CSRC,
                              subs)
    for f in ("probes.cu", "probes.cuh", "seg_scan.cuh"):
        with open(os.path.join(build.CSRC, f)) as g, \
                open(os.path.join(out, f)) as h:
            orig, text = g.read(), h.read()
        mine = [(o, n) for g_, o, n in subs if g_ == f]
        for old, new in mine:
            assert new in text and old not in text.replace(new, "")
        if not mine:
            assert text == orig


def test_conv_variants_column_digits():
    """The digits the variants without loads make in the kernel (the C
    expressions the script substitutes) are column_digits'."""
    a, b = pcv.column_digits(300, "cpu")
    for expr, want in ((pcv._DIGIT_A, a), (pcv._DIGIT_B, b)):
        got = [[float(eval(expr.replace("(float)", ""), {"c": c, "i": i}))
                for c in range(300)] for i in range(pconv.ND)]
        assert torch.equal(torch.tensor(got), want)
        assert want.min() >= 0 and want.max() <= 255


@pytest.mark.parametrize("variant", ["nosync", "block64", "smem"])
def test_poseidon_variants_sources(variant):
    """The wide-permutation variants script's copies of csrc: each of the
    variant's substitutions made where the script says (so a change that
    moves the text fails here, not on the card), every other file
    unchanged."""
    from zkpos_tpu_torch.probes import poseidon_variants as pv
    from zkpos_tpu_torch.utils import build
    subs = pv.VARIANTS[variant]
    out = pv._sources("test_" + variant, build.CSRC, subs)
    changed = {f for f, _, _ in subs}
    for f, old, new in subs:
        with open(os.path.join(out, f)) as g:
            text = g.read()
        assert new in text and old not in text
    for f in ("poseidon.cu", "poseidon.cuh", "field.cuh"):
        if f not in changed:
            with open(os.path.join(build.CSRC, f)) as g, \
                    open(os.path.join(out, f)) as h:
                assert g.read() == h.read()
