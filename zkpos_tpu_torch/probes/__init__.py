"""The port's measurement path: counterparts of the TPU probes in scripts/.

Each module keeps its TPU script's name and holds one kernel family of
csrc/probes*.cu with its plain PyTorch version: ``rates`` (micro_probe2.py,
micro_probe3.py's VPU bodies), ``probe_conv``, ``debug_product``
(debug_f32p.py), ``probe_kernel_split`` (probes_split.cu),
``probe_segscan`` (probes.cu, probes_scan.cu, probes_stages*.cu and
seg_scan's own kernels) and
``probe_dot`` (micro_probe3.py's k_dot and k_mix); ``latency`` is the
port's own (the product's latency on a lone warp, which the hash chain
pays).  Each module's ``run``
times its variants on the card and returns a ``check`` that holds them
against the plain versions and returns the rows; ``run_probe`` counts the
timed launches alone.  ``python -m zkpos_tpu_torch.probes`` prints one
JSON line per probe, and chip_smoke.py drives the same functions as its
probes path.
"""

from __future__ import annotations

from ..ops import field as F
from . import (debug_product, latency, probe_conv, probe_dot,
               probe_kernel_split, probe_segscan, rates)

PROBES = (("rates", rates), ("probe_conv", probe_conv),
          ("debug_product", debug_product),
          ("probe_kernel_split", probe_kernel_split),
          ("probe_segscan", probe_segscan), ("probe_dot", probe_dot),
          ("latency", latency))


def kernel_names():
    """The launch name of every probe variant, as the wrappers count them
    (the scan's ``full`` stage is seg_scan's own kernel, counted as
    ``seg_scan_<curve>``)."""
    return ([b[0] for b in rates.BODIES]
            + [f"conv_{f}" for f in probe_conv.FORMS]
            + [f"product_{s}" for s in debug_product.STAGES]
            + [f"split_{m}" for m in probe_kernel_split.MODES]
            + [probe_segscan.launch_name(s, c) for c in ("g1", "g2")
               for s in probe_segscan.STAGES]
            + [f"dot_{k}_{r}" for k in probe_dot.KINDS
               for r in probe_dot.ROUTES]
            + ["latency_mont"])


def run_probe(mod, device=None, log=print, **kw):
    """One probe: its timed launches with the launch counts set to 0 just
    before and read just after, then its checks, whose launches are not
    the probe's.  Returns (its rows, with those counts as their launches
    -- a row's ``counted_as`` where it names another kernel's count; the
    counts by kernel)."""
    F.LAUNCHES.clear()
    check = mod.run(device, log=log, **kw)
    counted = dict(F.LAUNCHES)
    rows = check()
    for r in rows:
        r["launches"] = counted.get(r.get("counted_as", r["name"]), 0)
    return rows, counted
