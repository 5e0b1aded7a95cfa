"""No module whose top-level name is jax, jaxlib, flax or zkpos_tpu is
loaded by the benchmark, compared by whole top-level names:
zkpos_tpu_torch begins with zkpos_tpu and is not it."""

import subprocess
import sys

from zkbench import harness, manifest


def test_whole_name_comparison():
    mods = ["zkpos_tpu_torch", "zkpos_tpu_torch.ops.msm_device", "jaxtyping",
            "flaxen", "numpy", "zkpos_tpu.ops", "jax.numpy", "jaxlib",
            "flax"]
    assert harness.banned_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                            "zkpos_tpu.ops"]
    assert harness.banned_modules(["zkpos_tpu_torch.x", "zkbench"]) == []


def test_a_run_loads_none_of_them():
    """Import everything a run imports (harness, runners, readers, the
    control, and the port's modules the runners call) in a fresh process,
    then compare."""
    readers = [m["name"] for m in manifest.Bench().spec["per_layer"]]
    code = (
        "import sys, zkbench.harness as h, zkbench.control, "
        "zkbench.manifest as m, zkbench.trace\n"
        "for d in ('prove', 'tree'): m.runner(d)\n"
        f"for r in {readers!r}: m.reader(r)\n"
        "import zkpos_tpu_torch.groth16.groth16, "
        "zkpos_tpu_torch.circuit.solver_native, "
        "zkpos_tpu_torch.circuit.batch_create_user, "
        "zkpos_tpu_torch.services.keygen, zkpos_tpu_torch.witness.core, "
        "zkpos_tpu_torch.merkle.tree, zkpos_tpu_torch.groth16.artifact, "
        "zkpos_tpu_torch.probes.probe_kernel_split\n"
        "bad = h.banned_modules()\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_of_the_benchmark_imports_them():
    import ast
    import glob
    import os
    for path in glob.glob(os.path.join(manifest.HERE, "**", "*.py"),
                          recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.BANNED, (path, n)
