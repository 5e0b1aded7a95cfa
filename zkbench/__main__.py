"""Entry point: python3 -m zkbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>.

Every build and kernel cache goes to a fixed directory of the checkout
before PyTorch loads: the port builds its kernels into
zkpos_tpu_torch/_build/, the rest goes under zkbench/_cache/.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from zkbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
