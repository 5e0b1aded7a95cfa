"""The benchmark of zkpos_tpu_torch, the PyTorch and CUDA port, on the card.

BENCHMARK.json at the root of the repository names its cells; this
package finds each cell's configuration (configs/), traffic mix
(workloads/), runner (runners/) and per-layer metrics (metrics/) by name.
Its yardstick (generators, reference, work counts, trace arithmetic) is
its own and imports nothing of the program.  See harness.py.
"""
