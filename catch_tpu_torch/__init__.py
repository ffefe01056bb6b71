"""catch_tpu_torch: the probe-design engine of catch_tpu in PyTorch and CUDA.

A second package beside ``catch_tpu`` (the JAX reference). It designs the
same probe sets on one NVIDIA GPU: candidate tiling and duplicate removal
on the host, the corpus scan on the device through four hand-written
CUDA kernels (``ops/scan_instance.py``, sources under ``csrc/``), and the
lazy greedy set cover on the host.

The package imports ``torch`` and never ``jax``, and it imports nothing
from ``catch_tpu``: host modules are copied, each with a header naming
its source file.  Every device call takes an explicit ``device``; a CPU
tensor runs a kernel's plain-PyTorch twin, a CUDA tensor runs the kernel.
"""

__version__ = "0.1.0"

from catch_tpu_torch.genome import Genome
from catch_tpu_torch.probe import Probe
