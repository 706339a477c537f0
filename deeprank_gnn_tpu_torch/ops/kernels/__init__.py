"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every kernel wrapper takes its plain version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device (or raises). ``LAUNCHES``
counts the kernel launches per kernel name: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels (``chip_smoke.py`` clears it before the serving pass and
reads it after).
"""

from collections import Counter

LAUNCHES: Counter = Counter()
