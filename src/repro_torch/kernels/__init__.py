"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel's ``ops.py`` dispatches on the device of the tensors it is
given: CPU tensors take the plain version in ``ref.py``; CUDA tensors launch
the kernel (``csrc/<name>.cu``) or raise.  ``launches`` counts kernel
launches per wrapper, so a run can show that its main path went through the
kernels; ``reset_launches`` zeroes the counts.
"""
from __future__ import annotations

launches = {"paged_attention": 0, "block_copy": 0, "bulk_op": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
