"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel's ``ops.py`` dispatches on the device of the tensors it is
given: CPU tensors take the plain version in ``ref.py``; CUDA tensors launch
the kernel (``csrc/<name>.cu``) or raise.  ``launches`` counts kernel
launches per wrapper, so a run can show that its main path went through the
kernels, and ``"flash_attention:<path>"`` and ``"decay_attention:<path>"``
the flash and decay kernels' launches by path; ``reset_launches`` zeroes the
counts.
"""
from __future__ import annotations

launches = {"paged_attention": 0, "block_copy": 0, "bulk_op": 0, "flash_attention": 0,
            "flash_attention:simt": 0, "flash_attention:mma": 0, "flash_attention:wgmma": 0,
            "flash_attention:tf32x3": 0,
            "decay_attention": 0, "decay_attention:simt": 0, "decay_attention:scalar_tc": 0,
            "decay_attention:vector_tc": 0, "decay_attention:scalar_tc_f32": 0,
            "decay_attention:vector_tc_f32": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
