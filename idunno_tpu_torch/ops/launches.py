"""The launch counts of the port's CUDA kernel wrappers.

Each wrapper of a hand-written kernel adds one to its ``launches``
attribute where it launches its kernel (a replayed CUDA graph adds the
launches its capture recorded), and nowhere else: on a CPU tensor the
wrapper runs the plain version and counts nothing. A run that zeroes the
counts before a path and reads them after shows that the path went
through the kernels.
"""
from __future__ import annotations


def kernel_wrappers() -> dict:
    """Kernel name → its wrapper, which carries the ``launches`` count."""
    from idunno_tpu_torch.ops import flash_attention as fa
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.ops.preprocess_kernel import preprocess_batch_kernel

    return {"preprocess": preprocess_batch_kernel,
            "flash_attention": fa.flash_attention_kernel,
            "paged_attention": paged_attention_kernel,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_kernel}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
