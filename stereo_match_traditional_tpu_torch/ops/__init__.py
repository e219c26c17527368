"""Stereo ops on torch tensors: cost volumes, WTA, post-processing.

Device rule: every op takes the device of its input tensors.  A public op
with a hand-written kernel (``ops.volume``, ``ops.scanline``,
``ops.aggregate``, ``ops.post``) decides once, by :func:`on_cuda`: CUDA
tensors go to its launcher in ``ops.kernels``, CPU tensors to its private
``_<name>_plain`` body.  The launchers take CUDA tensors only and import
nothing of the ops that call them but the plain-torch penalty helpers of
``ops.scanline`` (the banded kernels' route above 256 disparities)."""


def on_cuda(*tensors) -> bool:
    """Whether the tensors of a public op lie on CUDA devices (then the op
    launches its kernel) or on the CPU (then it runs its plain body).
    Raises ``ValueError`` for tensors split between the two."""
    kinds = {t.is_cuda for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on {', '.join(str(t.device) for t in tensors)}: all on "
                         f"CUDA devices or all on the CPU")
    return kinds.pop()
