"""The banded kernels' raw launch stood in for by the plain passes, so that
the routes built on it (``ops.kernels.scanline_banded_cuda``'s composed
whole-image routes and its passes along a band's rows) run on CPU tensors
in tests.  The launchers take CUDA tensors only; a test patches
``scanline_banded_cuda._launch`` with :func:`plain_launch`."""

from stereo_match_traditional_tpu_torch.ops import scanline


def plain_launch(canonical, cost, pen, carry, reset, p1, p2, dm1, reverse, store, entry=None):
    """``scanline_banded_cuda._launch``'s arguments and result, computed by
    the public pass of the family, which runs its plain body for CPU
    tensors."""
    if canonical:
        return scanline.canonical_pass_banded(cost, pen, carry, reset, p1, p2, reverse=reverse,
                                              store=store)
    return scanline.directional_pass_banded(cost, pen, carry, reset, p1, dm1, reverse=reverse,
                                            store=store)
