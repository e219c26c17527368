"""Hand-written CUDA kernels (sources in ``csrc/``, built by ``build``) and
their launchers, one module a family.  A launcher takes CUDA tensors only
and knows nothing above it: the public functions of ``ops.volume``,
``ops.scanline``, ``ops.aggregate`` and ``ops.post`` call the launchers for
CUDA tensors and run their plain bodies for CPU tensors."""
