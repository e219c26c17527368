"""stereo_match_traditional_tpu_torch — the PyTorch/CUDA port of
``stereo_match_traditional_tpu``.

The port runs on torch tensors and never imports jax.  It stands beside the
JAX package, which stays the reference it is tested against on the CPU.
Everything of the JAX package is ported but ``parallel.gspmd_pipeline`` (a
sharded-input XLA program with no torch counterpart): all five pipelines
through ``models.get_pipeline`` (``asw``, ``ad_census`` in its reference
and canonical families, ``sad``, ``ncc``, ``cblsm``) with their dormant
variants; stage re-entry (``return_stages``, ``utils.checkpoint``,
``models.registry.finish_from_volumes``); ``utils.io``; batching and
serving (``models.batch.serve_pairs`` over ``utils.native.PairLoader``, the
C++ decode pool of ``native/stereo_host``); the command line ``cli``
(``stereo-torch``); and the executors of ``parallel``: streamed row bands
on one card, tiles over a mesh of cards, the sharded scanline, WTA and
post, and the ``(tile, disp)`` runners.  The benchmark that measures the
port on the card is ``cardbench/``.

The port imports nothing of the JAX package.  ``config``, ``utils.io``
and ``utils.synthetic`` are its own copies of the JAX package's modules of the
same names (same classes, fields, defaults and bytes), and
``utils.convert.config_from_dict`` carries a JAX-package config across as
plain data.

Layers, each calling only the one below it: ``models`` and ``parallel``
call the public functions of ``ops``; those call the launchers of
``ops.kernels``; the launchers call the C entries of the hand-written CUDA
kernels (``ops/kernels/csrc``).

Device rule: every op takes the device of its input tensors.  A public
function of ``ops`` that has a kernel decides once, by ``ops.on_cuda``:
for CUDA tensors it calls its kernel's launcher, for CPU tensors it runs
its plain PyTorch body (``_<name>_plain`` beside it), and for tensors split
between the two it raises ``ValueError``.  A launcher takes CUDA tensors
only and raises ``ValueError`` for a CPU tensor: no plain body runs for a
CUDA tensor unless a caller names it (``ASWConfig.use_pallas=False``).
"""

__version__ = "0.1.0"

from stereo_match_traditional_tpu_torch.config import (  # noqa: F401
    ADCensusConfig,
    ASWConfig,
    CBLSMConfig,
    NCCConfig,
    SADConfig,
    ScanlineConfig,
)
