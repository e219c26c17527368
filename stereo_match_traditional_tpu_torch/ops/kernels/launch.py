"""What every kernel launcher does around a launch: the check that its
tensors lie on one CUDA device, the images as the kernels read them, the
current device and its stream, the error check, and the canonical kernels'
edge-bit scratch."""

from __future__ import annotations

import contextlib

import torch


def require_cuda(**tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the named tensors lie on one CUDA device:
    a launcher takes no CPU tensor."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{', '.join(f'{k} on {t.device}' for k, t in tensors.items())}: the "
                         f"kernel takes CUDA tensors on one device")


def kernel_inputs(left: torch.Tensor, right: torch.Tensor):
    """The images as the kernels read them, contiguous: both uint8 as they
    are, anything else as float32; and the entries' ``u8`` flag."""
    u8 = left.dtype == right.dtype == torch.uint8
    if not u8:
        left, right = left.to(torch.float32), right.to(torch.float32)
    return left.contiguous(), right.contiguous(), int(u8)


def current(device: torch.device):
    """A context in which ``device`` is the current CUDA device; it costs
    nothing where it already is (entering ``torch.cuda.device`` costs ~10 us
    of host time a call)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a C entry.
    ``torch.cuda.current_stream(device).cuda_stream`` gives the same handle
    for ~7 us of host time a call; this lookup (the one torch's own
    generated kernels use) takes ~0.4 us."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on_error(lib, name: str, err: int) -> None:
    """Raise if the C entry point ``name`` reported a CUDA error."""
    if err != 0:
        msg = lib.stereo_kernels_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def edge_bit_words(h: int, w: int) -> int:
    """32-bit words of the canonical kernels' four edge-bit planes
    (``[4, H, RW]``, ``RW = (W + 640 + 31) // 32``;
    ``csrc/scanline_canonical.cu``'s header describes them)."""
    return 4 * h * ((w + 640 + 31) // 32)
