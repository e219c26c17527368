"""Port parity: cost-volume ops and WTA of ``stereo_match_traditional_tpu_torch``
against the JAX package on the same seeded NumPy inputs (JAX on the CPU
backend, the Pallas kernel in interpret mode)."""

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.ops import wta as jwta
from stereo_match_traditional_tpu.ops.kernels import asw_volume_pallas
from stereo_match_traditional_tpu.utils.synthetic import make_pair
from stereo_match_traditional_tpu_torch.ops import volume as tvol
from stereo_match_traditional_tpu_torch.ops import wta as twta
from stereo_match_traditional_tpu_torch.ops.kernels import asw_cuda
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("pad_r,pad_c", [(2, None), (3, 1), (7, 9)])
def test_replicate_pad_bit_exact(pad_r, pad_c):
    x = np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32)
    want = np.asarray(jvol.replicate_pad(x, pad_r, pad_c))
    np.testing.assert_array_equal(tvol.replicate_pad(_t(x), pad_r, pad_c).numpy(), want)


@pytest.mark.parametrize("view,d_offset", [("left", 0), ("right", 0), ("left", 3)])
def test_shifted_stack_bit_exact(view, d_offset):
    x = np.random.default_rng(1).standard_normal((6, 11)).astype(np.float32)
    want = np.asarray(jvol.shifted_stack(x, 7, view, d_offset))
    got = tvol.shifted_stack(_t(x), 7, view, d_offset).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("shape", [(6, 5, 9), (12, 4, 7), (1, 3, 4)])
def test_border_fill_bit_exact(view, shape):
    """Includes D > W (the whole row is border) and D = 1 (no-op)."""
    vol = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jvol.border_fill(vol, view))
    np.testing.assert_array_equal(tvol.border_fill(_t(vol), view).numpy(), want)


@pytest.mark.parametrize("shape", [(6, 5, 9), (10, 3, 6)])
def test_right_volume_from_left_bit_exact(shape):
    vol = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jvol.right_volume_from_left(vol))
    np.testing.assert_array_equal(tvol.right_volume_from_left(_t(vol)).numpy(), want)


# (h, w, D, win_size, seed, view): the geometries of tests/test_kernels.py
# plus the reference's win_size 11 on a small image.
_ASW_CASES = [
    (14, 18, 5, 2, 2, "left"),
    (12, 20, 4, 1, 5, "right"),
    (20, 30, 6, 11, 1, "left"),
]


@pytest.mark.parametrize("h,w,d,win,seed,view", _ASW_CASES)
def test_asw_volume_matches_jax_scan(h, w, d, win, seed, view):
    """Same math in the same order as the jnp lax.scan; only exp's last-ulp
    rounding differs between the two backends: rtol 1e-5, atol 1e-4."""
    L, R, _ = make_pair(h, w, d, seed=seed)
    want = np.asarray(jvol.asw_volume(L, R, d, win_size=win, view=view))
    lt, rt = pair_to_torch(L, R, "cpu")
    got = tvol.asw_volume(lt, rt, d, win_size=win, view=view).numpy()
    assert got.shape == (d, h, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("h,w,d,win,seed,view", _ASW_CASES[:2])
def test_asw_volume_matches_jax_pallas_interpret(h, w, d, win, seed, view):
    """Against the Pallas kernel itself (interpret mode), which fuses the
    weights into one exp: the tolerance tests/test_kernels.py uses."""
    L, R, _ = make_pair(h, w, d, seed=seed)
    want = np.asarray(
        asw_volume_pallas(L, R, d, win, 50.0, 30.0, 40.0, view, interpret=True)
    )
    lt, rt = pair_to_torch(L, R, "cpu")
    got = tvol.asw_volume(lt, rt, d, win_size=win, view=view).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("view", ["left", "right"])
def test_asw_volume_cuda_takes_plain_version_on_cpu(view):
    """``asw_volume`` on CPU tensors runs its plain body and launches
    nothing."""
    L, R, _ = make_pair(14, 18, 5, seed=2)
    lt, rt = pair_to_torch(L, R, "cpu")
    before = asw_cuda.LAUNCHES
    got = tvol.asw_volume(lt, rt, 5, 2, view=view)
    assert asw_cuda.LAUNCHES == before
    want = tvol._asw_volume_plain(lt, rt, 5, 2, view=view)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_wta_bit_exact_with_forced_ties(mode):
    """Quantized costs force ties; both keep the lowest d."""
    rng = np.random.default_rng(4)
    vol = rng.integers(0, 3, size=(9, 7, 8)).astype(np.float32)
    vol[:, 0, :] = 1.0                      # a whole row of all-equal costs
    want = np.asarray(jwta.wta(vol, mode))
    got = twta.wta(_t(vol), mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0] == 0).all()
