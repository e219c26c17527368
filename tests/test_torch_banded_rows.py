"""Both horizontal passes of a band of rows (``ops.scanline.
horizontal_passes_banded`` and ``canonical_horizontal_passes_banded``, whose
kernels are ``ops.kernels.scanline_banded_cuda``'s band entries): against
the composition the streamed executor ran before them (two banded passes
along the columns from a zero carry, their penalties from the band's grey
rows), against the JAX package's streamed horizontal step, and through the
public functions' CPU path.  Inputs are seeded NumPy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu.ops import scanline as jscan
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu_torch.ops import scanline as tscan
from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
from stereo_match_traditional_tpu_torch.ops.volume import shifted_stack
from stereo_match_traditional_tpu_torch.parallel.halo import crop_row_halo
from stereo_match_traditional_tpu_torch.parallel.streamed import _band_rows

P1, P2_INIT = 0.5, 4.0          # legacy: p1, p2_init
CP1, CP2, TSO = 1.0, 3.0, 15.0  # canonical: p1, p2, tso
HALO = 3

# (t, D, W): a band of several rows, W = 1, W % 4 == 0, W % 4 != 0 with
# D > W (the match columns clamp), one row, and D = 300 (above the band
# entries' 256: on the card the wide route)
BANDS = [(6, 5, 13), (4, 3, 1), (5, 7, 12), (3, 9, 6), (1, 4, 10), (3, 300, 7)]


def _band(seed, t, d, w, cropped):
    """A [D, t, W] band of costs: contiguous, or the halo-cropped view of a
    [D, t + 2 HALO, W] volume that the streamed executor hands on."""
    rng = np.random.default_rng(seed)
    rows = t + 2 * HALO if cropped else t
    vol = torch.from_numpy((rng.random((d, rows, w)) * 4).astype(np.float32))
    band = crop_row_halo(vol, HALO, 1) if cropped else vol
    assert band.is_contiguous() != cropped
    return band


def _image(seed, h, w, u8):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return torch.from_numpy(img if u8 else img.astype(np.float32))


def _zero(d, m):
    return torch.zeros((d, m)), torch.zeros((m,))


def _legacy_composition(agg, g):
    """The streamed executor's legacy horizontal step before the band entry:
    two banded passes along the columns, P2 of the neighbouring column."""
    d, t, _ = agg.shape
    p2_t = torch.tensor(P2_INIT, dtype=torch.float32)

    def p2_of(g, g_ref):
        return torch.clamp(torch.div(p2_t, torch.abs(g - g_ref) + 1.0), min=P1)

    ch = agg.permute(2, 0, 1)
    z = _zero(d, t)
    prev_col = torch.cat([g[:, :1], g[:, :-1]], 1)
    next_col = torch.cat([g[:, 1:], g[:, -1:]], 1)
    lr, _ = tscan.directional_pass_banded(ch, p2_of(g, prev_col).T, z, None, P1, True)
    rl, _ = tscan.directional_pass_banded(ch, p2_of(g, next_col).T, z, None, P1, True,
                                          reverse=True)
    return lr.permute(1, 2, 0), rl.permute(1, 2, 0)


def _canonical_composition(agg, left, right, b0, v):
    """The streamed executor's canonical horizontal step before the band
    entry: the scales between columns from the band's grey rows (taken with
    a one-row halo, as it took them), then two banded passes."""
    d, t, _ = agg.shape
    h = left.shape[0]
    base, match = (left, right) if v == 0 else (right, left)
    g = _band_rows(base.to(torch.float32), b0 - 1, b0 + t + 1, h)
    g2 = shifted_stack(_band_rows(match.to(torch.float32), b0 - 1, b0 + t + 1, h), d,
                       ("left", "right")[v]).permute(1, 0, 2)
    gh = g[1:t + 1].T
    g2h = g2[1:t + 1].permute(2, 1, 0)
    gh = torch.cat([gh[:1], gh, gh[-1:]])
    g2h = torch.cat([g2h[:1], g2h, g2h[-1:]])
    horiz = tscan.canonical_scale(gh[1:], gh[:-1], g2h[1:], g2h[:-1], TSO)
    ch = agg.permute(2, 0, 1)
    z = _zero(d, t)
    lr, _ = tscan.canonical_pass_banded(ch, horiz[:-1], z, None, CP1, CP2)
    rl, _ = tscan.canonical_pass_banded(ch, horiz[1:], z, None, CP1, CP2, reverse=True)
    return lr.permute(1, 2, 0), rl.permute(1, 2, 0)


def _assert_pair_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("cropped", [False, True], ids=["contiguous", "halo_cropped"])
@pytest.mark.parametrize("t,d,w", BANDS)
def test_legacy_plain_equals_the_composition(t, d, w, cropped):
    """lr and rl bit for bit with the two banded passes the executor ran."""
    agg = _band(t + d + w, t, d, w, cropped)
    g = _image(w, t, w, False)
    _assert_pair_equal(tscan.horizontal_passes_banded(agg, g, P1, P2_INIT),
                       _legacy_composition(agg, g))


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "float32"])
@pytest.mark.parametrize("view", [0, 1], ids=["left", "right"])
@pytest.mark.parametrize("cropped", [False, True], ids=["contiguous", "halo_cropped"])
@pytest.mark.parametrize("t,d,w", BANDS)
def test_canonical_plain_equals_the_composition(t, d, w, cropped, view, u8):
    """Both views, u8 and float32 grey images, a band placed inside an image
    of more rows: lr and rl bit for bit with the scales and two banded
    passes the executor ran."""
    h, b0 = t + 4, 2
    agg = _band(t + d + w + view, t, d, w, cropped)
    left, right = _image(1, h, w, u8), _image(2, h, w, u8)
    rows = [_band_rows(x, b0, b0 + t, h) for x in (left, right)]
    got = tscan.canonical_horizontal_passes_banded(agg, rows[view], rows[1 - view], CP1, CP2,
                                                   TSO, view == 1)
    _assert_pair_equal(got, _canonical_composition(agg, left, right, b0, view))


@pytest.mark.parametrize("t,d,w", BANDS)
def test_legacy_plain_equals_jax_streamed_step(t, d, w):
    """The JAX package's streamed horizontal step, ``_directional_pass`` on
    the transposed band and on its reverse: bit for bit, as
    ``tests/test_torch_banded.py`` holds the legacy band pass."""
    agg = _band(t * d * w, t, d, w, False)
    g = _image(t, t, w, False)
    lr, rl = tscan.horizontal_passes_banded(agg, g, P1, P2_INIT)
    c_wdt = jnp.asarray(agg.permute(2, 0, 1).numpy())
    g_wt = jnp.asarray(g.T.numpy())
    jlr, _ = jscan._directional_pass(c_wdt, g_wt, P1, P2_INIT, True)
    jrl, _ = jscan._directional_pass(c_wdt[::-1], g_wt[::-1], P1, P2_INIT, True)
    np.testing.assert_array_equal(lr.numpy(), np.transpose(np.asarray(jlr), (1, 2, 0)))
    np.testing.assert_array_equal(rl.numpy(), np.transpose(np.asarray(jrl)[::-1], (1, 2, 0)))


@pytest.mark.parametrize("view", [0, 1], ids=["left", "right"])
@pytest.mark.parametrize("t,d,w", BANDS)
def test_canonical_plain_equals_jax_streamed_step(t, d, w, view):
    """JAX's ``canonical_pass_banded`` with its ``canonical_scale`` along the
    columns of the band from a zero carry: bit for bit with its op-by-op run
    (``jax.disable_jit()``), within rtol 1e-5 of its compiled scan, the
    envelope ``tests/test_torch_banded.py`` holds the canonical band pass
    to (ROADMAP.md Queue 3)."""
    agg = _band(t * d * w + view, t, d, w, False)
    base, match = _image(3, t, w, True), _image(4, t, w, True)
    lr, rl = tscan.canonical_horizontal_passes_banded(agg, base, match, CP1, CP2, TSO,
                                                      view == 1)
    g = jnp.asarray(base.numpy().astype(np.float32).T)                       # [W, t]
    g2 = jnp.transpose(jvol.shifted_stack(jnp.asarray(match.numpy().astype(np.float32)), d,
                                          ("left", "right")[view]), (2, 0, 1))  # [W, D, t]
    g = jnp.concatenate([g[:1], g, g[-1:]])
    g2 = jnp.concatenate([g2[:1], g2, g2[-1:]])
    scale = jscan.canonical_scale(g[1:], g[:-1], g2[1:], g2[:-1], TSO)
    c_wdt = jnp.asarray(agg.permute(2, 0, 1).numpy())
    zero = (jnp.zeros((d, t), jnp.float32), jnp.zeros((t,), jnp.float32))

    def both(unroll):
        jlr, _ = jscan.canonical_pass_banded(c_wdt, scale[:-1], zero, None, CP1, CP2, unroll)
        jrl, _ = jscan.canonical_pass_banded(c_wdt[::-1], scale[1:][::-1], zero, None, CP1, CP2,
                                             unroll)
        return (np.transpose(np.asarray(jlr), (1, 2, 0)),
                np.transpose(np.asarray(jrl)[::-1], (1, 2, 0)))

    # op by op a scan of no unrolled group (W < 4) cannot run; any unroll
    # gives the same values
    with jax.disable_jit():
        eager = both(1)
    compiled = both(4)
    for got, e, c in zip((lr, rl), eager, compiled):
        np.testing.assert_array_equal(got.numpy(), e)
        np.testing.assert_allclose(got.numpy(), c, rtol=1e-5, atol=0)


@pytest.mark.parametrize("cropped", [False, True], ids=["contiguous", "halo_cropped"])
def test_wrappers_on_cpu_run_the_plain_versions(cropped):
    """On CPU tensors each public band function returns its plain body's lr
    and rl and launches nothing."""
    t, d, w = BANDS[0]
    agg = _band(7, t, d, w, cropped)
    g = _image(8, t, w, True)
    m = _image(9, t, w, True)
    before = dict(banded.LAUNCHES)
    _assert_pair_equal(tscan.horizontal_passes_banded(agg, g.float(), P1, P2_INIT),
                       tscan._horizontal_passes_banded_plain(agg, g.float(), P1, P2_INIT))
    for view in (False, True):
        _assert_pair_equal(
            tscan.canonical_horizontal_passes_banded(agg, g, m, CP1, CP2, TSO, view),
            tscan._canonical_horizontal_passes_banded_plain(agg, g, m, CP1, CP2, TSO, view))
    assert banded.LAUNCHES == before


def test_zero_band_columns_seed_both_paths():
    """Each row is a whole path: the first column of lr and the last of rl
    are the cost itself, in both families."""
    agg = _band(11, 4, 6, 9, True)
    g = _image(12, 4, 9, True)
    lr, rl = tscan.horizontal_passes_banded(agg, g.float(), P1, P2_INIT)
    clr, crl = tscan.canonical_horizontal_passes_banded(agg, g, g.flip(1), CP1, CP2, TSO, False)
    for a, b in ((lr, rl), (clr, crl)):
        assert torch.equal(a[:, :, 0], agg[:, :, 0]) and torch.equal(b[:, :, -1], agg[:, :, -1])
