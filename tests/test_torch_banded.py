"""The banded scanline passes (``ops.scanline.directional_pass_banded`` and
``canonical_pass_banded``, whose kernels are ``ops.kernels.
scanline_banded_cuda``) against the JAX package's, and chained over bands
against the port's whole-path passes; the public passes' CPU path (reverse,
reset forms, carry only).  Inputs are seeded NumPy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu.ops import scanline as jscan
from stereo_match_traditional_tpu_torch.ops import scanline as tscan
from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

T, D, M = 13, 9, 33


def _inputs(seed, t=T, d=D, m=M):
    """Costs, legacy penalties, canonical scales and a non-zero carry."""
    rng = np.random.default_rng(seed)
    cost = (rng.random((t, d, m)) * 4).astype(np.float32)
    p2 = (rng.random((t, m)) * 3 + 0.5).astype(np.float32)
    scale = rng.choice(np.array([1.0, 0.25, 0.1], np.float32), size=(t, d, m))
    prev = (rng.random((d, m)) * 5).astype(np.float32)
    return cost, p2, scale, (prev, prev.min(0))


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.mark.parametrize("reset_at", [None, 7])
@pytest.mark.parametrize("dm1", [True, False])
def test_directional_banded_bit_exact_with_jax(dm1, reset_at):
    """A non-zero carry, with and without a reset mid-band, both l2 forms:
    the aggregated band and the outgoing carry bit for bit."""
    cost, p2, _, (prev, pm) = _inputs(1)
    reset = None
    if reset_at is not None:
        reset = np.zeros(T, bool)
        reset[reset_at] = True
    want, (wp, wm) = jscan.directional_pass_banded(
        jnp.asarray(cost), jnp.asarray(p2), (jnp.asarray(prev), jnp.asarray(pm)),
        None if reset is None else jnp.asarray(reset), 0.5, dm1)
    got, (gp, gm) = tscan.directional_pass_banded(
        *_t(cost, p2), _t(prev, pm), None if reset is None else torch.from_numpy(reset), 0.5, dm1)
    for g, w in ((got, want), (gp, wp), (gm, wm)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("reset_at", [None, 4])
def test_canonical_banded_matches_jax(reset_at):
    """The canonical band pass and its carry bit for bit with JAX's run op by
    op (``jax.disable_jit()``).  JAX's compiled scan rounds a few values an
    ulp apart from that same recurrence (ROADMAP.md Queue 3), and the
    difference grows along the path: up to 16 ulp (~1e-6 relative) on 8
    steps from a random carry, so it is held to rtol 1e-5."""
    cost, _, scale, (prev, pm) = _inputs(2, t=8)
    reset = None
    if reset_at is not None:
        reset = np.zeros(8, bool)
        reset[reset_at] = True
    args = (jnp.asarray(cost), jnp.asarray(scale), (jnp.asarray(prev), jnp.asarray(pm)),
            None if reset is None else jnp.asarray(reset), 1.0, 3.0)
    got, (gp, gm) = tscan.canonical_pass_banded(
        *_t(cost, scale), _t(prev, pm), None if reset is None else torch.from_numpy(reset),
        1.0, 3.0)
    with jax.disable_jit():
        eager, (ep, em) = jscan.canonical_pass_banded(*args)
    for g, w in ((got, eager), (gp, ep), (gm, em)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want, (wp, _) = jscan.canonical_pass_banded(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5, atol=0)


def _zero(d, m):
    return torch.zeros((d, m)), torch.zeros((m,))


@pytest.mark.parametrize("dm1,p2_ref", [(True, "prev"), (False, "first")])
@pytest.mark.parametrize("reverse", [False, True])
def test_chained_bands_equal_the_whole_pass(reverse, dm1, p2_ref):
    """A vertical pass over [D, H, W] as bands of 6 rows chained by their
    carries (the first from a zero carry) equals the port's whole-path pass
    bit for bit, downwards and upwards (a reversed band order), with the
    reference's vertical quirks too."""
    rng = np.random.default_rng(3)
    h, w, d, bt = 20, 17, 7, 6
    cost = torch.from_numpy((rng.random((d, h, w)) * 4).astype(np.float32))
    gray = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.float32))
    p1, p2_init = 0.5, 4.0
    want = tscan._directional_pass(cost, gray, 0, reverse, p1, p2_init, dm1, p2_ref)
    # the penalty each row's step consumes, from its path neighbour
    if p2_ref == "first":
        ref = gray[-1 if reverse else 0].expand(h, w)
    else:
        ref = torch.cat([gray[1:], gray[-1:]]) if reverse else torch.cat([gray[:1], gray[:-1]])
    p2 = torch.clamp(torch.div(torch.tensor(p2_init), torch.abs(gray - ref) + 1.0), min=p1)
    starts = list(range(0, h, bt))
    carry = _zero(d, w)
    got = torch.empty_like(cost)
    for b0 in (reversed(starts) if reverse else starts):
        band = cost[:, b0:b0 + bt].permute(1, 0, 2)
        out, carry = tscan.directional_pass_banded(band, p2[b0:b0 + bt], carry, None, p1, dm1,
                                                   reverse=reverse)
        got[:, b0:b0 + bt] = out.permute(1, 0, 2)
    assert torch.equal(got, want)


def test_chained_canonical_bands_equal_the_whole_pass():
    """The canonical pass over a path of 23 steps as bands of 5, 5, 5, 8 equals
    the port's whole-path ``_canonical_pass`` bit for bit."""
    rng = np.random.default_rng(4)
    n, d, m = 23, 6, 11
    cost = torch.from_numpy((rng.random((n, d, m)) * 4).astype(np.float32))
    g1 = torch.from_numpy(rng.integers(0, 256, (n, m)).astype(np.float32))
    g2 = torch.from_numpy(rng.integers(0, 256, (n, d, m)).astype(np.float32))
    want = tscan._canonical_pass(cost, g1, g2, 1.0, 3.0, 15.0)
    scale = tscan.canonical_scale(g1, torch.cat([g1[:1], g1[:-1]]),
                                  g2, torch.cat([g2[:1], g2[:-1]]), 15.0)
    carry = _zero(d, m)
    pieces = []
    for b0, b1 in ((0, 5), (5, 10), (10, 15), (15, 23)):
        out, carry = tscan.canonical_pass_banded(cost[b0:b1], scale[b0:b1], carry, None, 1.0, 3.0)
        pieces.append(out)
    assert torch.equal(torch.cat(pieces), want)


@pytest.mark.parametrize("family", ["legacy", "canonical"])
def test_wrapper_reverse_reset_and_carry_only_on_cpu(family):
    """On CPU tensors the public pass runs its plain body: ``reverse`` is
    the pass over the flipped band, flipped back; a reset given as a step
    index equals the bool mask; ``store=False`` returns the same carry and
    no volume; a strided view gives the same as a contiguous copy."""
    cost, p2, scale, carry = _inputs(5)
    cost, p2, scale = _t(cost, p2, scale)
    carry = _t(*carry)
    pen = p2 if family == "legacy" else scale
    if family == "legacy":
        def call(*a, **k):
            return tscan.directional_pass_banded(*a, 0.5, True, **k)

        def plain(c, p, cr, rs):
            return tscan._directional_pass_banded_plain(c, p, cr, rs, 0.5, True)
    else:
        def call(*a, **k):
            return tscan.canonical_pass_banded(*a, 1.0, 3.0, **k)

        def plain(c, p, cr, rs):
            return tscan._canonical_pass_banded_plain(c, p, cr, rs, 1.0, 3.0)
    mask = torch.zeros(T, dtype=torch.bool)
    mask[9] = True
    out, (cp, cm) = call(cost, pen, carry, 9, reverse=True)
    want, (wp, wm) = plain(cost.flip(0), pen.flip(0), carry, mask.flip(0))
    assert torch.equal(out, want.flip(0)) and torch.equal(cp, wp) and torch.equal(cm, wm)
    none, (np_, nm) = call(cost, pen, carry, mask, reverse=True, store=False)
    assert none is None and torch.equal(np_, wp) and torch.equal(nm, wm)
    strided = cost.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    again, _ = call(strided, pen, carry, 9, reverse=True)
    assert torch.equal(again, out)


def test_zero_carry_is_the_path_seed():
    """A zero carry gives the first step's cost bit for bit, in both
    families (the value the whole pass gives its path's first pixel)."""
    cost, p2, scale, _ = _inputs(6)
    cost, p2, scale = _t(cost, p2, scale)
    zero = _zero(D, M)
    legacy, _ = tscan.directional_pass_banded(cost, p2, zero, None, 0.5)
    canon, _ = tscan.canonical_pass_banded(cost, scale, zero, None, 1.0, 3.0)
    assert torch.equal(legacy[0], cost[0]) and torch.equal(canon[0], cost[0])


def test_wrapper_rejects_more_than_one_reset_on_the_card_path():
    mask = torch.zeros(T, dtype=torch.bool)
    mask[[2, 5]] = True
    with pytest.raises(ValueError, match="once"):
        banded._reset_index(mask, T)
    assert banded._reset_index(None, T) == -1 and banded._reset_index(T, T) == -1
