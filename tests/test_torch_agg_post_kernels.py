"""NumPy models of the port's aggregation and post kernels
(``csrc/aggregate.cu``, ``csrc/post.cu``), held against the JAX package on
the CPU, and the device dispatch of the four public functions they serve.

The CUDA kernels run only on a card (``tests/test_torch_kernels_cuda.py``
holds them against their plain versions there).  Here each kernel's
algorithm is modelled in NumPy as the kernel computes it: the union-find
linking that ``remove_speckles_f32`` runs (links in an arbitrary order,
roots hooked under the smaller root, areas counted at the roots; here over
every pair of the map, where the kernel links inside tiles and then across
their borders: ``tests/test_torch_walker_tiles.py`` models that), the 8-ray
walk of ``fill_pass_f32``'s first design (the first finite value a ray, an
insertion sort, the rank pick, three passes), the arm walk of
``cross_arms_i32``'s first design (both kept as models of the functions;
``tests/test_torch_fill_arms_tiles.py`` models the kernels' present
indexing) and the row-then-column float64 table of ``rect_mean_f32``.  Every model
is held bit for bit against the JAX package's function (the rect mean
against the port's plain version: the JAX package sums in float32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.ops.kernels import aggregate_cuda, post_cuda
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict

INF = np.float32(np.inf)
# map shapes of the hypothesis tests: one row, one column, odd, square
SHAPES = [(1, 13), (11, 1), (7, 11), (16, 16)]


def _t(a):
    return torch.tensor(np.asarray(a))


def _map(seed, h, w, levels=6, holes=0.15, invalid=np.inf):
    """Integer disparities in [0, levels) in 3x3 patches with noise, and a
    share of ``invalid`` pixels: components of many sizes."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, levels, size=(h // 3 + 1, w // 3 + 1))
    d = np.kron(coarse, np.ones((3, 3)))[:h, :w]
    d = np.where(rng.random((h, w)) < 0.2, rng.integers(0, levels, size=(h, w)), d)
    return np.where(rng.random((h, w)) < holes, invalid, d).astype(np.float32)


def _serpentine(h=15, w=12):
    """One snake-shaped component whose labels wind through every row."""
    snake = np.zeros((h, w), np.float32)
    snake[0::2, :] = 5.0
    snake[1::4, -1] = 5.0
    snake[3::4, 0] = 5.0
    return snake


# ---------------------------------------------------------------------------
# remove_speckles_f32: union-find labelling
# ---------------------------------------------------------------------------


def _find_root(labels, x):
    """The kernel's walk to the root: labels only fall toward a root, and
    each visited pixel is pointed at its grandparent (path halving)."""
    curr = labels[x]
    if curr != x:
        prev = x
        while curr > labels[curr]:
            nxt = labels[curr]
            labels[prev] = nxt
            prev, curr = curr, nxt
    return curr


def _unite(labels, a, b):
    """The kernel's hook: roots linked under the smaller by an atomic
    minimum, retried from the value it returns."""
    while True:
        a, b = _find_root(labels, a), _find_root(labels, b)
        if a == b:
            return
        if a < b:
            old = labels[b]
            labels[b] = min(old, a)
            if old == b:
                return
            b = old
        else:
            old = labels[a]
            labels[a] = min(old, b)
            if old == a:
                return
            a = old


def speckle_model(disp, diff, min_area, invalid, background=None, connectivity=8,
                  order_seed=0):
    """``remove_speckles_f32`` in NumPy: link every connected pair, the
    pixels taken in a random order (the kernel's threads run in none), then
    count each root's area (and non-background members) and kill, each
    pixel walking to its root again."""
    d = np.asarray(disp, np.float32)
    h, w = d.shape
    valid = np.isfinite(d) & (d != np.float32(invalid))
    labels = list(range(h * w))
    dirs = [(0, -1), (-1, 0), (-1, 1), (-1, -1)][: 4 if connectivity == 8 else 2]
    for p in np.random.default_rng(order_seed).permutation(h * w):
        i, j = divmod(int(p), w)
        if not valid[i, j]:
            continue
        for di, dj in dirs:
            ii, jj = i + di, j + dj
            if ii < 0 or jj < 0 or jj >= w or not valid[ii, jj]:
                continue
            if np.abs(d[i, j] - d[ii, jj]) <= np.float32(diff):
                _unite(labels, int(p), ii * w + jj)
    area = np.zeros(h * w, np.int64)
    fg = np.zeros(h * w, np.int64)
    for p in range(h * w):
        i, j = divmod(p, w)
        if valid[i, j]:
            r = _find_root(labels, p)
            area[r] += 1
            if background is not None and d[i, j] != np.float32(background):
                fg[r] += 1
    out = d.copy()
    for p in range(h * w):
        i, j = divmod(p, w)
        if valid[i, j]:
            r = p
            while labels[r] != r:
                r = labels[r]
            if area[r] < min_area and (background is None or fg[r] > 0):
                out[i, j] = np.float32(invalid)
    return out


def _speckle_case(d, diff, area, invalid, background, connectivity, order_seed=0):
    want = np.asarray(jpost.remove_speckles(jnp.asarray(d), diff, area, invalid_value=invalid,
                                            background=background,
                                            connectivity=connectivity))
    got = speckle_model(d, diff, area, invalid, background, connectivity, order_seed)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("invalid,background", [(np.inf, None), (0.0, None), (np.inf, 0.0)],
                         ids=["inf", "zero", "background"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speckle_model_matches_jax(connectivity, invalid, background, seed):
    d = _map(seed, 24, 32, invalid=invalid)
    got = _speckle_case(d, 1.0, 9, invalid, background, connectivity, order_seed=seed)
    assert (got != d).any() or background is not None


@pytest.mark.parametrize("connectivity", [4, 8])
def test_speckle_model_serpentine(connectivity):
    snake = _serpentine()
    got = _speckle_case(snake, 0.0, 60, 0.0, None, connectivity, order_seed=3)
    np.testing.assert_array_equal(got, snake)


def test_speckle_model_background_only_component_survives():
    """A component of background pixels alone is never seeded, so it
    survives however small; one with a foreground member is removed."""
    d = np.full((6, 9), np.inf, np.float32)
    d[1, 1:3] = 0.0                     # background only: survives
    d[4, 5:7] = [0.0, 1.0]              # one foreground member: removed
    got = _speckle_case(d, 1.0, 5, np.inf, 0.0, 8)
    assert (got[1, 1:3] == 0.0).all() and np.isinf(got[4, 5:7]).all()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.sampled_from(SHAPES),
       connectivity=st.sampled_from([4, 8]), area=st.integers(1, 12),
       diff=st.sampled_from([0.0, 1.0, 2.5]), background=st.sampled_from([None, 0.0, 2.0]))
def test_speckle_model_hypothesis(seed, shape, connectivity, area, diff, background):
    d = _map(seed, *shape, holes=0.2)
    _speckle_case(d, diff, area, np.inf, background, connectivity, order_seed=seed)


# ---------------------------------------------------------------------------
# fill_pass_f32: the first design's 8-ray walk and rank select
# ---------------------------------------------------------------------------

RAYS = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1)]


def _fill_pass_model(src, mask, raw, invalid, need_nonfinite, second, caps, finalize):
    """One launch of ``fill_pass_f32``'s first design in NumPy: the rays
    walked pixel by pixel."""
    h, w = src.shape

    def value(i, j):
        v = src[i, j]
        return INF if raw and v == np.float32(invalid) else v

    out = np.empty_like(src)
    for i in range(h):
        for j in range(w):
            v = value(i, j)
            target = (mask is None or mask[i, j]) and (not need_nonfinite or not np.isfinite(v))
            res = v
            if target:
                cand = []
                for r, (di, dj) in enumerate(RAYS):
                    ii, jj = i, j
                    for _ in range(caps[0] if r < 4 else caps[1]):
                        ii, jj = ii + di, jj + dj
                        if not (0 <= ii < h and 0 <= jj < w):
                            break
                        u = value(ii, jj)
                        if np.isfinite(u):
                            m = len(cand)           # insertion into the sorted list
                            cand.append(u)
                            while m > 0 and cand[m - 1] > u:
                                cand[m] = cand[m - 1]
                                m -= 1
                            cand[m] = u
                            break
                if cand:
                    k = len(cand)
                    res = cand[(1 if k > 1 else 0) if second else k // 2]
            if finalize and not np.isfinite(res):
                res = np.float32(invalid)
            out[i, j] = res
    return out


def fill_model(disp, occlusion, mismatch, invalid=np.inf, max_search=None):
    """``fill_holes_8dir_cuda`` in NumPy: three passes, the caps as the
    wrapper computes them."""
    d = np.asarray(disp, np.float32)
    h, w = d.shape
    if max_search is None:
        caps = (max(h, w), max(h, w))
    else:
        axis = max(max_search - 1, 0)
        caps = (axis, int(round(axis * 0.70710678)))
    d = _fill_pass_model(d, occlusion, True, invalid, True, True, caps, False)
    d = _fill_pass_model(d, mismatch, False, invalid, True, False, caps, False)
    return _fill_pass_model(d, None, False, invalid, True, False, caps, True)


def _holes(seed, h, w, share=0.35, invalid=np.inf):
    d = _map(seed, h, w, levels=10, holes=share, invalid=invalid)
    if h > 4:
        d[4, :] = invalid                # a row with no axis candidate
    rng = np.random.default_rng(seed + 1)
    bad = ~np.isfinite(d) | (d == np.float32(invalid))
    occl = bad & (rng.random(d.shape) < 0.5)
    mism = bad & ~occl & (rng.random(d.shape) < 0.7)
    return d, occl, mism


def _fill_case(d, occl, mism, invalid, max_search):
    want = np.asarray(jpost.fill_holes_8dir(jnp.asarray(d), jnp.asarray(occl),
                                            jnp.asarray(mism), invalid, max_search))
    got = fill_model(d, occl, mism, invalid, max_search)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("max_search", [None, 1, 4, 10])
@pytest.mark.parametrize("invalid", [np.inf, -1.0], ids=["inf", "minus_one"])
@pytest.mark.parametrize("seed", [18, 19])
def test_fill_model_matches_jax(max_search, invalid, seed):
    d, occl, mism = _holes(seed, 24, 32, invalid=invalid)
    got = _fill_case(d, occl, mism, invalid, max_search)
    if max_search != 1:
        assert (got != d).sum() > 0


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.sampled_from(SHAPES),
       share=st.sampled_from([0.1, 0.5, 0.9]), max_search=st.sampled_from([None, 2, 6]))
def test_fill_model_hypothesis(seed, shape, share, max_search):
    _fill_case(*_holes(seed, *shape, share=share), np.inf, max_search)


# ---------------------------------------------------------------------------
# cross_arms_i32 and rect_mean_f32
# ---------------------------------------------------------------------------


def arms_model(img, arm_cfg, row_offset=0, global_rows=None):
    """``cross_arms_i32``'s first design in NumPy: each pixel walks each
    arm to the first failed step; band rows clamped into the band, the
    rules on global rows."""
    x = np.asarray(img).astype(np.float32)
    if x.ndim == 2:
        x = x[..., None]
    h, w = x.shape[:2]
    global_rows = h if global_rows is None else global_rows
    out = np.zeros((4, h, w), np.int32)
    tao1, tao2 = np.float32(arm_cfg.tao1), np.float32(arm_cfg.tao2)
    for i in range(h):
        for j in range(w):
            for k, (vertical, sign) in enumerate([(False, -1), (False, 1), (True, -1),
                                                  (True, 1)]):
                pos = i + row_offset if vertical else j
                gsize = global_rows if vertical else w
                leading, fail1 = 0, False
                for o in range(1, arm_cfg.max_length + 1):
                    t = pos + sign * o
                    inb = 0 <= t <= gsize - 1
                    if vertical:
                        q = x[min(max(i + sign * o, 0), h - 1), j]
                    else:
                        q = x[i, min(max(j + sign * o, 0), w - 1)]
                    diff = np.max(np.abs(q - x[i, j]))
                    tao = tao1 if o <= arm_cfg.sec_length else tao2
                    if o == 1:
                        fail1 = inb and diff > tao
                    if not (inb and diff <= tao):
                        break
                    leading += 1
                border_ok = pos >= 2 if sign < 0 else pos <= gsize - 3
                out[k, i, j] = 1 if leading == 0 and fail1 and border_ok else leading
    return out


@pytest.mark.parametrize("colour", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("band", [None, (-3, 20), (5, 14)], ids=["whole", "top", "middle"])
def test_arms_model_matches_jax(colour, dtype, band):
    rng = np.random.default_rng(5)
    shape = (10, 23, 3) if colour else (10, 23)
    img = rng.integers(0, 60, size=shape).astype(dtype)
    arm_cfg = cfgs.CrossArmConfig(tao1=20, tao2=6, max_length=9, sec_length=4)
    ro, rows = band if band else (0, None)
    want = jagg.cross_arms(jnp.asarray(img), arm_cfg, ro, rows)
    got = arms_model(img, arm_cfg, ro, rows)
    for k, name in enumerate(("left", "right", "up", "down")):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, name)), err_msg=name)


def rect_model(vol, arms, inclusive=True):
    """``rect_mean_f32`` in NumPy: a float64 table summed along the rows,
    then down the columns, the four corners in the plain version's order,
    one rounding, the float32 division."""
    x = np.asarray(vol, np.float32)
    n, h, w = x.shape
    sat = np.zeros((n, h + 1, w + 1))
    sat[:, 1:, 1:] = np.cumsum(np.cumsum(x.astype(np.float64), axis=2), axis=1)
    up, down, left, right = (np.asarray(a, np.int64) for a in (arms.up, arms.down, arms.left,
                                                              arms.right))
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    e = 0 if inclusive else 1
    count = ((up + down + 1) * (left + right + 1) if inclusive
             else (up + down) * (left + right))
    i0, i1 = np.clip(ii - up, 0, h - 1), np.clip(ii + down - e, 0, h - 1)
    j0, j1 = np.clip(jj - left, 0, w - 1), np.clip(jj + right - e, 0, w - 1)
    total = (((sat[:, i1 + 1, j1 + 1] - sat[:, i0, j1 + 1]) - sat[:, i1 + 1, j0])
             + sat[:, i0, j0]).astype(np.float32)
    mean = total / np.maximum(count, 1).astype(np.float32)
    return np.where(count > 0, mean, x)


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("shape", [(5, 1, 17), (5, 13, 1), (7, 19, 23)])
def test_rect_model_matches_plain(inclusive, shape):
    """On AD-Census-like costs (0, or >= 1 - exp(-1/30), multiples of
    2^-28) every float64 sum is exact, so the kernel's table is the plain
    version's bit for bit whatever the order of its sums."""
    n, h, w = shape
    rng = np.random.default_rng(9)
    vol = np.where(rng.random(shape) < 0.2, 0.0,
                   np.round((0.0328 + 1.9 * rng.random(shape)) * 2**28) / 2**28)
    vol = vol.astype(np.float32)
    img = rng.integers(0, 255, size=(h, w)).astype(np.uint8)
    arms = tagg._cross_arms_plain(_t(img), config_from_dict(
        "CrossArmConfig", dataclasses.asdict(cfgs.CrossArmConfig(tao1=60, max_length=6))))
    want = tagg._rect_mean_aggregate_plain(_t(vol), arms, inclusive).numpy()
    np.testing.assert_array_equal(rect_model(vol, arms, inclusive), want)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain bodies and launch nothing
# ---------------------------------------------------------------------------


def _all_launches():
    return {**aggregate_cuda.LAUNCHES, **post_cuda.LAUNCHES}


def _counting(monkeypatch, module, name):
    calls = []
    plain = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return plain(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_public_functions_take_plain_bodies_on_cpu(monkeypatch):
    calls = []
    for module, name in ((tagg, "_cross_arms_plain"), (tagg, "_rect_mean_aggregate_plain"),
                         (tpost, "_remove_speckles_plain"), (tpost, "_fill_holes_8dir_plain"),
                         (tpost, "_fill_from_candidates_plain")):
        calls.append(_counting(monkeypatch, module, name))
    before = _all_launches()
    rng = np.random.default_rng(2)
    img = _t(rng.integers(0, 255, size=(9, 14)).astype(np.uint8))
    arm_cfg = config_from_dict("CrossArmConfig", dataclasses.asdict(cfgs.CrossArmConfig()))
    arms = tagg.cross_arms(img, arm_cfg)
    tagg.rect_mean_aggregate(_t(rng.random((3, 9, 14)).astype(np.float32)), arms)
    d, occl, mism = _holes(4, 9, 14)
    tpost.remove_speckles(_t(d), 1.0, 4)
    tpost.fill_holes_8dir(_t(d), _t(occl), _t(mism), max_search=5)
    assert [len(c) for c in calls] == [1, 1, 1, 1, 3]
    assert _all_launches() == before


def test_wrappers_take_plain_versions_on_cpu():
    """The public functions, given CPU tensors (a colour image, a row band,
    the exclusive rectangle, the SAD speckle background), return their
    plain bodies' results and launch nothing."""
    before = _all_launches()
    rng = np.random.default_rng(3)
    img = _t(rng.integers(0, 255, size=(8, 11, 3)).astype(np.uint8))
    arm_cfg = config_from_dict("CrossArmConfig", dataclasses.asdict(cfgs.CrossArmConfig()))
    arms = tagg.cross_arms(img, arm_cfg, 2, 12)
    for a, b in zip(arms, tagg._cross_arms_plain(img, arm_cfg, 2, 12)):
        assert torch.equal(a, b)
    vol = _t(rng.random((4, 8, 11)).astype(np.float32))
    assert torch.equal(tagg.rect_mean_aggregate(vol, arms, False),
                       tagg._rect_mean_aggregate_plain(vol, arms, False))
    d, occl, mism = _holes(6, 8, 11)
    assert torch.equal(tpost.fill_holes_8dir(_t(d), _t(occl), _t(mism)),
                       tpost._fill_holes_8dir_plain(_t(d), _t(occl), _t(mism)))
    assert torch.equal(tpost.remove_speckles(_t(d), 1.0, 5, background=0.0),
                       tpost._remove_speckles_plain(_t(d), 1.0, 5, float("inf"), 0.0, None, 8))
    assert _all_launches() == before


def test_small_max_iters_keeps_cpu_meaning():
    """On the CPU an explicit ``max_iters`` still stops the sweeps: one
    sweep leaves the serpentine in pieces, which die, where the fixpoint
    keeps it whole (on the card such a cap raises)."""
    snake = _t(_serpentine())
    once = tpost.remove_speckles(snake, 0.0, 60, invalid_value=0.0, max_iters=1,
                                 connectivity=4)
    whole = tpost.remove_speckles(snake, 0.0, 60, invalid_value=0.0, connectivity=4)
    assert torch.equal(whole, snake)
    assert (once == 0).sum() > (snake == 0).sum()
    assert post_cuda.speckle_iteration_cap(15, 12) == 32 + 8 * 8


def test_speckle_dispatch_checks_before_device():
    """``block=0`` and an unknown connectivity raise on either device,
    before the dispatch."""
    x = _t(_map(1, 5, 6))
    with pytest.raises(ValueError, match="block"):
        tpost.remove_speckles(x, block=0)
    with pytest.raises(ValueError, match="connectivity"):
        tpost.remove_speckles(x, connectivity=6)
