"""The full-resolution Middlebury 2014 cell: its banded plain reference against
the dense one (bands smaller than the image and than the halo, so halos
cross band edges), its three readers on synthetic summaries, and its files
found by name and run on the CPU at a small size."""

import numpy as np
import pytest
import torch

from cardbench import manifest, run
from cardbench.reference import ad_census, ad_census_banded, aggregate, scanline
from cardbench.reference.volume import ad_census_volume
from cardbench.synthetic import make_pair

CELL = "ad_census_full_mb2014.mb2014_adirondack_f_b1"
BENCH = manifest.load()
FIELDS = manifest.config("ad_census_full_mb2014")["fields"]


def _pair(h, w, d, seed):
    left, right, _ = make_pair(h, w, d, seed, max(4, 24 * d // 60))
    return torch.from_numpy(left), torch.from_numpy(right)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, w, d, seed, band_rows", [
    (40, 64, 300, 2**33 + 1, 7),      # D above W, bands of 7 rows under a halo of 34
    (37, 50, 20, 5, 5),
    (37, 50, 20, 5, 37),              # one band
    (60, 70, 24, 2**31 + 9, 16),
])
def test_the_banded_reference_is_the_dense_one(h, w, d, seed, band_rows, dtype):
    left, right = _pair(h, w, d, seed)
    want = ad_census.disparity(left, right, FIELDS, d, dtype)
    got = ad_census_banded.disparity(left, right, FIELDS, d, dtype, band_rows=band_rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("band_rows", [1, 6, 40])
def test_banded_rect_means_are_the_dense_ones_bit_for_bit(view, band_rows):
    h, w, d = 41, 33, 12
    left, right = _pair(h, w, d, 17)
    img = left if view == "left" else right
    vol = ad_census_volume(left, right, d, FIELDS["sigma_c"], FIELDS["sigma_s"],
                           FIELDS["census_rows"], FIELDS["census_cols"], view)
    want = aggregate.rect_mean(vol, aggregate.cross_arms(img, FIELDS["arms"]))
    bands = list(ad_census_banded._aggregated_bands(left, right, FIELDS, d, view, band_rows,
                                                    torch.float32))
    assert [r0 for r0, _, _ in bands] == list(range(0, h, band_rows))
    assert torch.equal(torch.cat([m for _, _, m in bands], 1), want)


@pytest.mark.parametrize("sc", [FIELDS["scanline"],
                                dict(FIELDS["scanline"], faithful_vertical_l2=True,
                                     faithful_vertical_p2=True)])
def test_the_scanline_minimum_is_the_dense_scanline_s(sc):
    gen = torch.Generator().manual_seed(3)
    cost = torch.rand((9, 13, 11), generator=gen) * 4
    grey = torch.randint(0, 256, (13, 11), generator=gen, dtype=torch.uint8)
    want = torch.argmin(scanline.scanline_optimize(cost, grey, sc), dim=0).to(torch.float32)
    assert torch.equal(ad_census_banded._scanline_wta(cost, grey, sc), want)


def test_the_banded_reference_takes_one_rect_mean_pass_only():
    left, right = _pair(16, 20, 4, 1)
    for fields in (dict(FIELDS, agg_iters=2), dict(FIELDS, aggregation="cross_two_pass")):
        with pytest.raises(ValueError):
            ad_census_banded.disparity(left, right, fields, 4)


def _summary(stages_s, pairs=4):
    return {"trace": {"pairs_traced": pairs, "stage_device_s": stages_s, "window_s": 1.0,
                      "busy_s": 0.9, "device_ops": 40},
            "stage_bound_s": {"rect_mean": 2e-3, "scanline": 1e-3, "post": 1e-4}}


def test_the_three_readers():
    s = _summary({"rect_mean": 0.04, "scanline": 0.02, "post": 0.006, "aggregate": 0.05})
    assert manifest.reader("rect_mean_roofline_pct")(s) == pytest.approx(20.0)
    assert manifest.reader("wide_scanline_roofline_pct")(s) == pytest.approx(20.0)
    assert manifest.reader("full_post_device_ms")(s) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["rect_mean_roofline_pct", "wide_scanline_roofline_pct",
                                  "full_post_device_ms"])
def test_the_readers_find_nothing_without_their_range(name):
    """A program without the range (the parent of the change that added
    ``stereo/rect_mean``), a stage without a bound, or no trace at all."""
    assert manifest.reader(name)(_summary({"aggregate": 0.05, "wta": 0.001})) is None
    assert manifest.reader(name)({}) is None
    no_bound = _summary({"rect_mean": 0.04, "scanline": 0.02, "post": 0.006})
    no_bound["stage_bound_s"] = {}
    if name.endswith("_pct"):
        assert manifest.reader(name)(no_bound) is None


def test_the_cell_s_pieces_load_and_its_metrics_are_its_own():
    cell = manifest.workload(BENCH, CELL)
    conf = manifest.config(cell["config"])
    traf = manifest.traffic(cell["traffic"])
    assert conf["reference"] == "ad_census_banded" and conf["reduced"] == []
    assert conf["fields"] == manifest.config("ad_census_full")["fields"]
    assert set(conf["work"]) == {"cost_volume", "aggregate", "rect_mean", "scanline"}
    assert (traf["height"], traf["width"], traf["disp_range"]) == (1988, 2880, 290)
    assert traf["feature_scale"] == 24 * traf["disp_range"] // 60
    limit = manifest.limits(CELL)["pixels_off"]
    assert limit["lower"] < limit["limit"] < limit["upper"]
    layer = {m["name"] for m in manifest.metrics_of(BENCH, "per_layer", CELL)}
    assert layer == {"rect_mean_roofline_pct", "wide_scanline_roofline_pct",
                     "full_post_device_ms"}
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, "end_to_end", CELL)}
    assert e2e == {"pairs_per_s", "setup_s"}


def test_the_cell_runs_on_the_cpu_at_a_small_size():
    traf = dict(manifest.traffic("mb2014_adirondack_f_b1"), height=30, width=44, disp_range=12,
                feature_scale=4, warmup_seconds=0, distinct_pairs=3)
    out = run.run_cell(CELL, 2**34 + 7, 0.3, False, "cpu", traffic=traf)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["compared"]["pixels_off"] == {"value": 0.0, "limit": manifest.limits(CELL)[
        "pixels_off"]["limit"], "maps": out["compared"]["pixels_off"]["maps"]}
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert np.isfinite(out["metrics"]["pairs_per_s"]["value"])
