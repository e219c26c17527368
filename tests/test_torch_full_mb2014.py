"""The port's FULL path (``__graft_entry__.entry()``'s configuration) above 256
disparities, on the CPU, against the benchmark's banded plain reference
(``cardbench/reference/ad_census_banded.py``), the reference that decides
the full-resolution Middlebury 2014 cell on the card.  The reference runs
in bands smaller than the image and than its halo of 34 rows."""

import dataclasses

import numpy as np
import pytest
import torch

from cardbench.reference import ad_census_banded
from stereo_match_traditional_tpu_torch import config as cfgs
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair


def _full(d):
    return cfgs.ADCensusConfig(disp_range=d, scanline=cfgs.ScanlineConfig(), run_post=True)


@pytest.mark.parametrize("h, w, d, seed, band_rows", [
    (24, 40, 300, 2**33 + 5, 5),
    (33, 45, 260, 7, 11),
    (40, 64, 290, 2**31 + 3, 16),
])
def test_full_above_256_disparities_is_the_banded_reference(h, w, d, seed, band_rows):
    left, right, _ = make_pair(h, w, d, seed=seed, feature_scale=max(4, 24 * d // 60))
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    cfg = _full(d)
    got = get_pipeline("ad_census")[0](lt, rt, cfg).disp_final
    want = ad_census_banded.disparity(lt, rt, dataclasses.asdict(cfg), d, band_rows=band_rows)
    assert torch.equal(got, want)


def test_served_full_maps_are_the_banded_reference_s():
    d = 270
    pairs = [make_pair(20, 36, d, seed=s, feature_scale=12)[:2] for s in (1, 2)]
    fields = dataclasses.asdict(_full(d))
    for (left, right), served in zip(pairs, serve_pairs("ad_census", pairs, _full(d),
                                                        device="cpu")):
        want = ad_census_banded.disparity(torch.from_numpy(left), torch.from_numpy(right),
                                          fields, d, band_rows=6)
        assert np.array_equal(served, want.numpy())
