"""The plain reference against the measured package's CPU path, and the
control: the reference with its volumes in bfloat16 has to fail each
cell's limit."""

import numpy as np
import pytest
import torch

from cardbench import check, control, manifest
from cardbench.run import program_config
from cardbench.synthetic import make_pair
from stereo_match_traditional_tpu_torch.models import get_pipeline

BENCH = manifest.load()
# every configuration file, also one that no cell uses yet
CONFIGS = sorted(p.stem for p in (manifest.HERE / "configs").glob("*.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("h, w, d, seed", [(24, 40, 8, 3), (37, 61, 13, 2**35 + 1)])
def test_the_reference_is_the_cpu_path(name, h, w, d, seed):
    conf = manifest.config(name)
    left, right, _ = make_pair(h, w, d, seed)
    fn = get_pipeline(conf["pipeline"])[0]
    want = fn(torch.from_numpy(left), torch.from_numpy(right), program_config(conf, d)).disp_final
    got = check.reference_maps([(left, right)], [0], conf, d, "cpu")[0]
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_limit(cell):
    traf = manifest.traffic(manifest.workload(BENCH, cell)["traffic"])
    small = dict(traf, height=48, width=96, disp_range=16, feature_scale=6, distinct_pairs=4,
                 sample_maps=2)
    limit = manifest.limits(cell)["pixels_off"]["limit"]
    for seed in (1, 2, 3):
        assert control.control_reading(cell, seed, "cpu", small)["value"] > limit


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    traf = manifest.traffic(manifest.workload(BENCH, cell)["traffic"])
    small = dict(traf, height=120, width=256, disp_range=32, feature_scale=12, distinct_pairs=4,
                 sample_maps=2)
    limit = manifest.limits(cell)["pixels_off"]["limit"]
    assert control.control_reading(cell, 5, "cuda", small)["value"] > limit
    conf = manifest.config(manifest.workload(BENCH, cell)["config"])
    left, right, _ = make_pair(120, 256, 32, 5, 12)
    fn = get_pipeline(conf["pipeline"])[0]
    served = fn(*(torch.from_numpy(a).cuda() for a in (left, right)),
                program_config(conf, 32)).disp_final
    ref = check.reference_maps([(left, right)], [0], conf, 32, "cuda")[0]
    assert check.pixels_off(served.cpu().numpy(), ref) <= limit
    assert np.isfinite(ref).any()
