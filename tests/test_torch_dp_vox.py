"""Data-parallel training of the small VoxelNet over `torch.distributed`
against the JAX `shard_map` step, by the rules of tests/test_torch_dp.py:
two gloo ranks, one sample each, one train step from the same weights.

The sparse middle's MaskedBatchNorms take each sample's statistics; the
JAX encoder runs under `nn.vmap` and averages them over ("batch",
"data"), the port over the ranks (`parallel/collectives.py::pmean`) with
their cross-rank gradient. The two samples hold different numbers of
voxels, so statistics pooled over the batch would not pass. Both sides
run `middle_gather_algo="stacked"` (the JAX package's `xpack` numbers in
half its compile time); the JAX forward drops no site."""
import dataclasses

import pytest

from futuredet_tpu import config as jax_config
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from tests.test_torch_dp import WORLD, check_dp_step, dp_case
from tests.test_torch_voxelnet import voxelnet_config

STACKED = dict(middle_gather_algo="stacked")


def _stacked(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, **STACKED))


@pytest.fixture(scope="module")
def vox_run(tmp_path_factory):
    cfg_j = _stacked(voxelnet_config(jax_config))
    cfg = _stacked(voxelnet_config(port_config))
    batch = make_batch(cfg, WORLD, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    return dp_case(cfg_j, cfg, batch, tmp_path_factory.mktemp("dp_vox"))


def test_two_gloo_ranks_take_the_jax_voxelnet_shard_map_step(vox_run):
    check_dp_step(vox_run)


def test_the_middle_statistics_are_per_sample_means(vox_run):
    """The samples differ in voxels, and the middle's running statistics
    moved: the per-sample averaging is what was compared."""
    from futuredet_torch.models.detector import build_detector
    case = vox_run["case"]
    model = build_detector(case["cfg"], device="cpu").train()
    model.voxelize(case["batch"]["points"], case["batch"]["points_valid"])
    v0, v1 = model.num_voxels
    assert v0 != v1
    sd = case["state_dict"]
    stats = vox_run["ranks"][0]["stats"]
    moved = [n for n in stats if n.startswith("backbone.")
             and not bool((stats[n] == sd[n]).all())]
    assert len(moved) >= 20
