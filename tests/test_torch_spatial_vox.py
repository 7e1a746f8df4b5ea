"""Spatial sharding of the small VoxelNet (tests/test_torch_dp_vox.py's
zero-drop config) over two gloo ranks at (1, 2) against the JAX GSPMD
step, by the rules of tests/test_torch_spatial.py: one B = 2 step from the
same weights, each rank holding a band of the middle's 8 output rows (4 /
4; z_crush, its re-mask, the RPN and the head on the band).

The voxelizer and the sparse middle run whole on both ranks (the prefix),
so their parameters' gradients are each rank's band's share, summed over
the space group with the rest; the middle's per-sample statistics are
those of the whole scene on both ranks. Both sides run
`middle_gather_algo="stacked"`; the JAX forward drops no site."""
import pytest

from futuredet_tpu import config as jax_config
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from tests.test_torch_dp_vox import _stacked
from tests.test_torch_spatial import check_spatial_step, spatial_case
from tests.test_torch_train_step import jax_variables
from tests.test_torch_voxelnet import voxelnet_config


@pytest.fixture(scope="module")
def vox_run(tmp_path_factory):
    cfg_j = _stacked(voxelnet_config(jax_config))
    cfg = _stacked(voxelnet_config(port_config))
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    variables = jax_variables(jax_build(cfg_j), batch["points"].numpy()[:1],
                              batch["points_valid"].numpy()[:1])
    return spatial_case(cfg_j, cfg, batch, variables, 1, 2,
                        tmp_path_factory.mktemp("spatial_vox"))


def test_two_space_ranks_take_the_jax_voxelnet_gspmd_step(vox_run):
    check_spatial_step(vox_run)


def test_the_prefix_gradients_are_band_shares(vox_run):
    """Each rank's own sparse-middle gradient is its band's share: the two
    ranks' differ, and their sum is what the step holds on both."""
    import torch
    ranks = vox_run["ranks"]
    mid = [n for n in ranks[0]["own_grads"] if n.startswith("backbone.")]
    assert len(mid) >= 20
    differ = 0
    for n in mid:
        a, b = ranks[0]["own_grads"][n], ranks[1]["own_grads"][n]
        differ += not torch.allclose(a, b, rtol=0.1, atol=0)
        torch.testing.assert_close(a + b, ranks[0]["grads"][n], rtol=1e-5,
                                   atol=1e-7)
    assert differ >= len(mid) // 2
