"""Spatial sharding at (2, 2): four gloo ranks, two data indices of two
space ranks each, one B = 2 step of tiny pp_forecast_n3dtf (one sample a
data index) against the JAX GSPMD step over `make_mesh_2d(2, 2)`, by the
rules of tests/test_torch_spatial.py. It checks the data x space layout
(rank r is data index r // 2, space index r % 2), the data shards, and
the reductions over both groups: the pillar reader's statistics pooled
over the data group (the GSPMD step's global batch), the banded
BatchNorms' sums over the space group then means over the data group,
and the gradients summed over space and averaged over data."""
import pytest

from tests.test_torch_spatial import (check_spatial_step,  # noqa: F401
                                      pillar_inputs, spatial_case)


@pytest.fixture(scope="module")
def run_2x2(pillar_inputs, tmp_path_factory):  # noqa: F811
    cfg_j, cfg, batch, variables = pillar_inputs
    return spatial_case(cfg_j, cfg, batch, variables, 2, 2,
                        tmp_path_factory.mktemp("spatial_2x2"))


def test_four_ranks_take_the_jax_gspmd_step_at_2x2(run_2x2):
    check_spatial_step(run_2x2)
