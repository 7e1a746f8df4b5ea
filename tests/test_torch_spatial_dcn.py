"""Spatial sharding (`--space`) with `dcn_head`: the deformable convs of
each DCNSepHead read the head's input gathered whole
(`parallel/collectives.py::gather_rows_summed`) and compute their band's
output rows, by the rules of tests/test_torch_spatial.py.

  * the gather alone, at 2 and 3 gloo ranks: a deformable conv
    (`ops/deform.py::deform_conv2d` with the band's first row) of the
    gathered input, offsets that reach across the bands and out of the
    canvas, against the whole conv in float64, forward and backward (the
    input's cotangent summed over the space group, then each band's own
    rows), and the gather's calls and bytes in `HALO_STATS`;
  * tiny forecast_n0 with `dcn_head=True` on the small VoxelNet of
    tests/test_torch_spatial_vox.py, its offset convs set to seeded random
    weights (the zero init makes the deformable conv a plain 3x3 and would
    hide a wrong gather): some samples land more than a band's height
    from their output row, some outside the canvas; one B = 2 step at
    (1, 2) against the JAX GSPMD step (losses, grad_norm, every gradient,
    the running statistics, on every rank, the ranks equal), and the eval
    forward against `make_eval_forward(cfg, make_mesh_2d(1, 2))`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.parallel.mesh import make_mesh_2d
from futuredet_tpu.train.step import make_eval_forward
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_dp_vox import _stacked
from tests.test_torch_spatial import (EVAL_ATOL, EVAL_RTOL,
                                      check_spatial_step, jax_batch,
                                      run_layout, run_ranks, spatial_case)
from tests.test_torch_train_step import jax_variables
from tests.test_torch_train_modes import mode_config

OFFSET_STD = 0.5        # tests/test_torch_head_modes.py's offset weights

# the gather alone: a deformable conv of the gathered input on each band
# against the whole conv, forward and backward, in float64
DEFORM_WORKER = r"""
import sys
import torch
rank, world, port, out_path = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
from futuredet_torch.ops.deform import deform_conv2d
from futuredet_torch.parallel import collectives as C
from futuredet_torch.parallel.mesh import make_space_group

C.initialize_multihost(f"127.0.0.1:{port}", world, rank, torch.device("cpu"))
space = make_space_group(world)
g = torch.Generator().manual_seed(0)
B, Cin, H, W, G = 2, 8, 20, 7, 4
x = torch.randn(B, Cin, H, W, generator=g, dtype=torch.float64)
off = 6 * torch.randn(B, G * 18, H, W, generator=g, dtype=torch.float64)
w = torch.randn(5, Cin, 3, 3, generator=g, dtype=torch.float64)
whole_x, whole_off = x.clone().requires_grad_(), off.clone().requires_grad_()
y = deform_conv2d(whole_x, whole_off, w, G)
dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
y.backward(dy)
bands = space.bands(10, 2)              # 10 coarse rows of 2 fine ones
a, b = bands[space.index]
band = x[:, :, a:b].clone().requires_grad_()
band_off = off[:, :, a:b].clone().requires_grad_()
C.reset_halo_stats()
yb = deform_conv2d(C.gather_rows_summed(band, 2, bands, space), band_off, w,
                   G, row0=a)
yb.backward(dy[:, :, a:b])
rows = torch.arange(a, b, dtype=torch.float64).view(1, 1, -1, 1)
dys = off.view(B, G, 9, 2, H, W)[:, :, :, 0, a:b]
ky = (torch.arange(9) // 3 - 1).view(1, 1, 9, 1, 1).to(torch.float64)
reach = rows.unsqueeze(2) + ky + dys
torch.save({"band": (a, b),
            "y_err": float((yb - y[:, :, a:b]).abs().max()),
            "dx_err": float((band.grad - whole_x.grad[:, :, a:b]).abs().max()),
            "doff_err": float((band_off.grad - whole_off.grad[:, :, a:b])
                              .abs().max()),
            "beyond_band": bool(((reach < a - (b - a))
                                 | (reach >= b + (b - a))).any()),
            "outside": bool(((reach < 0) | (reach > H - 1)).any()),
            "stats": dict(C.HALO_STATS)}, out_path)
C.leave(f"127.0.0.1:{port}")
"""


@pytest.mark.parametrize("world", [2, 3])
def test_the_summed_gather_feeds_a_banded_deformable_conv(world, tmp_path):
    """Each band's deformable conv of the gathered input equals the whole
    conv's rows, and its input and offset gradients the whole conv's
    (float64: the same sums); the gather counts its all-gather and its
    backward's all-reduce."""
    ranks = run_ranks(tmp_path, DEFORM_WORKER,
                      lambda r, port: (str(r), str(world), port), world)
    assert [r["band"] for r in ranks] == {
        2: [(0, 10), (10, 20)], 3: [(0, 8), (8, 16), (16, 20)]}[world]
    widest = 10 if world == 2 else 8
    for r in ranks:
        assert r["y_err"] < 1e-12, r
        assert r["dx_err"] < 1e-12, r
        assert r["doff_err"] < 1e-12, r
        assert r["beyond_band"] and r["outside"], r
        assert r["stats"]["exchanges"] == 0
        assert r["stats"]["gathers"] == 2
        # its padded band out, the whole cotangent in the all-reduce
        assert r["stats"]["gather_bytes"] == 8 * 2 * 8 * 7 * (widest + 20)


def dcn_config(mod):
    """The small VoxelNet (zero drops, `stacked`) with forecast_n0's head
    under dcn_head."""
    cfg = _stacked(mode_config(mod, "forecast_n0"))
    return cfg.replace(model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, dcn_head=True)))


@pytest.fixture(scope="module")
def dcn_inputs():
    cfg_j, cfg = dcn_config(jax_config), dcn_config(port_config)
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    variables = jax_variables(jax_build(cfg_j), batch["points"].numpy()[:1],
                              batch["points_valid"].numpy()[:1])
    rng = np.random.default_rng(7)

    def offsets(path, a):
        if "conv_offset" in jax.tree_util.keystr(path) and a.ndim == 4:
            return rng.normal(0, OFFSET_STD, a.shape).astype(np.float32)
        return a
    variables = jax.tree_util.tree_map_with_path(offsets, variables)
    return cfg_j, cfg, batch, variables


def test_the_offsets_cross_bands_and_leave_the_canvas(dcn_inputs):
    """The offsets of every DCN (the unsharded eval forward): some taps
    sample more than a band's height (half the head's rows at (1, 2))
    from their output row, some outside the canvas."""
    _, cfg, batch, variables = dcn_inputs
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    seen = []
    for t in model.bbox_head.tasks:
        for fa in (t.feature_adapt_cls, t.feature_adapt_reg):
            fa.conv_offset.register_forward_hook(
                lambda m, i, o: seen.append(o))
    with torch.no_grad():
        model(batch["points"], batch["points_valid"])
    assert len(seen) == 2 * len(model.bbox_head.tasks)
    for off in seen:
        B, _, H, W = off.shape
        dy = off.view(B, 4, 9, 2, H, W)[:, :, :, 0]
        ky = (torch.arange(9) // 3 - 1).view(1, 1, 9, 1, 1)
        rows = torch.arange(H).view(1, 1, 1, H, 1)
        reach = rows + ky + dy
        assert bool(((reach - rows).abs() > H // 2).any())
        assert bool(((reach < 0) | (reach > H - 1)).any())


def test_two_space_ranks_take_the_jax_gspmd_dcn_step(dcn_inputs,
                                                     tmp_path_factory):
    cfg_j, cfg, batch, variables = dcn_inputs
    run = spatial_case(cfg_j, cfg, batch, variables, 1, 2,
                       tmp_path_factory.mktemp("spatial_dcn"))
    check_spatial_step(run)
    for r in run["ranks"]:
        # one gather a DCNSepHead forward, one all-reduce in its backward
        assert r["halo"]["gathers"] == 2 * len(cfg.model.head.num_classes)
        assert r["halo"]["gather_bytes"] > 0


def test_the_space_dcn_eval_forward_matches_make_eval_forward(dcn_inputs,
                                                              tmp_path):
    cfg_j, cfg, batch, variables = dcn_inputs
    jb = jax_batch(batch)
    want = jax.device_get(make_eval_forward(cfg_j, make_mesh_2d(1, 2))(
        variables["params"], variables["batch_stats"],
        {"points": jb["points"], "points_valid": jb["points_valid"]}))
    case = {"cfg": cfg, "state_dict": flax_to_state_dict(variables, cfg),
            "batch": {k: v for k, v in batch.items() if k != "gt"},
            "mode": "eval"}
    ranks = run_layout(tmp_path, case, 1, 2)
    for r in ranks:
        assert len(r["maps"]) == len(want)
        for got_t, want_t in zip(r["maps"], want):
            assert set(got_t) == set(want_t)
            for k, v in got_t.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(want_t[k]),
                                           rtol=EVAL_RTOL, atol=EVAL_ATOL,
                                           err_msg=k)
    for a, b in zip(ranks[0]["maps"], ranks[1]["maps"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
