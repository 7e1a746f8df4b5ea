"""The sparse VoxelNet slice of futuredet_torch against the JAX package:
the middle encoder and the whole forecast_n3dtf detector with JAX-init
weights bridged, and the spconv weight bridge both ways.

The test config is the tiny forecast_n3dtf with a 64 x 64 x 41 grid
(0.5 m in xy, 0.15 m in z), so that the stage depths run 41 -> 21 -> 11 ->
5 as at full size and the z-mask takes the Z = 5, Dz = 2 branch; its
stage capacities hold every site, so the JAX forward drops none (the port
never drops). One JAX init and one apply serve the whole file."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.eval.decode import decode_and_nms as jax_decode_and_nms
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.detector import extract_dropped_sites
from futuredet_tpu.models.middle import \
    SparseMiddleEncoder as JaxSparseMiddleEncoder
from futuredet_tpu.utils.convert_checkpoint import \
    convert_reference_checkpoint
from futuredet_torch import config as port_config
from futuredet_torch.eval.decode import decode_and_nms
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.middle import SparseMiddleEncoder
from futuredet_torch.ops.voxelize import point_voxel_map, run_means
from futuredet_torch.utils.convert_checkpoint import (_compose_extra_conv,
                                                      flax_to_state_dict)
from tests.test_torch_pipeline import assert_detections_match

NAME = "forecast_n3dtf"
# 20 sparse convs, z_crush, RPN and 7 heads in fp32, summed in another
# order than XLA:CPU
ATOL = RTOL = 1e-4


def voxelnet_config(mod):
    cfg = mod.tiny_variant(mod.get_config(NAME))
    voxel = dataclasses.replace(
        cfg.voxel, pc_range=(-16.0, -16.0, -3.0, 16.0, 16.0, 3.0),
        voxel_size=(0.5, 0.5, 0.15), max_voxels_train=2048,
        max_voxels_eval=2048, max_points=2048)
    # stage capacities of at least the cells of each stage's grid
    # (2048 voxels; 21x32x32, 11x16x16, 5x8x8): nothing can be dropped
    model = dataclasses.replace(cfg.model,
                                middle_vmax=(2048, 21504, 2816, 320))
    test = dataclasses.replace(
        cfg.test, post_center_limit_range=(-20., -20., -10., 20., 20., 10.))
    return cfg.replace(voxel=voxel, model=model, test=test)


def scene(cfg, seed):
    """Half the points in 30 object-sized blobs, half spread out, all at
    x < 2 m: the BEV cells of x > 4 m stay empty."""
    rng = np.random.default_rng(seed)
    P = cfg.voxel.max_points
    pts = np.concatenate([rng.uniform(-16, 0, (P, 1)),
                          rng.uniform(-16, 16, (P, 1)),
                          rng.uniform(-3, 3, (P, 1)),
                          rng.uniform(0, 1, (P, 2))], -1)
    n = P // 2
    centres = np.concatenate([rng.uniform(-14, 0, (30, 1)),
                              rng.uniform(-14, 14, (30, 1)),
                              rng.uniform(-2, 1, (30, 1))], -1)
    pick = rng.integers(0, 30, n)
    pts[:n, :3] = centres[pick] + np.clip(rng.normal(0, 1, (n, 3)), -2, 2) \
        * [1.0, 0.6, 0.4]
    return pts[None].astype(np.float32), rng.random((1, P)) < 0.95


@pytest.fixture(scope="module")
def jax_run():
    """JAX-init variables of the test config, with random BN statistics in
    the middle encoder and z_crush and the heatmap bias raised so that
    many boxes per timestep pass the 0.1 threshold; and one apply of them,
    with the middle encoder's output captured."""
    cfg_j = voxelnet_config(jax_config)
    model = jax_build(cfg_j)
    pts, valid = scene(cfg_j, 0)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid)))
    variables = jax.tree.map(np.array, variables)
    rng = np.random.default_rng(1)
    for name in ("middle", "z_crush"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["batch_stats"][name]):
            leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape)
                         if path[-1].key == "var"
                         else rng.normal(0, 0.1, leaf.shape))
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["params"][name]):
            if path[-1].key in ("scale", "bias"):
                leaf += rng.normal(0, 0.1, leaf.shape).astype(leaf.dtype)
    for t in range(7):
        variables["params"]["head"][f"task{t}"]["hm_final"]["bias"][:] = 0.5
    pts, valid = scene(cfg_j, 2)
    preds, state = model.apply(
        variables, jnp.asarray(pts), jnp.asarray(valid),
        capture_intermediates=lambda m, _: isinstance(
            m, JaxSparseMiddleEncoder),
        mutable=["intermediates"])
    inter = state["intermediates"]
    middle = [np.asarray(a) for a in inter["middle"]["__call__"][0]]
    det = jax.device_get(jax_decode_and_nms(cfg_j, preds))
    return dict(cfg_j=cfg_j, variables=variables, pts=pts, valid=valid,
                preds=jax.device_get(preds), middle=middle, det=det,
                drops=extract_dropped_sites(inter))


def test_jax_reference_dropped_no_site(jax_run):
    np.testing.assert_array_equal(jax_run["drops"], [0, 0, 0])


def test_middle_encoder_matches_jax(jax_run):
    cfg = voxelnet_config(port_config)
    v = cfg.voxel
    gx, gy, gz = v.grid_size
    enc = SparseMiddleEncoder(cfg.model.num_input_features,
                              cfg.model.middle_channels,
                              (gz + 1, gy, gx)).eval()
    sd = flax_to_state_dict({k: {"middle": t["middle"]} for k, t in
                             jax_run["variables"].items()}, cfg)
    enc.load_state_dict({k.removeprefix("backbone."): t
                         for k, t in sd.items()}, strict=True)
    vm = point_voxel_map(torch.from_numpy(jax_run["pts"]),
                         torch.from_numpy(jax_run["valid"]), v.pc_range,
                         v.voxel_size, grid_size=v.grid_size,
                         max_voxels=v.max_voxels_eval,
                         max_points=v.max_points_per_voxel)
    with torch.no_grad():
        x, zmask = enc(run_means(vm), vm.coords, vm.batch, 1)
    jx, jzmask = jax_run["middle"]
    assert x.shape == (1, 8, 8, 5 * 32) and zmask.shape == (1, 8, 8, 2)
    assert enc.site_counts[0] == int(vm.num_voxels[0]) > 500
    np.testing.assert_allclose(x[0].numpy(), jx, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(zmask[0].numpy(), jzmask)
    assert 0 < zmask.sum() < zmask.numel()


def test_whole_voxelnet_matches_jax(jax_run):
    cfg = voxelnet_config(port_config)
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax_run["variables"], cfg),
                          strict=True)
    with torch.no_grad():
        preds = model(torch.from_numpy(jax_run["pts"]),
                      torch.from_numpy(jax_run["valid"]))
        det = decode_and_nms(cfg, preds)
    assert len(model.backbone.site_counts) == 4
    for t, (p, jp) in enumerate(zip(preds, jax_run["preds"])):
        for k in jp:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"task {t} {k}")
    jdet = jax_run["det"]
    keep = det.valid[0].numpy()
    jkeep = np.asarray(jdet.valid[0])
    per_t = keep.reshape(7, -1).sum(-1)
    assert (per_t >= 20).all(), per_t
    assert keep.sum() == jkeep.sum()
    assert_detections_match(
        det.boxes[0].numpy()[keep], det.scores[0].numpy()[keep],
        det.labels[0].numpy()[keep], np.asarray(jdet.boxes[0])[jkeep],
        np.asarray(jdet.scores[0])[jkeep], np.asarray(jdet.labels[0])[jkeep])


def test_spconv_layout_round_trip(jax_run):
    """The port's state dict stores sparse kernels as spconv's
    (kd, kh, kw, in, out); the JAX package's reference converter reads it
    back to the flax (27, in, out) leaves bit for bit. z_crush is the
    port's own (the reference has extra_conv there)."""
    variables, cfg_j = jax_run["variables"], jax_run["cfg_j"]
    cfg = voxelnet_config(port_config)
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sd["backbone.conv2.0.weight"].shape == (3, 3, 3, 8, 16)
    np.testing.assert_array_equal(
        sd["backbone.conv2.0.weight"].reshape(27, 8, 16),
        variables["params"]["middle"]["down1"]["kernel"])
    back = convert_reference_checkpoint(
        sd, cfg_j, jax.tree.map(np.zeros_like, variables))
    rep = back.pop("__convert_report__")
    assert not rep["missing_ref_keys"]
    assert sorted(rep["unused_ref_keys"]) == sorted(
        k for k in sd if k.startswith("z_crush.")
        and not k.endswith("num_batches_tracked"))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(variables):
        if path[1].key != "z_crush":
            np.testing.assert_array_equal(got[path], a, err_msg=str(path))


def test_extra_conv_fold_matches_jax(jax_run):
    """A reference-style state dict with `backbone.extra_conv.*` folds into
    the port's z_crush exactly as the JAX converter folds it into flax."""
    variables, cfg_j = jax_run["variables"], jax_run["cfg_j"]
    cfg = voxelnet_config(port_config)
    rng = np.random.default_rng(3)
    port_sd = flax_to_state_dict(variables, cfg)
    ref = {k: v.numpy() for k, v in port_sd.items()
           if not k.startswith("z_crush.")}
    C = cfg.model.middle_channels[-1]
    ref["backbone.extra_conv.0.weight"] = rng.normal(
        size=(3, 1, 1, C, C)).astype(np.float32)
    for name in ("weight", "bias", "running_mean"):
        ref[f"backbone.extra_conv.1.{name}"] = rng.normal(
            size=C).astype(np.float32)
    ref["backbone.extra_conv.1.running_var"] = rng.uniform(
        0.5, 1.5, C).astype(np.float32)
    back = convert_reference_checkpoint(
        ref, cfg_j, jax.tree.map(np.zeros_like, variables))
    assert back.pop("__convert_report__")["extra_conv_folded"]
    want = {k: v for k, v in flax_to_state_dict(back, cfg).items()
            if k.startswith("z_crush.")}
    got = _compose_extra_conv({k: torch.from_numpy(v) for k, v in ref.items()},
                              z_in=5 * C, z_out=cfg.model.rpn.in_channels)
    assert got is not None and set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert _compose_extra_conv({k: torch.from_numpy(v)
                                for k, v in ref.items()},
                               z_in=4 * C, z_out=64) is None
    model = build_detector(cfg, device="cpu")
    model.load_state_dict({**{k: torch.from_numpy(v) for k, v in ref.items()
                              if not k.startswith("backbone.extra_conv")},
                           **got}, strict=True)


def test_unported_voxelnet_options_raise():
    cfg = voxelnet_config(port_config)
    for change in (dict(middle="dense"), dict(middle_dense_from_stage=2),
                   dict(middle_gather_algo="window_bf16"),
                   dict(middle_sparse_dtype="bfloat16"),
                   dict(compute_dtype="bfloat16")):
        bad = cfg.replace(model=dataclasses.replace(cfg.model, **change))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_detector(bad, device="cpu")
    for algo in ("xpack", "loop", "stacked", "window", "hybrid"):
        build_detector(cfg.replace(model=dataclasses.replace(
            cfg.model, middle_gather_algo=algo, middle_map_format="bitmap",
            middle_xpack_max_cin=16)), device="cpu")
