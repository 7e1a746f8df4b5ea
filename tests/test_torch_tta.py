"""The port's double-flip TTA against the JAX package's: the point flip,
the box and map unflips exactly, and both formulations end to end at a
tiny pillar and a tiny VoxelNet size with the same weights (carried by
flax_to_state_dict): every flip's heatmaps within 1e-4 and the detections
matched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.eval import tta as jax_tta
from futuredet_tpu.eval.decode import Detections as JaxDetections
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_torch import config as port_config
from futuredet_torch.eval import tta
from futuredet_torch.eval.decode import Detections
from futuredet_torch.models.detector import build_detector
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_pipeline import assert_detections_match, tiny_scene
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_torch_voxelnet import scene as voxel_scene
from tests.test_torch_voxelnet import voxelnet_config

# the whole conv stack in fp32, summed in another order than XLA:CPU
HM_ATOL = 1e-4
T = 7


def random_maps(rng, B=2, H=12, W=10):
    return {"hm": rng.normal(0, 2, (B, H, W, 1)),
            "reg": rng.uniform(0, 1, (B, H, W, 2)),
            "height": rng.normal(0, 1, (B, H, W, 1)),
            "dim": rng.normal(0, 0.5, (B, H, W, 3)),
            "rot": rng.normal(0, 1, (B, H, W, 2)),
            "vel": rng.normal(0, 3, (B, H, W, 2)),
            "rvel": rng.normal(0, 3, (B, H, W, 4)),
            "feats": rng.normal(0, 1, (B, H, W, 8))}


@pytest.mark.parametrize("flip", tta.FLIPS)
def test_unflip_pred_maps_matches_jax_exactly(flip):
    maps = {k: v.astype(np.float32)
            for k, v in random_maps(np.random.default_rng(0)).items()}
    got = tta.unflip_pred_maps({k: torch.from_numpy(v)
                                for k, v in maps.items()}, *flip)
    want = jax_tta.unflip_pred_maps({k: jnp.asarray(v)
                                     for k, v in maps.items()}, *flip)
    assert set(got) == set(want) == set(maps) - {"feats"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("flip", tta.FLIPS)
def test_point_flip_and_box_unflip_match_jax_exactly(flip):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 20, (2, 50, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tta._flip_points(torch.from_numpy(pts), *flip).numpy(),
        np.asarray(jax_tta._flip_points(jnp.asarray(pts), *flip)))
    arrays = (rng.normal(0, 10, (2, 30, 9)).astype(np.float32),
              rng.random((2, 30)).astype(np.float32),
              rng.integers(0, 7, (2, 30)).astype(np.int32),
              rng.random((2, 30)) < 0.8)
    got = tta._unflip_boxes(Detections(*map(torch.from_numpy, arrays)),
                            *flip)
    want = jax_tta._unflip_boxes(JaxDetections(*map(jnp.asarray, arrays)),
                                 *flip)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the flip is its own inverse on boxes
    back = tta._unflip_boxes(got, *flip).boxes.numpy()
    np.testing.assert_allclose(np.sin(back[..., 8]), np.sin(arrays[0][..., 8]),
                               atol=1e-5)
    np.testing.assert_allclose(back[..., :8], arrays[0][..., :8], atol=0)


def jax_variables(cfg_j, pts, valid, perturb_stats=()):
    """JAX-init variables of cfg_j (one jitted init), the heatmap bias
    raised so that many boxes pass the 0.1 threshold, and random BN
    statistics in the named scopes; and the jitted forward of them."""
    model = jax_build(cfg_j)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid)))
    variables = jax.tree.map(np.array, variables)
    rng = np.random.default_rng(1)
    for name in perturb_stats:
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["batch_stats"][name]):
            leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape)
                         if path[-1].key == "var"
                         else rng.normal(0, 0.1, leaf.shape))
    for t in range(T):
        variables["params"]["head"][f"task{t}"]["hm_final"]["bias"][:] = 0.5
    return jax.jit(lambda p, v: model.apply(variables, p, v)), variables


def recording(fn, store, to_numpy):
    def forward(p, v):
        out = fn(p, v)
        store.append([to_numpy(pd["hm"]) for pd in out])
        return out
    return forward


def run_both(cfg, cfg_j, jfwd, variables, pts, valid, mode):
    """The port's and the JAX package's double flip of `mode` on the same
    scene and weights. Returns (port Detections, JAX Detections, max
    heatmap difference over the four flips)."""
    port = build_detector(cfg, device="cpu")
    port.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    hm, jhm = [], []
    fn = {"map": (tta.infer_double_flip_map, jax_tta.infer_double_flip_map),
          "box": (tta.infer_double_flip, jax_tta.infer_double_flip)}[mode]
    with torch.no_grad():
        det = fn[0](cfg, recording(port, hm, lambda x: x.numpy()),
                    torch.from_numpy(pts), torch.from_numpy(valid))
    jdet = jax.device_get(fn[1](cfg_j, recording(jfwd, jhm, np.asarray),
                                jnp.asarray(pts), jnp.asarray(valid)))
    assert len(hm) == len(jhm) == 4
    err = max(float(np.abs(1 / (1 + np.exp(-a)) - 1 / (1 + np.exp(-b)))
                    .max()) for f, jf in zip(hm, jhm) for a, b in zip(f, jf))
    return det, jdet, err


def assert_match(det, jdet, parts):
    """Per flip (a box ensemble has 4 parts), every detection matched."""
    n = det.valid.shape[1] // parts
    for i in range(parts):
        sl = slice(i * n, (i + 1) * n)
        keep = det.valid[0, sl].numpy()
        jkeep = np.asarray(jdet.valid[0, sl])
        assert keep.sum() == jkeep.sum() > 7 * 10
        scale = parts        # box scores are divided by the 4 flips
        assert_detections_match(
            det.boxes[0, sl].numpy()[keep],
            det.scores[0, sl].numpy()[keep] * scale,
            det.labels[0, sl].numpy()[keep],
            np.asarray(jdet.boxes[0, sl])[jkeep],
            np.asarray(jdet.scores[0, sl])[jkeep] * scale,
            np.asarray(jdet.labels[0, sl])[jkeep])


@pytest.fixture(scope="module")
def pillars():
    name = "pp_forecast_n3dtf"
    cfg_j = jax_config.tiny_variant(jax_config.get_config(name))
    cfg = port_config.tiny_variant(port_config.get_config(name))
    pts, valid = tiny_scene(cfg, 3)
    jfwd, variables = jax_variables(cfg_j, pts, valid)
    return cfg, cfg_j, jfwd, variables, pts, valid


@pytest.fixture(scope="module")
def voxelnet():
    cfg_j = voxelnet_config(jax_config)
    cfg = voxelnet_config(port_config)
    pts, valid = voxel_scene(cfg, 4)
    jfwd, variables = jax_variables(cfg_j, pts, valid,
                                    ("middle", "z_crush"))
    return cfg, cfg_j, jfwd, variables, pts, valid


@pytest.mark.parametrize("mode", ["map", "box"])
def test_pillar_double_flip_matches_jax(pillars, mode):
    det, jdet, err = run_both(*pillars, mode)
    assert err <= HM_ATOL, err
    assert det.boxes.shape == jdet.boxes.shape
    assert_match(det, jdet, 4 if mode == "box" else 1)


@pytest.mark.parametrize("mode", ["map", "box"])
def test_voxelnet_double_flip_matches_jax(voxelnet, mode):
    det, jdet, err = run_both(*voxelnet, mode)
    assert err <= HM_ATOL, err
    assert det.boxes.shape == jdet.boxes.shape
    assert_match(det, jdet, 4 if mode == "box" else 1)


def test_map_average_of_one_frame_is_the_plain_decode():
    """With maps that every flip leaves as they are, map averaging decodes
    the frame's own maps (up to the logit round trip)."""
    from futuredet_torch.eval.decode import decode_and_nms
    cfg = port_config.tiny_variant(
        port_config.get_config("pp_forecast_n3dtf"))
    rng = np.random.default_rng(2)
    H, W = cfg.feature_map_size[1], cfg.feature_map_size[0]
    maps = [{k: torch.from_numpy(v.astype(np.float32))
             for k, v in random_maps(rng, B=1, H=H, W=W).items()
             if k not in ("rvel", "feats")} for _ in range(T)]
    sym = [{k: (v + torch.flip(v, [1]) + torch.flip(v, [2])
                + torch.flip(v, [1, 2])) / 4 for k, v in m.items()}
           for m in maps]
    for m in sym:          # maps that every flip leaves as they are
        m["reg"][...] = 0.5
        m["vel"][...] = 0.0
        m["rot"][..., 0] = 0.0
        m["rot"][..., 1] = 1.0
    pts = torch.zeros(1, 4, 5)
    want = decode_and_nms(cfg, sym)
    got = tta.infer_double_flip_map(cfg, lambda p, v: [
        {k: x.clone() for k, x in m.items()} for m in sym], pts, None)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid.numpy())
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(),
                               atol=1e-6)
