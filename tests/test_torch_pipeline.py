"""The futuredet_torch slice end to end vs the JAX package: decode + NMS on
identical predictions, the whole tiny pp_forecast_n3dtf detector with
JAX-init weights bridged, and the weight bridge both ways."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.config import get_config as jax_get_config
from futuredet_tpu.config import tiny_variant as jax_tiny_variant
from futuredet_tpu.eval.decode import decode_and_nms as jax_decode_and_nms
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.utils.convert_checkpoint import \
    convert_reference_checkpoint
from futuredet_torch.config import get_config, tiny_variant
from futuredet_torch.eval.decode import decode_and_nms
from futuredet_torch.models.detector import build_detector
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict

# decode is elementwise (sigmoid, exp, atan2) on identical inputs
DECODE_ATOL = 1e-5
# the whole conv stack: fp32 summation order differs (XLA:CPU vs oneDNN)
HEAD_ATOL = HEAD_RTOL = 1e-4

NAME = "pp_forecast_n3dtf"


def assert_detections_match(boxes, scores, labels, rboxes, rscores, rlabels,
                            score_floor=0.1, center_tol=0.1,
                            score_tol=1e-2):
    """Greedy same-label centre matching; every confident reference
    detection needs a counterpart with matching geometry and score (copy of
    tests/test_checkpoint_convert.py::assert_detections_match)."""
    want = rscores >= score_floor
    rboxes, rscores, rlabels = rboxes[want], rscores[want], rlabels[want]
    used = np.zeros(len(boxes), bool)
    for rb, rs, rl in zip(rboxes, rscores, rlabels):
        d = np.linalg.norm(boxes[:, :2] - rb[:2], axis=1)
        d = np.where((labels == rl) & ~used, d, np.inf)
        j = int(np.argmin(d))
        assert d[j] <= center_tol, (
            f"reference detection at {rb[:3]} (label {rl}, score {rs:.3f}) "
            f"has no match within {center_tol} m (closest {d[j]:.3f})")
        used[j] = True
        assert abs(scores[j] - rs) <= score_tol, (scores[j], rs)
        np.testing.assert_allclose(boxes[j][:6], rb[:6], atol=0.05)
        np.testing.assert_allclose(
            [np.sin(boxes[j][8]), np.cos(boxes[j][8])],
            [np.sin(rb[8]), np.cos(rb[8])], atol=0.05)


def random_preds(rng, T=7, B=2, H=32, W=32):
    preds = []
    for _ in range(T):
        hm = rng.normal(-1.0, 1.5, (B, H, W, 1)).astype(np.float32)
        # ties: a block of equal logits above the score threshold
        hm[:, 4:12, 4:12] = 0.25
        preds.append({
            "hm": hm,
            "reg": rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32),
            "height": rng.normal(0, 1, (B, H, W, 1)).astype(np.float32),
            "dim": rng.normal(0.3, 0.3, (B, H, W, 3)).astype(np.float32),
            "rot": rng.normal(0, 1, (B, H, W, 2)).astype(np.float32),
            "vel": rng.normal(0, 1, (B, H, W, 2)).astype(np.float32)})
    return preds


def compare_decode(cfg_t, cfg_j, preds):
    got = decode_and_nms(cfg_t, [{k: torch.from_numpy(v) for k, v in p.items()}
                                 for p in preds])
    want = jax.device_get(jax_decode_and_nms(
        cfg_j, [{k: jnp.asarray(v) for k, v in p.items()} for p in preds]))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=DECODE_ATOL, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=DECODE_ATOL, rtol=0)
    return got


def with_post_max(cfg, post):
    return cfg.replace(test=dataclasses.replace(cfg.test, nms=dataclasses.replace(
        cfg.test.nms, post_max_size=post)))


def test_decode_and_nms_matches_jax():
    # post_max == pre_max, so the survivor count shows what NMS removed
    T, pre = 7, 128
    cfg = with_post_max(tiny_variant(get_config(NAME)), pre)
    cfg_j = with_post_max(jax_tiny_variant(jax_get_config(NAME)), pre)
    got = compare_decode(cfg, cfg_j, random_preds(np.random.default_rng(0)))
    assert got.boxes.shape == (2, T * pre, 9)
    per_t = got.valid.reshape(2, T, pre).sum(-1)
    assert bool((per_t > 5).all()) and bool((per_t < pre).all()), per_t


def test_decode_circular_nms_matches_jax():
    cfg = tiny_variant(get_config(NAME))
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, circular_nms=True,
                                               min_radius=(1.0,)))
    cfg_j = jax_tiny_variant(jax_get_config(NAME))
    cfg_j = cfg_j.replace(test=dataclasses.replace(
        cfg_j.test, circular_nms=True, min_radius=(1.0,)))
    compare_decode(cfg, cfg_j, random_preds(np.random.default_rng(1), T=7,
                                            B=1, H=16, W=16))


def tiny_scene(cfg, seed):
    rng = np.random.default_rng(seed)
    P = cfg.voxel.max_points
    lo, hi = cfg.voxel.pc_range[0], cfg.voxel.pc_range[3]
    pts = np.concatenate([
        rng.uniform(lo, hi, (1, P, 2)), rng.uniform(-2.5, 2.5, (1, P, 1)),
        rng.uniform(0, 1, (1, P, 2))], -1).astype(np.float32)
    return pts, rng.random((1, P)) < 0.95


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX-init variables of the tiny pp_forecast_n3dtf, with the heatmap
    bias raised so that many boxes per timestep pass the 0.1 threshold."""
    cfg_j = jax_tiny_variant(jax_get_config(NAME))
    model = jax_build(cfg_j)
    pts, valid = tiny_scene(cfg_j, 0)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid)))
    variables = jax.tree.map(np.array, variables)
    for t in range(7):
        variables["params"]["head"][f"task{t}"]["hm_final"]["bias"][:] = 0.5
    return cfg_j, model, variables


def test_whole_slice_matches_jax(tiny_pair):
    cfg_j, jmodel, variables = tiny_pair
    cfg = tiny_variant(get_config(NAME))
    pts, valid = tiny_scene(cfg, 1)
    jpreds = jmodel.apply(variables, jnp.asarray(pts), jnp.asarray(valid))
    jdet = jax.device_get(jax_decode_and_nms(cfg_j, jpreds))

    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    with torch.no_grad():
        preds = model(torch.from_numpy(pts), torch.from_numpy(valid))
        det = decode_and_nms(cfg, preds)

    for t, (p, jp) in enumerate(zip(preds, jpreds)):
        for k in jp:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       atol=HEAD_ATOL, rtol=HEAD_RTOL,
                                       err_msg=f"task {t} {k}")
    keep = det.valid[0].numpy()
    jkeep = np.asarray(jdet.valid[0])
    per_t = keep.reshape(7, -1).sum(-1)
    assert (per_t >= 20).all(), per_t
    assert keep.sum() == jkeep.sum()
    assert_detections_match(
        det.boxes[0].numpy()[keep], det.scores[0].numpy()[keep],
        det.labels[0].numpy()[keep], np.asarray(jdet.boxes[0])[jkeep],
        np.asarray(jdet.scores[0])[jkeep], np.asarray(jdet.labels[0])[jkeep])


def test_bridge_round_trip_is_exact(tiny_pair):
    """The JAX package's reference-checkpoint converter, fed the port's
    state dict, gives back the flax variables bit for bit."""
    cfg_j, _, variables = tiny_pair
    cfg = tiny_variant(get_config(NAME))
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    zeros = jax.tree.map(np.zeros_like, variables)
    back = convert_reference_checkpoint(sd, cfg_j, zeros)
    rep = back.pop("__convert_report__")
    assert not rep["missing_ref_keys"] and not rep["unused_ref_keys"]
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a, err_msg=str(path))


def test_full_width_key_space_and_shapes():
    """At full width the port's modules take every flax leaf of the JAX
    pp_forecast_n3dtf (shapes only: the grid does not change the tree)."""
    cfg_j = jax_get_config(NAME)
    model = jax_build(cfg_j)
    pts = jnp.zeros((1, 64, 5), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts, jnp.ones((1, 64), bool)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    cfg = get_config(NAME)
    port = build_detector(cfg, device="cpu")
    sd = flax_to_state_dict(variables, cfg)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    n_flax = sum(np.size(x) for x in jax.tree.leaves(variables))
    n_port = sum(v.numel() for k, v in port.state_dict().items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_port_imports_nothing_of_jax_and_builds_nothing_at_import():
    """The port stands alone: importing every module loads no jax, flax or
    futuredet_tpu module and starts no kernel build."""
    import subprocess
    import sys
    code = (
        "import sys, pkgutil, importlib, futuredet_torch\n"
        "for m in pkgutil.walk_packages(futuredet_torch.__path__, "
        "'futuredet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'futuredet_tpu')]\n"
        "assert not bad, bad\n"
        "from futuredet_torch.ops import _build\n"
        "assert not _build._loaded\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil

    import torch.utils.cpp_extension as cpp
    from futuredet_torch.ops import _build
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not list(tmp_path.iterdir())
