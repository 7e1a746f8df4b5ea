"""futuredet_torch models/two_stage.py against the JAX package's, on the same
numpy-seeded inputs and weights (`flax_to_state_dict`), on the CPU:

  * `box_sample_points` and `pool_bev_features`, boxes on, across and off
    the map's edges (1e-6);
  * `RoIHead` and `TwoStageRefiner` (1e-5 of max(1, max |JAX|));
  * `TwoStageDetector` in eval at `tiny_variant`, pillars and the small
    VoxelNet of tests/test_torch_voxelnet.py: first-stage heatmaps
    (post-sigmoid, 1e-5) and neck output (1e-5 of its max), proposals
    matched as tests/test_torch_decode_modes.py matches them, and on the
    matched valid proposals the RoI logits and residuals, the refined boxes
    and the fused scores (1e-4 of max(1, max |JAX|): the neck's fp32
    difference through the RoI head's long sums); fused scores 0 exactly
    where a proposal is invalid. The RoI stage alone, on the JAX first
    stage's neck output and proposals: 1e-5;
  * `proposal_targets` and `two_stage_loss` on random proposals and GT,
    invalid GT, a sample whose GT is all invalid, and proposals whose IoU
    is exactly the fg and bg edges (1e-6), and the loss's gradients in the
    logits and residuals (1e-6) and in the proposals (1e-5 of their max);
  * `adopt_first_stage` and `two_stage_trainable_mask` against the JAX
    functions through the bridge (the mask: 92 tensors, every
    `two_stage_forecast_conv` frozen);
  * the two configs' resolution, and the first stage's init drawn as the
    single-stage config's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.models import two_stage as jts
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.detector import \
    build_single_stage as jax_build_single
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models import two_stage as pts
from futuredet_torch.models.detector import build_detector
from futuredet_torch.ops.rotated_iou import pairwise_iou_bev
from futuredet_torch.utils.convert_checkpoint import (
    flax_to_state_dict, load_reference_state_dict)
from tests.test_torch_cli import match_timestep
from tests.test_torch_train_step import (  # noqa: F401 (a fixture)
    jax_variables, one_torch_thread)
from tests.test_torch_voxelnet import voxelnet_config

NAMES = ("pp_forecast_n3dtf_two_stage", "forecast_n3dtf_two_stage")
POOL_ATOL = 1e-6
ROI_RTOL = 1e-5          # of max(1, max |JAX|): fp32 sums in another order
# the first stage's neck output against the JAX one, of its max |JAX|, and
# what the RoI head's 640- or 2560-long sums make of that difference
BEV_RTOL = 1e-5
ROI_E2E_RTOL = 1e-4
HM_ATOL = 1e-5
TARGET_ATOL = 1e-6
# the proposals' gradient runs through the rotated IoU's clipped edges
GRAD_RTOL = 1e-5
N_TRAINABLE = 92         # 7 tasks x (vel, rot) x 6 tensors + the RoI head's 8


def pp_config(mod):
    return mod.tiny_variant(mod.get_config(NAMES[0]))


def vox_config(mod):
    """The small VoxelNet (no site dropped on either side) as a two-stage
    model."""
    cfg = voxelnet_config(mod)
    return cfg.replace(name=NAMES[1], model=dataclasses.replace(
        cfg.model, two_stage_refine=True,
        head=dataclasses.replace(cfg.model.head, two_stage=True)))


CONFIGS = {"pillars": pp_config, "voxelnet": vox_config}


def random_boxes(rng, n, lo=-9.0, hi=9.0):
    """(n, 9) decoded boxes over and past a [-8, 8] m map."""
    return np.concatenate([
        rng.uniform(lo, hi, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(0.5, 5.0, (n, 3)), rng.normal(0, 1, (n, 2)),
        rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)


def close_of_max(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (what, err, tol)


def test_box_sample_points_and_pooling_match_jax():
    """The sample points within 1e-6 m (XLA's and torch's sin and cos may
    differ in the last bit). Pooling within 1e-6 where the points agree
    exactly (heading 0: cos 1, sin 0 on both sides); at any heading within
    1e-6 plus the points' largest difference in cells times the map's
    largest step between neighbouring cells."""
    cfg = pp_config(port_config)
    cfg_j = pp_config(jax_config)
    rng = np.random.default_rng(0)
    boxes = random_boxes(rng, 300)
    # boxes whose taps fall off the map, and one at a cell corner
    boxes[:20, :2] = rng.uniform(8.5, 12.0, (20, 2))
    boxes[20, :2] = (-8.0, -8.0)
    bev = rng.normal(0, 1, (32, 32, 24)).astype(np.float32)
    step = max(np.abs(np.diff(bev, axis=a)).max() for a in (0, 1))
    cell = cfg.voxel.voxel_size[0] * cfg.assigner.out_size_factor
    for heading0 in (True, False):
        b = boxes.copy()
        if heading0:
            b[:, 8] = -np.pi / 2                 # physical heading 0
        want_pts = np.asarray(jts.box_sample_points(jnp.asarray(b)))
        got_pts = pts.box_sample_points(torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got_pts, want_pts, atol=POOL_ATOL, rtol=0)
        want = np.asarray(jts.pool_bev_features(jnp.asarray(bev),
                                                jnp.asarray(b), cfg_j))
        got = pts.pool_bev_features(torch.from_numpy(bev),
                                    torch.from_numpy(b), cfg).numpy()
        assert got.shape == (300, 5 * 24)
        if heading0:
            np.testing.assert_array_equal(got_pts, want_pts)
            np.testing.assert_allclose(got, want, atol=POOL_ATOL, rtol=0)
        else:
            drift = np.abs(got_pts - want_pts).max() / cell
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=POOL_ATOL + 2 * drift * step)
        # off the map: every tap of the first boxes reads zero
        assert not got[:20].any() and not want[:20].any()
    # the batched pooling is the per-sample one
    bb = np.stack([bev, bev[::-1].copy()])
    bx = np.stack([boxes, boxes[::-1].copy()])
    batched = pts.pool_batch(torch.from_numpy(bb), torch.from_numpy(bx), cfg)
    for b in range(2):
        np.testing.assert_array_equal(
            batched[b].numpy(), pts.pool_bev_features(
                torch.from_numpy(bb[b]), torch.from_numpy(bx[b]),
                cfg).numpy())


def roi_variables(rng, cin):
    """flax RoIHead params filled from a numpy generator."""
    shapes = jax.eval_shape(lambda: jts.RoIHead().init(
        jax.random.PRNGKey(0), jnp.zeros((1, cin))))
    return jax.tree.map(lambda s: rng.normal(0, 0.2, s.shape).astype(
        np.float32), shapes)


def test_roi_head_and_refiner_match_jax():
    cfg, cfg_j = pp_config(port_config), pp_config(jax_config)
    rng = np.random.default_rng(1)
    C = pts.bev_channels(cfg)
    variables = roi_variables(rng, 5 * C)
    sd = flax_to_state_dict({"params": {"roi_head": variables["params"]}},
                            cfg)
    assert sorted(sd) == sorted(
        f"roi_head.{m}.{p}" for m in ("shared_fc0", "shared_fc1", "cls",
                                      "reg") for p in ("weight", "bias"))
    pooled = rng.normal(0, 1, (2, 40, 5 * C)).astype(np.float32)
    head = pts.RoIHead(5 * C)
    head.load_state_dict({k.removeprefix("roi_head."): v
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        logit, resid = head(torch.from_numpy(pooled))
    jlogit, jresid = jts.RoIHead().apply(variables, jnp.asarray(pooled))
    close_of_max(logit.numpy(), jlogit, ROI_RTOL, "logit")
    close_of_max(resid.numpy(), jresid, ROI_RTOL, "resid")

    bev = rng.normal(0, 1, (2, 32, 32, C)).astype(np.float32)
    boxes = np.stack([random_boxes(rng, 50) for _ in range(2)])
    refiner = pts.TwoStageRefiner(cfg)
    refiner.load_state_dict(sd, strict=True)
    with torch.no_grad():
        rb, rs = refiner(torch.from_numpy(bev), torch.from_numpy(boxes))
    jrb, jrs = jts.TwoStageRefiner(cfg=cfg_j).apply(
        {"params": {"roi_head": variables["params"]}}, jnp.asarray(bev),
        jnp.asarray(boxes))
    close_of_max(rb.numpy(), jrb, ROI_RTOL, "refined boxes")
    close_of_max(rs.numpy(), jrs, ROI_RTOL, "scores")


@pytest.fixture(scope="module", params=list(CONFIGS))
def detector_pair(request):
    """The JAX TwoStageDetector's eval outputs on a seeded batch, and the
    port's from the same weights."""
    cfg_j, cfg = (CONFIGS[request.param](m) for m in (jax_config,
                                                       port_config))
    batch = make_batch(cfg, 2, seed=7, n_objects=8, n_clutter=500,
                       points_per_object=120)
    p, v = batch["points"].numpy(), batch["points_valid"].numpy()
    model = jax_build(cfg_j)
    variables = jax_variables(model, p[:1], v[:1])
    head = variables["params"]["first_stage"]["head"]
    for t in head:
        if t.startswith("task"):
            head[t]["hm_final"]["bias"][:] = 0.5      # many proposals
            head[t]["dim_final"]["kernel"] *= 0.05    # box sizes of metres
            head[t]["dim_final"]["bias"][:] = 0.5
    want = jax.device_get(model.apply(variables, jnp.asarray(p),
                                      jnp.asarray(v)))
    # the JAX first stage's neck output, for the RoI stage on its own
    jbev = jax.device_get(jax_build_single(cfg_j).apply(
        {t: variables[t]["first_stage"] for t in variables},
        jnp.asarray(p), jnp.asarray(v), return_bev=True)[1])
    port = build_detector(cfg, device="cpu")
    port.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    with torch.no_grad():
        got = port(batch["points"], batch["points_valid"])
        bev = port.first_stage(batch["points"], batch["points_valid"],
                               return_bev=True)[1]
    return cfg, port, got, want, bev.numpy(), np.asarray(jbev)


def matched_slots(cfg, det, jdet):
    """Per sample and pseudo-task the kept proposals of both sides matched
    as tests/test_torch_decode_modes.py matches them; returns the
    (sample, port slot, JAX slot) pairs."""
    post = cfg.test.nms.post_max_size
    B, N = det.valid.shape
    pairs = []
    for b in range(B):
        for t in range(N // post):
            sl = np.arange(t * post, (t + 1) * post)
            g = [np.asarray(x[b, sl]) for x in det]
            w = [np.asarray(x[b, sl]) for x in jdet]
            match_timestep(g[0][g[3]], g[1][g[3]], w[0][w[3]], w[1][w[3]],
                           post, cfg.test.nms.iou_threshold)
            for i in sl[g[3]]:
                d = np.abs(np.asarray(jdet.boxes[b, sl, :2])
                           - det.boxes[b, i, :2].numpy()).max(-1)
                d[~w[3]] = np.inf
                j = int(np.argmin(d))
                if d[j] <= 1e-4:
                    pairs.append((b, i, sl[j]))
    return pairs


def test_two_stage_detector_matches_jax(detector_pair):
    cfg, _, (preds, det, roi), (jpreds, jdet, jroi), bev, jbev = \
        detector_pair
    # the neck outputs the RoI head reads differ by fp32 sums in another
    # order (XLA:CPU against oneDNN)
    close_of_max(bev, jbev, BEV_RTOL, "bev")
    for t, (p, jp) in enumerate(zip(preds, jpreds)):
        np.testing.assert_allclose(torch.sigmoid(p["hm"]).numpy(),
                                   np.asarray(jax.nn.sigmoid(jp["hm"])),
                                   atol=HM_ATOL, rtol=0, err_msg=f"hm {t}")
    pairs = matched_slots(cfg, det, jdet)
    n_valid = int(det.valid.sum())
    assert len(pairs) >= max(n_valid - 4, 40), (len(pairs), n_valid)
    b, i, j = (np.array(x) for x in zip(*pairs))
    for k in ("logits", "resid", "boxes", "scores"):
        close_of_max(roi[k].numpy()[b, i], np.asarray(jroi[k])[b, j],
                     ROI_E2E_RTOL, k)
    # the fused score is 0 exactly where a proposal is invalid, and
    # positive where it is valid
    assert not roi["scores"][~det.valid].any()
    assert bool((roi["scores"][det.valid] > 0).all())
    assert bool(torch.isfinite(roi["boxes"]).all())
    ref = pts.refined_detections(det, roi)
    assert ref.boxes is roi["boxes"] and ref.labels is det.labels


def test_roi_stage_on_the_jax_first_stage_matches_jax(detector_pair):
    """The port's pooling, RoI head and refinement on the JAX first stage's
    neck output and proposals: every valid proposal's logit, residuals,
    refined box and fused score within 1e-5 of max(1, max |JAX|)."""
    cfg, port, _, (_, jdet, jroi), _, jbev = detector_pair
    boxes = torch.from_numpy(np.asarray(jdet.boxes))
    with torch.no_grad():
        logits, resid = port.roi_head(pts.pool_batch(
            torch.from_numpy(jbev), boxes, cfg))
    refined = pts._refine(boxes, resid, torch.exp(torch.clamp(
        resid[..., 3:6], -4.0, 4.0)))
    stage1 = torch.from_numpy(np.asarray(jdet.scores))
    score = torch.sqrt(torch.clamp_min(torch.sigmoid(logits) * stage1,
                                       1e-12))
    valid = np.asarray(jdet.valid)
    assert valid.sum() >= 40
    for k, got in (("logits", logits), ("resid", resid), ("boxes", refined),
                   ("scores", score)):
        close_of_max(got.numpy()[valid], np.asarray(jroi[k])[valid],
                     ROI_RTOL, k)


def test_the_roi_head_passes_no_gradient_to_the_first_stage():
    """In training the RoI head reads the proposals' boxes and the BEV map
    detached: its outputs reach no first-stage parameter. The proposals
    themselves keep their gradient (the loss's targets read them, as in the
    JAX step)."""
    cfg = pp_config(port_config)
    model = build_detector(cfg, device="cpu").train()
    batch = make_batch(cfg, 1, seed=2, n_objects=6, n_clutter=300,
                       points_per_object=100)
    preds, det, roi = model(batch["points"], batch["points_valid"])
    assert det.boxes.requires_grad and det.scores.requires_grad
    (roi["logits"].sum() + roi["resid"].sum()).backward()
    for n, p in model.named_parameters():
        assert (p.grad is not None) == n.startswith("roi_head."), n


def iou_np(props, gt):
    """(N, 9) decoded proposals, (M, 12) GT -> (N, M) IoU as
    `proposal_targets` computes it."""
    def bev5(b, yaw_col):
        b = torch.from_numpy(b)
        return torch.stack([b[..., 0], b[..., 1], b[..., 4], b[..., 3],
                            -b[..., yaw_col] - np.pi / 2], -1)
    return pairwise_iou_bev(bev5(props, 8), bev5(gt, 10)).numpy()


def edge_proposal(gt, target):
    """A proposal inside `gt` (same centre and yaw, shorter) whose fp32 IoU
    with it is exactly float32(target), by a walk over its length in
    ulps."""
    t = np.float32(target)
    p = gt[[0, 1, 2, 3, 4, 5, 6, 7, 10]].copy()
    p[4] = np.float32(gt[4] * target)
    for _ in range(5000):
        iou = iou_np(p[None], gt[None])[0, 0]
        if iou == t:
            return p
        p[4] = np.nextafter(p[4], np.float32(np.inf if iou < t else -np.inf))
    raise AssertionError(f"no proposal at IoU {target}")


def target_case(rng):
    """(proposals (2, 60, 9), gt (2, 12, 12), gt_valid (2, 12),
    prop_valid (2, 60)): sample 1's GT all invalid; sample 0 has invalid
    GT and proposals near GT boxes, and two proposals exactly at the fg
    (0.55) and bg (0.25) IoU edges."""
    B, N, M = 2, 60, 12
    gt = np.zeros((B, M, 12), np.float32)
    gt[..., :2] = rng.uniform(-6, 6, (B, M, 2))
    gt[..., 2] = rng.uniform(-1, 1, (B, M))
    gt[..., 3:6] = rng.uniform(1.0, 4.0, (B, M, 3))
    gt[..., 6:10] = rng.normal(0, 1, (B, M, 4))
    gt[..., 10] = rng.uniform(-np.pi, np.pi, (B, M))
    gt_valid = rng.random((B, M)) < 0.75
    gt_valid[1] = False
    props = np.stack([random_boxes(rng, N, -7, 7) for _ in range(B)])
    # 30 proposals jittered around the GT
    pick = rng.integers(0, M, (B, 30))
    near = np.take_along_axis(gt, pick[..., None], 1)
    props[:, :30, :6] = near[..., :6] + rng.normal(0, 0.3, (B, 30, 6)) * [
        1, 1, 0.2, 0.3, 0.3, 0.3]
    props[:, :30, 3:6] = np.abs(props[:, :30, 3:6]) + 0.1
    props[:, :30, 8] = near[..., 10] + rng.normal(0, 0.2, (B, 30))
    g0 = int(np.nonzero(gt_valid[0])[0][0])
    gt[0, g0, 8:] = 0.0
    gt[0, g0, 10] = 0.3
    props[0, 30] = edge_proposal(gt[0, g0], 0.55)
    props[0, 31] = edge_proposal(gt[0, g0], 0.25)
    prop_valid = rng.random((B, N)) < 0.9
    prop_valid[0, 30:32] = True
    return props, gt, gt_valid, prop_valid


def test_proposal_targets_and_loss_match_jax():
    rng = np.random.default_rng(3)
    props, gt, gt_valid, prop_valid = target_case(rng)
    cls_t, reg_t, fg = pts.proposal_targets(*(torch.from_numpy(x) for x in (
        props, gt, gt_valid)))
    for b in range(2):
        jc, jr, jf = (np.asarray(x) for x in jts.proposal_targets(
            jnp.asarray(props[b]), jnp.asarray(gt[b]),
            jnp.asarray(gt_valid[b])))
        np.testing.assert_array_equal(fg[b].numpy(), jf)
        np.testing.assert_allclose(cls_t[b].numpy(), jc, atol=TARGET_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(reg_t[b].numpy(), jr, atol=TARGET_ATOL,
                                   rtol=0)
    # what the case holds: both edges, fg and bg proposals, a soft middle,
    # and no target at all where every GT is invalid
    assert bool(fg[0, 30]) and float(cls_t[0, 31]) == 0.0
    iou = np.where(gt_valid[0], iou_np(props[0, 30:32], gt[0]), 0)
    assert iou[0].max() == np.float32(0.55)
    assert iou[1].max() == np.float32(0.25)
    assert int(fg[0].sum()) >= 3 and bool(((cls_t[0] > 0)
                                           & (cls_t[0] < 1)).any())
    assert not fg[1].any() and not cls_t[1].any()

    logits = rng.normal(0, 2, (2, 60)).astype(np.float32)
    logits[0, :3] = 0.0                          # max(x, 0) at its tie
    resid = rng.normal(0, 1, (2, 60, 7)).astype(np.float32)
    resid[0, 30, :2] = 3.0                       # the L1 arm
    x = torch.from_numpy(logits).requires_grad_()
    r = torch.from_numpy(resid).requires_grad_()
    pr = torch.from_numpy(props).requires_grad_()
    got = pts.two_stage_loss(x, r, pr, *(torch.from_numpy(a) for a in (
        gt, gt_valid, prop_valid)))
    got["loss"].backward()

    def jloss(lg, rs, pp):
        out = jts.two_stage_loss(lg, rs, pp, jnp.asarray(gt),
                                 jnp.asarray(gt_valid),
                                 jnp.asarray(prop_valid))
        return out["loss"], out
    (_, want), (gx, gr, gp) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(resid), jnp.asarray(props))
    for k in ("roi_cls_loss", "roi_reg_loss", "loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   atol=TARGET_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx),
                               atol=TARGET_ATOL, rtol=0)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr),
                               atol=TARGET_ATOL, rtol=0)
    # the targets pass gradient to the proposals (their IoU and residuals).
    # The two edge proposals sit on the kinks of fg and of the clip at the
    # port's IoU; the JAX package's IoU of those pairs (another arithmetic,
    # not K1's) lies 1-2 ulps above it, off the kinks: their gradients
    # differ by the kinks' one-sided halves and are left out
    off_edge = np.ones(props.shape[:2], bool)
    off_edge[0, 30:32] = False
    close_of_max(pr.grad.numpy()[off_edge], np.asarray(gp)[off_edge],
                 GRAD_RTOL, "proposal gradient")
    assert float(np.abs(np.asarray(gp)[..., [3, 4, 8]]).max()) > 0
    assert float(want["roi_reg_loss"]) > 0


def test_proposal_targets_of_a_sample_without_gt_are_empty():
    rng = np.random.default_rng(4)
    props = random_boxes(rng, 10)
    gt = np.zeros((5, 12), np.float32)
    gt[:, 3:6] = 1.0
    cls_t, reg_t, fg = pts.proposal_targets(
        torch.from_numpy(props), torch.from_numpy(gt),
        torch.zeros(5, dtype=torch.bool))
    jc, jr, jf = (np.asarray(x) for x in jts.proposal_targets(
        jnp.asarray(props), jnp.asarray(gt), jnp.zeros(5, bool)))
    assert not fg.any() and not jf.any() and not cls_t.any()
    np.testing.assert_allclose(reg_t.numpy(), jr, atol=TARGET_ATOL, rtol=0)
    # all proposals invalid: both losses 0
    out = pts.two_stage_loss(torch.zeros(1, 10), torch.zeros(1, 10, 7),
                             torch.from_numpy(props[None]),
                             torch.from_numpy(gt[None]),
                             torch.zeros(1, 5, dtype=torch.bool),
                             torch.zeros(1, 10, dtype=torch.bool))
    assert float(out["loss"]) == 0.0


def filled(shapes, rng):
    return jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(
        np.float32), shapes)


def init_shapes(cfg_j):
    pts_ = jnp.zeros((1, cfg_j.voxel.max_points, 5))
    return jax.eval_shape(lambda: jax_build(cfg_j).init(
        jax.random.PRNGKey(0), pts_, jnp.ones(pts_.shape[:2], bool)))


def test_adopt_first_stage_matches_jax():
    cfg2_j, cfg2 = pp_config(jax_config), pp_config(port_config)
    cfg1_j = jax_config.tiny_variant(jax_config.get_config(
        "pp_forecast_n3dtf"))
    cfg1 = port_config.tiny_variant(port_config.get_config(
        "pp_forecast_n3dtf"))
    rng = np.random.default_rng(5)
    two = filled(init_shapes(cfg2_j), rng)
    one = filled(init_shapes(cfg1_j), rng)
    want = {t: jts.adopt_first_stage(two[t], one[t])
            for t in ("params", "batch_stats")}
    want_sd = flax_to_state_dict(jax.device_get(want), cfg2)
    got = pts.adopt_first_stage(flax_to_state_dict(two, cfg2),
                                flax_to_state_dict(one, cfg1))
    assert set(got) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got[k], want_sd[k]), k
    # the two-stage convs and the RoI head keep their values; a shape
    # mismatch is refused
    two_sd = flax_to_state_dict(two, cfg2)
    kept = [k for k in got if "two_stage_forecast_conv" in k
            or k.startswith("roi_head.")]
    # 7 x (conv w, b; BN weight, bias, running mean, var, batch count) + 8
    assert len(kept) == 7 * 7 + 8
    assert all(torch.equal(got[k], two_sd[k]) for k in kept)
    bad = dict(flax_to_state_dict(one, cfg1))
    bad["neck.blocks.0.1.weight"] = torch.zeros(1)
    with pytest.raises(AssertionError, match="neck.blocks.0.1.weight"):
        pts.adopt_first_stage(two_sd, bad)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainable_mask_is_the_jax_mask(name):
    cfg_j, cfg = CONFIGS[name](jax_config), CONFIGS[name](port_config)
    params = init_shapes(cfg_j)["params"]
    jmask = jts.two_stage_trainable_mask(params)
    ones = jax.tree.map(lambda s, m: np.full(s.shape, float(m), np.float32),
                        params, jmask)
    want = {k for k, v in flax_to_state_dict({"params": ones}, cfg).items()
            if v.all()}
    model = build_detector(cfg, device="cpu")
    got = pts.two_stage_trainable_mask(model)
    assert got == want
    assert len(got) == N_TRAINABLE
    names = [n for n, _ in model.named_parameters()]
    ts = [n for n in names if "two_stage_forecast_conv" in n]
    assert len(ts) == 7 * 4 and not set(ts) & got
    assert len(names) == len(jax.tree.leaves(params))


@pytest.mark.parametrize("name", NAMES)
def test_two_stage_configs_resolve_as_jax(name):
    cfg, cfg_j = port_config.get_config(name), jax_config.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert cfg.model.two_stage_refine and cfg.model.head.two_stage
    single = port_config.get_config(name.removesuffix("_two_stage"))
    assert cfg.replace(name=single.name, model=dataclasses.replace(
        cfg.model, two_stage_refine=False, head=dataclasses.replace(
            cfg.model.head, two_stage=False))) == single
    with pytest.raises(NotImplementedError, match="long tail"):
        load_reference_state_dict("unused.pth", cfg)


def test_first_stage_draws_as_the_single_stage_config():
    """The seeded init: the first stage's tensors common to the
    single-stage config draw as they do there until the head's first
    two-stage conv; the RoI head draws after the first stage."""
    cfg = pp_config(port_config)
    single = port_config.tiny_variant(port_config.get_config(
        "pp_forecast_n3dtf"))
    two = build_detector(cfg, device="cpu", seed=3).state_dict()
    one = build_detector(single, device="cpu", seed=3).state_dict()
    for k in ("reader.pfn_layers.0.linear.weight", "neck.blocks.0.1.weight",
              "bbox_head.shared_conv.0.weight",
              "bbox_head.tasks.0.forecast_conv.0.weight"):
        assert torch.equal(two["first_stage." + k], one[k]), k
    again = build_detector(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in two.items())
    assert two["roi_head.shared_fc0.weight"].std() > 0
