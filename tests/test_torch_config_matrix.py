"""Every name of futuredet_torch's CONFIG_NAMES at `tiny_variant`, all 14:
the twelve single-stage names build, run a forward, decode and take one
train step on the CPU (finite maps of the head's widths, labels of the
mode, a finite loss that moves the weights); the two `_two_stage` names
build, infer (finite refined boxes, fused scores 0 exactly on invalid
proposals) and take one train step that moves only the trainable subset,
with the RoI losses finite and no heatmap loss."""
import numpy as np
import pytest
import torch

from futuredet_torch.config import CONFIG_NAMES, get_config, tiny_variant
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.eval.decode import decode_and_nms
from futuredet_torch.models.center_head import CenterHead
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.two_stage import (refined_detections,
                                              two_stage_trainable_mask)
from futuredet_torch.train.step import make_optimizer, train_step
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

SINGLE_STAGE = [n for n in CONFIG_NAMES if not n.endswith("_two_stage")]
TWO_STAGE = [n for n in CONFIG_NAMES if n.endswith("_two_stage")]


def test_the_matrix_is_twelve_and_two():
    assert len(SINGLE_STAGE) == 12 and len(TWO_STAGE) == 2


@pytest.mark.parametrize("name", SINGLE_STAGE)
def test_single_stage_config_infers_and_trains(name):
    torch.manual_seed(0)
    cfg = tiny_variant(get_config(name))
    head = cfg.model.head
    batch = make_batch(cfg, 2, seed=1, n_objects=6, n_clutter=300,
                       points_per_object=60)
    assert ("bev_map" in batch) == head.bev_map
    model = build_detector(cfg, device="cpu", seed=0)
    with torch.no_grad():
        preds = model(batch["points"], batch["points_valid"],
                      batch.get("bev_map"))
        det = decode_and_nms(cfg, preds)
    W, H = cfg.feature_map_size
    assert len(preds) == len(head.num_classes)
    for pd, heads in zip(preds, CenterHead.task_heads(head)):
        for k, (ch, _) in heads:
            assert pd[k].shape == (2, H, W, ch), (name, k)
            assert bool(torch.isfinite(pd[k]).all()), (name, k)
    multitask = head.multitask
    n_pseudo = len(head.tasks) if multitask else head.target_timesteps
    post = cfg.test.nms.post_max_size
    assert det.boxes.shape == (2, n_pseudo * post, 9)
    assert bool(torch.isfinite(det.boxes).all())
    labels = det.labels[det.valid]
    top = len(cfg.data.class_names) if multitask else n_pseudo
    assert bool(((labels >= 0) & (labels < top)).all())

    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(cfg, model, 4)
    out = train_step(model, opt, batch, 0)
    assert np.isfinite(float(out["loss"])) and float(out["loss"]) > 0
    assert out["hm_loss"].shape == (len(head.num_classes),)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    # AdamW moves every parameter but a zero one with a zero gradient (a
    # zero-init bias of a group with no object in the batch)
    assert {n for n, p in before.items() if p.any()} <= set(moved)
    assert all(n in moved for n in before if ".hm." in n)


@pytest.mark.parametrize("name", TWO_STAGE)
def test_two_stage_config_infers_and_trains(name):
    torch.manual_seed(0)
    cfg = tiny_variant(get_config(name))
    batch = make_batch(cfg, 2, seed=1, n_objects=6, n_clutter=300,
                       points_per_object=60)
    model = build_detector(cfg, device="cpu", seed=0)
    with torch.no_grad():
        preds, det, roi = model(batch["points"], batch["points_valid"])
    post = cfg.test.nms.post_max_size
    assert len(preds) == 7
    assert det.boxes.shape == (2, 7 * post, 9)
    assert roi["logits"].shape == (2, 7 * post)
    assert roi["resid"].shape == (2, 7 * post, 7)
    ref = refined_detections(det, roi)
    assert bool(torch.isfinite(ref.boxes).all())
    assert bool(det.valid.any())
    assert not ref.scores[~det.valid].any()
    assert bool((ref.scores[det.valid] > 0).all())

    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(cfg, model, 4)
    out = train_step(model, opt, batch, 0)
    for k in ("loss", "roi_cls_loss", "roi_reg_loss", "grad_norm"):
        assert np.isfinite(float(out[k])), k
    assert not out["hm_loss"].any()
    mask = two_stage_trainable_mask(model)
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert len(mask) == 92 and moved <= mask
    # every trainable parameter moves but a zero one with a zero gradient
    # (the RoI head's reg bias where no proposal is foreground)
    assert {n for n in mask if before[n].any()} <= moved
    assert any(n.startswith("roi_head.") for n in moved)
