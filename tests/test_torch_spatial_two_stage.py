"""Spatial sharding (`--space`) of the two-stage model: tiny
pp_forecast_n3dtf_two_stage over two gloo ranks at (1, 2) against the JAX
GSPMD step, by the rules of tests/test_torch_spatial.py, on the weights,
batch and planted foreground of tests/test_torch_train_two_stage.py.

Each rank holds a band of the first stage's canvas through the RPN and
the head; the head maps and the neck output are gathered whole, and every
rank decodes them (K1), pools the gathered BEV and runs the RoI head, as
the JAX GSPMD step computes the RoI stage with its outputs replicated. So
the RoI head's gradients are whole on every rank: the step averages them
over the space group (`models/detector.py::whole_parameters`), where it
sums the bands' shares of the rest.

  * one B = 2 step (the per-sample head loss plus the RoI loss over the
    batch, `_make_train_step_gspmd`'s two-stage branch, whose body is
    first held to `make_train_step`'s own at (1, 2)): the losses,
    roi_cls_loss and roi_reg_loss among them, grad_norm, every gradient
    (`roi_head.*` and the frozen ones) and the running statistics, on
    every rank, and the ranks equal to each other;
  * the RoI head's gradients counted once: each rank's own is the whole
    one, and the step's is their mean, not their sum;
  * the eval forward against `make_eval_forward(cfg, make_mesh_2d(1,
    2))`: the first stage's maps, the proposals matched as
    tests/test_torch_two_stage.py matches them, and the RoI outputs on
    the matched proposals (within ROI_E2E_RTOL of max(1, max |JAX|), as
    that file holds the unsharded detector: the RoI head's long sums
    carry the first stage's rounding); the two ranks' results equal."""
import jax
import numpy as np
import pytest
import torch

from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.parallel.mesh import make_mesh_2d
from futuredet_tpu.train.step import make_eval_forward
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_spatial import (EVAL_ATOL, EVAL_RTOL,
                                      check_spatial_step, jax_batch,
                                      run_layout, spatial_case)
from tests.test_torch_train_two_stage import (configs, plant_foreground,
                                              step_variables)
from tests.test_torch_two_stage import (ROI_E2E_RTOL, close_of_max,
                                        matched_slots)


@pytest.fixture(scope="module")
def inputs():
    cfg_j, cfg = configs()
    batch = make_batch(cfg, 2, seed=12, n_objects=14, n_clutter=300,
                       points_per_object=200)
    variables = step_variables(jax_build(cfg_j), batch["points"].numpy()[:1],
                               batch["points_valid"].numpy()[:1])
    plant_foreground(cfg, variables, batch)
    return cfg_j, cfg, batch, variables


@pytest.fixture(scope="module")
def step_run(inputs, tmp_path_factory):
    cfg_j, cfg, batch, variables = inputs
    return spatial_case(cfg_j, cfg, batch, variables, 1, 2,
                        tmp_path_factory.mktemp("spatial_two_stage"),
                        against_make_train_step=True)


def test_two_space_ranks_take_the_jax_gspmd_two_stage_step(step_run):
    check_spatial_step(step_run)
    for r in step_run["ranks"]:
        assert float(r["metrics"]["roi_reg_loss"]) > 0     # foreground
        assert any(n.startswith("roi_head.") for n in r["grads"])


def test_the_roi_head_gradients_count_once(step_run):
    """Every rank computes the RoI head's gradient whole, the same on
    both; after the step's all-reduce it is that gradient (the mean over
    the space group), not twice it."""
    ranks = step_run["ranks"]
    roi = [n for n in ranks[0]["own_grads"] if n.startswith("roi_head.")]
    assert len(roi) == 8
    for n in roi:
        own = [r["own_grads"][n] for r in ranks]
        assert torch.equal(own[0], own[1]), n
        assert bool(own[0].abs().max() > 0), n
        torch.testing.assert_close(ranks[0]["grads"][n], own[0], rtol=1e-6,
                                   atol=0)


def test_the_space_eval_forward_matches_make_eval_forward(inputs, tmp_path):
    cfg_j, cfg, batch, variables = inputs
    jb = jax_batch(batch)
    jpreds, jdet, jroi = jax.device_get(make_eval_forward(
        cfg_j, make_mesh_2d(1, 2))(
            variables["params"], variables["batch_stats"],
            {"points": jb["points"], "points_valid": jb["points_valid"]}))
    case = {"cfg": cfg, "state_dict": flax_to_state_dict(variables, cfg),
            "batch": {k: v for k, v in batch.items() if k != "gt"},
            "mode": "eval"}
    ranks = run_layout(tmp_path, case, 1, 2)
    for r in ranks:
        preds, det, roi = r["maps"]
        for got_t, want_t in zip(preds, jpreds):
            assert set(got_t) == set(want_t) - {"feats"}
            for k, v in got_t.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(want_t[k]),
                                           rtol=EVAL_RTOL, atol=EVAL_ATOL,
                                           err_msg=k)
        pairs = matched_slots(cfg, det, jdet)
        n_valid = int(det.valid.sum())
        assert len(pairs) >= max(n_valid - 4, 40), (len(pairs), n_valid)
        b, i, j = (np.array(x) for x in zip(*pairs))
        # the RoI head's long sums of the pooled map: as the unsharded
        # detector is held (ROI_E2E_RTOL, of max(1, max |JAX|))
        for k in ("logits", "resid", "boxes", "scores"):
            close_of_max(roi[k].numpy()[b, i], np.asarray(jroi[k])[b, j],
                         ROI_E2E_RTOL, k)
    # the ranks decode the same gathered maps: one result
    for got, other in zip(torch.utils._pytree.tree_leaves(ranks[0]["maps"]),
                          torch.utils._pytree.tree_leaves(ranks[1]["maps"])):
        assert torch.equal(got, other)
