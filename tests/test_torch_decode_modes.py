"""futuredet_torch eval/decode.py in every single-stage head mode against
the JAX package on the same numpy-seeded head maps: the pseudo-task
expansion (exact) and decode_and_nms (validity and labels exact, boxes and
scores within 1e-5), with multitask labels as global class ids that never
point at a padded channel. A pseudo-task where one NMS keeps a box the
other suppresses is matched box by box instead, and that box let off only
when the two clip-role orders of a pair straddle the IoU threshold (the
XLA NMS clips the victim, the port follows K1, which clips the killer:
`tests/test_torch_cli.py::match_timestep`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.eval.decode import expand_pseudo_tasks as jax_expand
from futuredet_tpu.models.center_head import CenterHead as JaxCenterHead
from futuredet_torch import config as port_config
from futuredet_torch.eval.decode import expand_pseudo_tasks
from futuredet_torch.models.center_head import CenterHead
from tests.test_torch_cli import match_timestep
from tests.test_torch_pipeline import DECODE_ATOL
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

# (config name, head flag): each mode on the config it is driven on
MODES = {"standard_t1": ("forecast_n0", None),
         "standard_t7": ("forecast_n3", None),
         "multitask": ("centerpoint_multitask", None),
         "reverse": ("forecast_n3", "reverse"),
         "sparse": ("forecast_n3", "sparse"),
         "classify": ("forecast_n3", "classify"),
         "wide_head": ("forecast_n3", "wide_head"),
         "dense": ("forecast_n3dtf", None)}
PSEUDO_TASKS = {"standard_t1": 7, "standard_t7": 7, "multitask": 6,
                "reverse": 7, "sparse": 14, "classify": 7, "wide_head": 7,
                "dense": 7}


def mode_config(mod, mode):
    """The tiny variant of the mode's config at out_size_factor 1, so that
    a 24 x 24 map decodes inside the post-centre range."""
    name, flag = MODES[mode]
    cfg = mod.tiny_variant(mod.get_config(name))
    head = cfg.model.head
    if flag:
        head = dataclasses.replace(head, **{flag: True})
    return cfg.replace(
        model=dataclasses.replace(cfg.model, head=head),
        assigner=dataclasses.replace(cfg.assigner, out_size_factor=1))


def mode_preds(head, rng, B=2, H=24, W=24):
    """Random maps of the shapes the flax head gives in this mode."""
    preds = []
    for heads in JaxCenterHead(cfg=head)._task_heads():
        pd = {}
        for name, (ch, _) in heads:
            if name == "hm":
                a = rng.normal(-1.0, 1.5, (B, H, W, ch))
                a[:, 4:10, 4:10] = 0.25         # ties above the threshold
            elif name == "reg":
                a = rng.uniform(0, 1, (B, H, W, ch))
            elif name == "dim":
                a = rng.normal(0.3, 0.3, (B, H, W, ch))
            else:
                a = rng.normal(0, 1, (B, H, W, ch))
            pd[name] = a.astype(np.float32)
        preds.append(pd)
    return preds


def compare_decode(cfg, cfg_j, preds):
    """Both packages' decode_and_nms on `preds`: per sample and
    pseudo-task the slots equal (validity, labels exact; boxes, scores
    within 1e-5), or the kept boxes matched with straddling pairs let off.
    Returns the port's Detections and the boxes let off."""
    from futuredet_tpu.eval.decode import decode_and_nms as jax_decode
    from futuredet_torch.eval.decode import decode_and_nms
    got = decode_and_nms(cfg, [{k: torch.from_numpy(v) for k, v in p.items()}
                               for p in preds])
    want = jax.device_get(jax_decode(
        cfg_j, [{k: jnp.asarray(v) for k, v in p.items()} for p in preds]))
    post = cfg.test.nms.post_max_size
    B, N = got.valid.shape
    let_off = []
    for b in range(B):
        for t in range(N // post):
            sl = slice(t * post, (t + 1) * post)
            g = [np.asarray(x[b, sl]) for x in got]
            w = [np.asarray(x[b, sl]) for x in want]
            same = (np.array_equal(g[3], w[3]) and np.array_equal(g[2], w[2])
                    and np.allclose(g[0], w[0], atol=DECODE_ATOL, rtol=0)
                    and np.allclose(g[1], w[1], atol=DECODE_ATOL, rtol=0))
            if not same:
                off = match_timestep(g[0][g[3]], g[1][g[3]], w[0][w[3]],
                                     w[1][w[3]], post,
                                     cfg.test.nms.iou_threshold)
                assert off, (b, t)
                let_off += off
    return got, let_off


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_mode_matches_jax(mode):
    cfg, cfg_j = mode_config(port_config, mode), mode_config(jax_config, mode)
    head = cfg_j.model.head
    assert CenterHead.task_heads(cfg.model.head) == \
        JaxCenterHead(cfg=head)._task_heads()
    preds = mode_preds(head, np.random.default_rng(3))
    want = jax_expand(cfg_j, [{k: jnp.asarray(v) for k, v in p.items()}
                              for p in preds])
    got = expand_pseudo_tasks(cfg, [{k: torch.from_numpy(v)
                                     for k, v in p.items()} for p in preds])
    assert len(got) == len(want) == PSEUDO_TASKS[mode]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"{mode} {k}")
    det, let_off = compare_decode(cfg, cfg_j, preds)
    assert len(let_off) <= 4, let_off
    post = cfg.test.nms.post_max_size
    per_task = det.valid.reshape(2, len(got), post).sum(-1)
    assert bool((per_task > 0).all()), per_task
    if mode == "multitask":
        labels = det.labels.reshape(2, len(got), post)
        valid = det.valid.reshape(2, len(got), post)
        off = 0
        for t, task in enumerate(cfg.model.head.tasks):
            lab = labels[:, t][valid[:, t]]
            assert bool(((lab >= off) & (lab < off + len(task))).all()), t
            off += len(task)
        assert set(labels[valid].tolist()) == set(range(10))
    else:
        labels = det.labels.reshape(2, len(got), post)
        assert bool((labels == torch.arange(len(got))[None, :, None]).all())


def test_multitask_pad_never_wins():
    """A one-class group whose logits are all far below zero still scores
    its own channel: the zero pad comes after the sigmoid."""
    cfg = mode_config(port_config, "multitask")
    cfg_j = mode_config(jax_config, "multitask")
    preds = mode_preds(cfg_j.model.head, np.random.default_rng(4))
    preds[0]["hm"][:] = -30.0           # car: sigmoid ~ 1e-13 > 0
    preds[3]["hm"][:] = -30.0           # barrier
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in preds]
    from futuredet_tpu.eval.decode import decode_single as jax_decode_single
    from futuredet_torch.eval.decode import decode_and_nms
    assert float(jax.nn.sigmoid(jnp.float32(-30.0))) > 0
    det = decode_and_nms(cfg, [{k: torch.from_numpy(v) for k, v in p.items()}
                               for p in preds])
    assert compare_decode(cfg, cfg_j, preds)[1] == []
    post = cfg.test.nms.post_max_size
    assert not det.valid.reshape(2, 6, post)[:, [0, 3]].any()
    assert jax_decode_single(jp[0], cfg_j)[1].shape[-1] == 1
