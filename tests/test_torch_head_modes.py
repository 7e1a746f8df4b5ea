"""futuredet_torch CenterHead in every single-stage mode against the flax
CenterHead, the weights carried by flax_to_state_dict and loaded with
strict=True: standard at T = 1 and T = 7, multitask class groups,
bev_map (on a map that is not symmetric), reverse, sparse, classify,
wide_head and dcn_head (random offset convs: fractional and out-of-image
taps). Eval mode and train mode (the batch statistics and the running
statistics they update)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.config import HeadConfig
from futuredet_tpu.models.center_head import CenterHead as JaxCenterHead
from futuredet_torch.config import get_config
from futuredet_torch.models.center_head import CenterHead
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_head import ATOL, RTOL, randomize
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

MULTITASK = (("car",), ("truck", "construction_vehicle"), ("bus", "trailer"),
             ("barrier",), ("motorcycle", "bicycle"),
             ("pedestrian", "traffic_cone"))
BASE = dict(in_channels=24, share_conv_channel=16)
MODES = {
    "standard_t1": HeadConfig(**BASE, timesteps=1),
    "standard_t7": HeadConfig(**BASE, timesteps=7),
    "multitask": HeadConfig(**BASE, timesteps=1, tasks=MULTITASK),
    "bev_map": HeadConfig(**BASE, timesteps=7, dense=True,
                          forecast_feature=True, bev_map=True),
    "reverse": HeadConfig(**BASE, timesteps=7, reverse=True),
    "sparse": HeadConfig(**BASE, timesteps=7, sparse=True),
    "classify": HeadConfig(**BASE, timesteps=7, classify=True),
    "wide_head": HeadConfig(**BASE, timesteps=7, wide_head=True),
    "dcn_head": HeadConfig(**BASE, timesteps=1, dcn_head=True),
}
HW = (12, 10)


def head_inputs(head, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, *HW, head.in_channels)).astype(np.float32)
    bev = None
    if head.bev_map:
        # a road band in the lower rows only: a transposed map differs
        bev = np.zeros((2, *HW, 1), np.float32)
        bev[:, 7:10, 2:] = 1.0
        bev[1, :, :3] = 0.5
    return rng, x, bev


def flax_head(head, seed=5):
    """The flax head's variables (random BN statistics and affine, and for
    dcn_head random offset convs) and its eval-mode outputs."""
    rng, x, bev = head_inputs(head, seed)
    jh = JaxCenterHead(cfg=head)
    kw = {} if bev is None else {"bev_map": jnp.asarray(bev)}
    variables = randomize(jh.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  **kw), rng)

    def offsets(path, a):
        # the zero-init offset conv: taps at fractional positions, some
        # off the map
        if "conv_offset" in jax.tree_util.keystr(path) and a.ndim == 4:
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        return a
    variables = jax.tree_util.tree_map_with_path(offsets, variables)
    return jh, variables, x, bev, kw


def port_head(head, variables):
    cfg = get_config("forecast_n0")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, head=head))
    sd = flax_to_state_dict({"params": {"head": variables["params"]},
                             "batch_stats": {"head":
                                             variables["batch_stats"]}}, cfg)
    th = CenterHead(head)
    th.load_state_dict({k.removeprefix("bbox_head."): v
                        for k, v in sd.items()}, strict=True)
    return th


def assert_maps_match(got, want, what):
    assert len(got) == len(want), what
    for t, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, t, set(g), set(w))
        for k in w:
            assert tuple(g[k].shape) == tuple(np.shape(w[k])), (what, t, k)
            np.testing.assert_allclose(g[k].detach().numpy(),
                                       np.asarray(w[k]), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{what} {t} {k}")


@pytest.mark.parametrize("mode", list(MODES))
def test_head_mode_matches_flax(mode):
    head = MODES[mode]
    jh, variables, x, bev, kw = flax_head(head)
    want = jax.device_get(jh.apply(variables, jnp.asarray(x), **kw))
    th = port_head(head, variables).eval()
    tb = None if bev is None else torch.from_numpy(bev)
    with torch.no_grad():
        got = th(torch.from_numpy(x).permute(0, 3, 1, 2), tb)
    assert_maps_match(got, want, mode)
    assert len(got) == len(head.num_classes)
    for g, n in zip(got, head.num_classes):
        assert g["hm"].shape[-1] == n
    widen = head.timesteps if mode in ("standard_t7", "reverse",
                                       "sparse") else 1
    assert got[0]["vel"].shape[-1] == 2 * widen
    if mode == "bev_map":
        # the map moves the maps: the head is conditioned on it
        with torch.no_grad():
            flipped = th(torch.from_numpy(x).permute(0, 3, 1, 2),
                         tb.transpose(1, 2).flip(1).reshape(tb.shape))
        assert float((flipped[0]["hm"] - got[0]["hm"]).abs().max()) > 1e-3
        with pytest.raises(ValueError, match="ego map"):
            th(torch.from_numpy(x).permute(0, 3, 1, 2))


@pytest.mark.parametrize("mode", ["multitask", "bev_map", "wide_head",
                                  "dcn_head"])
def test_head_mode_trains_as_flax(mode):
    """Train mode: the batch-statistics outputs and the updated running
    statistics."""
    head = MODES[mode]
    jh, variables, x, bev, kw = flax_head(head, seed=8)
    want, upd = jh.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"], **kw)
    th = port_head(head, variables).train()
    got = th(torch.from_numpy(x).permute(0, 3, 1, 2),
             None if bev is None else torch.from_numpy(bev))
    assert_maps_match(got, jax.device_get(want), mode)
    cfg = get_config("forecast_n0")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, head=head))
    sd = flax_to_state_dict({"params": {"head": variables["params"]},
                             "batch_stats": {"head": jax.device_get(
                                 upd["batch_stats"])}}, cfg)
    mine = th.state_dict()
    for k, v in sd.items():
        k = k.removeprefix("bbox_head.")
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(mine[k].numpy(), v.numpy(),
                                       atol=ATOL, rtol=RTOL, err_msg=k)


def test_dcn_head_offsets_start_at_zero():
    from futuredet_torch.config import tiny_variant
    from futuredet_torch.models.detector import build_detector
    cfg = tiny_variant(get_config("forecast_n0"))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, dcn_head=True)))
    task = build_detector(cfg, device="cpu", seed=0).bbox_head.tasks[0]
    for fa in (task.feature_adapt_cls, task.feature_adapt_reg):
        assert not fa.conv_offset.weight.any()
        assert not fa.conv_offset.bias.any()
        assert fa.conv_adaption.weight.abs().sum() > 0
    assert torch.all(task.cls_head[-1].bias == cfg.model.head.init_bias)
