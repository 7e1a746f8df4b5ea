"""futuredet_torch RPN / ConvBNReLU / DeconvBNReLU vs the flax modules, with
the same weights through the port's bridge (`flax_to_state_dict`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.config import RPNConfig
from futuredet_tpu.models.backbone2d import RPN as JaxRPN
from futuredet_torch.config import get_config
from futuredet_torch.models.backbone2d import RPN
from futuredet_torch.models.detector import build_detector
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict

# fp32 convs sum in another order in XLA:CPU and oneDNN
ATOL = RTOL = 1e-4


def randomize(tree, rng):
    """Random BN statistics, BN affine and biases; kernels keep their
    variance-preserving init so activations stay O(1) through the stack."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            return np.asarray(x)
        a = rng.normal(0, 0.2, np.shape(x)).astype(np.float32)
        if "'var'" in name:
            return np.abs(a) + 0.5
        return a + 1.0 if "'scale'" in name else a
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


def strip(sd, prefix):
    return {k.removeprefix(prefix): v for k, v in sd.items()
            if k.startswith(prefix)}


# the pillar RPN shape family at small width: a stride-2 conv deblock
# (us_stride 0.5), a 1x1 deblock and a transpose-conv deblock
SMALL_PP_RPN = RPNConfig(layer_nums=(1, 1, 1), ds_strides=(2, 2, 2),
                         ds_filters=(8, 16, 32), us_strides=(0.5, 1, 2),
                         us_filters=(8, 8, 8), in_channels=8)


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_matches_flax(seed):
    r = SMALL_PP_RPN
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 32, 32, r.in_channels)).astype(np.float32)
    jrpn = JaxRPN(layer_nums=r.layer_nums, ds_strides=r.ds_strides,
                  ds_filters=r.ds_filters, us_strides=r.us_strides,
                  us_filters=r.us_filters)
    variables = randomize(jrpn.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                          rng)
    want = np.asarray(jrpn.apply(variables, jnp.asarray(x)))

    cfg = get_config("pp_forecast_n3dtf")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, rpn=r))
    sd = flax_to_state_dict({"params": {"neck": variables["params"]},
                             "batch_stats": {"neck":
                                             variables["batch_stats"]}}, cfg)
    rpn = RPN(r.in_channels, layer_nums=r.layer_nums,
              ds_strides=r.ds_strides, ds_filters=r.ds_filters,
              us_strides=r.us_strides, us_filters=r.us_filters)
    rpn.load_state_dict(strip(sd, "neck."), strict=True)
    rpn.eval()
    with torch.no_grad():
        got = rpn(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, 24)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_deconv_bridge_undoes_the_tap_flip():
    """flax ConvTranspose (k == stride) with a kernel run through the
    bridge equals torch ConvTranspose2d: the flip lives on the flax side."""
    import flax.linen as fnn
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 4, 4, 3)).astype(np.float32)
    k = rng.normal(0, 1, (2, 2, 3, 5)).astype(np.float32)
    want = np.asarray(fnn.ConvTranspose(5, (2, 2), strides=(2, 2),
                                        use_bias=False).apply(
        {"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x)))
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(k[::-1, ::-1], (2, 3, 0, 1))))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


def test_entry_points_refuse_what_is_not_ported():
    cfg = get_config("pp_forecast_n3dtf")
    vox = get_config("forecast_n3dtf")
    with pytest.raises(NotImplementedError):
        build_detector(vox.replace(model=dataclasses.replace(
            vox.model, middle="dense")), device="cpu")
    with pytest.raises(NotImplementedError):
        build_detector(get_config("pp_forecast_n3dtf_two_stage"),
                       device="cpu")
    with pytest.raises(NotImplementedError):
        build_detector(cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16")), device="cpu")
    with pytest.raises(NotImplementedError):
        build_detector(get_config("pp_forecast_n3dtfm"), device="cpu")
    with pytest.raises(NotImplementedError):
        build_detector(get_config("pp_centerpoint_multitask"), device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector(get_config("pp_forecast_n3dtf"))


def test_config_copy_is_identical():
    from futuredet_tpu import config as jc
    from futuredet_torch import config as tc
    assert tc.CONFIG_NAMES == jc.CONFIG_NAMES
    for name in jc.CONFIG_NAMES:
        a = dataclasses.asdict(jc.get_config(name))
        b = dataclasses.asdict(tc.get_config(name))
        assert a == b, name
        assert (dataclasses.asdict(jc.tiny_variant(jc.get_config(name)))
                == dataclasses.asdict(tc.tiny_variant(tc.get_config(name))))


@pytest.mark.parametrize("cin,stride,bias", [(256, 1, False), (200, 2, True),
                                             (64, 1, True)])
def test_split_input_conv_is_a_conv(cin, stride, bias):
    """The RPN stem's conv, run over 128-channel input groups, computes
    Conv2d's function with Conv2d's parameters (fp32 sums regrouped:
    atol 1e-5)."""
    from futuredet_torch.models.layers import SplitInputConv2d
    torch.manual_seed(0)
    ref = torch.nn.Conv2d(cin, 32, 3, stride=stride, padding=0, bias=bias)
    split = SplitInputConv2d(cin, 32, 3, stride=stride, padding=0, bias=bias)
    split.load_state_dict(ref.state_dict())
    x = torch.randn(2, cin, 15, 13)
    with torch.no_grad():
        torch.testing.assert_close(split(x), ref(x), rtol=0, atol=1e-5)
