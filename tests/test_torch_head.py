"""futuredet_torch CenterHead (dense + forecast_feature, 7 chained SepHeads)
vs the flax CenterHead, same weights through the port's bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from futuredet_tpu.config import HeadConfig
from futuredet_tpu.models.center_head import CenterHead as JaxCenterHead
from futuredet_torch.config import get_config
from futuredet_torch.models.center_head import CenterHead
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict

# four chained 3x3 convs per head and seven heads deep: fp32 summation
# order differs between XLA:CPU and oneDNN
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


HEAD = HeadConfig(in_channels=24, share_conv_channel=16, timesteps=7,
                  dense=True, forecast_feature=True)


def test_center_head_dense_forecast_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 16, 16, HEAD.in_channels)).astype(np.float32)
    jh = JaxCenterHead(cfg=HEAD)
    variables = randomize(jh.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                          rng)
    want = jax.device_get(jh.apply(variables, jnp.asarray(x)))

    cfg = get_config("pp_forecast_n3dtf")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, head=HEAD))
    sd = flax_to_state_dict({"params": {"head": variables["params"]},
                             "batch_stats": {"head":
                                             variables["batch_stats"]}}, cfg)
    head = CenterHead(HEAD)
    head.load_state_dict({k.removeprefix("bbox_head."): v
                          for k, v in sd.items()}, strict=True)
    head.eval()
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 7
    for t, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"feats", "reg", "height", "dim", "rot",
                                    "vel", "hm"}
        for k in w:
            assert g[k].shape == w[k].shape, (t, k)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"task {t} {k}")


def test_seeded_init_sets_hm_bias_and_repeats():
    from futuredet_torch.config import tiny_variant
    from futuredet_torch.models.detector import build_detector
    cfg = tiny_variant(get_config("pp_forecast_n3dtf"))
    a = build_detector(cfg, device="cpu", seed=3)
    for t in a.bbox_head.tasks:
        assert torch.all(t.hm[-1].bias == cfg.model.head.init_bias)
        assert torch.all(t.reg[-1].bias == 0)
    b = build_detector(cfg, device="cpu", seed=3).state_dict()
    c = build_detector(cfg, device="cpu", seed=4).state_dict()
    for k, v in a.state_dict().items():
        assert torch.equal(v, b[k]), k
    w = "bbox_head.shared_conv.0.weight"
    assert not torch.equal(b[w], c[w])
