"""Eval BatchNorm folded into the conv before it (`models/layers.py::Stack`,
`BatchNorm2d.fold`): the folded block against the unfolded one
(`nn.Sequential.forward`, every layer called in turn) on calibrated,
non-unit statistics; the cache against every change of its sources; the
paths that must not fold (training, `compute_dtype`, autograd recording)
bit for bit; and the whole tiny detectors, whose every BatchNorm2d folds.
Imports nothing of JAX. The `cuda` tests run a full-width scene of each
stream configuration on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_bn_fold.py
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from futuredet_torch.config import get_config, tiny_variant  # noqa: E402
from futuredet_torch.models import layers  # noqa: E402
from futuredet_torch.models.layers import (  # noqa: E402
    BandPad2d, BatchNorm2d, ConvBNReLU, DeconvBNReLU, SplitInputConv2d,
    Stack, conv_bn_relu)

# of the unfolded output's largest |value|
RTOL = 1e-5


def split_stem(**cd):
    """The RPN's stem: pad, a stride-2 unpadded conv over 192 inputs (two
    input groups of SplitInputConv2d), then a 3x3 conv."""
    block = Stack(BandPad2d(1, 3, 2),
                  *conv_bn_relu(192, 16, 3, 2, bias=False, padding=0,
                                conv=SplitInputConv2d, **cd),
                  *conv_bn_relu(16, 16, 3, 1, bias=False, **cd))
    block[1].after_band_pad = True
    return block


# kind -> (block maker, input channels)
BLOCKS = {
    "conv_bias": (lambda **cd: ConvBNReLU(8, 16, 3, 1, bias=True, **cd), 8),
    "conv_no_bias": (lambda **cd: ConvBNReLU(8, 16, 3, 2, bias=False, **cd),
                     8),
    "split_stem": (split_stem, 192),
    "deblock_1x1": (lambda **cd: ConvBNReLU(16, 8, 1, 1, bias=False, **cd),
                    16),
    "deblock_transposed": (lambda **cd: DeconvBNReLU(16, 8, 2, **cd), 16),
}


def bns(module):
    return [m for m in module.modules() if isinstance(m, BatchNorm2d)]


@torch.no_grad()
def calibrate_(block, x, seed):
    """Each BatchNorm's running statistics those of its input on x (as the
    benchmark calibrates them), its variance scaled by 0.5-2 and its
    affine drawn away from 1 and 0; conv biases nonzero."""
    g = torch.Generator().manual_seed(seed)
    for m in block:
        if isinstance(m, BatchNorm2d):
            c = m.num_features
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m.running_mean.copy_(mean)
            m.running_var.copy_(var * (0.5 + 1.5 * torch.rand(c, generator=g)))
            m.weight.copy_(0.5 + torch.rand(c, generator=g))
            m.bias.copy_(0.3 * torch.randn(c, generator=g))
        elif getattr(m, "bias", None) is not None:
            m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=g))
        x = m(x) if not isinstance(m, BatchNorm2d) else m.eval()(x)


def make(kind, seed=0, **cd):
    maker, cin = BLOCKS[kind]
    torch.manual_seed(seed)
    block = maker(**cd)
    x = torch.randn(2, cin, 12, 12, generator=torch.Generator().manual_seed(
        seed + 1))
    calibrate_(block, x, seed)
    return block.eval(), x


def unfolded(block, x):
    """The block as nn.Sequential runs it: each layer called in turn."""
    return nn.Sequential.forward(block, x)


def counted(fn):
    """fn()'s result and the (folded, fold_builds) it added."""
    f0, b0 = layers.folded, layers.fold_builds
    out = fn()
    return out, (layers.folded - f0, layers.fold_builds - b0)


def close(got, want):
    err = float((got - want).abs().max())
    return err <= RTOL * float(want.abs().max()), err


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_the_folded_block_equals_the_unfolded_one(kind):
    block, x = make(kind)
    n = len(bns(block))
    with torch.no_grad():
        want = unfolded(block, x)
        got, (folds, builds) = counted(lambda: block(x))
        again, (folds2, builds2) = counted(lambda: block(x))
    assert (folds, builds, folds2, builds2) == (n, n, n, 0)
    ok, err = close(got, want)
    assert ok, err
    assert torch.equal(again, got)


def load_other(block, kind):
    block.load_state_dict(make(kind, seed=5)[0].state_dict())


def scale_var(block, kind):
    with torch.no_grad():
        bns(block)[0].running_var.mul_(2.0)


def adamw_step(block, kind):
    opt = torch.optim.AdamW(block.parameters(), lr=0.05)
    x = make(kind, seed=7)[1]
    block(x).square().mean().backward()
    opt.step()


def train_forward(block, kind):
    block.train()
    with torch.no_grad():
        block(make(kind, seed=9)[1] + 0.5)
    block.eval()


def to_float64(block, kind):
    block.to(torch.float64)


def swap_data(block, kind):
    """A conv weight given new storage, its identity and version kept."""
    conv = next(m for m in block if hasattr(m, "compute_dtype")
                and not isinstance(m, BatchNorm2d))
    conv.weight.data = conv.weight.data * 1.5


STALE = {"load_state_dict": load_other, "running_var.mul_": scale_var,
         "adamw": adamw_step, "train_then_eval": train_forward,
         "to": to_float64, "weight.data": swap_data}


@pytest.mark.parametrize("change", list(STALE))
@pytest.mark.parametrize("kind", ["conv_bias", "split_stem",
                                  "deblock_transposed"])
def test_the_fold_follows_every_change_of_its_sources(kind, change):
    block, x = make(kind)
    n = len(bns(block))
    with torch.no_grad():
        before, (_, builds) = counted(lambda: block(x))
    assert builds == n
    STALE[change](block, kind)
    x = x.to(bns(block)[0].weight.dtype)
    with torch.no_grad():
        want = unfolded(block, x)
        got, (folds, builds) = counted(lambda: block(x))
    assert folds == n and builds >= 1
    ok, err = close(got, want)
    assert ok, err
    assert float((got - before).abs().max()) > 100 * err


BYPASS = ("training", "compute_dtype", "grad_enabled")


@pytest.mark.parametrize("path", BYPASS)
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_paths_that_do_not_fold_run_as_before(kind, path):
    cd = {"compute_dtype": torch.bfloat16} if path == "compute_dtype" else {}
    block, x = make(kind, **cd)
    if path == "training":
        block.train()
    twin = copy.deepcopy(block)
    with torch.set_grad_enabled(path != "compute_dtype"):
        got, (folds, builds) = counted(lambda: block(x))
        want = unfolded(twin, x)
    assert (folds, builds) == (0, 0)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if path == "training":
        for a, b in zip(bns(block), bns(twin)):
            assert torch.equal(a.running_var, b.running_var)


@pytest.fixture(scope="module", params=["forecast_n3dtf",
                                        "pp_forecast_n3dtf"])
def tiny(request):
    """A tiny stream detector, every BatchNorm2d given non-unit
    statistics, and a scene."""
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.models.detector import build_detector
    cfg = tiny_variant(get_config(request.param))
    model = build_detector(cfg, "cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in bns(model):
            c = m.num_features
            m.running_mean.copy_(0.2 * torch.randn(c, generator=g))
            m.running_var.copy_(0.5 + torch.rand(c, generator=g))
            m.weight.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
            m.bias.copy_(0.1 * torch.randn(c, generator=g))
    batch = make_batch(cfg, 1, seed=3)
    return model, (torch.as_tensor(batch["points"]),
                   torch.as_tensor(batch["points_valid"]))


def test_every_batchnorm2d_of_a_tiny_detector_folds(tiny):
    model, inputs = tiny
    keys = list(model.state_dict())
    params = [(n, id(p)) for n, p in model.named_parameters()]
    n = len(bns(model))
    counts = []
    with torch.no_grad():
        for _ in range(3):
            got, c = counted(lambda: model(*inputs))
            counts.append(c)
    assert counts == [(n, n), (n, 0), (n, 0)]
    assert list(model.state_dict()) == keys
    assert [(k, id(p)) for k, p in model.named_parameters()] == params
    want, (folds, _) = counted(lambda: model(*inputs))
    assert folds == 0
    for g, w in zip(got, want):
        for k in w:
            err = float((g[k] - w[k].detach()).abs().max())
            assert err <= RTOL * max(1.0, float(w[k].detach().abs().max())), k


def test_a_train_step_folds_nothing():
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import make_optimizer, train_step
    cfg = tiny_variant(get_config("pp_forecast_n3dtf"))
    model = build_detector(cfg, "cpu", seed=0).train()
    batch = make_batch(cfg, 1, seed=2)
    batch = {k: batch[k] for k in ("points", "points_valid", "targets_raw")}
    _, c = counted(lambda: train_step(model, make_optimizer(cfg, model, 4),
                                      batch, 0))
    assert c == (0, 0)


# --- on the card: a full-width scene of each stream configuration --------

# conv + BatchNorm2d pairs of a full-width scene: the head's 57 (shared_conv
# and 7 forecast SepHeads of 2 forecast convs and 6 towers), and the neck's
# 15 (VoxelNet: 6 + 6 convs, 2 deblocks, z_crush) or 19 (pillars: 4 + 6 + 6,
# 3 deblocks)
FULL_FOLDS = {"forecast_n3dtf": 72, "pp_forecast_n3dtf": 76}
# the same detections: scores, and boxes in m and m/s; the yaw, atan2 of two
# maps within RTOL, in rad
SCORE_ATOL, BOX_ATOL, YAW_ATOL = 1e-5, 1e-3, 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FULL_FOLDS))
def test_a_full_width_scene_runs_no_batchnorm_kernel(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(name)
    model = build_detector(cfg, "cuda", seed=0)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in bns(model):
            c = m.num_features
            m.running_mean.copy_(0.2 * torch.randn(c, generator=g))
            m.running_var.copy_(0.5 + torch.rand(c, generator=g))
            m.weight.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
            m.bias.copy_(0.1 * torch.randn(c, generator=g))
    assert len(bns(model)) == FULL_FOLDS[name]
    pts, valid = (torch.from_numpy(a).cuda() for a in chip_smoke.scene_lidar(
        cfg, np.random.default_rng(6)))
    with torch.no_grad():
        model(pts, valid)                      # builds the folds
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got, counts = counted(lambda: model(pts, valid))
            torch.cuda.synchronize()
        det = decode_and_nms(cfg, got)
    assert counts == (FULL_FOLDS[name], 0)
    kernels = {e.key for e in prof.key_averages()}
    assert not [k for k in kernels if "bn_fw_inf" in k], sorted(kernels)
    want, (folds, _) = counted(lambda: model(pts, valid))
    assert folds == 0
    want = [{k: v.detach() for k, v in w.items()} for w in want]
    with torch.no_grad():
        ref = decode_and_nms(cfg, want)
    for g, w in zip(got, want):
        for k in w:
            err = float((g[k] - w[k]).abs().max())
            assert err <= RTOL * max(1.0, float(w[k].abs().max())), (k, err)
    assert torch.equal(det.valid, ref.valid)
    # the same detections, paired by centre within a label: two of nearly
    # equal score may take each other's slots
    got_b, ref_b = det.boxes[det.valid], ref.boxes[ref.valid]
    dist = torch.cdist(got_b[:, :2], ref_b[:, :2])
    dist += 1e9 * (det.labels[det.valid][:, None]
                   != ref.labels[ref.valid][None, :])
    pair = dist.argmin(1)
    assert torch.equal(pair.sort().values,
                       torch.arange(len(pair), device=pair.device))
    assert torch.allclose(det.scores[det.valid], ref.scores[ref.valid][pair],
                          rtol=0.0, atol=SCORE_ATOL)
    gap = (got_b - ref_b[pair]).abs()
    gap[:, 8] = torch.remainder(gap[:, 8] + torch.pi, 2 * torch.pi) - torch.pi
    gap = gap.abs().amax(0).tolist()
    assert max(gap[:8]) <= BOX_ATOL and gap[8] <= YAW_ATOL, gap
