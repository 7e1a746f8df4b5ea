"""The VoxelNet dense middle forms of futuredet_torch against the JAX
package: the masked dense stages (`middle_dense_from_stage`,
`middle_dense_dtype`: `DenseConv3d`, `DenseBasicBlock`, the hybrid
encoder), the `middle="dense"` detector (`_dense_path`), its weight
bridge, and the FCFS `voxelize` buffers.

The encoder cases are those of `tests/test_dense_middle.py` (a (6, 16, 16)
grid, channels (4, 8, 8, 16), 90 sites), weights bridged from the JAX
init by `flax_to_state_dict`. Dense forms sum in another order than the
sparse gathers: 2e-4 as the JAX package's own test, 5e-4 for train-mode
BatchNorm statistics."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.middle import DenseBasicBlock as JaxDenseBlock
from futuredet_tpu.models.middle import DenseConv3d as JaxDenseConv3d
from futuredet_tpu.models.middle import \
    SparseMiddleEncoder as JaxSparseMiddleEncoder
from futuredet_tpu.ops import voxelize as jax_voxelize
from futuredet_torch import config as port_config
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.middle import (SparseBasicBlock, SparseConv,
                                           SparseMiddleEncoder)
from futuredet_torch.ops.voxelize import voxelize
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from futuredet_torch.utils.native import voxelize_native
from tests.test_torch_voxelnet import voxelnet_config

DIMS = (6, 16, 16)
CH = (4, 8, 8, 16)
VMAX = (256, 256, 128, 64)
ATOL = RTOL = 2e-4
TRAIN_TOL = 5e-4
# bf16 operands, products summed in fp32, on both sides: the sums' order
BF16_SAME_TOL = 1e-4
BF16_VS_FP32 = 5e-2       # the JAX package's dense bf16 against fp32


def _scene(seed, n=90, V=256):
    """tests/test_dense_middle.py::_scene: n distinct sites padded to V."""
    rng = np.random.default_rng(seed)
    lin = rng.choice(np.prod(DIMS), n, replace=False)
    coords = np.zeros((V, 3), np.int32)
    coords[:n] = np.stack([lin // (DIMS[1] * DIMS[2]),
                           (lin // DIMS[2]) % DIMS[1], lin % DIMS[2]], -1)
    valid = np.zeros(V, bool)
    valid[:n] = True
    feats = np.zeros((V, 5), np.float32)
    feats[:n] = rng.normal(size=(n, 5)).astype(np.float32)
    return feats, coords, valid, n


def _port_cfg():
    cfg = voxelnet_config(port_config)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 middle_channels=CH))


def _jax_middle(**kw):
    return JaxSparseMiddleEncoder(channels=CH, vmax=VMAX, grid_zyx=DIMS,
                                  **kw)


def _port_middle(variables, **kw):
    enc = SparseMiddleEncoder(5, CH, DIMS, **kw).eval()
    sd = flax_to_state_dict({k: {"middle": t} for k, t in variables.items()},
                            _port_cfg())
    enc.load_state_dict({k.removeprefix("backbone."): t
                         for k, t in sd.items()}, strict=True)
    return enc


@pytest.fixture(scope="module")
def middle_vars():
    """JAX-init encoder variables with random BN statistics and affines,
    so that every stage's ReLU cuts."""
    feats, coords, valid, _ = _scene(0)
    v = jax.device_get(_jax_middle().init(jax.random.PRNGKey(0), feats,
                                          coords, valid))
    v = jax.tree.map(np.array, v)
    rng = np.random.default_rng(5)
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape)
                     if path[-1].key == "var"
                     else rng.normal(0, 0.1, leaf.shape))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        if path[-1].key in ("scale", "bias"):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(leaf.dtype)
    return v


def _port_in(seed):
    feats, coords, valid, n = _scene(seed)
    return (torch.from_numpy(feats[:n]), torch.from_numpy(coords[:n]),
            None, 1)


@pytest.mark.parametrize("stride,pads,dtype", [
    (1, (1, 1, 1), None), (2, (0, 1, 1), None), (2, (1, 1, 1), None),
    (1, (1, 1, 1), "bfloat16")])
def test_dense_conv3d_matches_jax(stride, pads, dtype):
    rng = np.random.default_rng(1)
    canvas = rng.normal(size=DIMS + (6,)).astype(np.float32)
    canvas[rng.random(DIMS) < 0.6] = 0.0
    jd = jnp.bfloat16 if dtype else None
    mod = JaxDenseConv3d(8, stride=stride, pads=pads, compute_dtype=jd)
    v = jax.device_get(mod.init(jax.random.PRNGKey(2), canvas))
    bias = rng.normal(size=8).astype(np.float32)
    v = {"params": {"kernel": v["params"]["kernel"], "bias": bias}}
    want = np.asarray(mod.apply(v, canvas))
    conv = SparseConv(6, 8)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(
            v["params"]["kernel"])).reshape(3, 3, 3, 6, 8))
        conv.bias.copy_(torch.from_numpy(bias))
        got = conv.dense(torch.from_numpy(canvas).permute(3, 0, 1, 2)[None],
                         stride, pads,
                         torch.bfloat16 if dtype else None)
    got = got[0].permute(1, 2, 3, 0).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("train", [False, True])
def test_dense_basic_block_matches_jax(train):
    rng = np.random.default_rng(3)
    mask = rng.random(DIMS) < 0.4
    canvas = np.where(mask[..., None], rng.normal(size=DIMS + (8,)),
                      0.0).astype(np.float32)
    mod = JaxDenseBlock(8)
    v = jax.tree.map(np.array, jax.device_get(
        mod.init(jax.random.PRNGKey(4), canvas, mask)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v):
        if path[-1].key in ("mean", "bias"):
            leaf[...] = rng.normal(0, 0.2, leaf.shape)
        elif path[-1].key in ("var", "scale"):
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
    if train:
        want, mut = mod.apply(v, canvas, mask, True, mutable=["batch_stats"])
    else:
        want = mod.apply(v, canvas, mask)
    block = SparseBasicBlock(8)
    p, s = v["params"], v["batch_stats"]
    with torch.no_grad():
        for cn, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            conv = getattr(block, cn)
            conv.weight.copy_(torch.from_numpy(
                np.asarray(p[cn]["kernel"])).reshape(3, 3, 3, 8, 8))
            conv.bias.copy_(torch.from_numpy(np.asarray(p[cn]["bias"])))
            b = getattr(block, bn)
            b.weight.copy_(torch.from_numpy(np.asarray(p[bn]["scale"])))
            b.bias.copy_(torch.from_numpy(np.asarray(p[bn]["bias"])))
            b.running_mean.copy_(torch.from_numpy(np.asarray(s[bn]["mean"])))
            b.running_var.copy_(torch.from_numpy(np.asarray(s[bn]["var"])))
    block.train(train)
    with torch.no_grad():
        got = block.dense(torch.from_numpy(canvas).permute(3, 0, 1, 2)[None],
                          torch.from_numpy(mask)[None])
    got = got[0].permute(1, 2, 3, 0).numpy()
    tol = TRAIN_TOL if train else ATOL
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)
    assert (got[~mask] == 0).all()
    if train:
        for bn in ("bn1", "bn2"):
            b = getattr(block, bn)
            for ours, theirs in (("running_mean", "mean"),
                                 ("running_var", "var")):
                np.testing.assert_allclose(
                    getattr(b, ours).numpy(),
                    np.asarray(mut["batch_stats"][bn][theirs]),
                    atol=TRAIN_TOL, rtol=TRAIN_TOL)


@pytest.mark.parametrize("dense_from", [0, 1, 2, 3])
def test_hybrid_middle_matches_jax(middle_vars, dense_from):
    feats, coords, valid, _ = _scene(0)
    want, zm_want = _jax_middle(dense_from_stage=dense_from).apply(
        middle_vars, feats, coords, valid)
    enc = _port_middle(middle_vars, dense_from_stage=dense_from)
    sparse = _port_middle(middle_vars)
    with torch.no_grad():
        got, zm = enc(*_port_in(0))
        ref, _ = sparse(*_port_in(0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(zm[0].numpy(), np.asarray(zm_want))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
    # a dense stage's active cells are the sparse stage's sites
    assert enc.site_counts == sparse.site_counts


def test_dense_train_mode_bn_stats_match_jax(middle_vars):
    feats, coords, valid, _ = _scene(2)
    (want, _), mut = _jax_middle(dense_from_stage=2).apply(
        middle_vars, feats, coords, valid, True, mutable=["batch_stats"])
    enc = _port_middle(middle_vars, dense_from_stage=2).train()
    with torch.no_grad():
        got, _ = enc(*_port_in(2))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    sd = flax_to_state_dict({"params": {"middle": middle_vars["params"]},
                             "batch_stats": {"middle": mut["batch_stats"]}},
                            _port_cfg())
    got_sd = enc.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20        # 5 BatchNorms a stage
    for k in stats:
        np.testing.assert_allclose(got_sd[k.removeprefix("backbone.")],
                                   sd[k], atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=k)


def test_dense_bf16_matches_jax(middle_vars):
    feats, coords, valid, _ = _scene(3)
    want, _ = _jax_middle(dense_from_stage=1,
                          dense_dtype=jnp.bfloat16).apply(
        middle_vars, feats, coords, valid)
    fp32, _ = _jax_middle().apply(middle_vars, feats, coords, valid)
    enc = _port_middle(middle_vars, dense_from_stage=1,
                       dense_dtype=torch.bfloat16)
    with torch.no_grad():
        got, _ = enc(*_port_in(3))
    got = got[0].numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=BF16_SAME_TOL,
                               rtol=BF16_SAME_TOL)
    np.testing.assert_allclose(got, np.asarray(fp32), atol=BF16_VS_FP32,
                               rtol=BF16_VS_FP32)


@pytest.mark.parametrize("dense_from", [0, 2])
def test_dense_stages_train_through_autograd(middle_vars, dense_from):
    """The dense tail's gradients (plain autograd) equal the sparse path's
    (K2's Function; held to the JAX step elsewhere) in train mode."""
    rng = np.random.default_rng(6)
    grads, r = [], None
    for kw in ({}, {"dense_from_stage": dense_from}):
        enc = _port_middle(middle_vars, **kw).train()
        out, _ = enc(*_port_in(1))
        if r is None:
            r = torch.from_numpy(rng.normal(size=out.shape).astype(
                np.float32))
        (out * r).sum().backward()
        grads.append({n: p.grad for n, p in enc.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(grads[1][n].numpy(), g.numpy(),
                                   atol=TRAIN_TOL * scale, rtol=TRAIN_TOL,
                                   err_msg=n)


# ---------------------------------------------------------------- detector

def dense_config(mod):
    cfg = voxelnet_config(mod)
    return cfg.replace(model=dataclasses.replace(cfg.model, middle="dense"))


def lattice_scene(cfg, seed, B=1):
    """Points on a 2^-4 m lattice: the JAX segment sums and the port's
    run sums of the voxel means then agree exactly."""
    rng = np.random.default_rng(seed)
    P = cfg.voxel.max_points
    pts = np.concatenate([rng.uniform(-16, 16, (B, P, 2)),
                          rng.uniform(-3, 3, (B, P, 1)),
                          rng.uniform(0, 1, (B, P, 2))], -1)
    pts = (np.round(pts * 16) / 16).astype(np.float32)
    return pts, rng.random((B, P)) < 0.9


@pytest.fixture(scope="module")
def dense_run():
    cfg_j = dense_config(jax_config)
    model = jax_build(cfg_j)
    pts, valid = lattice_scene(cfg_j, 0, B=2)
    variables = jax.tree.map(np.array, jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid))))
    rng = np.random.default_rng(1)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["batch_stats"]):
        leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape)
                     if path[-1].key == "var"
                     else rng.normal(0, 0.1, leaf.shape))
    variables["params"]["voxel_embed"]["bias"][:] = rng.normal(0, 0.1, 32)
    preds = jax.device_get(model.apply(variables, jnp.asarray(pts),
                                       jnp.asarray(valid)))
    return dict(variables=variables, pts=pts, valid=valid, preds=preds)


def test_dense_path_matches_jax(dense_run):
    cfg = dense_config(port_config)
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(dense_run["variables"], cfg),
                          strict=True)
    with torch.no_grad():
        preds = model(torch.from_numpy(dense_run["pts"]),
                      torch.from_numpy(dense_run["valid"]))
    assert not hasattr(model, "backbone") and len(model.num_voxels) == 2
    for t, (p, jp) in enumerate(zip(preds, dense_run["preds"])):
        for k in jp:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=f"task {t} {k}")


def test_dense_bridge_round_trip(dense_run):
    """flax -> state_dict -> the port's module and back: every tensor of
    the dense detector bit for bit, in the torch layouts."""
    cfg = dense_config(port_config)
    variables = dense_run["variables"]
    sd = flax_to_state_dict(variables, cfg)
    model = build_detector(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    p, s = variables["params"], variables["batch_stats"]
    np.testing.assert_array_equal(got["voxel_embed.weight"].numpy(),
                                  p["voxel_embed"]["kernel"].T)
    np.testing.assert_array_equal(
        got["mid_conv1.0.weight"].numpy(),
        np.transpose(p["mid_conv1"]["Conv_0"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(got["mid_conv0.1.running_var"].numpy(),
                                  s["mid_conv0"]["BatchNorm_0"]["var"])


def test_dense_path_trains():
    """middle="dense" trains through plain autograd: a finite loss and a
    gradient on every parameter."""
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.train.step import make_optimizer, train_step
    cfg = dense_config(port_config)
    model = build_detector(cfg, device="cpu").train()
    opt = make_optimizer(cfg, model, 10)
    batch = make_batch(cfg, 2, seed=0, n_objects=4, n_clutter=3000,
                       clutter_mode="lidar")
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in batch.items()}
    m = train_step(model, opt, batch, 0)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(p.grad is not None for p in model.parameters())


# --------------------------------------------------------------- voxelize

@pytest.mark.parametrize("max_voxels", [3000, 700])
def test_fcfs_voxelize_bit_for_bit(max_voxels):
    """The (V, K, F) buffers equal the JAX `voxelize`'s bit for bit; where
    no voxel is dropped they are `voxelize_native`'s voxels in ascending
    id order (the native kernel keeps first-appearance order)."""
    rng = np.random.default_rng(max_voxels)
    P = 4000
    pts = np.concatenate([rng.uniform(-8, 8, (P, 2)),
                          rng.uniform(-2, 2, (P, 1)),
                          rng.uniform(0, 1, (P, 2))], -1).astype(np.float32)
    pts[:P // 2, :3] = np.round(pts[:P // 2, :3] * 2) / 2   # shared cells
    valid = rng.random(P) < 0.9
    pc, vs, grid = (-8., -8., -2., 8., 8., 2.), (0.5, 0.5, 0.5), (32, 32, 8)
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(valid), pc, vs,
                   grid_size=grid, max_voxels=max_voxels, max_points=5)
    want = jax_voxelize.voxelize(jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.asarray(pc), jnp.asarray(vs),
                                 grid_size=grid, max_voxels=max_voxels,
                                 max_points=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = int(got.num_voxels)
    nv, nc, nn = voxelize_native(pts[valid], vs, pc, 5, 10 ** 6)
    if len(nv) <= max_voxels:
        order = np.argsort((nc[:, 0] * grid[1] + nc[:, 1]) * grid[0]
                           + nc[:, 2])
        assert n == len(nv)
        np.testing.assert_array_equal(got.voxels[:n].numpy(), nv[order])
        np.testing.assert_array_equal(got.coords[:n].numpy(), nc[order])
        np.testing.assert_array_equal(got.num_points[:n].numpy(),
                                      nn[order])
    else:
        assert n == max_voxels
