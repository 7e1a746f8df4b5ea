"""The bf16 serving mode of futuredet_torch against the JAX package: K2's
bf16 family (its plain version against the JAX `loop` contraction in
compute dtype bf16), the bf16 layers and towers (`compute_dtype`), the
sparse knobs (`middle_sparse_dtype` "bfloat16" and "bf16_packed",
`middle_gather_algo="window_bf16"` at B = 1 and B = 2) and the dense
middle stages inside the whole VoxelNet detector, and a train step under
each bf16 knob (held to the JAX step by tests/test_torch_train_bf16_*.py).

The VoxelNet cases run the tiny forecast_n3dtf of
`tests/test_torch_voxelnet.py` with middle channels (8, 16, 64, 64), so
that the stages the JAX package packs bf16 pairs at (128 < 3 * Cin <= 256)
exist; one JAX init serves them all. Tolerances: bf16 towers and inputs
against the JAX bf16 forward, 0.05 of max(1, max|ref|) on every head map
(the JAX package's own, tests/test_models.py:126-151); an fp32-exact
knob, the fp32 parity of tests/test_torch_voxelnet.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.layers import ConvBNReLU as JaxConvBNReLU
from futuredet_tpu.models.layers import DeconvBNReLU as JaxDeconvBNReLU
from futuredet_tpu.ops.sparse_conv import _gather_conv
from futuredet_torch import config as port_config
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.layers import ConvBNReLU, DeconvBNReLU
from futuredet_torch.ops.pallas_gather import (COUTS, gather_conv,
                                               gather_conv_plain, k2_route)
from futuredet_torch.ops.sparse_conv import (bf16_truncate, make_grid,
                                             neighbor_table,
                                             downsample_coords, out_dims_of,
                                             strided_gather_table)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_pipeline import tiny_scene
from tests.test_torch_train_step import jax_variables
from tests.test_torch_voxelnet import scene, voxelnet_config

K2_RTOL = 1e-5            # K2's plain bf16 version vs JAX: the sums' order
BF16_RTOL = 0.05          # of max(1, max|ref|): bf16 towers against bf16
# of max(1, max|ref|): bf16-rounded conv inputs under fp32 towers, where an
# fp32 difference upstream can flip the rounding of an input (3.6e-5 to
# 6.6e-5 seen)
BF16_INPUT_RTOL = 1e-3
FP32_ATOL = FP32_RTOL = 1e-4
CHANNELS = (8, 16, 64, 64)
# the knobs of each VoxelNet case and its batch size
CASES = {
    "bf16": (dict(compute_dtype="bfloat16",
                  middle_sparse_dtype="bfloat16"), 1),
    "window_bf16": (dict(middle_gather_algo="window_bf16"), 1),
    "window_bf16_b2": (dict(middle_gather_algo="window_bf16"), 2),
    "bf16_packed": (dict(middle_sparse_dtype="bf16_packed"), 1),
    "dense_from2": (dict(middle_dense_from_stage=2), 1),
    "dense_from2_bf16": (dict(middle_dense_from_stage=2,
                              middle_dense_dtype="bfloat16"), 1),
}
# the tolerance of each case: fp32 arithmetic (window_bf16 at B = 2 is
# `loop`), bf16 inputs of the middle's convs, or bf16 towers
CASE_RTOL = {"bf16": BF16_RTOL, "window_bf16": BF16_INPUT_RTOL,
             "window_bf16_b2": None, "bf16_packed": BF16_INPUT_RTOL,
             "dense_from2": None, "dense_from2_bf16": BF16_INPUT_RTOL}


# ------------------------------------------------------------------- K2

def _sites(seed, n=600, dims=(8, 16, 16)):
    rng = np.random.default_rng(seed)
    lin = rng.choice(int(np.prod(dims)), n, replace=False)
    coords = np.stack([lin // (dims[1] * dims[2]), (lin // dims[2])
                       % dims[1], lin % dims[2]], -1)
    return make_grid(torch.from_numpy(coords), dims)[0], dims


@pytest.mark.parametrize("kind", ["subm", "strided"])
@pytest.mark.parametrize("cin", [5, 16, 64])
def test_bf16_plain_matches_jax_loop(cin, kind):
    """K2's plain bf16 version == `_gather_conv(..., bf16, "loop")`: bf16
    rows and weights, products and sums in fp32."""
    grid, dims = _sites(cin)
    if kind == "subm":
        table = neighbor_table(grid, dims)
    else:
        out = downsample_coords(grid, out_dims_of(dims, (1, 1, 1)))
        table = strided_gather_table(grid, out, dims)
    rng = np.random.default_rng(7)
    cout = 32
    x = rng.normal(size=(len(grid.ids), cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    want = np.asarray(_gather_conv(jnp.asarray(x), jnp.asarray(table),
                                   jnp.asarray(w), jnp.asarray(b),
                                   jnp.bfloat16, "loop"))
    got = gather_conv(torch.from_numpy(x).bfloat16(), table,
                      torch.from_numpy(w).bfloat16(), torch.from_numpy(b))
    assert got.dtype == torch.float32
    tol = K2_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    assert (table == len(grid.ids)).any()      # absent neighbours present


@pytest.mark.parametrize("cin", [1, 5, 16, 20, 64, 128])
def test_k2_bf16_route_takes_any_cin(cin):
    for cout in COUTS:
        assert k2_route(cin, cout, torch.bfloat16) == "bf16"
    with pytest.raises(ValueError, match="bf16 family"):
        k2_route(cin, 24, torch.bfloat16)


def test_bf16_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 51, (27, 40)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(27, 16, 8)).astype(np.float32))
    before = gather_conv.launches
    got = gather_conv(x.bfloat16(), t, w.bfloat16())
    assert torch.equal(got, gather_conv_plain(x.bfloat16(), t, w.bfloat16()))
    assert gather_conv.launches == before
    with pytest.raises(ValueError, match="weights"):
        gather_conv(x.bfloat16(), t, w)
    with pytest.raises(ValueError, match="bias"):
        gather_conv(x.bfloat16(), t, w.bfloat16(), torch.zeros(8).bfloat16())


def test_bf16_truncate_is_the_jax_pair_packing():
    from futuredet_tpu.ops.sparse_conv import (pack_bf16_pairs,
                                               unpack_pairs_fp32)
    x = np.random.default_rng(9).normal(size=(30, 64)).astype(np.float32)
    # unpacked as [even channels | odd channels]
    u = np.asarray(unpack_pairs_fp32(pack_bf16_pairs(jnp.asarray(x))))
    got = bf16_truncate(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        np.concatenate([got[:, 0::2], got[:, 1::2]], -1), u)
    assert not np.array_equal(got, x) and (np.abs(got) <= np.abs(x)).all()


# --------------------------------------------------------------- layers

@pytest.mark.parametrize("deconv", [False, True])
def test_bf16_layers_match_flax(deconv):
    """A ConvBNReLU / DeconvBNReLU in bf16 returns bf16 from fp32
    parameters, as flax's nn.Conv(dtype=bf16) + nn.BatchNorm(dtype=bf16)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(1, 6, 6, 8)).astype(np.float32)
    mod = (JaxDeconvBNReLU(16, 2, compute_dtype="bfloat16") if deconv
           else JaxConvBNReLU(16, 3, 1, compute_dtype="bfloat16"))
    v = jax.tree.map(np.array, jax.device_get(
        mod.init(jax.random.PRNGKey(0), x)))
    bn = v["batch_stats"]["BatchNorm_0"]
    bn["mean"][:] = rng.normal(0, 0.3, 16)
    bn["var"][:] = rng.uniform(0.5, 1.5, 16)
    want = mod.apply(v, x)
    assert want.dtype == jnp.bfloat16
    ours = (DeconvBNReLU(8, 16, 2, compute_dtype=torch.bfloat16) if deconv
            else ConvBNReLU(8, 16, 3, 1, compute_dtype=torch.bfloat16)
            ).eval()
    k = np.asarray(v["params"]["ConvTranspose_0" if deconv else "Conv_0"][
        "kernel"])
    with torch.no_grad():
        ours[0].weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(k[::-1, ::-1], (2, 3, 0, 1)) if deconv
            else np.transpose(k, (3, 2, 0, 1)))))
        if not deconv:
            ours[0].bias.copy_(torch.from_numpy(np.asarray(
                v["params"]["Conv_0"]["bias"])))
        ours[1].running_mean.copy_(torch.from_numpy(bn["mean"]))
        ours[1].running_var.copy_(torch.from_numpy(bn["var"]))
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ours.parameters())
    ref = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), ref,
                               atol=BF16_RTOL * max(1.0, np.abs(ref).max()),
                               rtol=0)


# ------------------------------------------------------------ the forms

def _forms(cfg, batch_size, training=False):
    enc = build_detector(cfg, device="cpu").backbone.train(training)
    algo = enc.conv_algo(batch_size)
    c = enc.channels
    forms = [enc.conv_form(algo, 0, 5, packable=False)]
    forms += [enc.conv_form(algo, 0, c[0])] * 4
    for s in range(1, 4):
        forms += [enc.conv_form(algo, s - 1, c[s - 1])]
        forms += [enc.conv_form(algo, s, c[s])] * 4
    return forms


@pytest.mark.parametrize("change,B,training,want", [
    # the 20 convs in order: conv_input, 4 of stage 0, then down + 4 each
    ({}, 1, False, [None] * 20),
    (dict(middle_gather_algo="window_bf16"), 1, False, ["bf16"] * 20),
    (dict(middle_gather_algo="window_bf16"), 2, False, [None] * 20),
    (dict(middle_gather_algo="window_bf16"), 1, True, [None] * 20),
    (dict(middle_sparse_dtype="bfloat16"), 1, False, ["bf16"] * 20),
    (dict(middle_sparse_dtype="bfloat16", middle_gather_algo="window"), 1,
     False, ["round_x"] * 20),
    (dict(middle_sparse_dtype="bfloat16", middle_gather_algo="hybrid"), 2,
     False, ["bf16"] * 20),
    # packed pairs where the JAX package packs them: Cin = 64 (stage 2's
    # blocks, down3, stage 3's blocks of 64), algo xpack, not in training;
    # down2 reads 16 channels
    (dict(middle_sparse_dtype="bf16_packed"), 1, False,
     [None] * 11 + ["trunc_x"] * 9),
    (dict(middle_sparse_dtype="bf16_packed"), 2, False,
     [None] * 11 + ["trunc_x"] * 9),
    (dict(middle_sparse_dtype="bf16_packed"), 1, True, [None] * 20),
    (dict(middle_sparse_dtype="bf16_packed", middle_gather_algo="stacked"),
     1, False, [None] * 20),
    (dict(middle_sparse_dtype="bf16_packed", middle_xpack_max_cin=32), 1,
     False, [None] * 20),
])
def test_conv_forms_follow_the_jax_knobs(change, B, training, want):
    cfg = serving_config(port_config)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **change))
    assert _forms(cfg, B, training) == want


# ------------------------------------------------------- whole detectors

def serving_config(mod):
    cfg = voxelnet_config(mod)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 middle_channels=CHANNELS))


def with_knobs(cfg, change):
    return cfg.replace(model=dataclasses.replace(cfg.model, **change))


def _scene_batch(cfg, B):
    pts, valid = zip(*(scene(cfg, 2 + b) for b in range(B)))
    return np.concatenate(pts), np.concatenate(valid)


def serving_run(cases):
    """JAX-init variables of the serving test config, with random BN
    statistics and affines in the middle encoder and z_crush and the
    heatmap bias raised, and each of `cases`' JAX forward of them (the
    window cases run in tests/test_torch_bf16_window.py, so that the
    suite's workers share the JAX forwards' time)."""
    cfg_j = serving_config(jax_config)
    pts, valid = _scene_batch(cfg_j, 1)
    variables = jax_variables(jax_build(cfg_j), pts, valid)
    rng = np.random.default_rng(1)
    for name in ("middle", "z_crush"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["batch_stats"][name]):
            leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape)
                         if path[-1].key == "var"
                         else rng.normal(0, 0.1, leaf.shape))
        # BatchNorm biases near 0, so that the middle's ReLUs cut
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["params"][name]):
            if path[-1].key == "bias":
                leaf[...] = rng.normal(0, 0.1, leaf.shape)
    for t in range(7):
        variables["params"]["head"][f"task{t}"]["hm_final"]["bias"][:] = 0.5
    preds = {}
    for name in cases:
        change, B = CASES[name]
        p, v = _scene_batch(cfg_j, B)
        preds[name] = jax.device_get(jax_build(with_knobs(cfg_j, change))
                                     .apply(variables, jnp.asarray(p),
                                            jnp.asarray(v)))
    return dict(variables=variables, preds=preds)


def _port_forward(variables, cfg, B):
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    p, v = _scene_batch(cfg, B)
    with torch.no_grad():
        return model(torch.from_numpy(p), torch.from_numpy(v))


def _assert_maps_close(got, want, rtol_of_max=None, what=""):
    for t, (p, jp) in enumerate(zip(got, want)):
        for k in jp:
            ref = np.asarray(jp[k], np.float32)
            # the head's maps are fp32; forecast features stay in the
            # towers' dtype, as in the JAX head
            bf16 = k == "feats" and str(jp[k].dtype) == "bfloat16"
            assert p[k].dtype == (torch.bfloat16 if bf16
                                  else torch.float32), (what, k, p[k].dtype)
            p = {**p, k: p[k].float()}
            if rtol_of_max is None:
                np.testing.assert_allclose(p[k].numpy(), ref, atol=FP32_ATOL,
                                           rtol=FP32_RTOL,
                                           err_msg=f"{what} task {t} {k}")
            else:
                tol = rtol_of_max * max(1.0, float(np.abs(ref).max()))
                np.testing.assert_allclose(p[k].numpy(), ref, atol=tol,
                                           rtol=0,
                                           err_msg=f"{what} task {t} {k}")


def check_serving_case(run, case):
    """The port's forward of `case` against the JAX one in `run`."""
    change, B = CASES[case]
    cfg = with_knobs(serving_config(port_config), change)
    got = _port_forward(run["variables"], cfg, B)
    _assert_maps_close(got, run["preds"][case], CASE_RTOL[case], case)
    assert "feats" in got[0]
    if case == "bf16":
        assert got[0]["feats"].dtype == torch.bfloat16


SERVING_HERE = ("bf16", "bf16_packed", "dense_from2", "dense_from2_bf16")


@pytest.fixture(scope="module")
def serving():
    return serving_run(SERVING_HERE)


@pytest.mark.parametrize("case", SERVING_HERE)
def test_voxelnet_serving_matches_jax(serving, case):
    check_serving_case(serving, case)


@pytest.fixture(scope="module")
def pillar_bf16():
    cfg_j = port_tiny_pp(jax_config, compute_dtype="bfloat16")
    pts, valid = tiny_scene(cfg_j, 0)
    model = jax_build(cfg_j)
    variables = jax_variables(model, pts, valid)
    rng = np.random.default_rng(2)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["params"]["neck"]):
        if path[-1].key == "bias":
            leaf[...] = rng.normal(0, 0.1, leaf.shape)
    for t in range(7):
        variables["params"]["head"][f"task{t}"]["hm_final"]["bias"][:] = 0.5
    pts, valid = tiny_scene(cfg_j, 1)
    preds = jax.device_get(model.apply(variables, jnp.asarray(pts),
                                       jnp.asarray(valid)))
    return dict(variables=variables, pts=pts, valid=valid, preds=preds)


def port_tiny_pp(mod, **change):
    cfg = mod.tiny_variant(mod.get_config("pp_forecast_n3dtf"))
    return cfg.replace(model=dataclasses.replace(cfg.model, **change))


def test_pillar_bf16_towers_match_jax(pillar_bf16):
    cfg = port_tiny_pp(port_config, compute_dtype="bfloat16")
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(pillar_bf16["variables"], cfg),
                          strict=True)
    assert model.neck.blocks[0][1].compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        preds, bev = model(torch.from_numpy(pillar_bf16["pts"]),
                           torch.from_numpy(pillar_bf16["valid"]),
                           return_bev=True)
    # the neck hands fp32 on, as the JAX RPN returns it: the second stage
    # pools fp32
    assert bev.dtype == torch.float32
    _assert_maps_close(preds, pillar_bf16["preds"], BF16_RTOL, "pillars")


def test_two_stage_pools_the_fp32_bev_under_compute_dtype():
    cfg = port_config.tiny_variant(port_config.get_config(
        "pp_forecast_n3dtf_two_stage"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    model = build_detector(cfg, device="cpu")
    pts, valid = tiny_scene(cfg, 0)
    seen = []
    model.first_stage.neck.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        preds, det, roi = model(torch.from_numpy(pts),
                                torch.from_numpy(valid))
    assert seen == [torch.float32]
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in roi.values())


# ------------------------------------------------------------- training

def _train_batch(cfg, B=2):
    from futuredet_torch.data.synthetic import make_batch
    batch = make_batch(cfg, B, seed=0, n_objects=4, n_clutter=3000,
                       clutter_mode="lidar")
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("name,change", [
    ("forecast_n3dtf", dict(compute_dtype="bfloat16")),
    ("forecast_n3dtf", dict(middle_sparse_dtype="bfloat16")),
    ("forecast_n3dtf", dict(middle_dense_from_stage=2,
                            middle_dense_dtype="bfloat16")),
    ("pp_forecast_n3dtf", dict(compute_dtype="bfloat16")),
    ("pp_forecast_n3dtf_two_stage", dict(compute_dtype="bfloat16")),
])
def test_training_under_a_bf16_knob_runs(name, change):
    """A B = 1 train step of every tiny config under each bf16 knob, on
    one thread: finite losses and grad_norm, fp32 gradients on every
    trained parameter, and the parameters move (each step is held to the
    JAX step by tests/test_torch_train_bf16_*.py and phase 33)."""
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.train.step import make_optimizer, train_step
    cfg = with_knobs(port_config.tiny_variant(port_config.get_config(name)),
                     change)
    batch = make_batch(cfg, 1, seed=0, n_objects=4, n_clutter=1000,
                       clutter_mode="lidar")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_detector(cfg, device="cpu", seed=3).train()
        opt = make_optimizer(cfg, model, 10)
        before = [p.detach().clone() for p in model.parameters()]
        metrics = train_step(model, opt, batch, 0)
    finally:
        torch.set_num_threads(threads)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    trained = [p for g in opt.param_groups for p in g["params"]]
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in trained)
    assert any(not torch.equal(a, p) for a, p in
               zip(before, model.parameters()))


@pytest.mark.parametrize("change", [
    dict(middle_gather_algo="window"), dict(middle_gather_algo="window_bf16"),
    dict(middle_gather_algo="hybrid"), dict(middle_sparse_dtype="bf16_packed"),
])
def test_knobs_exact_in_training_train_as_fp32(change):
    """The JAX package trains these as fp32 `stacked`, packs nothing in
    training: the port's train step gives the default config's losses and
    gradients bit for bit."""
    from futuredet_torch.train.step import forward_backward
    cfg = serving_config(port_config)
    batch = _train_batch(cfg)
    grads = []
    for c in (cfg, with_knobs(cfg, change)):
        model = build_detector(c, device="cpu", seed=1).train()
        losses = forward_backward(model, batch)
        grads.append((float(losses["loss"].detach()),
                      [p.grad.clone() for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))

