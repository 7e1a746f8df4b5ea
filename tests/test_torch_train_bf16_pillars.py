"""Training under a bf16 knob, futuredet_torch against the JAX package:
two B = 2 train steps of tiny pp_forecast_n3dtf under
`compute_dtype="bfloat16"` (bf16 RPN and head towers). The helpers serve
the VoxelNet knobs too (tests/test_torch_train_bf16_vox.py,
tests/test_torch_train_bf16_dense.py).

The JAX step is the single-device `local_step` of
`futuredet_tpu/train/step.py::make_train_step` (on-device targets,
train-mode apply, center_head_loss, value_and_grad) under the knob. Both
steps start from the same point: the port loads the JAX run's parameters
and statistics before each (`flax_to_state_dict`), and between the steps
the JAX parameters take optax's update of the JAX gradients.

Runs at each step: the JAX step under the knob ("jb"), the JAX step in
fp32 ("jf"), two probes of its rounding noise (the JAX step under the
knob compiled with XLA's `xla_allow_excess_precision` off, "jx", where
its bf16 ops round elsewhere; and "jn", jb's compile on the parameters
scaled by 1 + NUDGE, which moves an fp32 step's gradients by ~1e-6 but
flips the roundings of bf16 operands and the ReLUs that sit on them),
the port under the knob ("pb"), and the port in fp32 ("pf"), which must
fail. The tolerance rule, per quantity: `err` is its distance from jb,
`gap` jf's, `noise` the larger of jx's and jn's.

  * the quantities: the loss, each task's heatmap loss, the box loss,
    grad_norm, and per top-level module the gradients and the running
    statistics, each as one relative distance over the module's tensors
    (the norm of the differences over the norm of jb's);
  * every quantity: err <= max(GAP_FRACTION * gap, NOISE_FACTOR * noise,
    floor), the floor two bf16 ulps (LOSS_ULPS) for a loss, FP32_FLOOR
    (the fp32 tests' 1e-5) for a distance;
  * a quantity whose gap stands SIGNAL times above its noise and above
    FP32_FLOOR (the knob moves it beyond rounding): err <= GAP_FRACTION *
    gap; the noise of grad_norm is that of all the gradients. At least one
    quantity of each step must stand so, and the fp32 port must break a
    rule;
  * every gradient tensor that is not zero up to rounding (its JAX fp32
    max |g| at least ZERO_FRACTION of the model's): a cosine with jb's of
    at least MIN_COSINE and a norm within NORM_RATIO of it, which catches
    a wrong tensor (a sign, a factor of 2, a missing path), not rounding:
    one ReLU decision that the bf16 noise flips moves a BatchNorm's
    gradient by a third of its max in one channel, and the cosines of the
    noisiest tensors with jb's fall to 0.82 for the port, the fp32 port
    and JAX's own noise alike.

Why not GAP_FRACTION of the gap everywhere: a bf16 forward decorrelates
its roundings layer by layer. Fed the same fp32 canvas, the port's and
the JAX RPN's first bf16 conv differ in 3e-5 of their outputs, by one
bf16 ulp, and each layer multiplies that share by 5-20, to 0.43 at the
last deblock; two JAX compiles that differ only in excess precision
diverge as much. Per gradient tensor the distance between any two bf16
runs is then as large as the bf16 effect itself (measured here: median
err / gap 0.86-0.91, and the JAX-vs-JAX noise as large); the global
gradient distance from fp32 is 0.10-0.12%, JAX's own noise 0.17-0.18%,
the port's 0.17%. So the gradients are held to JAX's own noise, and the
loss, where the bf16 effect stands out of the noise, to a quarter of it.

Two declared differences (`models/center_head.py`):

  * the JAX head fuses its towers and normalises them in bf16; on XLA:CPU
    the backward of that normalisation sums each channel's cotangent over
    the batch in bf16 (the transpose of a broadcast; `jnp.sum` itself
    accumulates in fp32), which saturates: the JAX bf16 step's gradients
    lie 47% from its fp32 step's, against 0.4% between two JAX bf16
    compiles. The port's towers normalise in fp32, flax's BatchNorm; the
    JAX reference here runs the per-branch towers (`fuse_branches=False`,
    the JAX package's own test hook), which normalise in fp32 too;
  * the bias of a bf16 conv: its JAX gradient is the same bf16 sum over
    the batch (`tests/test_torch_bf16_grads.py`), where the port's sums in
    fp32 as the card does. These tensors are left out of the comparison
    (`bf16_conv_biases`) and out of the compared grad_norm.

Every BatchNorm bias is raised by about 3 (`jax_variables`), so that few
ReLU decisions lie near 0. Three JAX compiles in a module fixture
(scripts/torch_bf16_train_gaps.py prints the per-quantity table)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models import center_head as jax_center_head
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.layers import Conv2d, ConvTranspose2d
from futuredet_torch.train.step import forward_backward
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_train_step import (  # noqa: F401 (a fixture)
    jax_variables, one_torch_thread)

TOTAL_STEPS = 20
NUDGE = 2.0 ** -20
NOISE_RUNS = ("jx", "jn")
GAP_FRACTION = 0.25
NOISE_FACTOR = 1.5
SIGNAL = 5.0
LOSS_ULPS = 2.0 ** -7
FP32_FLOOR = 1e-5
ZERO_FRACTION = 1e-3
MIN_COSINE = 0.5
NORM_RATIO = 1.5
BF16 = dict(compute_dtype="bfloat16")


def with_knobs(cfg, change):
    return cfg.replace(model=dataclasses.replace(cfg.model, **change))


class _PerBranchSepHead(jax_center_head.SepHead):
    fuse_branches: bool = False


@contextlib.contextmanager
def per_branch_towers():
    """The JAX head with its per-branch towers (fp32 normalisation)."""
    fused = jax_center_head.SepHead
    jax_center_head.SepHead = _PerBranchSepHead
    try:
        yield
    finally:
        jax_center_head.SepHead = fused


def jax_grad_fn(cfg_j, excess_precision=True):
    """The JAX step's value_and_grad, jitted; compiled with XLA's excess
    precision off when asked."""
    model = jax_build(cfg_j)

    def loss_fn(params, batch_stats, pts, valid, raw):
        targets = jax_build_targets_batch(cfg_j, raw)
        out, mut = model.apply({"params": params,
                                "batch_stats": batch_stats}, pts, valid,
                               train=True, mutable=["batch_stats"])
        losses = jax_loss(cfg_j.model.head, out, targets)
        return losses["loss"], (losses, mut["batch_stats"])
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    if excess_precision:
        return model, fn
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(fn.lower(*args).compile(compiler_options={
                "xla_allow_excess_precision": False}))
        return compiled[0](*args)
    return model, call


def bf16_conv_biases(model):
    """The biases of the port's bf16 convs (`compute_dtype`)."""
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, (Conv2d, ConvTranspose2d))
            and m.compute_dtype is not None and m.bias is not None}


def knob_steps(cfg_j, cfg_p, change, batch, patch=contextlib.nullcontext):
    """Two steps under `change` (module docstring): per step the runs
    "jb", "jf", "jx", "pb" and "pf", each {losses, grads, stats}
    (state_dict names, numpy), all from the JAX bf16 run's state. Every
    JAX step is traced under `patch()`."""
    pts = batch["points"].numpy()
    valid = batch["points_valid"].numpy()
    raw = {k: v.numpy() for k, v in batch["targets_raw"].items()}
    cfg_jb, cfg_pb = with_knobs(cfg_j, change), with_knobs(cfg_p, change)
    with patch():
        model_f, grad_f = jax_grad_fn(cfg_j)
        _, grad_b = jax_grad_fn(cfg_jb)
        _, grad_x = jax_grad_fn(cfg_jb, excess_precision=False)
        variables = jax_variables(model_f, pts[:1], valid[:1])
    tx = jax_make_optimizer(cfg_j, TOTAL_STEPS)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    ports = {"pb": build_detector(cfg_pb, device="cpu").train(),
             "pf": build_detector(cfg_p, device="cpu").train()}
    args = (jnp.asarray(pts), jnp.asarray(valid),
            jax.tree.map(jnp.asarray, raw))
    steps = []
    for _ in range(2):
        st = {}
        nudged = jax.tree.map(lambda p: p * np.float32(1 + NUDGE), params)
        for name, fn, at in (("jb", grad_b, params), ("jf", grad_f, params),
                             ("jx", grad_x, params), ("jn", grad_b, nudged)):
            with patch():
                (_, (losses, new_stats)), grads = jax.device_get(
                    fn(at, stats, *args))
            sd = flax_to_state_dict({"params": grads,
                                     "batch_stats": new_stats}, cfg_p)
            st[name] = dict(
                losses={k: np.asarray(v) for k, v in losses.items()},
                grads={n: sd[n].numpy() for n, _ in
                       ports["pb"].named_parameters()},
                stats={n: v.numpy() for n, v in sd.items()
                       if n.endswith(("running_mean", "running_var"))},
                jax=(grads, new_stats))
        for name, model in ports.items():
            model.load_state_dict(flax_to_state_dict(
                {"params": params, "batch_stats": stats}, cfg_p),
                strict=True)
            model.zero_grad(set_to_none=True)
            losses = forward_backward(model, batch)
            st[name] = dict(
                losses={k: v.detach().numpy() for k, v in losses.items()},
                grads={n: p.grad.numpy().copy()
                       for n, p in model.named_parameters()},
                stats={n: b.numpy().copy() for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})
        st["excluded"] = bf16_conv_biases(ports["pb"])
        steps.append(st)
        upd, opt_state = tx.update(st["jb"]["jax"][0], opt_state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params,
                                             upd))
        stats = st["jb"]["jax"][1]
    return steps


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _dist(run, got, kind, names):
    """sqrt(sum |got - jb|^2) / sqrt(sum |jb|^2) over tensors `names` of
    `kind` ("grads" or "stats")."""
    num = sum(float(np.sum(np.square(run[got][kind][n].astype(np.float64)
                                     - run["jb"][kind][n]))) for n in names)
    den = sum(float(np.sum(np.square(run["jb"][kind][n].astype(np.float64))))
              for n in names)
    return float(np.sqrt(num / max(den, 1e-60)))


def _norm(grads, names):
    return float(np.sqrt(sum(np.sum(np.square(grads[n].astype(np.float64)))
                             for n in names)))


def measures(run, got):
    """{quantity: (err, gap, noise, floor)} of run `got` (module
    docstring)."""
    jb = run["jb"]
    names = [n for n in jb["grads"] if n not in run["excluded"]]
    out = {}
    for k in ("loss", "hm_loss", "loc_loss"):
        err, gap, *noise = (_rel(run[r]["losses"][k], jb["losses"][k])
                            for r in (got, "jf") + NOISE_RUNS)
        out[k] = (err, gap, max(noise), LOSS_ULPS)
    # grad_norm's noise: the noise distance of all the gradients, which
    # bounds that of their norm
    norms = {r: _norm(run[r]["grads"], names) for r in ("jb", "jf", got)}
    out["grad_norm"] = tuple(abs(norms[r] - norms["jb"]) / norms["jb"]
                             for r in (got, "jf")) + (
        max(_dist(run, r, "grads", names) for r in NOISE_RUNS), FP32_FLOOR)
    for kind, pool in (("grads", names), ("stats", list(jb["stats"]))):
        for top in sorted({n.split(".")[0] for n in pool}):
            sel = [n for n in pool if n.split(".")[0] == top]
            err, gap, *noise = (_dist(run, r, kind, sel)
                                for r in (got, "jf") + NOISE_RUNS)
            out[f"{kind}:{top}"] = (err, gap, max(noise), FP32_FLOOR)
    return out


def violations(run, got="pb"):
    """The rules of the module docstring broken by run `got` ("pb", or
    "pf" for the fp32 port): {what: (value, limit)}."""
    bad = {}
    jb = run["jb"]
    names = [n for n in jb["grads"] if n not in run["excluded"]]

    def rule(key, err, limit):
        if not err <= limit:
            bad[key] = (err, limit)
    for key, (err, gap, noise, floor) in measures(run, got).items():
        if gap >= SIGNAL * max(noise, FP32_FLOOR):
            rule(key, err, GAP_FRACTION * gap)
        else:
            rule(key, err, max(GAP_FRACTION * gap, NOISE_FACTOR * noise,
                               floor))
    top = max(float(np.abs(run["jf"]["grads"][n]).max()) for n in names)
    for n in names:
        if float(np.abs(run["jf"]["grads"][n]).max()) < ZERO_FRACTION * top:
            continue
        a = run[got]["grads"][n].astype(np.float64).ravel()
        b = jb["grads"][n].astype(np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        rule(f"cos:{n}", -float(a @ b) / (na * nb), -MIN_COSINE)
        rule(f"norm:{n}", max(na / nb, nb / na), NORM_RATIO)
    return bad


def check_knob_step(run):
    """The port under the knob keeps every rule; some quantity stands
    out of the noise; the port in fp32 breaks a rule."""
    bad = violations(run)
    assert not bad, bad
    assert any(gap >= SIGNAL * max(noise, FP32_FLOOR)
               for _, gap, noise, _ in measures(run, "pb").values())
    assert violations(run, "pf")
    assert all(g.dtype == np.float32 for g in run["pb"]["grads"].values())
    assert set(run["pb"]["grads"]) == set(run["jb"]["grads"])
    assert set(run["pb"]["stats"]) == set(run["jb"]["stats"])


@pytest.fixture(scope="module")
def run():
    cfg_j = jax_config.tiny_variant(jax_config.get_config("pp_forecast_n3dtf"))
    cfg = port_config.tiny_variant(
        port_config.get_config("pp_forecast_n3dtf"))
    batch = make_batch(cfg, 2, seed=33, n_objects=4, n_clutter=300,
                       points_per_object=300)
    return knob_steps(cfg_j, cfg, BF16, batch, patch=per_branch_towers)


@pytest.mark.parametrize("step", [0, 1])
def test_pillar_bf16_step_matches_jax(run, step):
    check_knob_step(run[step])


def test_pillar_bf16_leaves_out_only_the_bf16_conv_biases(run):
    """The left-out tensors are the biases of the head's bf16 convs (the
    RPN's convs have none), each with its JAX gradient summed in bf16;
    every other parameter, the reader's and the RPN's all, is held."""
    ex = run[0]["excluded"]
    grads = run[0]["pb"]["grads"]
    assert ex and all(n.startswith("bbox_head.") and n.endswith(".bias")
                      and grads[n.removesuffix("bias") + "weight"].ndim == 4
                      for n in ex)
    assert not any(n.startswith(("reader.", "neck.")) for n in ex)
    assert len(ex) < len(grads) // 3
