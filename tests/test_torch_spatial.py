"""Spatial sharding of the BEV canvas (`--space`) over `torch.distributed`
against the JAX package's GSPMD step.

Gloo ranks (started as tests/test_torch_dp.py starts them, each with its
own timeout, WORKER_TIMEOUT_S) lay out as `make_mesh_2d(n_data, n_space)`
lays out its devices: rank r is data index r // n_space and space index
r % n_space. Each rank of a space group holds a band of the canvas rows
(`parallel/mesh.py::band_bounds` of the RPN's coarsest level: tiny
pp_forecast_n3dtf's 16 coarse rows give bands of 8 / 8 and, uneven, 6 / 6
/ 4) through the RPN and the head, fed by the halo exchange
(`parallel/collectives.py::halo_rows`), and gathers the head maps whole
(`gather_rows`).

  * the halo exchange and the band gather alone, at 2 and 3 ranks: a
    banded 3x3 conv at stride 1 and 2 and its backward against the whole
    conv, and the gather's gradient counted once, not once per rank;
  * one B = 2 train step of tiny pp_forecast_n3dtf at (1, 2) and (1, 3)
    (tests/test_torch_spatial_2x2.py: (2, 2), four ranks, the data x space
    layout, each data index reading its own sample) against the JAX GSPMD
    step on the same weights and global batch: the body of `futuredet_tpu/train/step.py::
    _make_train_step_gspmd` (the detector's `canvas_sharding`, global
    BatchNorm statistics, the per-sample loss under `jax.vmap`) returning
    its gradients, jitted over the mesh of the conftest's virtual CPU
    devices (`jax_gspmd_step`), its loss and grad_norm first held to
    `make_train_step`'s own at (1, 2). Compared, by the data-parallel
    tests' rules (tests/test_torch_dp.py: LOSS_RTOL, GRAD_FRACTION,
    STAT_ATOL): the losses, grad_norm, every gradient and the running
    statistics, on every rank; and every rank's gradients and statistics
    against the others' (equal);
  * the per-sample loss: at B = 2 on one data rank the step's loss is not
    `forward_backward`'s batch loss, and is the JAX GSPMD one;
  * the eval forward at (1, 2) against `make_eval_forward(cfg,
    make_mesh_2d(1, 2))`.

tests/test_torch_spatial_2x2.py holds (2, 2), tests/test_torch_spatial_vox.py
the small VoxelNet of tests/test_torch_dp_vox.py at (1, 2)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.parallel.mesh import (DATA_AXIS, canvas_sharding,
                                         make_mesh_2d)
from futuredet_tpu.train.step import (TrainState, make_eval_forward,
                                      make_optimizer, make_train_step)
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_dp import (GRAD_FRACTION, LOSS_RTOL, STAT_ATOL,
                                 ZERO_FRACTION, free_port)
from tests.test_torch_train_step import jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL_STEPS = 4
WORKER_TIMEOUT_S = 240
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-5     # tests/test_spatial_sharding.py's

# one rank of a (data, space) layout: its data index's share of the global
# batch, one train_step (its own gradients, and the summed ones recorded
# before the clip), the halo exchanges it made; or the eval forward's
# gathered maps
WORKER = r"""
import sys
import torch
rank, world, n_space, port, case_path, out_path = sys.argv[1:7]
rank, world, n_space = int(rank), int(world), int(n_space)
torch.set_num_threads(1)
from futuredet_torch.models.detector import build_detector, lay_out_space_
from futuredet_torch.parallel import collectives as C
from futuredet_torch.parallel.mesh import make_space_group
from futuredet_torch.train import step as S

C.initialize_multihost(f"127.0.0.1:{port}", world, rank, torch.device("cpu"))
space = make_space_group(n_space)
case = torch.load(case_path, weights_only=False)
cfg, batch = case["cfg"], case["batch"]
B = batch["points"].shape[0] // space.n_data
mine = slice(space.data_index * B, (space.data_index + 1) * B)
local = {"points": batch["points"][mine],
         "points_valid": batch["points_valid"][mine],
         "targets_raw": {k: v[mine] for k, v in batch["targets_raw"].items()}}
model = lay_out_space_(build_detector(cfg, device="cpu"), space)
model.load_state_dict(case["state_dict"], strict=True)
out = {"world": C.world_size(), "rank": C.rank(), "index": space.index,
       "data_index": space.data_index}
if case["mode"] == "eval":
    with torch.no_grad():
        out["maps"] = model(local["points"], local["points_valid"])
else:
    model.train()
    seen = {}
    apply_update = S.apply_update

    def recording(model, opt, count):
        seen.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return apply_update(model, opt, count)

    S.apply_update = recording
    own = {}
    average = S.average_gradients_

    def recording_average(params, space=None):
        own.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return average(params, space)

    S.average_gradients_ = recording_average
    opt = S.make_optimizer(cfg, model, case["total_steps"])
    C.reset_halo_stats()
    out["metrics"] = S.train_step(model, opt, local, 0)
    out["halo"] = dict(C.HALO_STATS)
    out["grads"], out["own_grads"] = seen, own
    out["stats"] = {n: b.clone() for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
torch.save(out, out_path)
C.leave(f"127.0.0.1:{port}")
"""

# the halo exchange and the band gather alone: a banded 3x3 conv (stride 1
# and 2) and its backward against the whole conv, both on every rank, in
# float64; the gradient through the gather of a loss every rank computes
HALO_WORKER = r"""
import sys
import torch
import torch.nn.functional as F
rank, world, port, out_path = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
from futuredet_torch.parallel import collectives as C
from futuredet_torch.parallel.mesh import make_space_group

C.initialize_multihost(f"127.0.0.1:{port}", world, rank, torch.device("cpu"))
space = make_space_group(world)
g = torch.Generator().manual_seed(0)
x = torch.randn(2, 3, 20, 7, generator=g, dtype=torch.float64)
w = torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64)
out = {}
for stride in (1, 2):
    whole = x.clone().requires_grad_()
    y = F.conv2d(whole, w, None, stride, 1)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    y.backward(dy)
    a, b = space.band(10, 2)              # 10 coarse rows of 2 fine ones
    band = x[:, :, a:b].clone().requires_grad_()
    yb = F.conv2d(C.halo_rows(band, 1, 2 - stride, space), w, None, stride,
                  (0, 1))
    oa, ob = a // stride, b // stride
    yb.backward(dy[:, :, oa:ob])
    ya = C.gather_rows(yb.detach(), 2, space.bands(10, 2 // stride), space)
    out[stride] = {"y_err": float((yb - y[:, :, oa:ob]).abs().max()),
                   "dx_err": float((band.grad - whole.grad[:, :, a:b])
                                   .abs().max()),
                   "gathered_err": float((ya - y.detach()).abs().max())}
# a loss of the gathered rows, computed alike on every rank
band = x[:, :, a:b].clone().requires_grad_()
full = C.gather_rows(band, 2, space.bands(10, 2), space)
(full * x).sum().backward()
out["gather_grad_err"] = float((band.grad - x[:, :, a:b]).abs().max())
out["band"] = (a, b)
torch.save(out, out_path)
C.leave(f"127.0.0.1:{port}")
"""


def run_ranks(tmp_path, script, args_of, world):
    """`script` on `world` gloo ranks, rank r with `args_of(r, port)`:
    their saved outputs."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *args_of(r, port), str(outs[r])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {world} gloo ranks did not finish in "
                    f"{WORKER_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def run_layout(tmp_path, case, n_data, n_space):
    case_path = tmp_path / "case.pt"
    torch.save(case, case_path)
    world = n_data * n_space
    return run_ranks(tmp_path, WORKER, lambda r, port: (
        str(r), str(world), str(n_space), port, str(case_path)), world)


def jax_gspmd_step(cfg_j, mesh):
    """The JAX GSPMD step's body (`_make_train_step_gspmd`) over `mesh`,
    returning (gradients, losses, new batch statistics, grad_norm)
    instead of the update."""
    model = jax_build(cfg_j, axis_name=None,
                      canvas_sharding=canvas_sharding(mesh))

    def step(params, batch_stats, batch):
        def loss_fn(p):
            targets = jax_build_targets_batch(cfg_j, batch["targets_raw"])
            out, mut = model.apply(
                {"params": p, "batch_stats": batch_stats},
                batch["points"], batch["points_valid"], train=True,
                mutable=["batch_stats"])
            losses = jax.vmap(lambda pr, tg: jax_loss(
                cfg_j.model.head, jax.tree.map(lambda x: x[None], pr),
                jax.tree.map(lambda x: x[None], tg)))(out, targets)
            losses = jax.tree.map(lambda x: jnp.mean(x, axis=0), losses)
            return losses["loss"], (losses, mut["batch_stats"])
        (_, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return grads, losses, new_bs, optax.global_norm(grads)

    repl = NamedSharding(mesh, P())
    return jax.jit(step, in_shardings=(repl, repl,
                                       NamedSharding(mesh, P(DATA_AXIS))),
                   out_shardings=repl)


def jax_batch(batch):
    return {"points": batch["points"].numpy(),
            "points_valid": batch["points_valid"].numpy(),
            "targets_raw": {k: v.numpy()
                            for k, v in batch["targets_raw"].items()}}


def spatial_case(cfg_j, cfg, batch, variables, n_data, n_space, tmp_path,
                 against_make_train_step=False):
    """The JAX GSPMD reference over make_mesh_2d(n_data, n_space) and
    every rank's outputs on `batch`."""
    mesh = make_mesh_2d(n_data, n_space)
    jb = jax_batch(batch)
    grads, losses, new_bs, gnorm = jax.device_get(jax_gspmd_step(
        cfg_j, mesh)(variables["params"], variables["batch_stats"], jb))
    if against_make_train_step:
        tx = make_optimizer(cfg_j, TOTAL_STEPS, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        new_state, metrics = jax.device_get(make_train_step(
            cfg_j, mesh, TOTAL_STEPS)(state, jb))
        np.testing.assert_allclose(metrics["loss"], losses["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(metrics["grad_norm"], gnorm, rtol=1e-6)
        for a, b in zip(jax.tree.leaves(new_state.batch_stats),
                        jax.tree.leaves(new_bs)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    want = flax_to_state_dict({"params": grads, "batch_stats": new_bs}, cfg)
    case = {"cfg": cfg, "state_dict": flax_to_state_dict(variables, cfg),
            "batch": {k: v for k, v in batch.items() if k != "gt"},
            "total_steps": TOTAL_STEPS, "mode": "train"}
    ranks = run_layout(tmp_path, case, n_data, n_space)
    return dict(want=want, losses=losses, grad_norm=float(gnorm),
                ranks=ranks, case=case, layout=(n_data, n_space))


def check_spatial_step(run):
    """Every rank against the JAX GSPMD step, and against each other."""
    want, ranks = run["want"], run["ranks"]
    n_data, n_space = run["layout"]
    world = n_data * n_space
    assert [r["world"] for r in ranks] == [world] * world
    assert [(r["rank"], r["data_index"], r["index"]) for r in ranks] == \
        [(r, r // n_space, r % n_space) for r in range(world)]
    for r in ranks:
        for k in ("loss", "hm_loss", "loc_loss"):
            np.testing.assert_allclose(r["metrics"][k].numpy(),
                                       np.asarray(run["losses"][k]),
                                       rtol=LOSS_RTOL, atol=0, err_msg=k)
        np.testing.assert_allclose(float(r["metrics"]["grad_norm"]),
                                   run["grad_norm"], rtol=LOSS_RTOL)
        assert set(r["grads"]) == {k for k in want if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))}
        top = max(float(want[n].abs().max()) for n in r["grads"])
        for n, g in r["grads"].items():
            w = want[n]
            scale = float(w.abs().max())
            tol = (GRAD_FRACTION * scale if scale > ZERO_FRACTION * top
                   else 2 * ZERO_FRACTION * top)
            err = float((g - w).abs().max())
            assert err <= tol, (n, err, tol)
        assert set(r["stats"]) == {k for k in want if k.endswith(
            ("running_mean", "running_var"))}
        for n, s in r["stats"].items():
            np.testing.assert_allclose(s.numpy(), want[n].numpy(),
                                       atol=STAT_ATOL, rtol=0, err_msg=n)
        # every banded 3x3 conv exchanged halos, forward and backward
        assert r["halo"]["exchanges"] > 0 and r["halo"]["bytes"] > 0
    # the ranks hold one model: the same gradients and statistics
    for kind in ("grads", "stats"):
        for n, a in ranks[0][kind].items():
            for other in ranks[1:]:
                assert torch.equal(a, other[kind][n]), (kind, n)


def pp_n3dtf():
    name = "pp_forecast_n3dtf"
    return (jax_config.tiny_variant(jax_config.get_config(name)),
            port_config.tiny_variant(port_config.get_config(name)))


@pytest.fixture(scope="module")
def pillar_inputs():
    cfg_j, cfg = pp_n3dtf()
    batch = make_batch(cfg, 2, seed=33, n_objects=4, n_clutter=300,
                       points_per_object=300)
    pts = batch["points"].numpy()[:1]
    valid = batch["points_valid"].numpy()[:1]
    return cfg_j, cfg, batch, jax_variables(jax_build(cfg_j), pts, valid)


@pytest.fixture(scope="module")
def pillar_runs(pillar_inputs, tmp_path_factory):
    """layout -> its spatial_case, each run once."""
    cfg_j, cfg, batch, variables = pillar_inputs
    runs = {}

    def run(n_data, n_space):
        if (n_data, n_space) not in runs:
            runs[n_data, n_space] = spatial_case(
                cfg_j, cfg, batch, variables, n_data, n_space,
                tmp_path_factory.mktemp("spatial"),
                against_make_train_step=(n_data, n_space) == (1, 2))
        return runs[n_data, n_space]
    return run


@pytest.mark.parametrize("world", [2, 3])
def test_halo_exchange_and_band_gather(world, tmp_path):
    """A banded conv equals the whole conv's rows, forward and backward
    (float64: the same sums), the gather gives the whole output, and a
    loss of the gathered rows gives each band its own rows' gradient."""
    ranks = run_ranks(tmp_path, HALO_WORKER,
                      lambda r, port: (str(r), str(world), port), world)
    bands = [r["band"] for r in ranks]
    assert bands == {2: [(0, 10), (10, 20)],
                     3: [(0, 8), (8, 16), (16, 20)]}[world]
    for r in ranks:
        for stride in (1, 2):
            assert r[stride]["y_err"] == 0.0, (stride, r[stride])
            assert r[stride]["dx_err"] < 1e-12, (stride, r[stride])
            assert r[stride]["gathered_err"] == 0.0, (stride, r[stride])
        assert r["gather_grad_err"] == 0.0


@pytest.mark.parametrize("n_data,n_space", [(1, 2), (1, 3)])
def test_space_ranks_take_the_jax_gspmd_step(pillar_runs, n_data, n_space):
    check_spatial_step(pillar_runs(n_data, n_space))


def test_the_space_step_normalises_the_loss_per_sample(pillar_runs):
    """At B = 2 on one data rank the step's loss is the mean of the two
    samples' losses (the JAX GSPMD step's), not the batch loss of
    `forward_backward`, which normalises the focal loss and the box loss
    over the batch's objects together."""
    pillar_run = pillar_runs(1, 2)
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import forward_backward
    case = pillar_run["case"]
    model = build_detector(case["cfg"], device="cpu").train()
    model.load_state_dict(case["state_dict"])
    batch_loss = float(forward_backward(model, case["batch"])["loss"])
    got = float(pillar_run["ranks"][0]["metrics"]["loss"])
    want = float(pillar_run["losses"]["loss"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert abs(batch_loss - want) > 100 * LOSS_RTOL * abs(want)


def test_the_space_eval_forward_matches_make_eval_forward(pillar_inputs,
                                                          tmp_path):
    cfg_j, cfg, batch, variables = pillar_inputs
    mesh = make_mesh_2d(1, 2)
    jb = jax_batch(batch)
    want = jax.device_get(make_eval_forward(cfg_j, mesh)(
        variables["params"], variables["batch_stats"],
        {"points": jb["points"], "points_valid": jb["points_valid"]}))
    case = {"cfg": cfg, "state_dict": flax_to_state_dict(variables, cfg),
            "batch": {k: v for k, v in batch.items() if k != "gt"},
            "mode": "eval"}
    for r in run_layout(tmp_path, case, 1, 2):
        assert len(r["maps"]) == len(want)
        for got_t, want_t in zip(r["maps"], want):
            assert set(got_t) == set(want_t) - {"feats"}
            for k, v in got_t.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(want_t[k]),
                                           rtol=EVAL_RTOL, atol=EVAL_ATOL,
                                           err_msg=k)
