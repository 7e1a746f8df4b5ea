"""Data-parallel training and evaluation of futuredet_torch over
`torch.distributed` against the JAX package's `shard_map` step.

Two processes on gloo (`parallel/collectives.py::initialize_multihost`
with a CPU device), each holding one sample of a B = 2 batch, take one
`train/step.py::train_step` from the same weights; the JAX reference is
the single-process two-device `shard_map` step over `make_mesh(2)` (the
conftest's virtual CPU devices) on the same global batch: the body of
`futuredet_tpu/train/step.py::make_train_step`'s `local_step` with the
detector's BatchNorms on the `data` axis and `pmean` of the gradients and
losses, returning the gradients (`jax_dp_step`); its loss and grad_norm
are first held to `make_train_step`'s own. Compared: the rank-mean losses
(LOSS_RTOL), grad_norm and every averaged gradient (GRAD_FRACTION of its
max |g|, the single-device tests' 1e-3 and their rule for a tensor that is
zero up to rounding), the running statistics after the
step (STAT_ATOL) on both ranks, and the two ranks' gradients and
statistics against each other (equal). The statistics' cross-rank
gradient (the transpose of `pmean`) is in every BatchNorm's backward: a
factor of the world size there, or statistics detached from it, moves the
gradients far beyond GRAD_FRACTION (`test_the_cross_rank_gradient_counts`).

This file holds tiny pp_forecast_n0, the model of
tests/test_collectives.py::_TRAIN_WORKER (flax BatchNorm in the RPN and
head, the pillar reader's pooled MaskedBatchNorm), the two-process
`gather_eval_batch` against the single-process batch, and the
`num_shards`/`shard_id` order of `batches_from_dataset` against the JAX
pipeline's; tests/test_torch_dp_vox.py the VoxelNet's per-sample
MaskedBatchNorm. The workers run with their own timeout
(WORKER_TIMEOUT_S) and fail on it."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.pipeline import \
    batches_from_dataset as jax_batches_from_dataset
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.parallel.collectives import \
    gather_eval_batch as jax_gather_eval_batch
from futuredet_tpu.parallel.mesh import DATA_AXIS, make_mesh
from futuredet_tpu.train.step import TrainState, make_optimizer, \
    make_train_step
from futuredet_torch import config as port_config
from futuredet_torch.data.pipeline import batches_from_dataset
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_train_step import jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOTAL_STEPS = 4
WORKER_TIMEOUT_S = 240
LOSS_RTOL = 5e-5
GRAD_FRACTION = 1e-3
ZERO_FRACTION = 1e-6
STAT_ATOL = 1e-5

# one rank: its sample of the global batch, one train_step (the averaged
# gradients recorded before the clip), then gather_eval_batch of its half
# of a fixed eval payload
WORKER = r"""
import sys
import torch
rank, world, port, case_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
from futuredet_torch.eval.decode import Detections
from futuredet_torch.models.detector import build_detector
from futuredet_torch.parallel import collectives as C
from futuredet_torch.train import step as S

C.initialize_multihost(f"127.0.0.1:{port}", world, rank, torch.device("cpu"))
case = torch.load(case_path, weights_only=False)
cfg = case["cfg"]
model = build_detector(cfg, device="cpu").train()
model.load_state_dict(case["state_dict"], strict=True)
batch = case["batch"]
local = {"points": batch["points"][rank:rank + 1],
         "points_valid": batch["points_valid"][rank:rank + 1],
         "targets_raw": {k: v[rank:rank + 1]
                         for k, v in batch["targets_raw"].items()}}
seen = {}
apply_update = S.apply_update


def recording(model, opt, count):
    seen.update({n: p.grad.clone() for n, p in model.named_parameters()})
    return apply_update(model, opt, count)


S.apply_update = recording
opt = S.make_optimizer(cfg, model, case["total_steps"])
metrics = S.train_step(model, opt, local, 0)
stats = {n: b.clone() for n, b in model.named_buffers()
         if n.endswith(("running_mean", "running_var"))}
ev = case["eval"]
half = slice(rank * ev["per_rank"], (rank + 1) * ev["per_rank"])
det = Detections(*(torch.from_numpy(a[half]) for a in ev["det"]))
gt = {k: v[half] for k, v in ev["gt"].items()}
gathered = C.gather_eval_batch(det, gt, ev["tokens"][half])
torch.save({"metrics": metrics, "grads": seen, "stats": stats,
            "gathered": gathered, "world": C.world_size(),
            "rank": C.rank()}, out_path)
C.leave(f"127.0.0.1:{port}")
"""


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def eval_payload(per_rank=3, seed=4):
    """A fixed eval batch of WORLD * per_rank samples: detections, GT with
    attributes and keyframe times of different lengths, tokens."""
    rng = np.random.default_rng(seed)
    B = WORLD * per_rank
    det = (rng.normal(size=(B, 12, 9)).astype(np.float32),
           rng.uniform(size=(B, 12)).astype(np.float32),
           rng.integers(0, 7, (B, 12)).astype(np.int32),
           rng.uniform(size=(B, 12)) > 0.3)
    gt = {"boxes": rng.normal(size=(B, 7, 5, 12)).astype(np.float32),
          "valid": rng.uniform(size=(B, 7, 5)) > 0.5,
          "classes": rng.integers(0, 3, (B, 7, 5)).astype(np.int32),
          "traj": rng.integers(0, 3, (B, 5)).astype(np.int32),
          "attr": [["vehicle.moving", "", "pedestrian.standing", "", ""]
                   for _ in range(B)],
          "times": [np.arange(3 + i % 4, dtype=np.float32) for i in
                    range(B)]}
    tokens = [f"sample-{i}" for i in range(B)]
    return {"det": det, "gt": gt, "tokens": tokens, "per_rank": per_rank}


def run_workers(tmp_path, case):
    """Both ranks of WORKER on `case`: their saved outputs."""
    case_path = tmp_path / "case.pt"
    torch.save(case, case_path)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    outs = [tmp_path / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), port,
         str(case_path), str(outs[r])], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {WORLD} gloo ranks did not finish in "
                    f"{WORKER_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def jax_dp_step(cfg_j, mesh):
    """The JAX data-parallel step's body under shard_map over `data`,
    returning (pmean'd gradients, pmean'd losses, new batch statistics,
    grad_norm) instead of the update."""
    model = jax_build(cfg_j, axis_name=DATA_AXIS)

    def local(params, batch_stats, batch):
        def loss_fn(p):
            targets = jax_build_targets_batch(cfg_j, batch["targets_raw"])
            out, mut = model.apply(
                {"params": p, "batch_stats": batch_stats},
                batch["points"], batch["points_valid"], train=True,
                mutable=["batch_stats"])
            losses = jax_loss(cfg_j.model.head, out, targets)
            return losses["loss"], (losses, mut["batch_stats"])
        (_, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads = jax.lax.pmean(grads, DATA_AXIS)
        losses = jax.lax.pmean(losses, DATA_AXIS)
        return grads, losses, new_bs, optax.global_norm(grads)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P(DATA_AXIS)),
        out_specs=(P(), P(), P(), P()), check_vma=False))


def dp_case(cfg_j, cfg, batch, tmp_path, against_make_train_step=False):
    """The JAX reference and both ranks' outputs on `batch`."""
    pts = batch["points"].numpy()
    valid = batch["points_valid"].numpy()
    raw = {k: v.numpy() for k, v in batch["targets_raw"].items()}
    variables = jax_variables(jax_build(cfg_j), pts[:1], valid[:1])
    mesh = make_mesh(WORLD)
    jbatch = {"points": pts, "points_valid": valid, "targets_raw": raw}
    grads, losses, new_bs, gnorm = jax.device_get(jax_dp_step(cfg_j, mesh)(
        variables["params"], variables["batch_stats"], jbatch))
    if against_make_train_step:
        tx = make_optimizer(cfg_j, TOTAL_STEPS, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        new_state, metrics = jax.device_get(make_train_step(
            cfg_j, mesh, TOTAL_STEPS)(state, jbatch))
        np.testing.assert_allclose(metrics["loss"], losses["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(metrics["grad_norm"], gnorm, rtol=1e-6)
        for a, b in zip(jax.tree.leaves(new_state.batch_stats),
                        jax.tree.leaves(new_bs)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    want = flax_to_state_dict({"params": grads, "batch_stats": new_bs}, cfg)
    case = {"cfg": cfg, "state_dict": flax_to_state_dict(variables, cfg),
            "batch": {k: v for k, v in batch.items() if k != "gt"},
            "total_steps": TOTAL_STEPS, "eval": eval_payload()}
    ranks = run_workers(tmp_path, case)
    return dict(want=want, losses=losses, grad_norm=float(gnorm),
                ranks=ranks, case=case)


def check_dp_step(run):
    want, ranks = run["want"], run["ranks"]
    assert [r["world"] for r in ranks] == [WORLD] * WORLD
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r in ranks:
        for k in ("loss", "hm_loss", "loc_loss"):
            np.testing.assert_allclose(r["metrics"][k].numpy(),
                                       np.asarray(run["losses"][k]),
                                       rtol=LOSS_RTOL, atol=0, err_msg=k)
        np.testing.assert_allclose(float(r["metrics"]["grad_norm"]),
                                   run["grad_norm"], rtol=LOSS_RTOL)
        assert set(r["grads"]) <= set(want)
        top = max(float(want[n].abs().max()) for n in r["grads"])
        for n, g in r["grads"].items():
            w = want[n]
            scale = float(w.abs().max())
            # a tensor below ZERO_FRACTION of the largest is zero up to
            # rounding (a conv bias under a train-mode BatchNorm)
            tol = (GRAD_FRACTION * scale if scale > ZERO_FRACTION * top
                   else 2 * ZERO_FRACTION * top)
            err = float((g - w).abs().max())
            assert err <= tol, (n, err, tol)
        assert set(r["stats"]) == {k for k in want if k.endswith(
            ("running_mean", "running_var"))}
        for n, s in r["stats"].items():
            np.testing.assert_allclose(s.numpy(), want[n].numpy(),
                                       atol=STAT_ATOL, rtol=0, err_msg=n)
    # the ranks hold one model: the same gradients and statistics
    for kind in ("grads", "stats"):
        for n, a in ranks[0][kind].items():
            assert torch.equal(a, ranks[1][kind][n]), (kind, n)


def pp_n0():
    return (jax_config.tiny_variant(jax_config.get_config("pp_forecast_n0")),
            port_config.tiny_variant(port_config.get_config("pp_forecast_n0")))


@pytest.fixture(scope="module")
def pillar_run(tmp_path_factory):
    cfg_j, cfg = pp_n0()
    batch = make_batch(cfg, WORLD, seed=0, n_objects=4, n_clutter=300,
                       points_per_object=300)
    return dp_case(cfg_j, cfg, batch, tmp_path_factory.mktemp("dp"),
                   against_make_train_step=True)


def test_two_gloo_ranks_take_the_jax_shard_map_step(pillar_run):
    check_dp_step(pillar_run)


def test_the_cross_rank_gradient_counts(pillar_run):
    """The BatchNorm statistics' cross-rank gradient moves the averaged
    gradients well beyond GRAD_FRACTION: a rank that detached its
    statistics from the other rank's would not pass."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import forward_backward
    case = pillar_run["case"]
    cfg = case["cfg"]
    grads = []
    for r in range(WORLD):
        # each sample alone: its BatchNorms see only their own statistics
        model = build_detector(cfg, device="cpu").train()
        model.load_state_dict(case["state_dict"])
        b = case["batch"]
        forward_backward(model, {
            "points": b["points"][r:r + 1],
            "points_valid": b["points_valid"][r:r + 1],
            "targets_raw": {k: v[r:r + 1]
                            for k, v in b["targets_raw"].items()}})
        grads.append({n: p.grad for n, p in model.named_parameters()})
    want = pillar_run["want"]
    worst = max(float(((grads[0][n] + grads[1][n]) / 2 - want[n])
                      .abs().max()) / float(want[n].abs().max())
                for n in grads[0] if float(want[n].abs().max()) > 0)
    assert worst > 10 * GRAD_FRACTION


def test_gather_eval_batch_gives_every_rank_the_whole_batch(pillar_run):
    ev = pillar_run["case"]["eval"]
    det, gt, tokens = jax_gather_eval_batch(ev["det"], ev["gt"],
                                            ev["tokens"])
    for r in pillar_run["ranks"]:
        gdet, ggt, gtok = r["gathered"]
        assert gtok == tokens == ev["tokens"]
        for a, b in zip(gdet, det):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert set(ggt) == set(gt)
        for k in ("boxes", "valid", "classes", "traj", "attr"):
            np.testing.assert_array_equal(ggt[k], gt[k])
        assert len(ggt["times"]) == len(gt["times"])
        for a, b in zip(ggt["times"], gt["times"]):
            np.testing.assert_array_equal(a, b)


def test_gather_eval_batch_on_one_process_is_a_round_trip():
    from futuredet_torch.eval.decode import Detections
    from futuredet_torch.parallel.collectives import gather_eval_batch
    ev = eval_payload()
    det = Detections(*(torch.from_numpy(np.asarray(a)) for a in ev["det"]))
    gdet, gt, tokens = gather_eval_batch(det, ev["gt"], ev["tokens"])
    assert tokens == ev["tokens"]
    for a, b in zip(gdet, ev["det"]):
        np.testing.assert_array_equal(a, b)
    for k in ("boxes", "valid", "classes", "traj", "attr"):
        np.testing.assert_array_equal(gt[k], np.asarray(ev["gt"][k],
                                                        gt[k].dtype))
    for a, b in zip(gt["times"], ev["gt"]["times"]):
        np.testing.assert_array_equal(a, b)


class _Samples:
    """A dataset of n tiny samples whose token is their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, j):
        return {"points": np.zeros((4, 5), np.float32),
                "points_valid": np.ones(4, bool),
                "gt_boxes": np.zeros((1, 2, 12), np.float32),
                "gt_classes": np.zeros((1, 2), np.int32),
                "gt_valid": np.zeros((1, 2), bool),
                "traj_classes": np.zeros(2, np.int32),
                "token": f"{j}", "gt_attr": ["", ""], "times": None}


@pytest.mark.parametrize("num_shards,shuffle", [(2, True), (3, True),
                                                (2, False)])
def test_shards_take_the_jax_pipeline_order(num_shards, shuffle):
    """Each shard's batches, over three epochs of a looping shuffle (or one
    pass in order), hold the JAX pipeline's samples; the shards of one
    epoch partition it."""
    cfg_j, cfg = pp_n0()
    ds = _Samples(23)
    epoch = []
    for shard in range(num_shards):
        kw = dict(shuffle=shuffle, seed=7, loop=shuffle,
                  num_shards=num_shards, shard_id=shard)
        port = batches_from_dataset(ds, cfg, 2, **kw)
        jax_it = jax_batches_from_dataset(ds, cfg_j, 2, **kw)
        n = 3 * (23 // num_shards // 2) if shuffle else 23 // num_shards // 2
        got = [next(port)["tokens"] for _ in range(n)]
        want = [next(jax_it)["tokens"] for _ in range(n)]
        assert got == want
        epoch += [t for b in got[:23 // num_shards // 2] for t in b]
    assert len(set(epoch)) == len(epoch)
