"""futuredet_torch's training loop on the CPU at the small VoxelNet config:
checkpoints (a relative work dir, max_to_keep, epoch and step specs, a
model and optimizer restored bit for bit), resume, the SIGUSR1 preemption
checkpoint, the voxel-budget warning and MetricBuffer's means; and the
voxel budget of each mode (`max_voxels_train` in training, as the JAX
detector takes it) on forecast_n3dtf's own voxel grid."""
import dataclasses
import logging
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.ops.voxelize import voxelize_mean as jax_voxelize_mean

from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.train.checkpoints import CheckpointManager
from futuredet_torch.train.step import make_optimizer, train_step
from futuredet_torch.train.trainer import Hook, MetricBuffer, train
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_torch_voxelnet import voxelnet_config


def small_config(epochs=2, **voxel):
    cfg = voxelnet_config(port_config)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, total_epochs=epochs,
                                  log_interval=2),
        voxel=dataclasses.replace(cfg.voxel, **voxel))


def batches(cfg):
    """An endless stream over two fixed batches."""
    pair = [make_batch(cfg, 1, seed=s, n_objects=6, n_clutter=300,
                       points_per_object=120) for s in (0, 1)]
    i = 0
    while True:
        yield pair[i % 2]
        i += 1


def same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.items(), b.items()):
        assert ka == kb
        if isinstance(va, dict):
            same_state(va, vb)
        elif isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), ka
        elif isinstance(va, list):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                if isinstance(x, dict):
                    same_state(x, y)
                else:
                    assert x == y, ka
        else:
            assert va == vb, ka


def test_checkpoint_round_trip_with_a_relative_work_dir(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = small_config()
    lines = []
    state = train(cfg, batches(cfg), steps_per_epoch=2, work_dir="work",
                  device="cpu", log_fn=lines.append)
    assert state.step == 4
    mgr = CheckpointManager("work")
    assert mgr.directory == str(tmp_path / "work")
    assert mgr.all_steps() == [2, 4] and mgr.latest_step() == 4
    assert mgr.resolve("epoch_1") == 2 and mgr.resolve("latest") == 4
    assert mgr.resolve(2) == 2 and mgr.resolve("4") == 4
    assert mgr.metadata(2) == {"config": cfg.name, "epoch": 1}
    with pytest.raises(FileNotFoundError):
        mgr.resolve("epoch_7")
    with pytest.raises(FileNotFoundError):
        mgr.resolve(3)
    assert any(ln.startswith("step 2/4 loss") for ln in lines)

    fresh = build_detector(cfg, device="cpu", seed=123).train()
    opt = make_optimizer(cfg, fresh, 4)
    assert mgr.restore(fresh, opt) == 4
    same_state(fresh.state_dict(), state.model.state_dict())
    same_state(opt.state_dict(), state.optimizer.state_dict())
    # the restored pair takes the same next step as the original
    batch = make_batch(cfg, 1, seed=5, n_objects=6, n_clutter=300,
                       points_per_object=120)
    a = train_step(fresh, opt, batch, 4)
    b = train_step(state.model, state.optimizer, batch, 4)
    assert torch.equal(a["loss"], b["loss"])
    same_state(fresh.state_dict(), state.model.state_dict())


def test_max_to_keep_removes_the_oldest(tmp_path):
    cfg = small_config()
    model = build_detector(cfg, device="cpu")
    opt = make_optimizer(cfg, model, 10)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, model, opt)
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt", "step_3.pt"]


def test_resume_continues_at_the_saved_step(tmp_path):
    cfg1 = small_config(epochs=1)
    train(cfg1, batches(cfg1), steps_per_epoch=2, work_dir=str(tmp_path),
          device="cpu", log_fn=lambda s: None)
    cfg = small_config(epochs=2)
    seen, lines = [], []

    class Record(Hook):
        def before_step(self, step, state, batch):
            seen.append(step)

    state = train(cfg, batches(cfg), steps_per_epoch=2,
                  work_dir=str(tmp_path), resume=True, hooks=[Record()],
                  device="cpu", log_fn=lines.append)
    assert lines[0] == "resumed from step 2"
    assert seen == [2, 3] and state.step == 4
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_sigusr1_checkpoints_at_the_next_step_and_returns(tmp_path):
    cfg = small_config(epochs=5)
    calls = []

    def old_handler(signum, frame):
        calls.append(signum)

    class Preempt(Hook):
        def before_step(self, step, state, batch):
            if step == 2:
                os.kill(os.getpid(), signal.SIGUSR1)

    prev = signal.signal(signal.SIGUSR1, old_handler)
    try:
        lines = []
        state = train(cfg, batches(cfg), steps_per_epoch=10,
                      work_dir=str(tmp_path), hooks=[Preempt()],
                      device="cpu", log_fn=lines.append)
        assert state.step == 3
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.all_steps() == [3]
        assert mgr.metadata(3)["preempted"] is True
        assert "preemption checkpoint @ step 3" in lines
        assert signal.getsignal(signal.SIGUSR1) is old_handler
        assert signal.getsignal(signal.SIGTERM) is not None
        assert calls == []
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_a_sample_at_the_voxel_budget_warns_once(caplog):
    cfg = small_config(epochs=1, max_voxels_train=50)
    with caplog.at_level(logging.WARNING, logger="futuredet_torch"):
        train(cfg, batches(cfg), steps_per_epoch=2, device="cpu",
              log_fn=lambda s: None)
    warned = [r for r in caplog.records if "max_voxels_train" in r.message]
    assert len(warned) == 1


def test_metric_buffer_means():
    buf = MetricBuffer()
    buf.push({"loss": torch.tensor(1.0), "hm": torch.tensor([1.0, 3.0])})
    buf.push({"loss": torch.tensor(2.0), "hm": torch.tensor([5.0, 7.0])})
    assert buf.mean_and_clear() == {"loss": 1.5, "hm": 4.0}
    assert buf.mean_and_clear() == {}


def test_train_step_refuses_an_eval_model():
    cfg = small_config()
    model = build_detector(cfg, device="cpu")
    with pytest.raises(ValueError, match="train mode"):
        train_step(model, make_optimizer(cfg, model, 4),
                   make_batch(cfg, 1, n_objects=2, n_clutter=50), 0)


def test_training_voxelizes_under_max_voxels_train():
    """A scene of ~145k occupied voxels on forecast_n3dtf's voxel grid
    (1440 x 1440 x 41 at 0.075 x 0.075 x 0.2 m), between its budgets of
    120,000 (train) and 160,000 (eval): the detector keeps the lowest
    120,000 voxel ids in training, as the JAX detector's train path does,
    and every voxel in eval. Only the voxelizer runs (a small network on
    the full voxel grid)."""
    full = port_config.get_config("forecast_n3dtf").voxel
    cfg = small_config(**{f.name: getattr(full, f.name)
                          for f in dataclasses.fields(full)})
    v = cfg.voxel
    assert (v.max_voxels_train, v.max_voxels_eval) == (120000, 160000)
    rng = np.random.default_rng(5)
    P = 150000
    pts = np.zeros((1, P, 5), np.float32)
    pts[0, :, :2] = rng.uniform(-53.9, 53.9, (P, 2))
    pts[0, :, 2] = rng.uniform(-1.9, -1.7, P)
    pts[0, :, 3] = rng.uniform(0, 1, P)
    valid = np.ones((1, P), bool)
    # float32, as the voxelizer divides
    lo = np.array(v.pc_range[:3], np.float32)
    vs = np.array(v.voxel_size, np.float32)
    ids = np.unique((np.floor((pts[0, :, :3] - lo) / vs).astype(np.int64)
                     @ np.array([1, v.grid_size[0],
                                 v.grid_size[0] * v.grid_size[1]])))
    assert v.max_voxels_train < len(ids) < v.max_voxels_eval

    model = build_detector(cfg, device="cpu")
    kept = {}
    for mode in ("train", "eval"):
        getattr(model, mode)()
        _, vm = model.voxelize(torch.from_numpy(pts), torch.from_numpy(valid))
        c = vm.coords.numpy().astype(np.int64)
        kept[mode] = (c[:, 0] * v.grid_size[1] + c[:, 1]) * v.grid_size[0] \
            + c[:, 2]
        assert model.num_voxels == [len(kept[mode])]
    assert len(kept["train"]) == v.max_voxels_train
    assert len(kept["eval"]) == len(ids)
    np.testing.assert_array_equal(kept["train"], ids[:v.max_voxels_train])
    np.testing.assert_array_equal(kept["eval"], ids)
    # the JAX detector's train path: voxelize_mean under max_voxels_train
    n_jax = jax_voxelize_mean(
        jnp.asarray(pts[0]), jnp.asarray(valid[0]), jnp.asarray(v.pc_range),
        jnp.asarray(v.voxel_size), grid_size=v.grid_size,
        max_voxels=v.max_voxels_train,
        max_points=v.max_points_per_voxel)[3]
    assert int(n_jax) == v.max_voxels_train
