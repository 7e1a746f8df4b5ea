"""The port's train and evaluate CLIs on nuScenes-format infos
(`--info_path`, the mini dataset of `tests/test_torch_cli.py::
mini_dataset`) against the JAX package's CLIs, both on the CPU from the
same weights: the losses of two train steps with GT-AUG, and the
evaluation's detections and metrics summary."""
import dataclasses
import pickle

import jax
import numpy as np
import pytest

from futuredet_torch.cli import evaluate, train
from tests.test_torch_cli import (MAX_LET_OFF, MODEL, SUMMARY_ATOL,
                                  match_timestep, mini_dataset)
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

# the first step's loss: the pillar train step's tolerance
# (tests/test_torch_train_pillars.py); the second follows a first AdamW
# update, which moves each weight by ~lr * sign(g), so a near-zero gradient
# whose sign rounding flips moves that weight by 2 lr
LOSS_RTOL = (5e-5, 1e-3)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return mini_dataset(tmp_path_factory.mktemp("nusc"))


def port_model_from(variables, cfg):
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.device_get(variables),
                                             cfg), strict=True)
    return model


class LossHook:
    def __init__(self):
        self.losses = []

    def before_step(self, *a):
        pass

    def after_step(self, step, state, metrics):
        self.losses.append(float(np.asarray(metrics["loss"])))

    def after_epoch(self, *a):
        pass

    def after_train(self, *a):
        pass


def test_train_cli_on_infos_matches_the_jax_cli(data, tmp_path,
                                                monkeypatch):
    """Both CLIs train the tiny pillar model for one epoch of two steps on
    the same CBGS-resampled, GT-AUG-pasted, augmented batches, the port
    from the JAX CLI's initial weights."""
    import futuredet_torch.train.trainer as port_trainer
    import futuredet_tpu.train.trainer as jax_trainer

    tr, _, db = data
    monkeypatch.chdir(tmp_path)
    argv = ["--model", MODEL, "--tiny", "--info_path", tr, "--db_info_path",
            db, "--epochs", "1", "--batch_size", "1"]

    inits, runs = [], {}

    def recording(module, key):
        real = module.train

        def run(*a, **kw):
            hook = LossHook()
            runs[key] = hook
            kw["hooks"] = list(kw.get("hooks") or []) + [hook]
            return real(*a, **kw)
        return run

    real_init = jax_trainer.init_state

    def init(*a, **kw):
        # a host copy: the jitted step donates the state's buffers
        st = real_init(*a, **kw)
        inits.append(jax.device_get({"params": st.params,
                                     "batch_stats": st.batch_stats}))
        return st

    monkeypatch.setattr(jax_trainer, "init_state", init)
    monkeypatch.setattr(jax_trainer, "train", recording(jax_trainer, "jax"))
    from futuredet_tpu.cli import train as jax_train
    jax_train.main(argv + ["--work_dir", "jax_work"])

    variables = inits[0]
    monkeypatch.setattr(port_trainer, "build_detector",
                        lambda cfg, device=None, seed=0:
                        port_model_from(variables, cfg).to(device))
    monkeypatch.setattr(port_trainer, "train",
                        recording(port_trainer, "port"))
    state = train.main(argv + ["--device", "cpu", "--work_dir",
                               "port_work"])
    assert state.step == 2
    got, want = runs["port"].losses, runs["jax"].losses
    assert len(got) == len(want) == 2
    for g, w, rtol in zip(got, want, LOSS_RTOL):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


def test_evaluate_cli_on_infos_matches_the_jax_cli(data, tmp_path,
                                                   monkeypatch):
    """The JAX CLI's seeded init on the first val batch, carried into a
    port checkpoint: both CLIs on the val infos give the same detections
    (`match_timestep`'s let-off) and every summary value within
    SUMMARY_ATOL."""
    import futuredet_tpu.train.step as jax_step
    from futuredet_torch.config import get_config, tiny_variant
    from futuredet_torch.train.checkpoints import CheckpointManager
    from futuredet_torch.train.step import make_optimizer
    from futuredet_tpu.cli import evaluate as jax_evaluate

    _, va, _ = data
    monkeypatch.chdir(tmp_path)
    inits = []
    real_init = jax_step.init_state

    def init(*a, **kw):
        st = real_init(*a, **kw)
        inits.append(jax.device_get({"params": st.params,
                                     "batch_stats": st.batch_stats}))
        return st

    monkeypatch.setattr(jax_step, "init_state", init)
    common = ["--model", MODEL, "--tiny", "--info_path", va,
              "--feed_dtype", "fp32", "--forecast_mode", "velocity_dense", "--cohort_analysis",
              "--K", "5", "--extractBox"]
    want = jax_evaluate.main(common + [
        "--checkpoint_dir", "no_jax_ckpt", "--predictions_path", "j.pkl",
        "--out", "j.json"])

    cfg = tiny_variant(get_config(MODEL))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                num_input_features=6))
    st = inits[0]
    model = port_model_from(st, cfg)
    CheckpointManager("port_ckpt").save(1, model,
                                        make_optimizer(cfg, model, 1))
    got = evaluate.main(common + [
        "--device", "cpu", "--checkpoint_dir", "port_ckpt",
        "--predictions_path", "p.pkl", "--out", "p.json"])

    with open("j.pkl", "rb") as f:
        jsaved = pickle.load(f)
    with open("p.pkl", "rb") as f:
        psaved = pickle.load(f)
    assert len(psaved) == len(jsaved) == 2
    post = cfg.test.nms.post_max_size
    thr = cfg.test.nms.iou_threshold
    n, let_off = 0, []
    for (det, gt, tok), (jdet, jgt, jtok) in zip(psaved, jsaved):
        assert tok == jtok
        np.testing.assert_array_equal(gt["boxes"], jgt["boxes"])
        for t in range(cfg.model.head.timesteps):
            sl = slice(t * post, (t + 1) * post)
            keep = det.valid[0, sl]
            jkeep = np.asarray(jdet.valid[0, sl])
            assert keep.sum() == jkeep.sum()
            n += int(keep.sum())
            let_off += match_timestep(
                det.boxes[0, sl][keep], det.scores[0, sl][keep],
                np.asarray(jdet.boxes[0, sl])[jkeep],
                np.asarray(jdet.scores[0, sl])[jkeep], post, thr)
    assert n > 20 and len(let_off) <= MAX_LET_OFF, let_off

    def flat(d, path=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", v
    got_flat, want_flat = dict(flat(got)), dict(flat(want))
    assert got_flat.keys() == want_flat.keys()
    for k, v in want_flat.items():
        assert abs(got_flat[k] - v) <= SUMMARY_ATOL, (k, got_flat[k], v)

