"""chip_smoke.py's phases 35-38 (export, the dense-tail and circle-NMS
programs among it, --profile, FLOPs, tools and the sorted reader)
rehearsed on the CPU with the tiny configs, K1 and K2 counted inside
their operators' CPU implementations (so that an exported program counts
too), a small nuScenes-format dataset and short
checkpoints standing in for phases 17 and 21's. The trace of phase 36
holds no card kernels here: the rehearsal runs it to that check."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tests.test_torch_chip_smoke_nusc import small_dataset  # noqa: E402


@pytest.fixture
def tools_phases_on_the_cpu(monkeypatch, tmp_path):
    """The tiny configs, K1 and K2 counted
    inside their operators' CPU implementations (so that a loaded program
    counts too), no-op device synchronisation and timers."""
    from futuredet_torch import config
    from futuredet_torch.ops import pallas_gather, pallas_nms
    small = {n: config.tiny_variant(config.get_config(n))
             for n in (cs.NAME, cs.VOX_NAME)}
    monkeypatch.setattr(config, "get_config", lambda name: small[name])
    for mod, name, wrapper in (
            (pallas_nms, "nms_alive_plain", pallas_nms.rotate_nms_alive),
            (pallas_gather, "gather_conv_plain", pallas_gather.gather_conv)):
        def counted(*args, plain=getattr(mod, name), wrapper=wrapper):
            wrapper.launches += 1
            return plain(*args)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "time_host", lambda fn, warmup=0, reps=0:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "MAX_POINTS", 1024)
    monkeypatch.setattr(cs, "TRAIN_CLUTTER", 1500)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(cs, "NUSC_KEYFRAMES", 2)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    os.makedirs(cs.OUT_DIR)
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lines
    torch.set_num_threads(n)


def test_tools_phases_rehearse_on_the_cpu(tools_phases_on_the_cpu,
                                          tmp_path):
    from futuredet_torch.cli import create_data
    lines = tools_phases_on_the_cpu
    dev = torch.device("cpu")
    work = str(tmp_path)
    assert cs.export_path(dev, "cpu", work) == {
        cs.NAME + "_exported": {"k1": 1, "k2": 0},
        cs.VOX_NAME + "_exported": {"k1": 1, "k2": 20},
        cs.VOX_NAME + "_dense_from_stage0_exported": {"k1": 1, "k2": 0},
        cs.VOX_NAME + "_dense_from_stage2_exported": {"k1": 1, "k2": 10},
        cs.NAME + "_circular_nms_exported": {"k1": 0, "k2": 0}}
    with pytest.raises(RuntimeError, match="K2 launches"):
        cs.profile_path(dev, "cpu", work)
    cs.flops_path(dev, "cpu", {cs.NAME: {"uniform": 1.0},
                               cs.VOX_NAME: {"uniform_blobs": 1.0}})
    # phases 17 and 21's pillar checkpoints and phase 21's infos
    root = tmp_path / "nuscenes"
    version = small_dataset(root, keyframes=cs.NUSC_KEYFRAMES, between=1)
    train_pkl, _ = create_data.main([
        "nuscenes_data_prep", "--root_path", str(root), "--version",
        version, "--nsweeps", "3", "--model", cs.NAME])
    for d, seed in (("pp17", "1"), (f"nusc_{cs.NAME}", "0")):
        cs.run_train_cli(["--model", cs.NAME, "--device", "cpu",
                          "--info_path", str(train_pkl), "--epochs", "1",
                          "--batch_size", "1", "--no_gt_aug", "--seed", seed,
                          "--work_dir", str(tmp_path / d)], cs.StepCounts())
    post = cs.tools_path(dev, "cpu", work, str(tmp_path / "pp17"))
    assert post == {cs.NAME + "_postprocess_eval": {"k1": 2, "k2": 0}}
    phases = [ln.get("phase") for ln in lines]
    assert phases == ["export"] * 5 + ["flops", "flops", "tools"]
    tools_line = lines[-1]
    assert [ln["launches_exported"] for ln in lines[:5]] == [
        (1, 0), (1, 20), (1, 0), (1, 10), (0, 0)]
    assert lines[4]["operator_nodes"] == {"nms_alive": 0, "circle_nms": 7,
                                          "gather_conv": 0}
    assert all("eager_ms" in ln for ln in lines[:2])
    assert tools_line["prototypes"] > 0
    assert tools_line["postprocess_launches_per_sample"] == [(1, 0)] * 2
    assert tools_line["sorted_reader_max_abs_err"] <= \
        tools_line["sorted_reader_tol"]
