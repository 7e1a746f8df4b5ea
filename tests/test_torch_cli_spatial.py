"""The train and evaluate CLIs' `--space`: two gloo ranks of one space
group on the CPU train two steps of tiny pp_forecast_n3dtf, each holding
a band of the canvas rows, and evaluate the checkpoint; `--autoscale_lr`
counts the data ranks. The spatially sharded step itself is held to the
JAX GSPMD step by tests/test_torch_spatial.py."""
import json
import os
import subprocess
import sys

import pytest
import torch

from futuredet_torch.cli import evaluate, train
from futuredet_torch.parallel import mesh
from tests.test_torch_cli_dp import EVAL, MODEL, TRAIN
from tests.test_torch_dp import ROOT, WORKER_TIMEOUT_S, free_port
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

METRIC_ATOL = 1e-3

# one rank: the train CLI (recording the points of every batch it trains
# on), then the evaluate CLI of the checkpoint, each joining the process
# group at its own port
WORKER = r"""
import json, sys
import torch
rank, tport, eport, work, out = sys.argv[1:6]
torch.set_num_threads(1)
from futuredet_torch.cli import evaluate, train
from futuredet_torch.train import trainer

seen = []
step = trainer.train_step


def recording(model, opt, batch, count):
    seen.append(batch["points"].clone())
    return step(model, opt, batch, count)


trainer.train_step = recording
sp = ["--space", "2", "--num_processes", "2", "--process_id", rank]
state = train.main(json.loads(sys.argv[6]) + [
    "--work_dir", work, "--coordinator_address", "127.0.0.1:" + tport] + sp)
torch.save({"params": {n: p.detach() for n, p in
                       state.model.named_parameters()},
            "batches": seen}, out + ".train.pt")
summary = evaluate.main(json.loads(sys.argv[7]) + [
    "--checkpoint_dir", work, "--out", out + ".json",
    "--coordinator_address", "127.0.0.1:" + eport] + sp)
json.dump(summary, open(out + ".summary", "w"))
"""


@pytest.fixture(scope="module")
def space_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_spatial")
    work = tmp / "work"
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    tport, eport = free_port(), free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), tport, eport, str(work),
         str(tmp / f"rank{r}"), json.dumps(TRAIN), json.dumps(EVAL)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two CLI ranks did not finish in "
                    f"{WORKER_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return tmp, work, logs


def test_one_space_group_trains_one_model_on_the_same_batches(space_ranks):
    tmp, work, logs = space_ranks
    runs = [torch.load(tmp / f"rank{r}.train.pt") for r in range(2)]
    params = [r["params"] for r in runs]
    assert all(torch.equal(params[0][n], params[1][n]) for n in params[0])
    # two one-sample steps an epoch, two epochs, the same scenes on both
    assert len(runs[0]["batches"]) == len(runs[1]["batches"]) == 4
    for a, b in zip(*(r["batches"] for r in runs)):
        assert torch.equal(a, b)
    assert "process 1/2, 2 ranks a space group" in logs[1]
    from futuredet_torch.train.checkpoints import CheckpointManager
    assert CheckpointManager(str(work)).latest_step() == 4


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def test_space_evaluate_writes_the_metrics_of_space_1(space_ranks, tmp_path):
    """The first rank of the space group decodes and writes the metrics
    JSON of the single-process run of the same checkpoint; the other rank
    runs the forward alone and returns None. The banded convs sum in
    another order than the whole ones (head maps within 1e-5 of their max,
    tests/test_torch_spatial.py), which can swap two detections' ranks:
    every number within METRIC_ATOL."""
    tmp, work, logs = space_ranks
    assert (tmp / "rank0.json").exists()
    assert not (tmp / "rank1.json").exists()
    assert json.load(open(tmp / "rank1.summary")) is None
    evaluate.main(EVAL + ["--checkpoint_dir", str(work), "--out",
                          str(tmp_path / "single.json")])
    got = list(leaves(json.load(open(tmp / "rank0.json"))))
    want = list(leaves(json.load(open(tmp_path / "single.json"))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(b, float):
            assert abs(a - b) <= METRIC_ATOL, (path, a, b)
        else:
            assert a == b, (path, a, b)
    assert json.load(open(tmp / "rank0.summary")) == \
        json.load(open(tmp / "rank0.json"))


def test_autoscale_lr_counts_the_data_ranks(monkeypatch):
    from futuredet_torch.config import get_config, tiny_variant
    cfg = tiny_variant(get_config(MODEL))
    base = cfg.train.optim.lr_max
    args = train.parse_args(["--autoscale_lr", "--space", "2"])
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    assert train.train_config(cfg, args, mesh.data_axis_size(args.space)) \
        .train.optim.lr_max == 2 * base
    assert mesh.data_axis_size(4) == 1
    with pytest.raises(ValueError, match="does not divide"):
        mesh.data_axis_size(3)


@pytest.mark.parametrize("cli", [train.main, evaluate.main])
def test_space_without_its_ranks_fails_loudly(cli):
    """--space 2 in a process of one rank: no layout to shard over."""
    base = TRAIN if cli is train.main else EVAL
    with pytest.raises(ValueError, match="does not divide"):
        cli(base + ["--space", "2"])
