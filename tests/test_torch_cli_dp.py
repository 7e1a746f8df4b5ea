"""The train and evaluate CLIs' multi-process flags
(`--coordinator_address`, `--num_processes`, `--process_id`): two gloo
ranks of each CLI on the CPU, world size 1 against the plain run, and
`--autoscale_lr`. The data-parallel step itself is held to the JAX
`shard_map` step by tests/test_torch_dp.py."""
import json
import os
import subprocess
import sys

import pytest
import torch

from futuredet_torch.cli import evaluate, train
from futuredet_torch.parallel import collectives, mesh
from tests.test_torch_dp import ROOT, WORKER_TIMEOUT_S, free_port
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

MODEL = "pp_forecast_n3dtf"
TRAIN = ["--model", MODEL, "--tiny", "--device", "cpu", "--synthetic", "2",
         "--epochs", "2", "--batch_size", "1"]
EVAL = ["--model", MODEL, "--tiny", "--device", "cpu", "--synthetic", "4",
        "--batch_size", "1", "--forecast_mode", "velocity_dense"]

# one rank: the train CLI, then the evaluate CLI of its checkpoint, each
# joining the process group at its own port
WORKER = r"""
import json, sys
import torch
rank, tport, eport, work, out = sys.argv[1:6]
torch.set_num_threads(1)
from futuredet_torch.cli import evaluate, train
dp = ["--num_processes", "2", "--process_id", rank]
state = train.main(json.loads(sys.argv[6]) + [
    "--work_dir", work, "--autoscale_lr",
    "--coordinator_address", "127.0.0.1:" + tport] + dp)
torch.save({n: p.detach() for n, p in state.model.named_parameters()},
           out + ".params.pt")
summary = evaluate.main(json.loads(sys.argv[7]) + [
    "--checkpoint_dir", work, "--out", out + ".json",
    "--coordinator_address", "127.0.0.1:" + eport] + dp)
json.dump(summary, open(out + ".summary", "w"))
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_dp")
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


def test_two_ranks_train_one_model_and_rank_0_writes_it(two_ranks):
    tmp, work, logs = two_ranks
    params = [torch.load(tmp / f"rank{r}.params.pt") for r in range(2)]
    assert all(torch.equal(params[0][n], params[1][n]) for n in params[0])
    assert "data-parallel training: process 1/2" in logs[1]
    # two steps an epoch, two epochs: checkpoints at steps 2 and 4
    from futuredet_torch.train.checkpoints import CheckpointManager
    assert CheckpointManager(str(work)).latest_step() == 4


def test_two_ranks_evaluate_the_whole_set_and_rank_0_writes(two_ranks,
                                                             tmp_path):
    """Each rank infers two of the four scenes; the gathered batches give
    every rank the single-process metrics, and only rank 0 writes them."""
    tmp, work, logs = two_ranks
    assert (tmp / "rank0.json").exists()
    assert not (tmp / "rank1.json").exists()
    assert "multi-process evaluation: process 1/2" in logs[1]
    summaries = [json.load(open(tmp / f"rank{r}.summary"))
                 for r in range(2)]
    single = evaluate.main(EVAL + ["--checkpoint_dir", str(work), "--out",
                                   str(tmp_path / "single.json")])
    assert summaries[0] == summaries[1] == json.loads(json.dumps(single))


def test_world_size_one_trains_as_the_plain_cli(tmp_path):
    """--num_processes 1 joins a one-rank gloo group: the same parameters
    bit for bit as the run without the flags (on one thread: the CPU's
    threaded reductions vary from run to run), and the group is left."""
    plain = train.main(TRAIN + ["--work_dir", str(tmp_path / "a")])
    one = train.main(TRAIN + ["--work_dir", str(tmp_path / "b"),
                              "--coordinator_address",
                              f"127.0.0.1:{free_port()}",
                              "--num_processes", "1", "--process_id", "0"])
    assert not torch.distributed.is_initialized()
    for (n, a), (_, b) in zip(plain.model.named_parameters(),
                              one.model.named_parameters()):
        assert torch.equal(a, b), n


def test_autoscale_lr_scales_by_the_world_size(monkeypatch):
    from futuredet_torch.config import get_config, tiny_variant
    cfg = tiny_variant(get_config(MODEL))
    args = train.parse_args(["--autoscale_lr"])
    base = cfg.train.optim.lr_max
    assert train.train_config(cfg, args, mesh.data_axis_size()) \
        .train.optim.lr_max == base
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    assert train.train_config(cfg, args, mesh.data_axis_size()) \
        .train.optim.lr_max == 4 * base
    # two ranks a space group leave two data ranks
    assert mesh.data_axis_size(2) == 2


@pytest.mark.parametrize("kw,match", [
    (dict(num_processes=2), "--process_id"),
    (dict(num_processes=2, process_id=2), "outside"),
])
def test_initialize_multihost_checks_its_flags(kw, match):
    with pytest.raises(ValueError, match=match):
        collectives.initialize_multihost("127.0.0.1:1", **kw)
    assert collectives.initialize_multihost() == 1
