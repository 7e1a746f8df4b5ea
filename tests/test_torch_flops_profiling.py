"""futuredet_torch.utils.{flops,profiling,registry} against the JAX
package's modules, and the train CLI's --profile: model_flops of the tiny
pillar and VoxelNet configs equals the analytic count of their convs,
deconvs, matmuls and K2 contractions exactly (XLA's cost analysis of the
same JAX forward printed beside it: XLA also counts elementwise
operations, and its static-capacity middle), a CPU trace file, StepTimer
and Registry."""
import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import analytic_flops
from futuredet_torch.config import get_config, tiny_variant
from futuredet_torch.models.detector import build_detector
from futuredet_torch.utils import flops, profiling, registry
from futuredet_tpu.config import get_config as jax_get_config
from futuredet_tpu.config import tiny_variant as jax_tiny_variant
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.utils import flops as jax_flops
from futuredet_tpu.utils import profiling as jax_profiling
from futuredet_tpu.utils import registry as jax_registry
from tests.test_torch_train_step import one_torch_thread  # noqa: F401


def xla_cost(name):
    """XLA's cost analysis of the JAX forward on model_flops's inputs (the
    variables as abstract shapes: only the apply is compiled)."""
    cfg = jax_tiny_variant(jax_get_config(name))
    model = jax_build(cfg)
    P = cfg.voxel.max_points
    pts = jnp.zeros((1, P, 5), jnp.float32)
    valid = jnp.ones((1, P), bool)
    variables = jax.eval_shape(
        lambda r: model.init(r, pts, valid, train=False),
        jax.random.PRNGKey(0))
    return jax_flops.cost_analysis(
        lambda v, p, m: model.apply(v, p, m, train=False), variables, pts,
        valid)


@pytest.mark.parametrize("name", ["pp_forecast_n3dtf", "forecast_n3dtf"])
def test_model_flops_is_the_analytic_count(name):
    cfg = tiny_variant(get_config(name))
    got = flops.model_flops(cfg, device="cpu")
    P = cfg.voxel.max_points
    want, parts = analytic_flops(build_detector(cfg, "cpu"),
                                 torch.zeros(1, P, 5),
                                 torch.ones(1, P, dtype=torch.bool))
    assert parts["conv"] > 0 and parts["linear" if name.startswith("pp")
                                         else "k2"] > 0
    assert got["flops"] == want
    assert got["bytes_accessed"] > 0
    xla = xla_cost(name)
    print(f"{name} tiny: port {got['flops']:.0f} flops (analytic {parts}),"
          f" XLA {xla['flops']:.0f} (ratio port/XLA "
          f"{got['flops'] / xla['flops']:.3f}); bytes port "
          f"{got['bytes_accessed']:.0f} (unfused), XLA "
          f"{xla['bytes accessed']:.0f} (fused)")


def test_cost_analysis_counts_k2_and_not_k1():
    """K2's registered formula 2 N 27 Cin Cout, K1 0 flops; bytes are the
    inputs and outputs of each dispatched operation."""
    from futuredet_torch.ops.pallas_gather import gather_conv
    from futuredet_torch.ops.pallas_nms import rotate_nms_alive
    x = torch.randn(10, 8)
    t = torch.randint(0, 11, (27, 6), dtype=torch.int32)
    w = torch.randn(27, 8, 16)
    got = flops.cost_analysis(gather_conv, x, t, w)
    assert got["flops"] == 2 * 6 * 27 * 8 * 16
    assert got["bytes accessed"] == 4 * (10 * 8 + 27 * 6 + 27 * 8 * 16
                                         + 6 * 16)
    b = torch.rand(2, 30, 5)
    v = torch.ones(2, 30, dtype=torch.bool)
    assert flops.cost_analysis(rotate_nms_alive, b, v, 0.2)["flops"] == 0


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" == e.get("name") for e in events)
    assert profiling.device_memory_stats() == {}   # no card here


def test_step_timer_and_registry_behave_as_the_jax_ones():
    for mod in (profiling, jax_profiling):
        t = mod.StepTimer()
        with t.phase("data"):
            time.sleep(0.01)
        with t.phase("data"):
            pass
        with pytest.raises(ValueError):
            with t.phase("compute"):
                raise ValueError
        out = t.summary_and_reset()
        assert set(out) == {"data", "compute"} and out["data"] >= 0.01
        assert t.summary_and_reset() == {}
    for mod in (registry, jax_registry):
        assert [r.name for r in (mod.DETECTORS, mod.READERS,
                                 mod.DATASETS)] == ["detectors", "readers",
                                                    "datasets"]
        reg = mod.Registry("things")

        @reg.register()
        def thing():
            return 1

        reg.register("other")(len)
        assert "thing" in reg and reg.get("other") is len
        assert reg.get("thing") is thing
        with pytest.raises(KeyError, match="already registered"):
            reg.register("thing")(len)
        with pytest.raises(KeyError, match=r"known: \['other', 'thing'\]"):
            reg.get("missing")


def test_train_cli_profile_traces_two_steps(tmp_path):
    from futuredet_torch.cli import train
    state = train.main([
        "--model", "pp_forecast_n3dtf", "--tiny", "--device", "cpu",
        "--synthetic", "2", "--batch_size", "1", "--epochs", "1",
        "--work_dir", str(tmp_path / "work"),
        "--profile", str(tmp_path / "trace")])
    assert state.step == 2
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::convolution" in names and "Optimizer.step#AdamW.step" in \
        names
