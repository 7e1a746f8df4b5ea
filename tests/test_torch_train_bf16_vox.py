"""Training of the small VoxelNet under `middle_sparse_dtype="bfloat16"`
and `compute_dtype="bfloat16"`, futuredet_torch against the JAX package:
two B = 2 train steps of the zero-drop config of
tests/test_torch_voxelnet.py, by the rules of
tests/test_torch_train_bf16_pillars.py (the JAX step with its per-branch
head towers; the bf16 conv biases left out).

Under these knobs every sparse conv runs its forward on bf16 inputs and
weights (K2's bf16 family on the card) and its backward on the fp32
weights and cotangent (K2's fp32 families), with dx rounded to bf16 and an
fp32 dW, as the JAX custom VJPs do (`ops/sparse_conv.py::
SparseConvFunction`, pinned alone by tests/test_torch_bf16_grads.py); the
z_crush, RPN and head towers run in bf16. The JAX forward drops no site.
Both sides run `middle_gather_algo="stacked"`, which the JAX package
computes as its default `xpack` (the same products and fp32 sums, the
same custom VJPs) and compiles in 32 s where `xpack` takes 56 s.
"""
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.ops import sparse_conv
from tests.test_torch_train_bf16_pillars import (check_knob_step,
                                                 knob_steps,
                                                 per_branch_towers,
                                                 with_knobs)
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_torch_voxelnet import voxelnet_config

KNOBS = dict(compute_dtype="bfloat16", middle_sparse_dtype="bfloat16")
STACKED = dict(middle_gather_algo="stacked")


@pytest.fixture(scope="module")
def run():
    cfg_j = with_knobs(voxelnet_config(jax_config), STACKED)
    cfg = with_knobs(voxelnet_config(port_config), STACKED)
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    return knob_steps(cfg_j, cfg, KNOBS, batch, patch=per_branch_towers)


@pytest.mark.parametrize("step", [0, 1])
def test_voxelnet_bf16_step_matches_jax(run, step):
    check_knob_step(run[step])


def test_voxelnet_bf16_step_runs_the_sparse_convs_in_bf16(monkeypatch):
    """20 sparse convs a step take bf16 features and bf16 weights forward;
    the 19 input gradients take the fp32 cotangent and fp32 weights."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import forward_backward
    cfg = with_knobs(voxelnet_config(port_config), KNOBS)
    calls = []
    conv = sparse_conv.gather_conv

    def recording(f, t, w, b=None):
        calls.append((f.dtype, w.dtype))
        return conv(f, t, w, b)
    monkeypatch.setattr(sparse_conv, "gather_conv", recording)
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    model = build_detector(cfg, device="cpu").train()
    forward_backward(model, batch)
    bf16 = (torch.bfloat16, torch.bfloat16)
    fp32 = (torch.float32, torch.float32)
    assert calls[:20] == [bf16] * 20
    assert calls[20:] == [fp32] * 19
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(float(model.backbone.conv1[0].conv1.weight.grad
                             .abs().max()))
