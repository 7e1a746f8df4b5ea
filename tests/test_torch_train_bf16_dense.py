"""Training of the small VoxelNet under `middle_dense_from_stage=2` and
`middle_dense_dtype="bfloat16"`, futuredet_torch against the JAX package:
two B = 2 train steps of the zero-drop config of
tests/test_torch_voxelnet.py, by the rules of
tests/test_torch_train_bf16_pillars.py.

The JAX package cannot take this step as it stands: its `DenseConv3d`
convolves bf16 operands with `preferred_element_type=float32`, and the
transpose of `conv_general_dilated` passes the fp32 cotangent and the
bf16 operand to one conv, which raises (jax 0.9.0;
tests/test_torch_bf16_grads.py pins it). The reference here is the JAX
step with that conv written as an fp32 conv of the bf16-rounded operands
(`differentiable_bf16_conv`): the same forward, and the gradient that
JAX's rule for a mixed-precision product gives (the fp32 result rounded
to each operand's dtype, as the transpose of `dot_general` does), which
the port computes (`models/middle.py::SparseConv.dense`). The stages
before the dense tail run `middle_gather_algo="stacked"`, the JAX
package's `xpack` numbers in half its compile time."""
import contextlib

import jax
import jax.numpy as jnp
import pytest

from futuredet_tpu import config as jax_config
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from tests.test_torch_train_bf16_pillars import (check_knob_step,
                                                 knob_steps, with_knobs)
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_torch_voxelnet import voxelnet_config

KNOBS = dict(middle_dense_from_stage=2, middle_dense_dtype="bfloat16")
STACKED = dict(middle_gather_algo="stacked")


@contextlib.contextmanager
def differentiable_bf16_conv():
    """`jax.lax.conv_general_dilated` of bf16 operands into fp32 computed
    as an fp32 conv of the same (bf16-valued) operands."""
    conv = jax.lax.conv_general_dilated

    def fp32_conv(lhs, rhs, *args, preferred_element_type=None, **kw):
        if lhs.dtype == jnp.bfloat16 and preferred_element_type == \
                jnp.float32:
            lhs, rhs = lhs.astype(jnp.float32), rhs.astype(jnp.float32)
            preferred_element_type = None
        return conv(lhs, rhs, *args,
                    preferred_element_type=preferred_element_type, **kw)
    jax.lax.conv_general_dilated = fp32_conv
    try:
        yield
    finally:
        jax.lax.conv_general_dilated = conv


@pytest.fixture(scope="module")
def run():
    cfg_j = with_knobs(voxelnet_config(jax_config), STACKED)
    cfg = with_knobs(voxelnet_config(port_config), STACKED)
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    return knob_steps(cfg_j, cfg, KNOBS, batch,
                      patch=differentiable_bf16_conv)


@pytest.mark.parametrize("step", [0, 1])
def test_dense_bf16_step_matches_jax(run, step):
    check_knob_step(run[step])


def test_dense_bf16_step_trains_the_dense_stages(run):
    """Stages 2-3 run dense: their parameters take gradients, in fp32."""
    grads = run[0]["pb"]["grads"]
    dense = [n for n in grads if n.startswith(("backbone.conv3",
                                               "backbone.conv4"))]
    assert dense and all(grads[n].dtype.name == "float32" for n in dense)
    assert all(abs(grads[n]).max() > 0 for n in dense
               if n.endswith("weight"))
