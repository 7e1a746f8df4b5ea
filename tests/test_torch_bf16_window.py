"""`middle_gather_algo="window_bf16"` of futuredet_torch against the JAX
package, on the serving config of `tests/test_torch_bf16.py`: at B = 1
the JAX Pallas window kernel in bf16 (run in interpret mode, as the JAX
package's tests run it on the CPU) against K2's bf16 family, at bf16
inputs' tolerance; at B = 2, where the JAX detector runs `loop` in fp32,
at fp32 tolerance, and the port's forward bit for bit its fp32 one. A file
of its own: the two JAX forwards take about a minute on one worker."""
import pytest
import torch

from futuredet_torch import config as port_config
from tests.test_torch_bf16 import (CASES, _port_forward, check_serving_case,
                                   serving_config, serving_run, with_knobs)

WINDOW = ("window_bf16", "window_bf16_b2")


@pytest.fixture(scope="module")
def serving():
    return serving_run(WINDOW)


@pytest.mark.parametrize("case", WINDOW)
def test_window_bf16_matches_jax(serving, case):
    check_serving_case(serving, case)


def test_window_bf16_at_b2_is_the_fp32_forward(serving):
    """window_bf16 is `loop` when batched (the JAX detector): the port's
    B = 2 forward is its fp32 forward bit for bit."""
    base = serving_config(port_config)
    got = _port_forward(serving["variables"],
                        with_knobs(base, CASES["window_bf16_b2"][0]), 2)
    want = _port_forward(serving["variables"], base, 2)
    for p, q in zip(got, want):
        for k in q:
            assert torch.equal(p[k], q[k]), k
