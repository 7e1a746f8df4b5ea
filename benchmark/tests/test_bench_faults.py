"""`correct` comes out false when the timed path is broken underneath: the
harness runs as a run does, but for the look for a card, on the CPU at
the tiny geometry, with one fault planted in the program each time."""
from __future__ import annotations

import pytest
import torch

from conftest import STREAMS, TRAIN, tiny_cell


def _run(cell, wrap):
    from benchmark import harness
    base = harness.program_factory(cell)
    return harness.run_cell(cell, lambda sd: wrap(base(sd)))


def _altered_answer(program):
    """Every detection's box moved 0.5 m where decode_and_nms made it."""
    decode = program.decode

    def bad(preds):
        det = decode(preds)
        boxes = det.boxes.clone()
        boxes[..., 0] += 0.5
        return det._replace(boxes=boxes)
    program.decode = bad
    return program


def _altered_maps(program):
    """One head map altered by 1% where the detector produced it."""
    forward = program.forward

    def bad(points, valid):
        preds = forward(points, valid)
        preds[3]["vel"] = preds[3]["vel"] * 1.01
        return preds
    program.forward = bad
    return program


@pytest.mark.parametrize("fault", [_altered_answer, _altered_maps])
@pytest.mark.parametrize("config,workload", STREAMS)
def test_stream_fault_is_not_correct(config, workload, fault):
    rec = _run(tiny_cell(config, "sweep_stream", workload), fault)
    assert rec["correct"] is False, rec["checks"]


def _unchanged_state(program):
    """A step that leaves the parameters and the optimizer as they were."""
    def step(batch, count):
        from futuredet_torch.train.step import train_step
        saved = {k: v.detach().clone()
                 for k, v in program.model.state_dict().items()}
        out = train_step(program.model, program.optimizer, batch, count)
        program.model.load_state_dict(saved)
        return out
    program.step = step
    return program


def _altered_loss(program):
    """The step's loss altered by 0.1% where the step returns it."""
    step = program.step

    def bad(batch, count):
        out = step(batch, count)
        return dict(out, loss=out["loss"] * 1.001)
    program.step = bad
    return program


class _ScaledGrad(torch.autograd.Function):
    """The identity forward; the gradient scaled on its way back."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.scale, None


def _strided_conv(program):
    """The sparse middle's strided conv into its third stage: its input
    gradient is the only one that reaches the stages before it."""
    return program.model.backbone.conv3[0]


def _scaled_dw(program):
    """One sparse conv's weight gradient (dW) 25% too large, where the
    backward produces it."""
    _strided_conv(program).weight.register_hook(lambda g: g * 1.25)
    return program


def _scaled_dx(program):
    """One sparse conv's input gradient (dx) 25% too large, where the
    backward produces it."""
    _strided_conv(program).register_forward_pre_hook(
        lambda m, args: (_ScaledGrad.apply(args[0], 1.25),) + args[1:])
    return program


@pytest.mark.parametrize("fault", [_unchanged_state, _altered_loss,
                                   _scaled_dw, _scaled_dx])
def test_train_fault_is_not_correct(fault):
    config, workload = TRAIN
    rec = _run(tiny_cell(config, "train_b1", workload), fault)
    assert rec["correct"] is False, rec["checks"]
