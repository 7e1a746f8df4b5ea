"""The system under test: `futuredet_torch`, and nothing else of the repo.

This is the only module of the benchmark that imports the program. It
builds the detector of a configuration with the benchmark's weights, and
hands the loops three calls: a served scene (`build_detector`'s model in
eval mode, then `eval/decode.py::decode_and_nms`), a training step
(`train/step.py::train_step` with `make_optimizer`), and the names of the
detector's children, which the traced run hooks.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

import torch
from torch import nn

# the program's hand-written kernels, by the names its CUDA sources give
# them (`futuredet_torch/csrc/*.cu`)
K1_KERNELS = ("nms_pair_kernel", "nms_walk_kernel")
K2_KERNELS = ("narrow_kernel", "wide_kernel", "bf16_kernel")


def port_config(config: Dict):
    """The port's ExperimentConfig that a configuration file names (its
    `tiny_variant` where the file asks for one: the CPU tests' geometry)."""
    from futuredet_torch.config import get_config, tiny_variant
    cfg = get_config(config["port_config"])
    return tiny_variant(cfg) if config.get("variant") == "tiny" else cfg


def port_experiment(config: Dict) -> Dict:
    """That configuration as a plain dict (lists for tuples)."""
    return json.loads(json.dumps(dataclasses.asdict(port_config(config))))


class Program:
    """The port's detector of the configuration file `config` on `device`,
    its parameters and buffers those of `state_dict` (made by the
    benchmark)."""

    def __init__(self, config: Dict, state_dict: Dict, device,
                 training: bool = False, total_steps: int = 1):
        from futuredet_torch.models.detector import build_single_stage
        self.cfg = port_config(config)
        # the modules `build_detector` builds for a single-stage config,
        # made on the device without its seeded CPU init: the benchmark's
        # weights replace it. Not on the meta device: the first move of
        # meta tensors to a device costs some seconds of torch's lazy
        # imports, which no run of the port itself pays
        with torch.device(device):
            model = build_single_stage(self.cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.train(training)
        self.optimizer = None
        if training:
            from futuredet_torch.train.step import make_optimizer
            self.optimizer = make_optimizer(self.cfg, model, total_steps)

    def children(self) -> Dict[str, nn.Module]:
        return dict(self.model.named_children())

    @torch.no_grad()
    def forward(self, points: torch.Tensor, valid: torch.Tensor):
        """One scene's head maps: points (P, F), valid (P,) on the card."""
        return self.model(points[None], valid[None])

    @torch.no_grad()
    def decode(self, preds):
        """The Detections of the maps (boxes, scores, labels, valid), on
        the device."""
        from futuredet_torch.eval.decode import decode_and_nms
        return decode_and_nms(self.cfg, preds)

    def step(self, batch: Dict, count: int) -> Dict[str, torch.Tensor]:
        from futuredet_torch.train.step import train_step
        return train_step(self.model, self.optimizer, batch, count)

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """AdamW's first moment of each parameter, by name."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {names[id(p)]: s["exp_avg"]
                for p, s in self.optimizer.state.items()}
