"""Step-indexed checkpoints on `torch.save`.

Port of `futuredet_tpu/train/checkpoints.py` (orbax there; reference
torch save / load with a latest pointer,
`det3d/torchie/trainer/trainer.py:362-376`). A checkpoint is one file,
`<directory>/step_<N>.pt`, holding the step, the model's `state_dict`,
the optimizer's `state_dict` and a metadata dict; it is written to a
temporary name and renamed, so a file under its final name is whole.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Union

import torch
from torch import nn

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        # an absolute path: the JAX package's fix for relative work dirs
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, model: nn.Module,
             optimizer: torch.optim.Optimizer,
             metadata: Optional[Dict] = None) -> str:
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save({"step": step, "model": model.state_dict(),
                    "optimizer": optimizer.state_dict(),
                    "metadata": dict(metadata or {})}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int, device=None) -> Dict:
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def resolve(self, spec: Union[str, int, None] = "latest"
                ) -> Optional[int]:
        """'latest' -> the newest step (None when there is none);
        'epoch_N' -> the step whose metadata records epoch N; an integer
        (or its string) -> that step. Raises FileNotFoundError when the
        spec matches nothing."""
        if spec in (None, "latest"):
            return self.latest_step()
        if isinstance(spec, str) and spec.startswith("epoch_"):
            want = int(spec[len("epoch_"):])
            for step in self.all_steps():
                if self.metadata(step).get("epoch") == want:
                    return step
            raise FileNotFoundError(
                f"no checkpoint for {spec} (have steps {self.all_steps()})")
        step = int(spec)
        if step not in self.all_steps():
            raise FileNotFoundError(
                f"no checkpoint step {step} (have {self.all_steps()})")
        return step

    def metadata(self, step: int) -> Dict:
        return self._load(step, "cpu")["metadata"]

    def restore(self, model: nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                step: Optional[int] = None) -> int:
        """Load a checkpoint (default: the latest) into `model` and
        `optimizer`, in place. Returns its step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dev = next(model.parameters()).device
        ckpt = self._load(step, dev)
        model.load_state_dict(ckpt["model"])
        if optimizer is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt["step"])
