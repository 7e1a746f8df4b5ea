"""FLOP and byte accounting.

Port of `futuredet_tpu/utils/flops.py`, where XLA's cost model reports the
flops and bytes of the compiled program. PyTorch runs eagerly, so the port
counts what one run dispatches:

  * flops: `torch.utils.flop_counter.FlopCounterMode`, which counts the
    matmuls and convolutions (2 per multiply-add) and, through the formula
    registered in `ops/pallas_gather.py`, kernel K2's sparse gather-conv as
    the dense contraction 2 N 27 Cin Cout, as XLA counts the JAX middle's
    gathered product. It has no formula for elementwise operations, which
    XLA also counts, nor for kernel K1 (`torch.ops.futuredet.nms_alive`),
    which counts 0.
  * bytes accessed: every dispatched operation's input and output bytes,
    summed (views move none). That is an unfused count, above XLA's count
    of its fused program.

    python -c "from futuredet_torch.config import get_config; \\
        from futuredet_torch.utils.flops import model_flops; \\
        print(model_flops(get_config('pp_forecast_n3dtf')))"
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of each dispatched operation's tensor inputs and
    outputs; view operations count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run fn(*args, **kwargs) once, without autograd, and return its
    counted cost under XLA's keys: {"flops", "bytes accessed"}."""
    bytes_mode = ByteCounter()
    with torch.no_grad(), bytes_mode, FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops()),
            "bytes accessed": float(bytes_mode.bytes)}


def model_flops(cfg, batch_size: int = 1,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, float]:
    """Forward-pass cost of a config's detector (weights from seed 0) on
    the JAX function's inputs: `cfg.voxel.max_points` zero points a
    sample, all valid. Runs on `device` (default: the card)."""
    from ..models.detector import build_detector

    model = build_detector(cfg, device)
    dev = next(model.parameters()).device
    P = cfg.voxel.max_points
    pts = torch.zeros((batch_size, P, 5), dtype=torch.float32, device=dev)
    valid = torch.ones((batch_size, P), dtype=torch.bool, device=dev)
    out = cost_analysis(model, pts, valid)
    return {"flops": out["flops"], "bytes_accessed": out["bytes accessed"]}
