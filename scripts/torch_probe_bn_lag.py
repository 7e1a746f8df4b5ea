"""Boxes a timestep of a pillar model overfit on one scene, decoded with its
BatchNorm running statistics (eval mode) and with the batch's (train mode).

    python3 scripts/torch_probe_bn_lag.py [--epochs 100 300] [--device cpu]
        [--full]

Trains `tiny_variant(pp_forecast_n3dtf)` (or the full-width model with
`--full`, for the card) through `train/trainer.py::train` for each count of
one-step epochs on the train CLI's scene (`make_batch`, seed 0, lidar
clutter), as `python -m futuredet_torch.cli.train --synthetic 1` does, then
decodes that scene in both modes. The running statistics move by 1% of the
batch's a step, so they trail weights that the one-cycle schedule still
moves: chip_smoke.py phase 17's count of epochs rests on this. One JSON
line per count and mode.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, nargs="+", default=[100, 300])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    from futuredet_torch.config import get_config, tiny_variant
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.train.trainer import _to_device, train

    cfg = get_config("pp_forecast_n3dtf")
    if not args.full:
        cfg = tiny_variant(cfg)
    dev = torch.device(args.device)
    batch = make_batch(cfg, 1, seed=0, clutter_mode="lidar")
    batch.pop("gt")
    for epochs in args.epochs:
        c = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  total_epochs=epochs))
        state = train(c, itertools.cycle([batch]), steps_per_epoch=1,
                      device=dev, log_fn=lambda line: None)
        b = _to_device(batch, dev)
        with torch.no_grad():
            for mode in ("eval", "train"):
                # train mode also updates the running statistics: eval first
                state.model.train(mode == "train")
                preds = state.model(b["points"], b["points_valid"])
                det = decode_and_nms(c, preds)
                per_t = det.valid.reshape(-1, c.test.nms.post_max_size)
                print(json.dumps({
                    "epochs": epochs, "statistics": {
                        "eval": "running", "train": "batch"}[mode],
                    "max_heatmap_t0": float(
                        torch.sigmoid(preds[0]["hm"]).max()),
                    "boxes_per_t": per_t.sum(-1).tolist(),
                    "full_width": args.full, "device": str(dev)}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
