"""Two-stage numbers from a fresh process on one NVIDIA GPU: chip_smoke.py's
phases 26 and 27, then full-width B = 1 train steps of each two-stage
config and of its single-stage config in turns.

    python3 scripts/torch_two_stage_phases.py [ROOT] [--turns N]

ROOT (default: this checkout) is the checkout whose chip_smoke.py and
futuredet_torch run, e.g. a parent commit unpacked under build/. Phase 26
times each two-stage scene beside its single-stage config; phase 27 checks
and times a step of each two-stage config. The turns then time a step
(chip_smoke.step_times: warm-ups, then the median of synced steps on the
host clock, and its split) of the single-stage, two-stage, two-stage and
single-stage config, N times over, each from build_detector(seed=0) on
phase 10's lidar-family scene: the RoI stage's cost in a step is the
difference, taken in one process. chip_smoke.py runs them after twenty
other phases, where host time per step grows. One JSON line each."""
import argparse
import dataclasses
import os
import sys

parser = argparse.ArgumentParser()
parser.add_argument("root", nargs="?", default=os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
parser.add_argument("--turns", type=int, default=2)
args = parser.parse_args()
root = os.path.abspath(args.root)
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from futuredet_torch.config import get_config  # noqa: E402
from futuredet_torch.models.detector import build_detector  # noqa: E402
from futuredet_torch.ops import _build  # noqa: E402
from futuredet_torch.train.step import make_optimizer  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
card = cs.card_line()
print(card, _build.build_all(), flush=True)
cs.two_stage_path(dev, card)
cs.two_stage_train_path(dev, card)


def step(name):
    """chip_smoke.step_times of a fresh model of `name` on phase 10's
    scene (pillars in phase 14's 150,000-point buffer)."""
    cfg = get_config(name)
    clutter = cs.TRAIN_CLUTTER
    if cfg.model.detector == "pointpillars":
        clutter = cs.PILLAR_TRAIN_CLUTTER
        cfg = cfg.replace(voxel=dataclasses.replace(
            cfg.voxel, max_points=cs.MAX_POINTS))
    batch = cs.train_batch(cfg, cs.TRAIN_SEED, dev, clutter)
    model = build_detector(cfg, device=dev, seed=0).train()
    opt = make_optimizer(cfg, model, 2 * (cs.TRAIN_WARMUP + cs.TRAIN_REPS))
    return cs.step_times(cfg, model, opt, batch, 0)


for two, single in cs.TWO_STAGE_NAMES:
    for turn in range(args.turns):
        for name in (single, two, two, single):
            ms, split, peak = step(name)
            cs.emit({"phase": "two_stage_turns", "model": name,
                     "turn": turn, "card": card, "train_step_ms": ms,
                     "train_step_split_ms": split,
                     "train_step_peak_mib": peak,
                     "warmup": cs.TRAIN_WARMUP, "reps": cs.TRAIN_REPS})
print("done", flush=True)
