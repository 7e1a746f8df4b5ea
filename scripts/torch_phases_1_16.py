"""Phases 1-16 of one checkout's chip_smoke.py (the inference and training
paths), for same-call turns of a parent and a change on one NVIDIA GPU.

    python3 scripts/torch_phases_1_16.py ROOT

ROOT is the checkout whose chip_smoke.py and futuredet_torch run, e.g. a
parent commit unpacked under build/ (`git archive`). It builds that
checkout's kernels and prints the phases' JSON lines, times included."""
import os
import sys
import tempfile

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from futuredet_torch.ops import _build  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
card = cs.card_line()
print(card, _build.build_all(), flush=True)
with tempfile.TemporaryDirectory() as work:
    cs.pillar_path(dev, card)
    cs.voxelnet_path(dev, card)
    cs.train_path(dev, card, os.path.join(work, "vox"))
    cs.pillar_train_path(dev, card)
print("done", flush=True)
