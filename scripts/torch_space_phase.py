"""Spatial sharding of the canvas on gloo ranks of one NVIDIA GPU, from a
fresh process: chip_smoke.py's phase 39 alone, after the build.

    python3 scripts/torch_space_phase.py [ROOT]

ROOT (default: this checkout) is the checkout whose chip_smoke.py and
futuredet_torch run, e.g. a parent commit unpacked under build/. Prints the
card and the build's seconds per source, then phase 39's JSON lines as
chip_smoke.py prints them."""
import os
import sys
import tempfile

root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else \
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
os.makedirs(cs.OUT_DIR, exist_ok=True)
with tempfile.TemporaryDirectory() as work:
    print(cs.space_path(dev, card, work), flush=True)
print("done", flush=True)
