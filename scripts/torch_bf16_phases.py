"""The bf16 serving mode and the dense middle forms from a fresh process
on one NVIDIA GPU: chip_smoke.py's phases 29-32 alone, after the build.

    python3 scripts/torch_bf16_phases.py [ROOT]

ROOT (default: this checkout) is the checkout whose chip_smoke.py and
futuredet_torch run, e.g. a parent commit unpacked under build/. Prints the
card, the build's seconds per source and ptxas's lines for K2's bf16
family (which must not spill), then one JSON line per phase as
chip_smoke.py prints them."""
import os
import re
import sys

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
log = _build.build_log("gather_conv_kernel.cu").splitlines()
bf16 = [ln.strip() for i, ln in enumerate(log)
        if "bf16_kernel" in ln or (i and "bf16_kernel" in log[i - 1]
                                   and "spill" in ln)]
cs.check(not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in bf16),
         f"K2's bf16 family spills: {bf16}")
print("\n".join(bf16), flush=True)
cs.serving_path(dev, card)
cs.dense_middle_path(dev, card)
print("done", flush=True)
