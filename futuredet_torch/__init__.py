"""FutureDet in PyTorch for NVIDIA Hopper: the port of `futuredet_tpu`.

Each module keeps the name of its counterpart in `futuredet_tpu`, so the
reference for `futuredet_torch/x/y.py` is `futuredet_tpu/x/y.py`. Public
functions keep the JAX package's layouts: points (B, P, F), NHWC head maps,
(B, N, 9) detection boxes. Entry points run on the card (`device="cuda"`)
unless the caller passes `device="cpu"`; on the CPU every kernel runs its
plain PyTorch version. Importing the package builds no kernel; it
registers kernels K1 and K2 as the custom operators
`torch.ops.futuredet.nms_alive` and `torch.ops.futuredet.gather_conv`, and
the sparse middle's table builders (`ops/sparse_conv.py`) as
`torch.ops.futuredet.make_grid` and its kin, so importing it is enough to
load a program that `cli/tools.py export` wrote.
"""

# registers the operators
from .ops import pallas_gather, pallas_nms, sparse_conv  # noqa: F401

__version__ = "0.1.0"
