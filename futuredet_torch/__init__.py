"""FutureDet in PyTorch for NVIDIA Hopper: the port of `futuredet_tpu`.

Each module keeps the name of its counterpart in `futuredet_tpu`, so the
reference for `futuredet_torch/x/y.py` is `futuredet_tpu/x/y.py`. Public
functions keep the JAX package's layouts: points (B, P, F), NHWC head maps,
(B, N, 9) detection boxes. Entry points run on the card (`device="cuda"`)
unless the caller passes `device="cpu"`; on the CPU every kernel runs its
plain PyTorch version. Importing the package builds no kernel.
"""

__version__ = "0.1.0"
