"""The benchmark's plain reference: FutureDet's two detectors, their decode
and their training step in plain PyTorch, fp32.

A frozen, cut-down copy of `futuredet_torch`'s model, decode and
training code for the modes the benchmark's configurations use (the
dense forecast head with forecast features, fp32, one card), with the
port's two hand-written kernels replaced by their plain versions: K2 (the
sparse gather-conv) by one row gather and one matmul over the
reference's own neighbour tables, K1 (rotated NMS) by the rotated IoU
that judges the program's detections. Module and parameter names are the
port's, so one state dict loads into both. It imports nothing of the
program, of the JAX package or of JAX.
"""
