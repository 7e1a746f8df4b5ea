"""The per-quantity table behind the bf16 training tests
(tests/test_torch_train_bf16_{pillars,vox,dense}.py), on the CPU: for each
knob's two B = 2 steps, every quantity's distance from the JAX bf16 step
for the port ("err"), the JAX fp32 step ("gap") and the JAX step's own
rounding-noise probes ("noise"), and its share of the test's limit; then
the same for the JAX step with its fused head towers (the JAX default),
whose bf16 normalisation's backward XLA:CPU sums in bf16. `divergence`
prints, layer by layer through the RPN of tiny pp_forecast_n3dtf under
`compute_dtype`, the share of outputs in which the port's and the JAX
package's train-mode forwards of the same weights differ.

    JAX_PLATFORMS=cpu python scripts/torch_bf16_train_gaps.py \\
        [pillars|vox|dense|fused|divergence]...

Compiles three JAX steps per knob (about 1-2 minutes each on one core)."""
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402
import torch  # noqa: E402

from futuredet_tpu import config as jc  # noqa: E402
from futuredet_torch import config as pc  # noqa: E402
from futuredet_torch.data.synthetic import make_batch  # noqa: E402
from tests import test_torch_train_bf16_pillars as P  # noqa: E402
from tests.test_torch_train_bf16_dense import (  # noqa: E402
    differentiable_bf16_conv)
from tests.test_torch_voxelnet import voxelnet_config  # noqa: E402

STACKED = dict(middle_gather_algo="stacked")


def cases():
    pp = (jc.tiny_variant(jc.get_config("pp_forecast_n3dtf")),
          pc.tiny_variant(pc.get_config("pp_forecast_n3dtf")))
    vox = (P.with_knobs(voxelnet_config(jc), STACKED),
           P.with_knobs(voxelnet_config(pc), STACKED))
    pp_batch = dict(seed=33, n_objects=4, n_clutter=300,
                    points_per_object=300)
    vox_batch = dict(seed=10, n_objects=10, n_clutter=600,
                     points_per_object=150)
    return {
        "pillars": (pp, P.BF16, pp_batch, P.per_branch_towers),
        "fused": (pp, P.BF16, pp_batch, contextlib.nullcontext),
        "vox": (vox, dict(compute_dtype="bfloat16",
                          middle_sparse_dtype="bfloat16"), vox_batch,
                P.per_branch_towers),
        "dense": (vox, dict(middle_dense_from_stage=2,
                            middle_dense_dtype="bfloat16"), vox_batch,
                  differentiable_bf16_conv)}


def divergence():
    """Per RPN layer: the share of outputs that differ, and the largest
    difference of max |JAX|, port against JAX under compute_dtype."""
    from futuredet_tpu.models.detector import build_detector as jax_build
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
    cfg_j = jc.tiny_variant(jc.get_config("pp_forecast_n3dtf"))
    cfg = pc.tiny_variant(pc.get_config("pp_forecast_n3dtf"))
    batch = make_batch(cfg, 2, seed=33, n_objects=4, n_clutter=300,
                       points_per_object=300)
    pts, valid = batch["points"].numpy(), batch["points_valid"].numpy()
    variables = P.jax_variables(jax_build(cfg_j), pts[:1], valid[:1])
    with P.per_branch_towers():
        _, inter = jax_build(P.with_knobs(cfg_j, P.BF16)).apply(
            variables, pts, valid, train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
    flat = {}

    def walk(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                flat[pre + k] = v[0]
    walk(inter["intermediates"]["neck"])
    model = build_detector(P.with_knobs(cfg, P.BF16), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg))
    model.train()
    acts = {}
    for n, m in model.neck.named_modules():
        m.register_forward_hook(
            lambda m, i, o, n=n: acts.__setitem__(n, o))
    model(batch["points"], batch["points_valid"])
    pairs = [("block0_in/Conv_0", "blocks.0.1"),
             ("block0_in/BatchNorm_0", "blocks.0.2"),
             ("block0_conv0/Conv_0", "blocks.0.4"),
             ("block0_conv0/BatchNorm_0", "blocks.0.5"),
             ("deblock0/Conv_0", "deblocks.0.0"),
             ("deblock0/BatchNorm_0", "deblocks.0.1"),
             ("block1_in/Conv_0", "blocks.1.1"),
             ("block1_in/BatchNorm_0", "blocks.1.2"),
             ("block1_conv0/BatchNorm_0", "blocks.1.5"),
             ("deblock1/ConvTranspose_0", "deblocks.1.0"),
             ("deblock1/BatchNorm_0", "deblocks.1.1")]
    for jk, pk in pairs:
        a = np.asarray(flat[jk + "/__call__"], np.float32)
        b = acts[pk].permute(0, 2, 3, 1).detach().float().numpy()
        print(f"  {jk:28s} differ {np.mean(a != b):.3g} of the outputs, "
              f"max {np.abs(a - b).max() / np.abs(a).max():.3g} of max")


def main(names):
    torch.set_num_threads(1)
    table = cases()
    for name in names or ["pillars", "vox", "dense", "fused"]:
        if name == "divergence":
            divergence()
            continue
        (cfg_j, cfg), knobs, kw, patch = table[name]
        steps = P.knob_steps(cfg_j, cfg, knobs, make_batch(cfg, 2, **kw),
                             patch=patch)
        for i, run in enumerate(steps):
            print(f"{name} step {i}: violations {P.violations(run)}; the "
                  f"fp32 port breaks {sorted(P.violations(run, 'pf'))}")
            for key, (err, gap, noise, floor) in P.measures(
                    run, "pb").items():
                signal = gap >= P.SIGNAL * max(noise, P.FP32_FLOOR)
                limit = P.GAP_FRACTION * gap if signal else max(
                    P.GAP_FRACTION * gap, P.NOISE_FACTOR * noise, floor)
                print(f"  {key:24s} err {err:.3g} gap {gap:.3g} noise "
                      f"{noise:.3g} err/limit {err / limit:.2f}"
                      + (" (signal)" if signal else ""))
            names_ = [n for n in run["jb"]["grads"]
                      if n not in run["excluded"]]
            print(f"  all gradients: port {P._dist(run, 'pb', 'grads', names_):.3g}"
                  f" fp32 {P._dist(run, 'jf', 'grads', names_):.3g} noise "
                  f"{max(P._dist(run, r, 'grads', names_) for r in P.NOISE_RUNS):.3g}")


if __name__ == "__main__":
    main(sys.argv[1:])
