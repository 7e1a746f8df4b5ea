"""Experiment tools: port of `futuredet_tpu/cli/tools.py` (the reference's
repo-root scripts), with the same subcommands and flags, plus `--device`
where a subcommand runs the model.

  trajectory  dump train-set trajectory prototypes per class, the
              `{classname}_trajectory.pkl` that `cli/evaluate.py
              --postprocess` reads (ref `trajectory.py:43-65`)
  statistics  count static/linear/nonlinear GT trajectories
              (ref `statistics.py`)
  compare     diff the parameters of two checkpoint directories of
              `train/checkpoints.py` (the newest step of each; ref
              `compare.py:5-19`), by state_dict name
  visualize   render GT vs predicted forecasts to a BEV png per sample,
              with --video one mp4 per scene (ref `visualize.py`;
              matplotlib, and cv2 for the video)
  export      `torch.export` the inference forward + decode_and_nms of a
              config into a `.pt2` artifact; kernels K1 and K2 are the
              custom operators `torch.ops.futuredet.*`, so a process
              that loads it imports `futuredet_torch` first

    python -m futuredet_torch.cli.tools trajectory --info_path infos.pkl
    python -m futuredet_torch.cli.tools export --model pp_forecast_n3dtf \\
        --check
    # load: import futuredet_torch; torch.export.load(path).module()

Every config exports, under every knob (`export_config` takes a config
that `dataclasses.replace` changed, e.g. `middle_dense_from_stage` or
`circular_nms`): the VoxelNet stages' sizes, set per scene, are unbacked
sizes of the program, and the circle NMS is the operator
`torch.ops.futuredet.circle_nms`, one node a pseudo-task.
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np

log = logging.getLogger(__name__)

def cmd_trajectory(args):
    """Per-class trajectory prototypes: (velocity, rotation) + future offsets
    relative to the start box (ref trajectory.py:43-65 layout)."""
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    protos = []
    for info in infos:
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 1, 12))))
        names = np.asarray(info.get("gt_names", []))
        if boxes.ndim != 3 or len(boxes) == 0:
            continue
        first = names[:, 0] if names.ndim > 1 else names
        for i in np.where(first == args.classname)[0]:
            tr = boxes[i]
            vel = tr[0, 6:8]
            yaw = -tr[0, 10] - np.pi / 2
            rot = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
            offsets = [tr[t, :3] - tr[0, :3] for t in range(1, tr.shape[0])]
            protos.append([(vel, rot)] + offsets)
    out = args.out or f"{args.classname}_trajectory.pkl"
    with open(out, "wb") as f:
        pickle.dump(protos, f)
    log.info("wrote %d %s trajectory prototypes to %s",
             len(protos), args.classname, out)
    return protos


def cmd_statistics(args):
    """ref statistics.py: cohort counts over the info set."""
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    counts = {"static": 0, "linear": 0, "nonlinear": 0}
    for info in infos:
        traj = np.asarray(info.get("gt_trajectory", []))
        if traj.size == 0:
            continue
        first = traj[:, 0] if traj.ndim > 1 else traj
        for t in first:
            if str(t) in counts:
                counts[str(t)] += 1
    total = max(sum(counts.values()), 1)
    for k, v in counts.items():
        log.info("%s: %d (%.1f%%)", k, v, 100.0 * v / total)
    return counts


# BatchNorm buffers: the JAX tool compares params, not batch_stats
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _load_params(directory):
    """(the newest checkpoint's parameters by state_dict name, its step)."""
    import torch

    from ..train.checkpoints import CheckpointManager

    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    sd = torch.load(mgr._path(step), map_location="cpu",
                    weights_only=True)["model"]
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith(_BUFFERS)}, step


def cmd_compare(args):
    """ref compare.py: which parameters differ between two checkpoints."""
    a, sa = _load_params(args.checkpoint_a)
    b, sb = _load_params(args.checkpoint_b)
    log.info("comparing step %s vs step %s", sa, sb)
    changed, same = [], []
    for name, leaf in a.items():
        other = b.get(name)
        if other is None or leaf.shape != other.shape:
            changed.append(name)
        elif np.allclose(leaf, other):
            same.append(name)
        else:
            changed.append(name)
    log.info("%d changed, %d identical", len(changed), len(same))
    for n in changed[:50]:
        log.info("changed: %s", n)
    return changed, same


def _import_optional(name: str, what: str):
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError as e:
        pkg = {"cv2": "opencv-python"}.get(name, name)
        raise ImportError(
            f"{what} needs {name} ({pkg}), which is not installed") from e


def cmd_visualize(args):
    """BEV png per sample: GT tracklets (green) vs predicted trajectories
    (red), matplotlib. With --video, the per-sample frames are additionally
    stitched into one mp4 per scene at 2 fps (ref visualize.py:212-232,
    cv2.VideoWriter mp4v). Scene grouping comes from, in order: a
    `{scene_token: [sample_token, ...]}` pickle passed via --scene_map, a
    "scene_token" key on each sample dict, else a single "all" video in
    pickle order."""
    matplotlib = _import_optional("matplotlib", "visualize")
    matplotlib.use("Agg")
    plt = _import_optional("matplotlib.pyplot", "visualize")
    if args.video:
        _import_optional("cv2", "visualize --video")

    with open(args.predictions, "rb") as f:
        data = pickle.load(f)
    rendered = []
    for token, sample in list(data.items())[:args.max_samples]:
        fig, ax = plt.subplots(figsize=(8, 8))
        for tr in sample.get("gt", []):
            tr = np.asarray(tr)
            ax.plot(tr[:, 0], tr[:, 1], "g.-", lw=1)
        for tr in sample.get("pred", []):
            tr = np.asarray(tr)
            ax.plot(tr[:, 0], tr[:, 1], "r.-", lw=1, alpha=0.6)
        ax.set_xlim(-55, 55)
        ax.set_ylim(-55, 55)
        ax.set_title(token)
        out = f"{args.out_dir}/{token}.png"
        fig.savefig(out, dpi=100)
        plt.close(fig)
        rendered.append(token)
    log.info("wrote %d visualizations to %s", len(rendered), args.out_dir)
    if args.video and rendered:
        scenes = _group_by_scene(data, rendered, args.scene_map)
        for scene_token, tokens in scenes.items():
            _write_scene_video(args.out_dir, scene_token, tokens)
    return rendered


def _group_by_scene(data, rendered, scene_map_path):
    """Ordered sample tokens per scene, restricted to the rendered frames."""
    rendered_set = set(rendered)
    if scene_map_path:
        with open(scene_map_path, "rb") as f:
            scene_map = pickle.load(f)
        return {sc: [t for t in toks if t in rendered_set]
                for sc, toks in scene_map.items()
                if any(t in rendered_set for t in toks)}
    scenes = {}
    for token in rendered:
        sc = data[token].get("scene_token", "all") if isinstance(
            data[token], dict) else "all"
        scenes.setdefault(sc, []).append(token)
    return scenes


def _write_scene_video(out_dir, scene_token, tokens, fps=2.0):
    """One mp4 per scene from the per-sample pngs (ref visualize.py:212-232:
    mp4v fourcc, 2 fps, frame size from the rendered image)."""
    cv2 = _import_optional("cv2", "visualize --video")

    frames = [cv2.imread(f"{out_dir}/{t}.png") for t in tokens]
    frames = [f for f in frames if f is not None]
    if not frames:
        return
    h, w = frames[0].shape[:2]
    path = f"{out_dir}/{scene_token}.mp4"
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    for f in frames:
        if f.shape[:2] != (h, w):
            f = cv2.resize(f, (w, h))
        writer.write(f)
    writer.release()
    log.info("wrote %d-frame scene video %s", len(frames), path)


def inference_program(cfg, model):
    """The module that `export` traces: points (B, P, 5), valid (B, P) ->
    (boxes, scores, labels, valid) of `decode_and_nms`, or of the refined
    detections of a two-stage model, as `cli/evaluate.py` infers."""
    import torch

    from ..eval.decode import decode_and_nms
    from ..models.two_stage import refined_detections

    class Program(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, points, points_valid):
            out = self.model(points, points_valid)
            det = (refined_detections(*out[1:])
                   if cfg.model.two_stage_refine
                   else decode_and_nms(cfg, out))
            return det.boxes, det.scores, det.labels, det.valid

    return Program().eval()


def cmd_export(args):
    """Export the model's forward + decode of the config `--model` (its
    tiny variant under --tiny) as a `torch.export` artifact (`.pt2`):
    `export_config`."""
    from ..config import get_config, tiny_variant

    cfg = get_config(args.model)
    if args.tiny:
        cfg = tiny_variant(cfg)
    return export_config(cfg, args.out or f"{args.model}.pt2", args.device,
                         batch_size=args.batch_size, check=args.check)


def export_config(cfg, out: str, device="cuda", batch_size: int = 1,
                  check: bool = False) -> str:
    """Export the forward + decode of `cfg`'s detector, weights drawn from
    seed 0, on `cfg.voxel.max_points` zero points a sample, to `out`. With
    `check`, load the artifact, run it once and assert that its outputs
    equal the eager program's. Returns `out`."""
    import torch

    from ..models.detector import build_detector

    model = build_detector(cfg, device, seed=0)
    program = inference_program(cfg, model)
    dev = next(model.parameters()).device
    P = cfg.voxel.max_points
    pts = torch.zeros((batch_size, P, 5), dtype=torch.float32, device=dev)
    pv = torch.zeros((batch_size, P), dtype=torch.bool, device=dev)
    # without autograd, as a server runs it (the sparse convs then skip
    # their autograd Function)
    with torch.no_grad():
        ep = torch.export.export(program, (pts, pv), strict=False)
    torch.export.save(ep, out)
    log.info("exported %s (%d bytes, device %s) to %s", cfg.name,
             os.path.getsize(out), dev, out)
    if check:
        loaded = torch.export.load(out).module()
        with torch.no_grad():
            got = loaded(pts, pv)
            want = program(pts, pv)
        for name, g, w in zip(("boxes", "scores", "labels", "valid"), got,
                              want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"the loaded program's {name} differ from eager")
        log.info("roundtrip check ok: boxes %s", tuple(got[0].shape))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="FutureDet tools (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trajectory")
    t.add_argument("--info_path", required=True)
    t.add_argument("--classname", default="car")
    t.add_argument("--out", default=None)

    s = sub.add_parser("statistics")
    s.add_argument("--info_path", required=True)

    c = sub.add_parser("compare")
    c.add_argument("checkpoint_a")
    c.add_argument("checkpoint_b")

    v = sub.add_parser("visualize")
    v.add_argument("--predictions", required=True)
    v.add_argument("--out_dir", default=".")
    v.add_argument("--max_samples", type=int, default=20)
    v.add_argument("--video", action="store_true",
                   help="also stitch one mp4 per scene (2 fps, ref "
                        "visualize.py:212-232)")
    v.add_argument("--scene_map", default=None,
                   help="pickle of {scene_token: [sample_token, ...]} for "
                        "scene grouping (e.g. from "
                        "NuScenesTables.sample_tokens_by_scene)")

    e = sub.add_parser("export")
    e.add_argument("--model", default="pp_forecast_n3dtf")
    e.add_argument("--batch_size", type=int, default=1)
    e.add_argument("--out", default=None)
    e.add_argument("--tiny", action="store_true")
    e.add_argument("--check", action="store_true",
                   help="load the artifact, run it once and compare it "
                        "with the eager forward")
    e.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs the plain PyTorch versions")

    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return {"trajectory": cmd_trajectory, "statistics": cmd_statistics,
            "compare": cmd_compare, "visualize": cmd_visualize,
            "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    main()
