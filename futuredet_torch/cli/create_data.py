"""Data preparation CLI, the port's counterpart of
`futuredet_tpu/cli/create_data.py` (reference `tools/create_data.py:15-28`):
the infos pkls of a nuScenes-format dataset and, with --gt_database, the
GT-AUG database beside them; or the infos of decoded Waymo frames.

  python -m futuredet_torch.cli.create_data nuscenes_data_prep \\
      --root_path R --version v1.0-trainval --nsweeps 20 --gt_database \\
      --model forecast_n3dtf

It is host code (numpy and the port's C++ sweep loader): it needs no card,
no OpenCV and no nuScenes devkit; PIL only where the dataset ships a map
raster.
"""
from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="futuredet_torch data prep")
    p.add_argument("command", choices=["nuscenes_data_prep",
                                       "waymo_data_prep"])
    p.add_argument("--root_path", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--split", default="train",
                   help="waymo_data_prep: train/val/test")
    p.add_argument("--nsweeps", type=int, default=20)
    p.add_argument("--timesteps", type=int, default=7)
    p.add_argument("--filter_zero", type=lambda s: s != "False", default=True)
    p.add_argument("--gt_database", action="store_true",
                   help="also build the GT-AUG database")
    p.add_argument("--model", default="forecast_n3dtf",
                   help="config used for gt database packing")
    return p.parse_args(argv)


def gt_database_config(model: str, nsweeps: int):
    """The config the GT database is packed with. As the JAX CLI, `data`
    is rebuilt from `nsweeps` and the class names alone, so every other
    data field (sample groups, augmentation ranges) takes its default."""
    from ..config import DataConfig, get_config
    cfg = get_config(model)
    return cfg.replace(data=DataConfig(nsweeps=nsweeps,
                                       class_names=cfg.data.class_names))


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.command == "waymo_data_prep":
        # ref tools/create_data.py:30-31
        from ..data.waymo import create_waymo_infos
        path = create_waymo_infos(args.root_path, split=args.split,
                                  nsweeps=args.nsweeps)
        log.info("waymo infos written: %s", path)
        return [path]

    from ..data.infos import create_nuscenes_infos
    paths = create_nuscenes_infos(args.root_path, args.version, args.nsweeps,
                                  args.timesteps, args.filter_zero)
    log.info("infos written: %s", paths)

    if args.gt_database:
        from ..data.gt_database import create_groundtruth_database
        from ..data.pipeline import NuScenesForecastDataset
        cfg = gt_database_config(args.model, args.nsweeps)
        ds = NuScenesForecastDataset(cfg, paths[0], train=False,
                                     class_balanced=False)
        db = create_groundtruth_database(cfg, ds, args.root_path)
        log.info("gt database written: %s", db)
    return paths


if __name__ == "__main__":
    main()
