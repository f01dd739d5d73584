"""Command-line interface: ``python -m image_stitching_tpu_torch <dir>``.

A copy of `image_stitching_tpu/cli.py`: the same flags with the same
defaults (the zero-flag invocation is the reference run, `StitchConfig()`:
stitch <dir> -> result.jpg plus the cams.data / indices.data
checkpoints), the same `config_from_args`, stage-time lines and exit
codes, and one flag more, `--device` (default cuda).  The device is
explicit: nothing falls back to the CPU.  Every `--features` choice runs
(orb, akaze, sift, surf); a stitch that fails exits 1 with its message,
as the reference's does ("Need more images: ..." when all but one image
are dropped).
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import (BlenderType, ExposureCompensatorType, StitchConfig,
                     TimelapserType, WaveCorrectKind)


def build_parser() -> argparse.ArgumentParser:
    d = StitchConfig()
    p = argparse.ArgumentParser(
        prog="image_stitching_tpu_torch",
        description="Panorama stitcher, PyTorch/CUDA port "
                    "(capability parity with a1q123456/image_stitching)")
    p.add_argument("image_dir", help="directory of JPEG/PNG captures")
    p.add_argument("--device", default="cuda",
                   help="torch device to stitch on (cuda, cuda:1, cpu)")
    p.add_argument("--result", default=d.result_name)
    p.add_argument("--work-megapix", type=float, default=d.work_megapix)
    p.add_argument("--seam-megapix", type=float, default=d.seam_megapix)
    p.add_argument("--compose-megapix", type=float,
                   default=d.compose_megapix)
    p.add_argument("--conf-thresh", type=float, default=d.conf_thresh)
    p.add_argument("--features", default=d.features_type,
                   choices=["orb", "akaze", "sift", "surf"])
    p.add_argument("--orb-pattern", default=d.orb_pattern,
                   choices=["gauss", "cv"],
                   help="rBRIEF table: self-consistent Gaussian or "
                        "OpenCV bit_pattern_31_ (descriptor interop)")
    p.add_argument("--match-conf", type=float, default=None,
                   help="default 0.32 (orb/akaze) or 0.65 (sift/surf)")
    p.add_argument("--matcher", default=d.matcher_type,
                   choices=["homography", "affine"])
    p.add_argument("--estimator", default=d.estimator_type,
                   choices=["homography", "affine"])
    p.add_argument("--ba", default=d.ba_cost_func,
                   choices=["reproj", "ray", "affine", "no"])
    p.add_argument("--ba-refine-mask", default=d.ba_refine_mask)
    p.add_argument("--wave-correct", default="horiz",
                   choices=["no", "horiz", "vert", "auto"])
    p.add_argument("--warp", default=d.warp_type)
    p.add_argument("--expos-comp", default="gain_blocks",
                   choices=[e.value for e in ExposureCompensatorType])
    p.add_argument("--expos-comp-nr-feeds", type=int,
                   default=d.expos_comp_nr_feeds)
    p.add_argument("--expos-comp-nr-filtering", type=int,
                   default=d.expos_comp_nr_filtering)
    p.add_argument("--expos-comp-block-size", type=int,
                   default=d.expos_comp_block_size)
    p.add_argument("--seam", default=d.seam_find_type,
                   choices=["no", "voronoi", "gc_color", "gc_colorgrad",
                            "dp_color", "dp_colorgrad"])
    p.add_argument("--blend", default="multiband",
                   choices=[e.value for e in BlenderType])
    p.add_argument("--blend-strength", type=float, default=d.blend_strength)
    p.add_argument("--timelapse", action="store_true")
    p.add_argument("--timelapse-type", default="crop",
                   choices=[e.value for e in TimelapserType])
    p.add_argument("--range-width", type=int, default=d.range_width)
    p.add_argument("--no-find-features", action="store_true",
                   help="resume from cams.data/indices.data "
                        "(serialize_data=false path)")
    p.add_argument("--crop", action="store_true",
                   help="auto-crop black borders (wires in cropper.cpp)")
    p.add_argument("--no-sensor-priors", action="store_true",
                   help="ignore EXIF pose priors; bootstrap from "
                        "homographies")
    p.add_argument("--num-features", type=int, default=d.num_features)
    p.add_argument("--checkpoint-dir", default=d.checkpoint_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--infill-dropped", action="store_true",
                   help="recover removed images from nearest-neighbor "
                        "refined poses (requires EXIF priors)")
    p.add_argument("--checkpoint-npz", action="store_true")
    p.add_argument("--save-graph", metavar="DOT",
                   help="write the match graph as Graphviz DOT")
    p.add_argument("--profile-dir", default="",
                   help="emit a profiler trace here")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def config_from_args(args) -> StitchConfig:
    match_conf = args.match_conf
    if match_conf is None:
        match_conf = 0.65 if args.features in ("surf", "sift") else 0.32
    return StitchConfig(
        work_megapix=args.work_megapix,
        seam_megapix=args.seam_megapix,
        compose_megapix=args.compose_megapix,
        conf_thresh=args.conf_thresh,
        features_type=args.features,
        orb_pattern=args.orb_pattern,
        match_conf=match_conf,
        matcher_type=args.matcher,
        estimator_type=args.estimator,
        ba_cost_func=args.ba,
        ba_refine_mask=args.ba_refine_mask,
        do_wave_correct=args.wave_correct != "no",
        wave_correct=(WaveCorrectKind(args.wave_correct)
                      if args.wave_correct != "no" else WaveCorrectKind.NO),
        warp_type=args.warp,
        expos_comp_type=ExposureCompensatorType(args.expos_comp),
        expos_comp_nr_feeds=args.expos_comp_nr_feeds,
        expos_comp_nr_filtering=args.expos_comp_nr_filtering,
        expos_comp_block_size=args.expos_comp_block_size,
        seam_find_type=args.seam,
        blend_type=BlenderType(args.blend),
        blend_strength=args.blend_strength,
        timelapse=args.timelapse,
        timelapse_type=TimelapserType(args.timelapse_type),
        range_width=args.range_width,
        find_features=True,
        serialize_data=not args.no_find_features,
        result_name=args.result,
        crop_result=args.crop,
        use_sensor_priors=not args.no_sensor_priors,
        num_features=args.num_features,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
        infill_dropped=args.infill_dropped,
        checkpoint_npz=args.checkpoint_npz,
        save_graph=bool(args.save_graph),
        save_graph_to=args.save_graph or "",
        profile_dir=args.profile_dir,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(message)s")
    from .pipeline.stitcher import stitch
    try:
        result = stitch(args.image_dir, config_from_args(args),
                        device=args.device)
    except (ValueError, RuntimeError) as e:
        # NotImplementedError (an option outside the slice) is a
        # RuntimeError: its message names the option.
        print(e, file=sys.stderr)
        return 1
    for name, secs in result.stage_times.items():
        print(f"{name}, time: {secs:.6g} sec")
    if not args.timelapse:
        print(f"wrote {args.result} "
              f"({result.panorama.shape[1]}x{result.panorama.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
