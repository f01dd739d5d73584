"""StitchConfig: the stitcher's configuration as a frozen dataclass.

A copy of `image_stitching_tpu/config.py`, so that both packages read the
same field names, defaults and enum values.  The PyTorch port runs the
whole surface.
"""

from __future__ import annotations

import dataclasses
import enum


class WaveCorrectKind(enum.Enum):
    """cv::detail::WaveCorrectKind."""
    HORIZ = "horiz"
    VERT = "vert"
    AUTO = "auto"
    NO = "no"


class ExposureCompensatorType(enum.Enum):
    """cv::detail::ExposureCompensator::{NO,GAIN,GAIN_BLOCKS,CHANNELS,...}."""
    NO = "no"
    GAIN = "gain"
    GAIN_BLOCKS = "gain_blocks"
    CHANNELS = "channels"
    CHANNELS_BLOCKS = "channels_blocks"


class BlenderType(enum.Enum):
    """cv::detail::Blender::{NO,FEATHER,MULTI_BAND}."""
    NO = "no"
    FEATHER = "feather"
    MULTI_BAND = "multiband"


class TimelapserType(enum.Enum):
    """cv::detail::Timelapser::{AS_IS,CROP}."""
    AS_IS = "as_is"
    CROP = "crop"


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    # --- scales (image_stitching.cpp:53-55) ---
    work_megapix: float = -1.0      # -1 => full resolution registration
    seam_megapix: float = 0.1
    compose_megapix: float = 0.4

    # --- registration (:56-67) ---
    conf_thresh: float = 0.95
    features_type: str = "orb"       # orb | akaze | sift | surf
    orb_pattern: str = "gauss"       # gauss (self-consistent rBRIEF) |
                                     # cv (bit_pattern_31_ interop table)
    match_conf: float = 0.32         # 0.65 for surf (:59)
    matcher_type: str = "homography"  # homography | affine
    estimator_type: str = "homography"
    ba_cost_func: str = "reproj"     # reproj | ray | affine | no
    ba_refine_mask: str = "_____"    # fx,skew,ppx,aspect,ppy; '_' = frozen
    do_wave_correct: bool = True     # (:68)
    wave_correct: WaveCorrectKind = WaveCorrectKind.HORIZ  # (:69)
    save_graph: bool = False         # (:70-71)
    save_graph_to: str = ""

    # --- geometry / photometric (:72-77) ---
    warp_type: str = "spherical"
    expos_comp_type: ExposureCompensatorType = ExposureCompensatorType.GAIN_BLOCKS
    expos_comp_nr_feeds: int = 1
    expos_comp_nr_filtering: int = 2
    expos_comp_block_size: int = 64
    seam_find_type: str = "dp_color"  # no|voronoi|gc_color|gc_colorgrad|dp_color|dp_colorgrad

    # --- compositing (:78-85) ---
    blend_type: BlenderType = BlenderType.MULTI_BAND
    timelapse_type: TimelapserType = TimelapserType.CROP
    blend_strength: float = 5.0
    result_name: str = "result.jpg"
    timelapse: bool = False
    range_width: int = -1
    find_features: bool = True
    serialize_data: bool = True
    # try_cuda (:52) has no TPU meaning: the accelerator path is default-on.

    # --- additions beyond the reference (documented as such) ---
    num_features: int = 4000         # ORB::create nfeatures (:545)
    crop_result: bool = False        # wire in the dangling cropper (SURVEY 3.5)
    use_sensor_priors: bool = True   # EXIF ImageDescription ingestion (:340-528)
    checkpoint_dir: str = "."        # where cams.data / indices.data live
    seed: int = 0                    # RANSAC determinism
    infill_dropped: bool = False     # nearest-neighbor pose recovery for
                                     # removed images (dead-path :754-866)
    checkpoint_npz: bool = False     # also write cameras.npz next to
                                     # cams.data (binary checkpoint)
    profile_dir: str = ""            # profiler trace output directory
    use_sharded_compose: bool = False  # shard the compose canvas over the
                                     # mesh 'sp' axis (gigapixel mode;
                                     # needs >1 device, MULTI_BAND/NO blend)
    compose_strips_mp: float = 96.0  # canvas size (MP) above which the
                                     # single-chip compose streams the
                                     # canvas in vertical strips (bounded
                                     # HBM: gigapixel canvases; <=0 never)
    compose_strip_w: int = 4096      # strip interior width (px) for the
                                     # streaming compose
    fast_ingest: bool = True         # luma-only + DCT-scaled native JPEG
                                     # decode on background threads (falls
                                     # back to the legacy full-RGB loop for
                                     # PNG / non-uniform / no native lib)
    work_scale_snap: bool = True     # round a fractional work scale UP to
                                     # the decoder's num8/8 grid so the
                                     # detection luma decodes exactly at
                                     # work scale (no device resize; never
                                     # below the requested work_megapix).
                                     # Identity for work_megapix=-1 (the
                                     # reference default, full res).

    def __post_init__(self):
        # Accept the enum VALUES as plain strings (the reference's globals
        # are strings, and callers naturally write blend_type="feather").
        # Without coercion a string silently missed every enum comparison
        # (e.g. a string blend type bypassed the fused compose path, and a
        # string exposure type degraded *_BLOCKS to plain GAIN).
        coerce = (("expos_comp_type", ExposureCompensatorType),
                  ("blend_type", BlenderType),
                  ("timelapse_type", TimelapserType),
                  ("wave_correct", WaveCorrectKind))
        for name, enum_cls in coerce:
            v = getattr(self, name)
            if isinstance(v, str):
                object.__setattr__(self, name, enum_cls(v.lower()))

    def replace(self, **kw) -> "StitchConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = StitchConfig()
