"""Typed configuration tree + job-JSON front end (the port's copy of
tpu_splat/core/config.py; the schema and every default are the same).

The public job-JSON schema matches the reference (generate_splat.py:48-96, validated
by workflow_trigger.py:38-96) so existing job files work unchanged. Internally the
stringly-typed three-tier system (job JSON -> env vars -> config.json) is replaced by
one typed dataclass tree with explicit defaults (reference defaults from
source/container/src/config.json).
"""

from __future__ import annotations

import json
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Any

from tpu_splat_torch.core.errors import PipelineError


def _as_bool(v: Any, default: bool = False) -> bool:
    if v is None:
        return default
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "on")
    return bool(v)


def _as_int(v: Any, default: int) -> int:
    if v is None or v == "":
        return default
    return int(v)


def _as_float(v: Any, default: float) -> float:
    if v is None or v == "":
        return default
    return float(v)


@dataclass
class VideoProcessingConfig:
    max_num_images: int = 300


@dataclass
class ImageProcessingConfig:
    filter_blurry_images: bool = True
    # "full" = whole-frame Laplacian variance; a u2net model name scores only
    # the salient subject (the reference's MASK_METHOD config)
    blur_mask_method: str = "full"


@dataclass
class PosePriorConfig:
    use_pose_prior_colmap_model_files: bool = False
    use_pose_prior_transform_json: bool = False
    source_coordinate_name: str = "arkit"  # arkit | arcore | opengl | opencv | ros
    pose_is_world_to_cam: bool = True


@dataclass
class SfMConfig:
    enable: bool = True
    software_name: str = "native"  # native/colmap = incremental, glomap/global = rotation+position averaging
    # default matches the reference's user-facing job default
    # (generate_splat.py:67: "false"); at high resolutions the 2x upsample
    # quadruples extraction cost/memory for little registration gain
    enable_enhanced_feature_extraction: bool = False
    matching_method: str = "sequential"  # sequential | spatial | vocab | exhaustive
    pose_priors: PosePriorConfig = field(default_factory=PosePriorConfig)
    # Auto-switch to exhaustive matching below this image count (main.py:1017-1032).
    exhaustive_matching_max_images: int = 20
    max_features_per_image: int = 4096
    # Per-camera focal/principal-point polish on the converged map (COLMAP's
    # refine_intrinsics, main.py:1090-1113). Job-JSON: sfm.refineIntrinsics.
    refine_intrinsics_per_camera: bool = False


@dataclass
class TrainingConfig:
    enable: bool = True
    max_steps: int = 30000
    model: str = "splatfacto"  # splatfacto | splatfacto-big | splatfacto-mcmc | splatfacto-w-light
    enable_multi_gpu: bool = False  # kept for job-JSON compat; maps to mesh data-parallel
    rotate_splat: bool = True
    sh_degree: int = 3
    batch_size: int = 1
    # Downscale policy mirrors main.py:1260-1263: >=250 imgs -> 1/4 res, >=120 -> 1/2.
    downscale_factor: int = 0  # 0 = auto


@dataclass
class SphericalCameraConfig:
    enable: bool = False
    cube_faces_to_remove: str = ""  # e.g. "down" or "up,down"
    optimize_sequential_frame_order: bool = True
    use_oval_nodes: bool = False
    angled_up_views: bool = False
    angled_down_views: bool = False


@dataclass
class SegmentationConfig:
    remove_background: bool = False
    background_removal_model: str = "u2net"  # u2net | u2net_human_seg | sam2
    mask_threshold: float = 0.6
    remove_human_subject: bool = False


@dataclass
class MeasurementConfig:
    reference_type: str = "none"  # none | tripod
    tripod_height_m: float = 0.0


@dataclass
class SemanticConfig:
    enable_object_layer: bool = False
    min_object_area_m2: float = 0.25


@dataclass
class StorageConfig:
    """Artifact-sink config (replaces the S3 bucket/prefix trio)."""

    bucket_name: str = ""
    input_prefix: str = ""
    input_key: str = ""
    output_prefix: str = "workflow-output"


@dataclass
class JobConfig:
    """One reconstruction job. Field names mirror the reference job JSON."""

    uuid: str = ""
    instance_type: str = ""  # informational only on TPU
    log_verbosity: str = "info"
    input_path: str = ""  # local path to the media file (video or zip)
    output_path: str = "output"  # local output directory
    s3: StorageConfig = field(default_factory=StorageConfig)
    video_processing: VideoProcessingConfig = field(default_factory=VideoProcessingConfig)
    image_processing: ImageProcessingConfig = field(default_factory=ImageProcessingConfig)
    sfm: SfMConfig = field(default_factory=SfMConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    spherical_camera: SphericalCameraConfig = field(default_factory=SphericalCameraConfig)
    segmentation: SegmentationConfig = field(default_factory=SegmentationConfig)
    measurement: MeasurementConfig = field(default_factory=MeasurementConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)

    def __post_init__(self):
        if not self.uuid:
            self.uuid = str(uuid_mod.uuid4())

    def validate(self) -> None:
        pp = self.sfm.pose_priors
        if pp.use_pose_prior_colmap_model_files and pp.use_pose_prior_transform_json:
            raise PipelineError(715)
        if self.sfm.matching_method not in ("sequential", "spatial", "vocab", "exhaustive"):
            raise PipelineError(710, f"unknown matching method {self.sfm.matching_method!r}")
        if self.training.model not in (
            "splatfacto",
            "splatfacto-big",
            "splatfacto-mcmc",
            "splatfacto-w-light",
            "nerfacto",
            "3dgut",
            "3dgrt",
        ):
            raise PipelineError(765, f"model {self.training.model!r}")


# Required top-level keys in a job JSON (workflow_trigger.py:38-96 validation parity).
REQUIRED_JOB_KEYS = ("uuid", "s3")


def job_config_from_json(payload: dict | str) -> JobConfig:
    """Parse a reference-format job JSON into a typed JobConfig."""
    if isinstance(payload, str):
        payload = json.loads(payload)
    p = dict(payload)

    def sub(name: str) -> dict:
        v = p.get(name) or {}
        return v if isinstance(v, dict) else {}

    s3 = sub("s3")
    vp = sub("videoProcessing")
    ip = sub("imageProcessing")
    sfm = sub("sfm")
    pp_root = sub("sfm").get("posePriors") or {}
    pp_json = pp_root.get("usePosePriorTransformJson") or {}
    tr = sub("training")
    sph = sub("sphericalCamera")
    seg = sub("segmentation")
    meas = sub("measurement")
    sem = sub("semantic")

    cfg = JobConfig(
        uuid=str(p.get("uuid") or ""),
        instance_type=str(p.get("instanceType") or ""),
        log_verbosity=str(p.get("logVerbosity") or "info"),
        input_path=str(p.get("inputPath") or ""),
        output_path=str(p.get("outputPath") or "output"),
        s3=StorageConfig(
            bucket_name=str(s3.get("bucketName") or ""),
            input_prefix=str(s3.get("inputPrefix") or ""),
            input_key=str(s3.get("inputKey") or ""),
            output_prefix=str(s3.get("outputPrefix") or "workflow-output"),
        ),
        video_processing=VideoProcessingConfig(
            max_num_images=_as_int(vp.get("maxNumImages"), 300)
        ),
        image_processing=ImageProcessingConfig(
            filter_blurry_images=_as_bool(ip.get("filterBlurryImages"), True),
            blur_mask_method=str(ip.get("blurMaskMethod") or "full"),
        ),
        sfm=SfMConfig(
            enable=_as_bool(sfm.get("enable"), True),
            software_name=str(sfm.get("softwareName") or "native"),
            enable_enhanced_feature_extraction=_as_bool(
                sfm.get("enableEnhancedFeatureExtraction"), False
            ),
            matching_method=str(sfm.get("matchingMethod") or "sequential"),
            refine_intrinsics_per_camera=_as_bool(
                sfm.get("refineIntrinsics"), False),
            pose_priors=PosePriorConfig(
                use_pose_prior_colmap_model_files=_as_bool(
                    pp_root.get("usePosePriorColmapModelFiles"), False
                ),
                use_pose_prior_transform_json=_as_bool(pp_json.get("enable"), False),
                source_coordinate_name=str(pp_json.get("sourceCoordinateName") or "arkit"),
                pose_is_world_to_cam=_as_bool(pp_json.get("poseIsWorldToCam"), True),
            ),
        ),
        training=TrainingConfig(
            enable=_as_bool(tr.get("enable"), True),
            max_steps=_as_int(tr.get("maxSteps"), 30000),
            model=str(tr.get("model") or "splatfacto"),
            enable_multi_gpu=_as_bool(tr.get("enableMultiGpu"), False),
            rotate_splat=_as_bool(tr.get("rotateSplat"), True),
        ),
        spherical_camera=SphericalCameraConfig(
            enable=_as_bool(sph.get("enable"), False),
            cube_faces_to_remove=str(sph.get("cubeFacesToRemove") or ""),
            optimize_sequential_frame_order=_as_bool(
                sph.get("optimizeSequentialFrameOrder"), True
            ),
            # config.json-only knobs in the reference (SPHERICAL_USE_OVAL_NODES/
            # ANGLED_UP/DOWN); accepted here as optional job-JSON keys
            use_oval_nodes=_as_bool(sph.get("useOvalNodes"), False),
            angled_up_views=_as_bool(sph.get("angledUpViews"), False),
            angled_down_views=_as_bool(sph.get("angledDownViews"), False),
        ),
        segmentation=SegmentationConfig(
            remove_background=_as_bool(seg.get("removeBackground"), False),
            background_removal_model=str(seg.get("backgroundRemovalModel") or "u2net"),
            mask_threshold=_as_float(seg.get("maskThreshold"), 0.6),
            remove_human_subject=_as_bool(seg.get("removeHumanSubject"), False),
        ),
        measurement=MeasurementConfig(
            reference_type=str(meas.get("referenceType") or "none"),
            tripod_height_m=_as_float(meas.get("tripodHeightM"), 0.0),
        ),
        semantic=SemanticConfig(
            enable_object_layer=_as_bool(sem.get("enableObjectLayer"), False),
            min_object_area_m2=_as_float(sem.get("minObjectAreaM2"), 0.25),
        ),
    )
    cfg.validate()
    return cfg


def job_config_to_json(cfg: JobConfig) -> dict:
    """Serialize a JobConfig back to the reference job-JSON shape."""
    return {
        "uuid": cfg.uuid,
        "instanceType": cfg.instance_type,
        "logVerbosity": cfg.log_verbosity,
        "inputPath": cfg.input_path,
        "outputPath": cfg.output_path,
        "s3": {
            "bucketName": cfg.s3.bucket_name,
            "inputPrefix": cfg.s3.input_prefix,
            "inputKey": cfg.s3.input_key,
            "outputPrefix": cfg.s3.output_prefix,
        },
        "videoProcessing": {"maxNumImages": cfg.video_processing.max_num_images},
        "imageProcessing": {
            "filterBlurryImages": cfg.image_processing.filter_blurry_images,
            "blurMaskMethod": cfg.image_processing.blur_mask_method,
        },
        "sfm": {
            "enable": cfg.sfm.enable,
            "softwareName": cfg.sfm.software_name,
            "enableEnhancedFeatureExtraction": cfg.sfm.enable_enhanced_feature_extraction,
            "matchingMethod": cfg.sfm.matching_method,
            "refineIntrinsics": cfg.sfm.refine_intrinsics_per_camera,
            "posePriors": {
                "usePosePriorColmapModelFiles": cfg.sfm.pose_priors.use_pose_prior_colmap_model_files,
                "usePosePriorTransformJson": {
                    "enable": cfg.sfm.pose_priors.use_pose_prior_transform_json,
                    "sourceCoordinateName": cfg.sfm.pose_priors.source_coordinate_name,
                    "poseIsWorldToCam": cfg.sfm.pose_priors.pose_is_world_to_cam,
                },
            },
        },
        "training": {
            "enable": cfg.training.enable,
            "maxSteps": cfg.training.max_steps,
            "model": cfg.training.model,
            "enableMultiGpu": cfg.training.enable_multi_gpu,
            "rotateSplat": cfg.training.rotate_splat,
        },
        "sphericalCamera": {
            "enable": cfg.spherical_camera.enable,
            "cubeFacesToRemove": cfg.spherical_camera.cube_faces_to_remove,
            "optimizeSequentialFrameOrder": cfg.spherical_camera.optimize_sequential_frame_order,
            "useOvalNodes": cfg.spherical_camera.use_oval_nodes,
            "angledUpViews": cfg.spherical_camera.angled_up_views,
            "angledDownViews": cfg.spherical_camera.angled_down_views,
        },
        "segmentation": {
            "removeBackground": cfg.segmentation.remove_background,
            "backgroundRemovalModel": cfg.segmentation.background_removal_model,
            "maskThreshold": cfg.segmentation.mask_threshold,
            "removeHumanSubject": cfg.segmentation.remove_human_subject,
        },
        "measurement": {
            "referenceType": cfg.measurement.reference_type,
            "tripodHeightM": cfg.measurement.tripod_height_m,
        },
        "semantic": {
            "enableObjectLayer": cfg.semantic.enable_object_layer,
            "minObjectAreaM2": cfg.semantic.min_object_area_m2,
        },
    }
