"""Job runner (the port of tpu_splat/pipeline/runner.py): assembles and
executes the reconstruction pipeline from a JobConfig, with the reference's
component graph, names, error codes, artifact paths and metrics:

  resolve-input -> video-to-images | extract-archive -> filter-blurry-images
  -> [remove-background] -> [spherical-to-perspective] -> sfm (features/match/
  map/BA) -> train-stage-1 (3DGS) -> export-ply -> rotate-pre-spz ->
  mirror-pre-spz -> spz-export -> [mesh-export] -> [estimate-scale -> floorplan
  -> object-layer] -> artifact-export

With pose priors (a transforms(-in).json or a COLMAP model in the capture),
process-pose-priors and a pre-SfM image-undistorter run, and SfM triangulates
against the fixed prior poses.

The matting nets, the 360-degree expansion, SfM (incremental, global or
with pose priors), undistortion, training and the extras (mesh, plane fits)
run on the job's device (CUDA unless the caller asks for the CPU). With
enableMultiGpu on a CUDA job and more than one card, training runs
data-parallel on every card (train_splat(distributed=True)); with one card
it logs so and trains on it. A job with both removeBackground and
sphericalCamera is refused (705) before any stage runs.

Quality gates mirror main.py:2031-2087 (frames >= 10 & points >= 50 for
splatfacto, >= 3/>= 3 otherwise); the delivery orientation dance mirrors
main.py:1479-1595 (the .spz is rotated x:270,y:180 + mirrored across x, while
the delivered .ply keeps the reconstruction orientation).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from tpu_splat_torch.core import spz as spz_codec
from tpu_splat_torch.core.config import JobConfig
from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.errors import PipelineError
from tpu_splat_torch.core.ply import save_ply
from tpu_splat_torch.core.types import to_numpy
from tpu_splat_torch.pipeline.component import ComponentType, Pipeline, PipelineContext
from tpu_splat_torch.pipeline.sink import ArtifactSink

LOGGER = "tpu_splat_torch.pipeline"


@dataclass
class JobResult:
    uuid: str
    status: str
    artifacts: Dict[str, str] = field(default_factory=dict)
    timings: Dict[str, float] = field(default_factory=dict)
    metrics: Dict[str, float] = field(default_factory=dict)
    error: Optional[str] = None


class JobStore:
    """Local job-state store (the DynamoDB table analog, workflow_trigger.py:179).

    One JSON file per job under <root>/jobs/."""

    def __init__(self, root: str):
        self.root = os.path.join(root, "jobs")
        os.makedirs(self.root, exist_ok=True)

    def update(self, uuid: str, **fields):
        path = os.path.join(self.root, f"{uuid}.json")
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data.update(fields)
        with open(path, "w") as f:
            json.dump(data, f, indent=2, default=str)

    def get(self, uuid: str) -> dict:
        path = os.path.join(self.root, f"{uuid}.json")
        with open(path) as f:
            return json.load(f)


@contextlib.contextmanager
def _bridge_pipeline_logs(log_fn):
    """Forward the pipeline logger's INFO records to log_fn for the duration
    of the block (no-op when log_fn is None). Restores the logger's
    level/propagate on exit so a job without log_fn keeps whatever logging
    config the host application set up."""
    if log_fn is None:
        yield
        return

    class _LogFnHandler(logging.Handler):
        def emit(self, record):
            try:
                log_fn(record.getMessage())
            except Exception:
                pass

    lg = logging.getLogger(LOGGER)
    bridge = _LogFnHandler(level=logging.INFO)
    prev_level, prev_propagate = lg.level, lg.propagate
    lg.addHandler(bridge)
    if lg.level > logging.INFO or lg.level == logging.NOTSET:
        lg.setLevel(logging.INFO)
    lg.propagate = False  # no double print when root has a handler
    try:
        yield
    finally:
        lg.removeHandler(bridge)
        lg.setLevel(prev_level)
        lg.propagate = prev_propagate


def run_job(cfg: JobConfig, log_fn=None, device=None) -> JobResult:
    """Execute a reconstruction job end to end on `device` (CUDA unless the
    CPU is asked for). Returns the JobResult; raises PipelineError with a
    taxonomy code on failure (after recording it)."""
    cfg.validate()
    dev = resolve_device(device)
    out_dir = os.path.abspath(cfg.output_path)
    pipe = Pipeline(name="3DGS-Pipeline", uuid=cfg.uuid, log_fn=log_fn)
    _register_components(pipe, cfg)

    os.makedirs(out_dir, exist_ok=True)
    store = JobStore(out_dir)
    store.update(cfg.uuid, status="In-Progress", start=time.time(), config=cfg.uuid)
    t0 = time.time()
    try:
        _refuse_unsupported(cfg)
        # Component internals (mapper registrations, trainer milestones, ...)
        # log through the pipeline logger; bridge it to log_fn for the job.
        with _bridge_pipeline_logs(log_fn):
            ctx = pipe.run(PipelineContext(cfg=cfg, out_dir=out_dir, device=dev))
    except PipelineError as e:
        store.update(cfg.uuid, status="Error", end=time.time(),
                     elapsed=time.time() - t0, error=str(e), code=e.code)
        raise
    result = JobResult(
        uuid=cfg.uuid,
        status="Complete",
        artifacts=ctx.get("artifacts", {}),
        timings=pipe.timings(),
        metrics=ctx.get("metrics", {}),
    )
    store.update(
        cfg.uuid, status="Complete", end=time.time(), elapsed=time.time() - t0,
        artifacts=result.artifacts, metrics=result.metrics, timings=result.timings,
    )
    return result


def _refuse_unsupported(cfg: JobConfig):
    """Refuse, before any stage runs, a job whose options cannot run
    together. Remove-Background makes one mask per equirectangular frame,
    and the cube-face expansion replaces those frames with views the masks
    do not fit, so SfM would index them with view numbers (the reference's
    runner takes the same path and fails at SfM)."""
    if cfg.segmentation.remove_background and cfg.spherical_camera.enable:
        raise PipelineError(705, "segmentation.removeBackground and sphericalCamera.enable "
                                 "cannot run in one job: the background masks are made per "
                                 "equirectangular frame, not per cube-face view")


# ---------------------------------------------------------------------------
# component registration (the conditional graph of main.py:659-1840)
# ---------------------------------------------------------------------------


def _register_components(pipe: Pipeline, cfg: JobConfig):
    pipe.create_component("Resolve-Input", ComponentType.LOADER, _resolve_input, 705)
    pipe.create_component("Media-To-Images", ComponentType.LOADER, _media_to_images, 730)
    pipe.create_component(
        "Filter-Blurry-Images", ComponentType.FILTER, _filter_blurry, 795,
        enabled=cfg.image_processing.filter_blurry_images,
    )
    pipe.create_component(
        "Remove-Background", ComponentType.FILTER, _remove_background, 740,
        enabled=cfg.segmentation.remove_background,
    )
    pipe.create_component(
        "Remove-Human-Subject", ComponentType.FILTER, _remove_human_subject, 745,
        enabled=cfg.segmentation.remove_human_subject,
    )
    pipe.create_component(
        "Spherical-To-Perspective", ComponentType.TRANSFORM, _spherical, 735,
        enabled=cfg.spherical_camera.enable,
    )
    use_priors = (cfg.sfm.pose_priors.use_pose_prior_transform_json
                  or cfg.sfm.pose_priors.use_pose_prior_colmap_model_files)
    pipe.create_component(
        "Process-Pose-Priors", ComponentType.TRANSFORM, _load_pose_priors, 725,
        enabled=cfg.sfm.enable and use_priors,
    )
    # As in the reference, the pre-SfM undistorter runs exactly when pose
    # priors are on (distortion then comes from a prior COLMAP model).
    pipe.create_component(
        "Image-Undistorter", ComponentType.TRANSFORM, _undistort, 755,
        enabled=cfg.sfm.enable and use_priors,
    )
    pipe.create_component("SfM", ComponentType.TRANSFORM, _sfm, 755,
                          enabled=cfg.sfm.enable)
    pipe.create_component("Quality-Gate", ComponentType.FILTER, _quality_gate, 795,
                          enabled=cfg.sfm.enable and cfg.training.enable)
    pipe.create_component("Train-Stage1", ComponentType.RENDERER, _train, 770,
                          enabled=cfg.training.enable)
    pipe.create_component("Export-Splat", ComponentType.EXPORTER, _export_ply, 780,
                          enabled=cfg.training.enable)
    pipe.create_component(
        "Rotate-Mirror-SPZ-Export", ComponentType.EXPORTER, _export_spz, 783,
        enabled=cfg.training.enable,
    )
    pipe.create_component(
        "Mesh-Export", ComponentType.EXPORTER, _export_mesh, 785,
        enabled=cfg.training.enable and cfg.training.model == "nerfacto",
    )
    pipe.create_component(
        "Estimate-Scale", ComponentType.EXPORTER, _estimate_scale, 795,
        enabled=cfg.measurement.reference_type != "none",
    )
    pipe.create_component(
        "Extract-Floorplan", ComponentType.EXPORTER, _floorplan, 795,
        enabled=cfg.measurement.reference_type != "none",
    )
    pipe.create_component(
        "Extract-Object-Layer", ComponentType.EXPORTER, _object_layer, 795,
        enabled=cfg.semantic.enable_object_layer,
    )
    pipe.create_component("Artifact-Export", ComponentType.EXPORTER, _artifact_export, 786)


def _resolve_input(ctx: PipelineContext):
    cfg: JobConfig = ctx["cfg"]
    path = cfg.input_path
    from tpu_splat_torch.ingest.video import IMAGE_EXTENSIONS, VIDEO_EXTENSIONS

    # Multi-video property scans: comma-separated video list -> merged SfM.
    if "," in (path or ""):
        parts = [p.strip() for p in path.split(",") if p.strip()]
        for p in parts:
            if not os.path.exists(p):
                raise PipelineError(710, f"input not found: {p!r}")
            if os.path.splitext(p)[1].lower() not in VIDEO_EXTENSIONS:
                raise PipelineError(705, f"multi-input only supports videos: {p!r}")
        ctx["input_kind"] = "multi_video"
        ctx["input_path"] = parts
        return
    if not path or not os.path.exists(path):
        raise PipelineError(710, f"input not found: {path!r}")
    ext = os.path.splitext(path)[1].lower()
    if os.path.isdir(path):
        vids = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith(VIDEO_EXTENSIONS)
        )
        if len(vids) > 1:
            ctx["input_kind"] = "multi_video"
            ctx["input_path"] = vids
            return
        if len(vids) == 1:
            ctx["input_kind"] = "video"
            ctx["input_path"] = vids[0]
            return
        ctx["input_kind"] = "dir"
    elif ext in VIDEO_EXTENSIONS:
        ctx["input_kind"] = "video"
    elif ext == ".zip":
        ctx["input_kind"] = "zip"
    elif ext in IMAGE_EXTENSIONS:
        raise PipelineError(705, "a single image cannot be reconstructed")
    else:
        raise PipelineError(705, f"unsupported input type {ext!r}")
    ctx["input_path"] = path


def _media_to_images(ctx: PipelineContext):
    from tpu_splat_torch.ingest.video import (exif_focal_px, extract_frames, extract_zip,
                                              load_images_from_dir)

    cfg: JobConfig = ctx["cfg"]
    kind = ctx["input_kind"]
    max_images = cfg.video_processing.max_num_images
    resize = 3840  # resize-to-4K rule (main.py:97-157)
    if kind == "video":
        images = extract_frames(ctx["input_path"], max_frames=max(max_images * 2, 60),
                                resize_max_dim=resize)
    elif kind == "multi_video":
        # merged SfM over several captures of the same property: frames from all
        # videos share one image set; exhaustive/retrieval matching links them
        paths = ctx["input_path"]
        per = max(max_images * 2 // len(paths), 30)
        segs, stacks = [], []
        for p in paths:
            frames = extract_frames(p, max_frames=per, resize_max_dim=resize)
            segs.append(len(frames))
            stacks.append(frames)
        h = min(s.shape[1] for s in stacks)
        w = min(s.shape[2] for s in stacks)
        images = np.concatenate([s[:, :h, :w] for s in stacks])
        ctx["segments"] = segs
    elif kind == "zip":
        img_dir = os.path.join(ctx["out_dir"], "images_raw")
        extract_zip(ctx["input_path"], img_dir)
        images, names = load_images_from_dir(img_dir, resize_max_dim=resize)
        ctx["raw_dir"] = img_dir
        ctx["image_names"] = names
    else:
        images, names = load_images_from_dir(ctx["input_path"], resize_max_dim=resize)
        ctx["raw_dir"] = ctx["input_path"]
        ctx["image_names"] = names
    if len(images) < 3:
        raise PipelineError(705, f"need >= 3 frames, got {len(images)}")
    ctx["images"] = images
    # EXIF focal seed for SfM self-calibration (photo inputs only)
    if ctx.get("raw_dir") and ctx.get("image_names"):
        fx = exif_focal_px(
            os.path.join(ctx["raw_dir"], ctx["image_names"][0]),
            images.shape[2],
        )
        if fx:
            ctx["exif_fx"] = fx
            pipe_logger(ctx)(f"EXIF focal seed: fx={fx:.1f}px")


def _filter_blurry(ctx: PipelineContext):
    from tpu_splat_torch.ingest.blur import filter_blurry_images

    cfg: JobConfig = ctx["cfg"]
    images = ctx.require("images")
    target = min(cfg.video_processing.max_num_images, len(images))
    selected, idx = filter_blurry_images(
        images, target_count=target,
        mask_method=cfg.image_processing.blur_mask_method, device=ctx["device"],
    )
    ctx["images"] = selected
    ctx["frame_indices"] = idx
    if ctx.get("image_names") is not None:
        ctx["image_names"] = [ctx["image_names"][i] for i in idx]


def _remove_background(ctx: PipelineContext):
    from tpu_splat_torch.matting.remove import remove_background_batch

    cfg: JobConfig = ctx["cfg"]
    images, masks = remove_background_batch(
        ctx.require("images"),
        model=cfg.segmentation.background_removal_model,
        threshold=cfg.segmentation.mask_threshold,
        device=ctx["device"],
    )
    ctx["images"] = images
    ctx["masks"] = masks


def _find_mask_images(ctx: PipelineContext):
    """Locate externally supplied mask images for the capture: a `masks/`
    sibling directory whose files pair with the frames by sorted order (the
    reference pairs os.listdir orderings, remove_object_using_mask.py:147-166).
    Returns (N, H, W) float masks aligned to ctx images, or None."""
    import cv2

    raw_dir = ctx.get("raw_dir")
    if not raw_dir:
        return None
    mask_dir = os.path.join(raw_dir, "masks")
    if not os.path.isdir(mask_dir):
        mask_dir = os.path.join(os.path.dirname(raw_dir.rstrip("/")), "masks")
        if not os.path.isdir(mask_dir):
            return None
    files = sorted(
        f for f in os.listdir(mask_dir)
        if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg", ".bmp")
    )
    if not files:
        return None
    images = ctx.require("images")
    idx = ctx.get("frame_indices")
    if len(files) != len(images) and idx is not None and len(files) > max(idx):
        files = [files[i] for i in idx]  # masks were per raw frame
    if len(files) != len(images):
        raise PipelineError(
            740, f"mask count {len(files)} != frame count {len(images)}"
        )
    h, w = images.shape[1:3]
    masks = np.stack([
        cv2.resize(
            cv2.imread(os.path.join(mask_dir, f), cv2.IMREAD_GRAYSCALE),
            (w, h), interpolation=cv2.INTER_LINEAR,
        ).astype(np.float32)
        for f in files
    ])
    return masks


def _remove_human_subject(ctx: PipelineContext):
    """Remove a human subject from every frame (remove_object_using_mask.py:28-169
    + the SAM2 human-detection seeding, main.py:912-941). When the capture
    ships mask images (a masks/ directory), they are applied through the
    reference's invert -> alpha -> Otsu-binarize contract; otherwise the person
    is detected with the person-segmentation matting stack. Either way the
    training masks keep the COMPLEMENT — the scene minus the subject."""
    from tpu_splat_torch.matting.remove import apply_mask_images, remove_background_batch

    cfg: JobConfig = ctx["cfg"]
    images = ctx.require("images")
    mask_imgs = _find_mask_images(ctx)
    if mask_imgs is not None:
        pipe_logger(ctx)(f"applying {len(mask_imgs)} external mask images")
        _, keep = apply_mask_images(images, mask_imgs)
    else:
        _, person_masks = remove_background_batch(
            images, model="u2net_human_seg",
            threshold=cfg.segmentation.mask_threshold, device=ctx["device"],
        )
        keep = (1.0 - person_masks).astype(np.float32)
    if ctx.get("masks") is not None:
        keep = keep * ctx["masks"]
    ctx["images"] = (images * keep[..., None]).astype(np.float32)
    ctx["masks"] = keep


def _load_pose_priors(ctx: PipelineContext):
    """Import prior camera poses (the ProcessPoseTransforms analog,
    main.py:989-1009): either a NeRFCapture transforms(-in).json or an existing
    COLMAP text model shipped inside the capture archive. Aligns poses to the
    surviving image set by file name, normalizes translations, and records
    intrinsics (+ distortion, for the undistorter)."""
    from tpu_splat_torch.sfm.pose_priors import load_transforms_json, normalize_poses

    cfg: JobConfig = ctx["cfg"]
    pp = cfg.sfm.pose_priors
    raw_dir = ctx.get("raw_dir")
    names = ctx.get("image_names")
    if raw_dir is None or names is None:
        raise PipelineError(
            720, "pose priors require a .zip or image-directory input"
        )
    images = ctx.require("images")
    h, w = images.shape[1:3]

    if pp.use_pose_prior_transform_json:
        path = os.path.join(raw_dir, "transforms-in.json")
        if not os.path.exists(path):
            path = os.path.join(raw_dir, "transforms.json")
        if not os.path.exists(path):
            raise PipelineError(725, f"no transforms(-in).json under {raw_dir}")
        c2ws, intrin, frame_names = load_transforms_json(
            path, source=pp.source_coordinate_name,
            is_world_to_cam=pp.pose_is_world_to_cam,
        )
        pose_of = {os.path.basename(n): c2ws[i] for i, n in enumerate(frame_names)}
        # json intrinsics are at capture resolution; frames may have been resized
        sx = w / intrin["w"] if intrin["w"] else 1.0
        sy = h / intrin["h"] if intrin["h"] else 1.0
        fx = (intrin["fx"] or 0.9 * w) * sx
        fy = (intrin["fy"] or fx) * sy
        cx = (intrin["cx"] or w / 2 / sx) * sx
        cy = (intrin["cy"] or h / 2 / sy) * sy
        dist = np.zeros(4)
    else:  # COLMAP text model files
        from tpu_splat_torch.sfm.colmap_io import qvec_to_rotmat, read_colmap_model

        model_dir = None
        for cand in ("sparse/0", "sparse", "colmap/sparse/0"):
            d = os.path.join(raw_dir, cand)
            if os.path.exists(os.path.join(d, "cameras.txt")):
                model_dir = d
                break
        if model_dir is None:
            raise PipelineError(725, f"no COLMAP text model under {raw_dir}")
        cameras, img_map, _, _ = read_colmap_model(model_dir)
        cam = cameras[sorted(cameras)[0]]
        params = cam["params"]
        model = cam["model"].upper()
        if model == "SIMPLE_PINHOLE":
            fx = fy = params[0]
            cx, cy = params[1:3]
            dist = np.zeros(4)
        elif model == "PINHOLE":
            fx, fy, cx, cy = params[:4]
            dist = np.zeros(4)
        elif model == "SIMPLE_RADIAL":
            fx = fy = params[0]
            cx, cy = params[1:3]
            dist = np.array([params[3], 0.0, 0.0, 0.0])
        elif model == "RADIAL":
            fx = fy = params[0]
            cx, cy = params[1:3]
            dist = np.array([params[3], params[4], 0.0, 0.0])
        elif model == "OPENCV":
            fx, fy, cx, cy = params[:4]
            dist = np.array(params[4:8] + [0.0] * (8 - len(params)))[:4]
        else:
            raise PipelineError(700, f"unsupported camera model {model}")
        sx = w / cam["width"] if cam["width"] else 1.0
        sy = h / cam["height"] if cam["height"] else 1.0
        fx *= sx
        fy *= sy
        cx *= sx
        cy *= sy
        pose_of = {}
        for name, rec in img_map.items():
            R = qvec_to_rotmat(rec["qvec"])
            c2w = np.eye(4)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ rec["tvec"]
            pose_of[os.path.basename(name)] = c2w

    have = np.array([n in pose_of for n in names])
    if have.sum() < 3:
        raise PipelineError(
            725, f"only {int(have.sum())}/{len(names)} frames have prior poses"
        )
    keep_idx = np.flatnonzero(have)
    ctx["images"] = images[keep_idx]
    ctx["image_names"] = [names[i] for i in keep_idx]
    if ctx.get("masks") is not None:
        ctx["masks"] = ctx["masks"][keep_idx]
    c2ws = np.stack([pose_of[names[i]] for i in keep_idx])
    c2ws, _, _ = normalize_poses(c2ws)
    ctx["prior_c2ws"] = c2ws
    ctx["prior_intrin"] = (float(fx), float(fy), float(cx), float(cy))
    ctx["prior_distortion"] = np.asarray(dist, np.float64)


def _undistort(ctx: PipelineContext):
    """Undistort frames to a pinhole model when the prior COLMAP model carries
    distortion (the colmap image_undistorter analog, main.py:1161-1180), on
    the job's device. Runs before feature extraction so everything
    downstream is pinhole."""
    dist = ctx.get("prior_distortion")
    if dist is None or not np.any(np.abs(dist) > 1e-12):
        return  # pinhole already
    from tpu_splat_torch.sfm.undistort import undistort_batch

    fx, fy, cx, cy = ctx["prior_intrin"]
    ctx["images"] = undistort_batch(ctx.require("images"), fx, fy, cx, cy,
                                    k1=float(dist[0]), k2=float(dist[1]),
                                    p1=float(dist[2]), p2=float(dist[3]),
                                    device=ctx["device"])
    ctx["prior_distortion"] = np.zeros(4)


def _spherical(ctx: PipelineContext):
    from tpu_splat_torch.spherical.pipeline import expand_equirectangular_captures

    cfg: JobConfig = ctx["cfg"]
    ctx["images"] = expand_equirectangular_captures(
        ctx.require("images"), cfg.spherical_camera, device=ctx["device"]
    )


def _sfm(ctx: PipelineContext):
    from tpu_splat_torch.sfm.features import FeatureConfig
    from tpu_splat_torch.sfm.mapper import MapperConfig, run_sfm

    cfg: JobConfig = ctx["cfg"]
    images = ctx.require("images")
    # Low-resolution captures (<400px) auto-enable the enhanced small-image
    # recipe: 2x upsample before octave 0, 3 octaves, capped feature count
    # (the reference's enableEnhancedFeatureExtraction, main.py:967-971).
    small = max(images.shape[1], images.shape[2]) < 400
    mcfg = MapperConfig(
        feature=FeatureConfig(
            max_features=(min(cfg.sfm.max_features_per_image, 1024) if small
                          else cfg.sfm.max_features_per_image),
            num_octaves=3 if small else 4,
            upsample_first=(cfg.sfm.enable_enhanced_feature_extraction
                            or small),
        ),
        matching_method=cfg.sfm.matching_method,
        exhaustive_max_images=cfg.sfm.exhaustive_matching_max_images,
        refine_per_camera=cfg.sfm.refine_intrinsics_per_camera,
    )
    try:
        if ctx.get("prior_c2ws") is not None:
            # fixed-pose triangulation (colmap point_triangulator analog,
            # main.py:1090-1113) against the imported prior poses
            from tpu_splat_torch.sfm.pose_priors import sfm_with_pose_priors

            fx, fy, cx, cy = ctx["prior_intrin"]
            scene = sfm_with_pose_priors(
                images, ctx["prior_c2ws"], fx, fy, cx, cy,
                mapper_cfg=mcfg, log_fn=pipe_logger(ctx), device=ctx["device"],
            )
        elif cfg.sfm.software_name in ("glomap", "global"):
            from tpu_splat_torch.sfm.global_mapper import run_global_sfm

            scene = run_global_sfm(images, mcfg, log_fn=pipe_logger(ctx),
                                   device=ctx["device"])
        else:
            # EXIF focal (when present) seeds self-calibration; refinement
            # stays ON either way (COLMAP mapper default behavior)
            exif_fx = ctx.get("exif_fx")
            if exif_fx:
                mcfg = dataclasses.replace(mcfg, refine_intrinsics=True)
            colmap_dir = os.path.join(ctx["out_dir"], "colmap")
            os.makedirs(colmap_dir, exist_ok=True)
            db_path = os.path.join(colmap_dir, "database.db")
            scene = run_sfm(images, mcfg, fx=exif_fx, fy=exif_fx,
                            log_fn=pipe_logger(ctx),
                            export_database=db_path, device=ctx["device"])
            if os.path.exists(db_path):
                ctx.setdefault("artifacts", {})["colmap_db"] = db_path
    except RuntimeError as e:
        raise PipelineError(755, str(e)) from e
    ctx["scene"] = scene
    reg = np.asarray(scene.registered)
    # job-report metrics (the reference surfaces the same counts in its
    # completion email, workflow_complete.py:386-406)
    ctx.setdefault("metrics", {}).update({
        "num_images": float(len(reg)),
        "num_registered": float(reg.sum()),
    })
    ctx["images"] = images[reg]
    if ctx.get("masks") is not None:
        ctx["masks"] = ctx["masks"][reg]
    _undistort_selfcal(ctx)
    _export_sfm_model(ctx, reg)


def _export_sfm_model(ctx: PipelineContext, reg: np.ndarray):
    """Deliver the SfM model like the reference's workflow output: COLMAP
    sparse model (text + binary, sparse/0 layout) under <out>/colmap/ and a
    Nerfstudio transforms.json (colmap_to_nerfstudio_cam.py analog,
    main.py:1202-1232) registered as a job artifact."""
    from tpu_splat_torch.sfm.colmap_io import (write_colmap_model,
                                               write_colmap_model_binary,
                                               write_transforms_json)

    scene = ctx["scene"]
    names = ctx.get("image_names")
    if names is not None and len(names) == len(reg):
        names = [nm for nm, r in zip(names, reg) if r]
    else:
        names = None
    colmap_dir = os.path.join(ctx["out_dir"], "colmap")
    sparse = os.path.join(colmap_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    write_colmap_model(scene, sparse, image_names=names)
    write_colmap_model_binary(scene, sparse, image_names=names)
    tj = os.path.join(colmap_dir, "transforms.json")
    write_transforms_json(scene, tj, image_names=names)
    ctx.setdefault("artifacts", {})["transforms_json"] = tj


def _undistort_selfcal(ctx: PipelineContext):
    """Undistort frames when SfM self-calibrated a radial model.

    SfM poses/points live in UNDISTORTED observation space
    (mapper._norm_coords), so before pinhole training the frames must be
    undistorted with the estimated model (the reference's image_undistorter,
    main.py:1161-1180), on the job's device. No-op on pinhole scenes."""
    from tpu_splat_torch.sfm.undistort import undistort_batch

    scene = ctx.require("scene")
    dist = to_numpy(scene.cameras.distortion)
    if not dist.size or not np.any(np.abs(dist) > 1e-6):
        return
    k1, k2, p1, p2 = (float(v) for v in dist[0])
    cams = scene.cameras
    intrin = [float(to_numpy(v)[0]) for v in (cams.fx, cams.fy, cams.cx, cams.cy)]
    pipe_logger(ctx)(f"undistorting {ctx['images'].shape[0]} frames with "
                     f"self-calibrated k1={k1:+.4f}")
    ctx["images"] = undistort_batch(ctx["images"], *intrin, k1=k1, k2=k2, p1=p1, p2=p2,
                                    device=ctx["device"])
    if ctx.get("masks") is not None:
        # masks are (N, H, W); the remap is channel-last
        ctx["masks"] = undistort_batch(ctx["masks"].astype(np.float32)[..., None], *intrin,
                                       k1=k1, k2=k2, p1=p1, p2=p2,
                                       device=ctx["device"])[..., 0]
    ctx["scene"] = dataclasses.replace(
        scene, cameras=dataclasses.replace(cams, distortion=np.zeros_like(dist)))


def _quality_gate(ctx: PipelineContext):
    """Pre-training sufficiency checks (main.py:2031-2087)."""
    cfg: JobConfig = ctx["cfg"]
    scene = ctx.require("scene")
    n_frames = int(np.asarray(scene.registered).sum())
    n_points = scene.num_points
    min_frames, min_points = (10, 50) if cfg.training.model.startswith("splatfacto") else (3, 3)
    if n_frames < min_frames:
        raise PipelineError(
            755, f"SfM failed to converge: not enough registered frames "
                 f"({n_frames} < {min_frames})"
        )
    if n_points < min_points:
        raise PipelineError(
            755, f"SfM failed to converge: not enough sparse points "
                 f"({n_points} < {min_points})"
        )


def _train(ctx: PipelineContext):
    from tpu_splat_torch.gs.pipeline import train_splat

    cfg: JobConfig = ctx["cfg"]
    # Multi-card dispatch (the gsplat multi-GPU path, main.py:1317-1347):
    # enableMultiGpu + a CUDA job + more than one card -> data-parallel ranks.
    distributed = False
    if cfg.training.enable_multi_gpu:
        distributed = ctx["device"].type == "cuda" and torch.cuda.device_count() > 1
        if not distributed:
            pipe_logger(ctx)("enableMultiGpu set but only one device present; "
                             "training single-chip")
    cloud, metrics = train_splat(
        ctx.require("scene"),
        ctx.require("images"),
        model=cfg.training.model,
        max_steps=cfg.training.max_steps,
        downscale_factor=cfg.training.downscale_factor,
        masks=ctx.get("masks"),
        checkpoint_dir=os.path.join(ctx["out_dir"], "checkpoints"),
        resume=True,
        distributed=distributed,
        log_fn=pipe_logger(ctx),
        device=ctx["device"],
    )
    ctx["splat"] = cloud
    ctx.setdefault("metrics", {}).update(metrics)


def _export_ply(ctx: PipelineContext):
    out = os.path.join(ctx["out_dir"], "exports")
    os.makedirs(out, exist_ok=True)
    ply_path = os.path.join(out, "splat.ply")
    save_ply(ctx.require("splat"), ply_path)
    ctx.setdefault("artifacts", {})["ply"] = ply_path


def _export_spz(ctx: PipelineContext):
    """Delivery orientation dance (main.py:1479-1595): the .spz artifact is
    rotated x:270,y:180 and mirrored across x for web viewers; the delivered
    .ply then gets the reference's post-SPZ chain (rotate x:180,y:180 +
    mirror x applied to the pre-SPZ-oriented cloud, main.py:1554-1595), so
    both artifacts match the reference deliverables byte-for-orientation.
    Portrait captures get an extra -90° y rotation (main.py:2201-2240's
    Rotation-Pre-SPZ hook) so the delivered splat stands upright."""
    from tpu_splat_torch.export.transforms import mirror_splat, rotate_splat

    cfg: JobConfig = ctx["cfg"]
    cloud = ctx.require("splat")
    out = os.path.join(ctx["out_dir"], "exports")
    os.makedirs(out, exist_ok=True)
    if cfg.training.rotate_splat:
        y_deg = 180
        images = ctx.get("images")
        if images is not None and images.shape[1] > images.shape[2]:
            y_deg -= 90  # portrait input: height > width
            pipe_logger(ctx)("portrait capture detected: y rotation 180 -> 90")
        cloud = rotate_splat(cloud, f"x:270,y:{y_deg}")
        cloud = mirror_splat(cloud, "x")
    spz_path = os.path.join(out, "splat.spz")
    spz_codec.save_spz(cloud, spz_path)
    ctx.setdefault("artifacts", {})["spz"] = spz_path
    if cfg.training.rotate_splat:
        delivered = mirror_splat(rotate_splat(cloud, "x:180,y:180"), "x")
        save_ply(delivered, os.path.join(out, "splat.ply"))


def _export_mesh(ctx: PipelineContext):
    """Polygonize the trained splat into poisson_mesh.ply + textured mesh
    .obj/.glb (the nerfacto mesh-export deliverables, main.py:1388-1468), on
    the job's device."""
    from tpu_splat_torch.export.mesh import export_mesh_artifacts

    out = os.path.join(ctx["out_dir"], "exports")
    os.makedirs(out, exist_ok=True)
    arts = export_mesh_artifacts(ctx.require("splat"), out, device=ctx["device"])
    pipe_logger(ctx)(
        f"mesh: {arts['n_vertices']} vertices, {arts['n_faces']} faces"
    )
    ctx.setdefault("artifacts", {}).update(
        {k: v for k, v in arts.items() if isinstance(v, str)}
    )


def _estimate_scale(ctx: PipelineContext):
    from tpu_splat_torch.export.measurement import estimate_scale_from_tripod

    cfg: JobConfig = ctx["cfg"]
    scene = ctx.require("scene")
    result = estimate_scale_from_tripod(
        to_numpy(ctx.require("splat").means),
        to_numpy(scene.cameras.camtoworlds),
        tripod_height_m=cfg.measurement.tripod_height_m,
        device=ctx["device"],
    )
    path = os.path.join(ctx["out_dir"], "exports", "measurement.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    ctx.setdefault("artifacts", {})["measurement"] = path
    ctx["scale_m_per_unit"] = result.get("metersPerModelUnit", 0.0)


def _floorplan(ctx: PipelineContext):
    from tpu_splat_torch.export.floorplan import extract_floorplan

    # Gate on scale estimation having actually found a ground plane — a
    # floorplan with made-up meters is worse than none (reference only runs
    # extract_floorplan.py after estimate_scale succeeds).
    scale = ctx.get("scale_m_per_unit", 0.0)
    if not scale or scale <= 0.0:
        pipe_logger(ctx)("floorplan: skipped (no scale estimate)")
        return
    out = os.path.join(ctx["out_dir"], "exports")
    arts = extract_floorplan(
        to_numpy(ctx.require("splat").means),
        scale_m_per_unit=scale,
        out_dir=out,
        device=ctx["device"],
    )
    ctx.setdefault("artifacts", {}).update(arts)


def _object_layer(ctx: PipelineContext):
    from tpu_splat_torch.export.objects import extract_object_layer

    cfg: JobConfig = ctx["cfg"]
    out = os.path.join(ctx["out_dir"], "exports")
    arts = extract_object_layer(
        to_numpy(ctx.require("splat").means),
        scale_m_per_unit=ctx.get("scale_m_per_unit", 1.0),
        min_object_area_m2=cfg.semantic.min_object_area_m2,
        out_dir=out,
        device=ctx["device"],
    )
    ctx.setdefault("artifacts", {}).update(arts)


def _artifact_export(ctx: PipelineContext):
    """Copy artifacts to the configured sink (graceful skip of missing optional
    artifacts, main.py:2250-2266 parity)."""
    cfg: JobConfig = ctx["cfg"]
    root = cfg.s3.bucket_name or ctx["out_dir"]
    prefix = cfg.s3.output_prefix or "workflow-output"
    sink = ArtifactSink(root)
    delivered = {}
    for name, path in ctx.get("artifacts", {}).items():
        if not os.path.exists(path):
            continue  # graceful skip
        delivered[name] = sink.put(path, os.path.join(prefix, cfg.uuid,
                                                      os.path.basename(path)))
    ctx["artifacts"] = delivered


def pipe_logger(ctx: PipelineContext):
    lg = logging.getLogger(LOGGER)
    return lambda s: lg.info(s)
