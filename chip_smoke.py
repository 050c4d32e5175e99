"""On-card smoke test of the PyTorch/CUDA port (tpu_splat_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU and the CUDA toolkit (nvcc); imports nothing of JAX or of
the JAX package. Phases, each of which raises on failure:

1. card: name and power limit, as nvidia-smi reports them;
2. build: compile the compositing and Adam kernels from tpu_splat_torch/csrc
   with nvcc, print each kernel's registers, shared memory and spills, and
   fail on a spill;
3. kernels against their plain PyTorch versions, on the card: the
   check_kernel_parity fixture (near-empty, saturating and never-saturating
   tiles), the same fixture with ragged pair counts (RAGGED_COUNTS: an empty
   tile, and tiles on the edges of the backward's 16-gaussian segments and
   128-gaussian chunks) and packed tensors from a real 1280x720 binning at
   K=256 and K=1024; forward and tstart max abs <= 2e-5 with the same
   chunks reached, counts-bounded sweep bit-identical, two forward launches
   bit-identical (out and tstart), backward
   max|d| / max|g| <= 5e-5 fed by the plain forward's checkpoints and by
   the kernel's own, two backward launches bit-identical, and every
   gradient slot past its tile's count exactly 0; kernel and plain times,
   and bounds counted over the real pairs of the reached chunks; then the
   Adam kernel (csrc/adam.cu) against adam_update_plain at splatbench
   outdoor-3m's layout (2^22 rows of 59 elements, shN's first moment in
   bf16, 30% of the rows dead), dense and with `visible`: parameters and
   moments within 1e-6 relative (the count of leaves that agree bit for bit
   printed), two launches bit-identical, its time, the plain chain's time
   and its share of its bound (the least bytes over 3.35 TB/s);
4. full width: train_step on bench.py's workload (2^19 capacity, 400K alive,
   1280x720, SH degree 3, 8 ring views, no random background, K=256), ms/step
   from CUDA events after a warm-up, finite loss, one Adam launch a step;
   two identical train_steps
   from one state must agree bit for bit in every parameter, Adam moment and
   densify accumulator (also run, for the record, with the parent's atomic
   pack-gather backward, which is timed beside the new one);
5. end to end: train_splat on a small seeded scene through one refine pass
   (the refine must change the gaussian count), then .ply/.spz written,
   reloaded and counted;
6. SfM at a real size: run_sfm on 16 frames of 1280x720, rendered by the
   port from a seeded textured scene on a forward walk, at the runner's
   720p configuration (4096 features, 4 octaves, no upsample, sequential
   matching, which is exhaustive at 16 frames) with no focal given, so
   self-calibration runs. Prints the registered and point counts, the final
   BA rms, the camera-centre RMSE against the true poses after a similarity
   alignment (as a fraction of the walk's span), each mapper phase's
   seconds and the batched torch.linalg calls' times; raises unless at least
   N - 2 frames register, every pose and point is finite, and two identical
   bundle_adjust calls on the result agree bit for bit;
7. a default job: phase 6's frames as 8-bit PNGs in a .zip, run by the
   port's CLI (`run`, on the card) with the reference's default job JSON but
   for maxSteps (600, past the first refine pass): ingest, blur filter,
   self-calibrated SfM, undistortion, the COLMAP model and database,
   training, .ply and the rotated .spz, the artifact sink. Raises unless the
   job completes with >= 14 frames registered, every default artifact is
   present and reads back (the database holds every frame, the text and
   binary models hold the registered ones, the .ply and .spz the trained
   gaussian count) and every pose, point and gaussian is finite. Prints each
   component's seconds, the mapper's timers, the self-calibrated k1, the
   training's step time and held-out PSNR;
8. a --remove-background job: 16 frames of 1280x720 of testing.subject_scene
   (a rock on a dim ground) on an arc, zipped as PNGs, a job JSON written by
   the port's generator (`generate_splat --remove-background --job-only`,
   maxSteps lowered to 300) and run by the CLI. Raises unless it completes,
   every artifact reads back as in phase 7, every frame's mask covers
   (0.05, 0.80) of it and the registered frames' masks reach Train-Stage1.
   Then MatNet on the card against the port on the CPU (two of the job's
   frames: saliency max abs <= 1e-3, 0.1% of the mask; each f32 result's
   distance from the f64 one is printed), its IoU on
   tests/test_matting_quality.py's composite capture (> 0.9, the
   reference's bar), and the full U2Net from a
   seeded standard .pth through TPU_SPLAT_U2NET_WEIGHTS: remove_background_
   batch on 4 frames, and the card's saliency of one frame against the CPU's
   (max abs <= 1e-3; the CPU's f32 against f64 is printed beside it). Prints
   ms a frame of MatNet (256x256, batch 8) and U2Net (320x320, batch 4);
9. a --spherical job: 4 equirectangular frames of 512x1024 of
   testing.room_scene, assembled from cube faces rendered by the port with
   cubemap_to_erp, zipped, a job JSON from `generate_splat --spherical
   --preset fast --job-only` with maxSteps 300 and cubeFacesToRemove
   "up,down" (64 views of 256x256; at 6 frames, 96 views, SfM alone took
   3.5-5 minutes on the H100's host), run by the CLI. The yardstick is the
   reference's own job on the same capture, recorded on the CPU by
   scripts/compare_torch_spherical_sfm.py --record (SPHERICAL_REFERENCE).
   Raises unless the capture is the recorded one, the job completes, times
   Spherical-To-Perspective, hands SfM as many images as the expansion and
   the reference make, registers at least the reference's views less 2, puts
   them where they belong (the camera-centre RMSE of every registered view
   against its frame's eye, after a similarity alignment, at most max(2 x
   the reference's, 1% of the eyes' span)), and writes a .spz that reads
   back with more than 100 gaussians. Prints erp_to_perspective's ms a view;
10. a pose-prior job: phase 6's frames as PNGs in a .zip beside a
   transforms-in.json of the true poses (ARKit world-to-camera matrices) and
   intrinsics, run by the CLI with the reference's default job but for pose
   priors, a tripod measurement (1.0 m), the object layer, the nerfacto
   model (so the mesh is exported) and maxSteps 300. Raises unless it
   completes with 16 of 16 frames registered, the exported poses are
   normalize_poses of the priors (camera 0, BA's gauge, within 1e-5; the
   others, which BA refines, within 1% of the walk), every default
   artifact reads back as in phase 7, measurement.json is a valid scale,
   floorplan.json, objects.geojson, poisson_mesh.ply, textured/mesh.obj and
   mesh.glb read back with more than 0 faces and every vertex inside the
   density grid's cube (the splat's 1-99% bounds plus the padding, on its
   largest side). Then on the job's trained splat the plane RANSAC and the
   mesh on the card against the port on the CPU: the same winning
   hypothesis and inliers, metersPerModelUnit within 1e-9 relative, the
   density grid within 1e-12 relative, equal face counts, and two card
   plane fits and extract_mesh runs bit-identical. The CLI's `convert`
   (the repo's C++ codec, compiled at first use) turns the job's .ply into
   a .spz whose payload must equal core/spz's. Prints the component
   seconds, the plane found and the scale against the true one, the mesh's
   counts and the grid, marching tetrahedra and RANSAC times;
11. a global-SfM job: phase 7's capture with softwareName glomap and
   maxSteps 300, run by the CLI. The yardstick is the reference's own
   outcome on the same frames, recorded on the CPU by
   scripts/compare_torch_global_sfm.py --record (GLOBAL_SFM_REFERENCE).
   Raises unless the capture is the recorded one, the job completes with
   at least the reference's registered count less 1, every pose, point and
   gaussian is finite, the camera-centre RMSE is at most max(2 x the
   reference's, 1% of the walk's span), and the job's own rotation_averaging
   and global_positioning inputs, run twice more on the card, agree bit for
   bit. Prints the relative-pose count, the averaging, positioning and BA
   seconds and the component seconds;
12. multi-card training on the one card, in a process group of this process
   and in spawned ranks: (a) one NCCL rank, {data:1, gauss:1}, at phase 4's
   width: make_distributed_train_step against train_step on the same view
   from the same state (loss and every parameter, Adam moment and densify
   accumulator within 1e-6 of the tensor's max), two identical distributed
   steps bit-identical, ms/step of each from CUDA events; (b) four gloo
   ranks, {data:2, gauss:2}, on this card (NCCL refuses two ranks on one
   card; the phase picks gloo), 2 steps on 2 views against this process's
   2-view mean-of-views step (loss 1e-5 relative, tensors at (a)'s bar),
   every rank holding only its half of the rows, both kernels launched on
   every rank; s/step and peak memory of each rank; (c)
   train_splat(distributed=True) on phase 5's scene (one NCCL rank spawned
   by the launcher) through the refine at step 500: the gaussian count must
   change, the PSNR be finite, and the step-260 checkpoint restore bit for
   bit into a DistributedTrainer of this process's group and run on;
13. the web console: web.server.start_background on a fresh store answers a
   validateOnly job (200) and a malformed one (400), runs phase 11's job
   (glomap, maxSteps 300) as a CLI subprocess on the card until Complete
   (300 s at most), and serves /api/splat/<uuid> byte-identical to
   cloud_to_splat_bytes of the job's splat.ply and /artifacts/<uuid>/
   splat.ply byte-identical to the file; a `..` segment gets 400 and a
   cross-origin POST 403. Prints the job's seconds;
14. MatNet training at full width (the port of scripts/train_matnet.py: batch
   16, 256x256, the full channel plan, lr 3e-4, seed 0): the first 3 steps
   on the card against the port on the CPU on the same batches (loss and
   soft IoU within 1e-4 relative; step 1's gradients, computed once more in
   f64 on each device, within 1e-4 of each tensor's largest entry, and in
   f32 within 1e-3; the parameters after 3 steps within 1e-3, the share
   within 1e-5 printed), two 10-step runs from one seed on one set of
   batches bit-identical in every parameter and moment, then train_matnet
   for 120 steps (`MATNET_STEPS`; the cosine decay spans them), whose mean
   loss over the last 20 steps must fall below that of the first 20 and
   whose float16 npz must hold the bundled file's keys and shapes and run
   through load_matnet and matnet_saliency. Prints ms a step on the card,
   host seconds a step making batches, and the held-out IoU of the trained
   and of the bundled weights;
15. a multi-video property scan (tests/test_spherical_multivideo_e2e.py's
   shape at 384x288, the widest at which the reference merges both videos):
   core/meshrender's capture scene rendered on the host from 22 angles of
   its orbit and written as two mp4v videos of frames 0-12 and 9-21, run by
   the CLI as one job (a comma-separated inputPath, every frame kept,
   exhaustive matching, maxSteps 300). The yardstick is the reference's own
   job on the same videos, recorded on the CPU by
   scripts/compare_torch_multivideo.py --record (MULTIVIDEO_REFERENCE).
   Raises unless the frames the job decoded are the recorded capture, it
   completes with as many images as the videos gave, registers frames of
   both videos into one model (more than 13, some of each), within 2 of the
   reference's count, with a camera-centre RMSE against the true orbit of
   at most max(2 x the reference's, 1% of the orbit's diameter), every
   artifact reads back as in phase 7, the .spz holds the trained count
   (more than 100), and the kernels launched once a step (and the forward
   once more a scored view). Prints the frames of each video that
   registered, the component seconds and the launches.

The launch counters are zeroed just before each of the training paths
(phases 4, 5, 7, 8, 9, 10, 11, 12, 13 and 15) and read just after it; all
three kernels must have launched in each, and in every rank or job process of
phases 12 and 13 (those start counting from 0, and the processes that
phases 12(c) and 13 start write their counts to TPU_SPLAT_LAUNCH_DIR as they
exit). SfM, the matting nets (their training too) and the extras hold no
hand-written kernel.
The line before the last is the {"kernels": [...]} record, with phase 4's
launches; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

from tpu_splat_torch.testing import (RAGGED_COUNTS, SUBJECT_BACKGROUND, arc_viewmats,
                                     build_packed, camera_centre_rmse, centre_rmse,
                                     composite_scene, mask_iou,
                                     render_capture, render_erp, ring_viewmats, room_scene,
                                     seeded_u2net_state_dict, subject_scene, synthetic_capture,
                                     textured_scene, walk_viewmats)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per (pixel, gaussian) pair, counted from composite.cu:
# forward: offsets 2, sigma 9, exp/clamp/threshold 8, weight 1, rgb+depth
# accumulation 8, transmittance 2;
# backward: the same 17 to recompute alpha, e and dalpha 14, conic/mean
# chain 8, the 10 gradient terms 15, suffix 2, and 10 adds for the 256-pixel
# reduction of the 10 channels.
FWD_OPS_PER_PAIR = 30
BWD_OPS_PER_PAIR = 66
FWD_BAR, BWD_BAR = 2e-5, 5e-5
WALK_SPAN = 5.0  # testing.walk_viewmats' default: phase 6's capture
SFM_FOCAL = 1100.0  # phase 6's true focal
JOB_STEPS = 600  # phase 7: past the first refine pass, at step 500
OPTION_STEPS = 300  # phases 8-11: the jobs' maxSteps, lowered from the preset's
MATNET_STEPS = 120  # phase 14: train_matnet's steps, of the script's 3000
MATNET_REPEAT_STEPS = 10  # phase 14: the two runs that must agree bit for bit
# phase 10: the walk's eyes sit 1.0 above testing.textured_scene's ground (y 0.3
# against 1.3, +y down): with world units taken as metres, a tripod of 1.0 m
TRIPOD_HEIGHT_M = 1.0
# phase 10: exported poses against the normalised priors. Camera 0 is BA's
# fixed gauge and comes back as imported; sfm_with_pose_priors' BA refines
# the others around their priors (as the reference's), by up to 0.33% of the
# walk and 3.4e-3 in rotation on this capture (H100 80GB HBM3, 700 W), so
# they are held to 1% of the walk and 0.01 in each rotation entry.
PRIOR_POSE_TOL = 1e-5
PRIOR_POSE_SHIFT = 0.01
# phase 11: the reference's global SfM (softwareName glomap) on phase 7's
# capture, and the capture's mean and its values at CAPTURE_PIXELS (frame, y,
# x, channel): `JAX_PLATFORMS=cpu python scripts/compare_torch_global_sfm.py
# --record` (rmse in world units)
CAPTURE_PIXELS = [(0, 100, 200, 0), (3, 400, 640, 1), (7, 700, 1200, 2), (9, 360, 10, 0),
                  (12, 5, 900, 1), (15, 550, 333, 2)]
GLOBAL_SFM_REFERENCE = {
    "registered": 16, "points": 578, "rmse": 0.8548157811164856, "final_rms_px": 1.29,
    "capture_mean": 0.5228276252746582,
    "capture_values": [0.8705882430076599, 0.4117647111415863, 0.4117647111415863,
                       0.572549045085907, 0.45098039507865906, 0.364705890417099]}
# phase 9: the reference's --spherical job (training off) on phase 9's ERP
# capture, and the capture's mean and its values at ERP_PIXELS: `JAX_PLATFORMS=
# cpu python scripts/compare_torch_spherical_sfm.py --record` (rmse in world
# units, against the frames' eyes)
SPHERICAL_FRAMES, SPHERICAL_ERP_HEIGHT = 4, 512
ERP_PIXELS = [(0, 100, 200, 0), (1, 256, 512, 1), (2, 500, 1000, 2), (3, 30, 700, 0),
              (0, 400, 20, 1), (3, 300, 900, 2)]
SPHERICAL_REFERENCE = {
    "num_images": 64, "registered": 26, "rmse": 0.4460658133029938,
    "capture_mean": 0.5003737211227417,
    "capture_values": [0.05098039284348488, 0.2862745225429535, 0.29411765933036804,
                       0.729411780834198, 0.7058823704719543, 0.6470588445663452]}
# phase 15: the multi-video property scan of tests/test_spherical_multivideo_e2e.py
# at twice its width, 384x288 (fx = fy: the test's 175 px at 192 wide,
# scaled), two mp4v videos of core/meshrender's capture scene on one orbit,
# frames [:13] and [9:] of 22. The width is the widest of 192, 384, 640 and
# 1280 at which the reference's job merges both videos (at 384, 24, 26, 26,
# 25 and 26 frames over RANSAC seeds 0-4, both videos under each; at 640, 13
# of one video with seed 0; at 1280, 10-23 over seeds 0-4, both in 2).
MULTIVIDEO_SIZE, MULTIVIDEO_FOCAL, MULTIVIDEO_FPS = (384, 288), 350.0, 10.0
MULTIVIDEO_ANGLES = np.linspace(0, 1.8 * np.pi, 22)
MULTIVIDEO_SEGMENTS = (("scan_a.mp4", range(0, 13)), ("scan_b.mp4", range(9, 22)))
MULTIVIDEO_MAX_IMAGES = 24  # the test's maxNumImages: every frame of both videos
ORBIT_DIAMETER = 8.0  # meshrender.orbit_w2c's radius 4.0
# the reference's job on that capture (training off) with the mapper's RANSAC
# seed 0, as a job runs, and the decoded capture's mean and its values at
# MULTIVIDEO_PIXELS: `JAX_PLATFORMS=cpu python scripts/compare_torch_multivideo.py
# --record` (rmse in world units)
MULTIVIDEO_PIXELS = [(0, 50, 100, 0), (5, 200, 320, 1), (12, 280, 380, 2),
                     (13, 144, 10, 0), (20, 5, 300, 1), (25, 220, 111, 2)]
MULTIVIDEO_REFERENCE = {
    "segments": [13, 13], "registered": 24, "rmse": 1.4584403038024902,
    "capture_mean": 0.34049031138420105,
    "capture_values": [0.30588236451148987, 0.7058823704719543, 0.2666666805744171,
                       0.32156863808631897, 0.38823530077934265, 0.6392157077789307]}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ring_views(n_views, width, height, rng, radius=4.5, fov_scale=0.85):
    """bench.py's camera ring: (viewmats, intrinsics, random images)."""
    intrins = np.tile(np.array([[width * fov_scale, width * fov_scale, width / 2, height / 2]],
                               np.float32), (n_views, 1))
    images = rng.uniform(0, 1, (n_views, height, width, 3)).astype(np.float32)
    return ring_viewmats(n_views, radius), intrins, images


def bench_params(rng, capacity, n_alive, device):
    """bench.py's 512K/400K-alive SH3 state, from the same seeded draws."""
    import torch

    alive = np.zeros(capacity, bool)
    alive[:n_alive] = True
    arrays = {
        "means": rng.uniform(-2, 2, (capacity, 3)),
        "scales": np.log(rng.uniform(0.005, 0.03, (capacity, 3))),
        "quats": np.concatenate([np.ones((capacity, 1)),
                                 0.1 * rng.normal(size=(capacity, 3))], 1),
        "opacities": rng.normal(0.0, 1.0, (capacity,)),
        "sh0": rng.normal(0, 0.5, (capacity, 3)),
        "shN": rng.normal(0, 0.05, (capacity, 15, 3)),
    }
    params = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in arrays.items()}
    params["alive"] = torch.from_numpy(alive).to(device)
    return params


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, packed, counts, tx, ty, rng, timing_reps=0):
    """Both kernels against their plain versions on one packed tensor.
    Returns a dict of errors, times and bounds."""
    import torch

    from tpu_splat_torch.gs import cuda_raster as cr

    t_total, k = packed.shape[1], packed.shape[2]
    n_chunks = k // cr.CHUNK
    out_k, ts_k = cr.composite_fwd_cuda(packed, counts, tx)
    out_again, ts_again = cr.composite_fwd_cuda(packed, counts, tx)
    out_p, ts_p = cr.composite_tiles_plain(packed, counts, tx, ty)
    full = torch.full_like(counts, k)
    out_full, _ = cr.composite_fwd_cuda(packed, full, tx)
    torch.cuda.synchronize()
    fwd_err = float((out_k[:, :5] - out_p[:, :5]).abs().max())
    ts_err = float((ts_k - ts_p).abs().max())
    if not fwd_err <= FWD_BAR:
        raise AssertionError(f"{name}: forward max abs {fwd_err:.3e} > {FWD_BAR}")
    # the backward skips every chunk whose checkpoint row is all zero
    reached_k = ts_k.reshape(t_total, n_chunks, cr.P).amax(dim=2) > 0
    reached_p = ts_p.reshape(t_total, n_chunks, cr.P).amax(dim=2) > 0
    if not torch.equal(reached_k, reached_p):
        raise AssertionError(f"{name}: the kernel reached {int(reached_k.sum())} chunks, "
                             f"the plain version {int(reached_p.sum())}")
    if not ts_err <= FWD_BAR:
        raise AssertionError(f"{name}: tstart max abs {ts_err:.3e} > {FWD_BAR}")
    if not torch.equal(out_k[:, :5], out_full[:, :5]):
        raise AssertionError(f"{name}: counts-bounded forward differs from the full sweep")
    if not (torch.equal(out_k, out_again) and torch.equal(ts_k, ts_again)):
        raise AssertionError(f"{name}: two forward launches on one input differ")
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{name}: non-finite forward output")

    gout = torch.from_numpy(rng.standard_normal((t_total, 8, cr.P)).astype(np.float32)).cuda()
    t_final = (1.0 - out_p[:, 3]).contiguous()
    g_p = cr.composite_tiles_bwd_plain(packed, gout, ts_p, t_final, tx)
    g_scale = float(g_p.abs().max()) + 1e-12
    # fed the plain forward's checkpoints, then the kernel's own (as training does)
    g_k = cr.composite_bwd_cuda(packed, counts, gout, ts_p, t_final, tx)
    g_kk = cr.composite_bwd_cuda(packed, counts, gout, ts_k, (1.0 - out_k[:, 3]).contiguous(),
                                 tx)
    g_again = cr.composite_bwd_cuda(packed, counts, gout, ts_p, t_final, tx)
    torch.cuda.synchronize()
    bwd_abs = float((g_k - g_p).abs().max())
    bwd_rel = bwd_abs / g_scale
    chain_rel = float((g_kk - g_p).abs().max()) / g_scale
    for what, rel in (("backward", bwd_rel), ("backward from the kernel's tstart", chain_rel)):
        if not rel <= BWD_BAR:
            raise AssertionError(f"{name}: {what} max|d|/max|g| {rel:.3e} > {BWD_BAR}")
    if not torch.equal(g_k, g_again):
        raise AssertionError(f"{name}: two backward launches on one input differ")
    # the sweep stops at each tile's count: every slot past it must be exactly 0
    past = torch.arange(k, device=counts.device)[None, :] >= counts[:, None].long()
    n_past = int(past.sum())
    if not bool((g_k[:, past] == 0).all()):
        raise AssertionError(f"{name}: backward nonzero in a slot past its tile's count")
    log(f"[kernels] {name}: T={t_total} K={k} fwd max abs {fwd_err:.3e}, tstart "
        f"{ts_err:.3e} over {int(reached_k.sum())} reached chunks, counts-bounded "
        f"bit-identical, two forward launches bit-identical, bwd max abs {bwd_abs:.3e} "
        f"rel {bwd_rel:.3e} (from the kernel's tstart: rel {chain_rel:.3e}), two launches "
        f"bit-identical, {n_past} slots past the counts all 0")
    res = {"fwd_err": fwd_err, "bwd_abs": bwd_abs, "bwd_rel": bwd_rel}
    if not timing_reps:
        return res

    # data-dependent work: the chunks this input reaches (a prefix of each
    # tile's), and the real pairs in them; the slots past a tile's count hold
    # the zero sentinel row, which neither kernel needs to sweep
    reached = int(reached_p.sum())
    slot_pairs = reached * cr.CHUNK * cr.P
    reached_slots = reached_p.sum(dim=1) * cr.CHUNK
    pairs = int(torch.minimum(counts.long(), reached_slots).sum()) * cr.P
    chunk_bytes = reached * cr.CHUNK * 10 * 4
    fwd_bytes = chunk_bytes + t_total * 4 + t_total * 8 * cr.P * 4 + t_total * n_chunks * cr.P * 4
    bwd_bytes = (chunk_bytes + t_total * 5 * cr.P * 4 + t_total * n_chunks * cr.P * 4
                 + t_total * cr.P * 4 + 16 * t_total * k * 4)

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    res["fwd_ms"] = time_ms(lambda: cr.composite_fwd_cuda(packed, counts, tx), timing_reps)
    res["bwd_ms"] = time_ms(
        lambda: cr.composite_bwd_cuda(packed, counts, gout, ts_p, t_final, tx), timing_reps)
    res["fwd_plain_ms"] = time_ms(lambda: cr.composite_tiles_plain(packed, counts, tx, ty), 3)
    res["bwd_plain_ms"] = time_ms(
        lambda: cr.composite_tiles_bwd_plain(packed, gout, ts_p, t_final, tx), 3)
    res["fwd_bound_ms"], res["fwd_bound_by"] = bound(fwd_bytes, pairs * FWD_OPS_PER_PAIR)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound(bwd_bytes, pairs * BWD_OPS_PER_PAIR)
    res["reached_chunks"] = reached
    log(f"[kernels] {name}: reached {reached}/{t_total * n_chunks} chunks, {slot_pairs} "
        f"pixel-slot pairs in them, {pairs} real pairs (the operation bounds' count); "
        f"fwd {res['fwd_ms']:.3f} ms (plain {res['fwd_plain_ms']:.3f}, bound "
        f"{res['fwd_bound_ms']:.4f} by {res['fwd_bound_by']}); bwd {res['bwd_ms']:.3f} ms "
        f"(plain {res['bwd_plain_ms']:.3f}, bound {res['bwd_bound_ms']:.4f} by "
        f"{res['bwd_bound_by']})")
    return res


ADAM_ROWS = 1 << 22  # splatbench's outdoor-3m capacity, 59 elements a row at SH degree 3


def compare_adam(dev) -> dict:
    """The Adam kernel against adam_update_plain on the card at outdoor-3m's
    layout, dense and with `visible`; raises unless parameters and moments
    agree within 1e-6 relative and two launches agree bit for bit. Returns
    the largest relative error, the kernel's and the plain chain's ms (CUDA
    events over whole adam_update calls, the bias corrections' small
    kernels included) and the bound: the least bytes (read parameter,
    gradient and both moments, write parameter and both moments, one byte a
    row a mask) over HBM bandwidth."""
    import torch

    from tpu_splat_torch.gs.optim import AdamState, adam_update_cuda, adam_update_plain

    n = ADAM_ROWS
    gen = torch.Generator(device=dev).manual_seed(7)
    widths = {"means": (3,), "scales": (3,), "quats": (4,), "opacities": (),
              "sh0": (3,), "shN": (15, 3)}

    def draw(shape, scale):
        return torch.randn((n,) + shape, generator=gen, device=dev) * scale

    params = {k: draw(w, 1.0) for k, w in widths.items()}
    grads = {k: draw(w, 0.1) for k, w in widths.items()}
    state = AdamState({k: draw(w, 0.01).to(torch.bfloat16 if k == "shN" else torch.float32)
                       for k, w in widths.items()},
                      {k: draw(w, 1e-3).abs() for k, w in widths.items()},
                      torch.tensor(20000, dtype=torch.int32, device=dev))
    lrs = {"means": 1.6e-6, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2,
           "sh0": 2.5e-3, "shN": 1.25e-4}
    alive = torch.rand(n, generator=gen, device=dev) < 0.7
    shown = torch.rand(n, generator=gen, device=dev) < 0.45
    res = {"max_rel": 0.0}
    for tag, vis in (("dense", None), ("visible", shown)):
        def kernel():
            return adam_update_cuda(params, grads, state, lrs, visible=vis, grad_mask=alive)

        def plain():
            return adam_update_plain(params, grads, state, lrs, visible=vis, grad_mask=alive)

        (kp, ks), (kp2, ks2), (pp, ps) = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        pairs = [(f"{k} {what}", a, b, c)
                 for k in widths
                 for what, a, b, c in (("param", kp[k], kp2[k], pp[k]),
                                       ("mu", ks.mu[k], ks2.mu[k], ps.mu[k]),
                                       ("nu", ks.nu[k], ks2.nu[k], ps.nu[k]))]
        exact = 0
        for name, a, again, want in pairs:
            if not torch.equal(a, again):
                raise AssertionError(f"adam {tag}: two launches differ in {name}")
            rel = (float((a.float() - want.float()).abs().max())
                   / max(float(want.float().abs().max()), 1e-30))
            if not rel <= 1e-6:
                raise AssertionError(f"adam {tag}: {name} max rel {rel:.3e} > 1e-6")
            res["max_rel"] = max(res["max_rel"], rel)
            exact += torch.equal(a, want)
        del kp, ks, kp2, ks2, pp, ps
        nbytes = sum(v.numel() * (20 + 2 * state.mu[k].element_size())
                     for k, v in params.items()) + n * (1 + (vis is not None))
        ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 5)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[adam] {tag}: {n} rows x 59, kernel against the plain chain max rel "
            f"{res['max_rel']:.3e}, {exact}/{len(pairs)} tensors bit-identical, two launches "
            f"bit-identical; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB), {100 * bound_ms / ms:.1f}% of it")
        if tag == "dense":
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
    return res


def profile_steps(run_step, first: int, n: int, step_ms: float, tag: str = "profile") -> float:
    """Device time by kernel over n steps (torch.profiler), per step, and the
    device's busy share of the unprofiled step time `step_ms` (the profiler's
    own host overhead stretches the wall-clock it sees). Returns the busy ms
    a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            run_step(i)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    log(f"[{tag}] {n} steps: device busy {busy_ms:.2f} ms/step = "
        f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.2f} ms step (idle "
        f"{100 * (1 - busy_ms / step_ms):.1f}%); {len(kernels)} kernel names; "
        f"{wall_ms:.1f} ms/step wall with the profiler on")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[{tag}] {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.1f}x  {e.key[:90]}")
    return busy_ms


def layer_times(params, viewmat, intrin, image, width, height, k) -> dict:
    """ms of each layer of one training step, alone, at the main path's shapes
    (CUDA events over 10 calls after a warm-up)."""
    import torch

    from tpu_splat_torch.gs.losses import image_loss
    from tpu_splat_torch.gs.optim import adam_init, adam_update
    from tpu_splat_torch.gs.projection import project_gaussians
    from tpu_splat_torch.gs.rasterize import pack_tiles, tile_gaussians
    from tpu_splat_torch.gs.sh import sh_to_color

    trainable = {n: v.detach().requires_grad_(True) for n, v in params.items() if n != "alive"}
    op = torch.sigmoid(params["opacities"]).detach()

    def project_sh():
        proj = project_gaussians(trainable["means"], trainable["scales"], trainable["quats"],
                                 viewmat, *intrin, width, height, opacities=op)
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = torch.nn.functional.normalize(trainable["means"] - cam_pos, dim=-1)
        col = sh_to_color(trainable["sh0"], trainable["shN"], dirs, 3)
        (proj.means2d.sum() + proj.conics.sum() + col.sum()).backward()
        return proj

    proj = project_sh()
    with torch.no_grad():
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = torch.nn.functional.normalize(params["means"] - cam_pos, dim=-1)
        colors = sh_to_color(params["sh0"], params["shN"], dirs, 3)
        radii = torch.where(params["alive"], proj.radii, torch.zeros_like(proj.radii))
        args = [proj.means2d.detach(), proj.conics.detach(), colors, op, proj.depths.detach()]

    def pack():
        leaves = [a.clone().requires_grad_(True) for a in args]
        packed, _, _ = pack_tiles(*leaves, radii, width, height, 16, k)
        packed.backward(torch.ones_like(packed))

    pred = image.clone().flip(0).requires_grad_(True)
    grads = {n: torch.randn_like(v) for n, v in trainable.items()}
    adam = adam_init({n: v.detach() for n, v in trainable.items()})
    lrs = {n: 1e-3 for n in trainable}
    with torch.no_grad():
        detached = {n: v.detach() for n, v in trainable.items()}
    return {
        "project+sh fwd+bwd": time_ms(project_sh, 10),
        "binning (tile_gaussians)": time_ms(
            lambda: tile_gaussians(args[0], args[4], radii, width, height, 16, k, opacities=op),
            10),
        "binning+pack gather fwd+bwd": time_ms(pack, 10),
        "image_loss fwd+bwd": time_ms(lambda: image_loss(pred, image).backward(), 10),
        "adam_update": time_ms(lambda: adam_update(detached, grads, adam, lrs), 10),
    }


def atomic_pack_gather_bwd(ctx, d_packed):
    """The parent's rasterize._PackGather.backward: index_add_, which sums
    duplicate indices with atomics on the card. Kept here only to time it
    and to run the two-step check with it."""
    import torch

    gidx_ext, mid_order, big4_order, big8_order = ctx.saved_tensors[:4]
    n = ctx.n
    c = d_packed.shape[0]
    k4, k8, km = big4_order.shape[0], big8_order.shape[0], mid_order.shape[0]
    rows = d_packed.to(torch.bfloat16).to(torch.float32).reshape(c, -1).T.contiguous()
    d_ext = torch.zeros((n + k4 + k8 + km + 1, c), dtype=torch.float32, device=d_packed.device)
    d_ext.index_add_(0, gidx_ext.reshape(-1), rows)
    d_feat = d_ext[:n].clone()
    d_feat.index_add_(0, big4_order, d_ext[n:n + k4])
    d_feat.index_add_(0, big8_order, d_ext[n + k4:n + k4 + k8])
    d_feat.index_add_(0, mid_order, d_ext[n + k4 + k8:n + k4 + k8 + km])
    return d_feat, None, None, None, None, None


def repeat_step(step, state, i, pack_bwd=None):
    """Two train_steps from one state (parameters, Adam moments, densify
    accumulators) and one view; returns (name, max abs difference) of every
    tensor of the two results that is not bit-identical. `pack_bwd` swaps in
    another _PackGather.backward for the two steps."""
    import torch

    from tpu_splat_torch.gs import rasterize as ras

    saved = ras._PackGather.backward
    if pack_bwd is not None:
        ras._PackGather.backward = staticmethod(pack_bwd)
    try:
        (a, _), (b, _) = step(i, state), step(i, state)
    finally:
        ras._PackGather.backward = saved
    torch.cuda.synchronize()
    pairs = [(f"param {k}", a[0][k], b[0][k]) for k in a[0]]
    pairs += [(f"adam {m} {k}", getattr(a[1], m)[k], getattr(b[1], m)[k])
              for m in ("mu", "nu") for k in a[1].mu]
    pairs += [(f"densify {f}", getattr(a[2], f), getattr(b[2], f)) for f in a[2]._fields]
    return [(name, float((x.float() - y.float()).abs().max())) for name, x, y in pairs
            if not torch.equal(x, y)]


def pack_gather_bwd_times(params, viewmat, intrin, width, height, k) -> dict:
    """ms of _PackGather.backward alone at the main path's shapes: the
    fixed-order sum through the inverse slot map against the parent's
    index_add_."""
    from types import SimpleNamespace

    import torch

    from tpu_splat_torch.gs import rasterize as ras

    with torch.no_grad():
        packed, _, b = real_packed(params, viewmat, intrin, width, height, k, binning=True)
        n = params["means"].shape[0]
        sentinel = n + b.big4_order.shape[0] + b.big8_order.shape[0] + b.mid_order.shape[0]
        gidx_ext = torch.where(b.gvalid, b.gidx, torch.full_like(b.gidx, sentinel))
        ctx = SimpleNamespace(saved_tensors=(gidx_ext, b.mid_order, b.big4_order,
                                             b.big8_order, b.pair_slot), n=n)
        d_packed = torch.randn_like(packed)
        return {
            "pack gather bwd (fixed order)": time_ms(
                lambda: ras._PackGather.backward(ctx, d_packed), 10),
            "pack gather bwd (parent's index_add_)": time_ms(
                lambda: atomic_pack_gather_bwd(ctx, d_packed), 10),
        }


def real_packed(params, viewmat, intrin, width, height, k, binning=False):
    """The packed tensor the main path hands the kernels for one view, and
    its counts (and the Binning, when asked for)."""
    import torch

    from tpu_splat_torch.gs.projection import project_gaussians
    from tpu_splat_torch.gs.rasterize import pack_tiles
    from tpu_splat_torch.gs.sh import sh_to_color

    with torch.no_grad():
        op = torch.sigmoid(params["opacities"])
        proj = project_gaussians(params["means"], params["scales"], params["quats"], viewmat,
                                 *intrin, width, height, opacities=op)
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = torch.nn.functional.normalize(params["means"] - cam_pos, dim=-1)
        colors = sh_to_color(params["sh0"], params["shN"], dirs, 3)
        radii = torch.where(params["alive"], proj.radii, torch.zeros_like(proj.radii))
        packed, counts, b = pack_tiles(proj.means2d, proj.conics, colors, op, proj.depths,
                                       radii, width, height, 16, k)
    if binning:
        return packed.contiguous(), counts, b
    return packed.contiguous(), counts


def smoke_scene(device):
    """A seeded 16-view 320x180 capture of 3000 gaussians, rendered by the
    port, as an SfMScene and its images."""
    from tpu_splat_torch.core.types import Cameras, SfMScene

    vms, intrin, images, pts, colors = synthetic_capture(
        n=3000, width=320, height=180, focal=260.0, radius=3.2, seed=11, scale=0.04,
        max_per_tile=1024, device=device)
    n, (h, w) = len(pts), images.shape[1:3]
    cams = Cameras(camtoworlds=np.linalg.inv(vms).astype(np.float32),
                   fx=intrin[:, 0], fy=intrin[:, 1], cx=intrin[:, 2], cy=intrin[:, 3],
                   distortion=np.zeros((len(vms), 4), np.float32), width=w, height=h)
    scene = SfMScene(cameras=cams, points=pts, point_colors=colors,
                     point_errors=np.zeros(n, np.float32),
                     track_counts=np.full(n, 2, np.float32), registered=np.ones(len(vms), bool))
    return scene, images


def main_path_launches(path: str) -> dict:
    """The launch counts since the last reset; raises unless every kernel
    launched on this path."""
    from tpu_splat_torch.gs import cuda_raster as cr

    launches = dict(cr.LAUNCHES)
    log(f"[main path] {path}: launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    return launches


def sfm_capture(n_views, width, height, focal, device):
    """testing.textured_scene's 100K-gaussian rock, ground and back wall
    rendered by the port on a forward walk of n_views frames;
    (world-to-camera matrices, images)."""
    vms = walk_viewmats(n_views)
    return vms, render_capture(textured_scene(np.random.default_rng(3)), vms, focal, width,
                               height, max_per_tile=1024, device=device)


def ba_repeat(scene, device, rng):
    """rms and seconds of two identical bundle_adjust calls on a problem made
    from the reconstruction (every point seen by every registered camera it
    lands in front of, 0.5 px of noise, poses and points perturbed). Its
    segment sums run in a fixed order, so the two must agree bit for bit."""
    import torch

    from tpu_splat_torch.sfm.ba import BAProblem, bundle_adjust

    c2w = np.asarray(scene.cameras.camtoworlds, np.float32)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    pts = np.asarray(scene.points, np.float32)
    fx = float(np.asarray(scene.cameras.fx)[0])
    pc = np.einsum("cij,pj->cpi", w2c[:, :3, :3], pts) + w2c[:, None, :3, 3]
    uv = pc[..., :2] / np.maximum(pc[..., 2:], 1e-6)
    seen = (pc[..., 2] > 0.1) & (np.abs(uv[..., 0]) < 0.6) & (np.abs(uv[..., 1]) < 0.35)
    oc, op = np.nonzero(seen)
    obs = uv[oc, op] + rng.normal(0, 0.5 / fx, (len(oc), 2))
    t = lambda a, d=torch.float32: torch.as_tensor(np.asarray(a), dtype=d, device=device)  # noqa: E731
    prob = BAProblem(t(w2c[:, :3, :3]), t(w2c[:, :3, 3] + rng.normal(0, 0.01, (len(w2c), 3))),
                     t(pts + rng.normal(0, 0.01, pts.shape)), t(oc, torch.long),
                     t(op, torch.long), t(obs), torch.ones(len(oc), dtype=torch.bool,
                                                           device=device))
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        rms = float(bundle_adjust(prob, huber_delta=4.0 / fx, outer_iters=30, cg_iters=48)[3])
        out.append((rms, time.time() - t0))
    return len(oc), out


def linalg_times(device) -> dict:
    """ms of the batched torch.linalg calls SfM makes, at phase-6 batch sizes
    (CUDA events, 5 calls after a warm-up). cuSOLVER's batched eigh refuses
    32768 4x4 matrices, so geometry._smallest_right_vector4 slices at 8192;
    it is timed whole on a 32768-track triangulation batch."""
    import torch

    from tpu_splat_torch.sfm.geometry import _smallest_right_vector4

    g = torch.Generator(device=device).manual_seed(0)
    r = lambda *shape: torch.randn(*shape, device=device, generator=g)  # noqa: E731
    a9, a3, a12 = r(32 * 512, 9, 9), r(32 * 512, 3, 3), r(256, 12, 12)
    gram = r(8192, 4, 4)
    gram = gram @ gram.mT
    dlt = r(32768, 16, 4)
    h6 = r(32 * 129, 6, 6)
    h6 = h6 @ h6.mT + torch.eye(6, device=device)
    b6 = r(32 * 129, 6, 1)
    return {
        "svd (16384, 9, 9) [8-point, 32 pairs x 512]": time_ms(lambda: torch.linalg.svd(a9), 5),
        "svd (16384, 3, 3) [essential projection]": time_ms(lambda: torch.linalg.svd(a3), 5),
        "svd (256, 12, 12) [PnP DLT]": time_ms(lambda: torch.linalg.svd(a12), 5),
        "eigh (8192, 4, 4) [one triangulation slice]": time_ms(
            lambda: torch.linalg.eigh(gram), 5),
        "_smallest_right_vector4 (32768, 16, 4) [QR + 4 eigh slices + inverse iteration]":
            time_ms(lambda: _smallest_right_vector4(dlt), 5),
        "solve_ex (4128, 6, 6) [polish GN, 32 pairs x 129]": time_ms(
            lambda: torch.linalg.solve_ex(h6, b6), 5),
        "det (16384, 3, 3)": time_ms(lambda: torch.linalg.det(a3), 5),
    }


def sfm_phase(dev, rng) -> np.ndarray:
    """Phase 6 (see the module docstring); returns its frames."""
    from tpu_splat_torch.gs import cuda_raster as cr
    from tpu_splat_torch.sfm.features import FeatureConfig
    from tpu_splat_torch.sfm.mapper import MapperConfig, run_sfm

    n_views, width, height, focal = 16, 1280, 720, SFM_FOCAL
    t0 = time.time()
    vms, images = sfm_capture(n_views, width, height, focal, dev)
    log(f"[sfm] capture: {n_views} frames {width}x{height}, true fx {focal}, rendered in "
        f"{time.time() - t0:.1f} s")
    cfg = MapperConfig(feature=FeatureConfig(max_features=4096, num_octaves=4,
                                             upsample_first=False),
                       matching_method="sequential")
    logs = []
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "sfm_log.txt")
    with open(log_path, "w") as f:
        def sfm_log(line):  # the mapper's log, kept whole in a file
            logs.append(line)
            f.write(line + "\n")
            f.flush()

        cr.reset_launch_counts()
        t0 = time.time()
        scene = run_sfm(images, cfg, log_fn=sfm_log, device=dev)
        sfm_s = time.time() - t0
    log(f"[sfm] run_sfm path launches of the compositing kernels: {dict(cr.LAUNCHES)} "
        f"(SfM holds no hand-written kernel); its log: {os.path.relpath(log_path, ROOT)}")
    feat_line = next((s for s in logs if s.startswith("features:")), "")
    ba_lines = [s for s in logs if s.startswith("BA:")]
    timer_line = [s for s in logs if s.startswith("sfm timers")][-1]
    reg = np.asarray(scene.registered)
    c2w = np.asarray(scene.cameras.camtoworlds)
    pts = np.asarray(scene.points)
    if not (np.isfinite(c2w).all() and np.isfinite(pts).all()):
        raise AssertionError("run_sfm returned a non-finite pose or point")
    if int(reg.sum()) < n_views - 2:
        raise AssertionError(f"run_sfm registered {int(reg.sum())}/{n_views} frames")
    rmse = centre_rmse(scene, vms) / WALK_SPAN
    log(f"[sfm] {feat_line}; {len(ba_lines)} BA calls")
    log(f"[sfm] N={n_views} registered={int(reg.sum())} points={scene.num_points} "
        f"final {ba_lines[-1] if ba_lines else 'no BA'}; fx {float(scene.cameras.fx[0]):.1f} "
        f"(true {focal}); camera-centre RMSE {rmse:.5f} of the span; run_sfm {sfm_s:.1f} s")
    log(f"[sfm] {timer_line}")
    n_obs, runs = ba_repeat(scene, dev, rng)
    log(f"[sfm] bundle_adjust twice on one {n_obs}-observation problem (30 x 48): rms "
        + ", ".join(f"{r!r} in {t:.2f} s" for r, t in runs))
    if runs[0][0] != runs[1][0]:
        raise AssertionError("two identical bundle_adjust calls differ")
    for name, ms in linalg_times(dev).items():
        log(f"[sfm] linalg {name}: {ms:.3f} ms")
    return images


def zip_frames(images: np.ndarray, zip_path: str) -> None:
    """The frames as 8-bit PNGs in a .zip, as a user uploads a capture."""
    import zipfile

    import cv2

    with zipfile.ZipFile(zip_path, "w") as zf:
        for i, img in enumerate(images):
            bgr = (np.clip(img[..., ::-1], 0, 1) * 255).round().astype(np.uint8)
            zf.writestr(f"capture/frame_{i:04d}.png", cv2.imencode(".png", bgr)[1].tobytes())


def run_cli_job(job_path: str, path: str, log_name: str):
    """Run a job JSON through the port's CLI (`run`, on the card) with the
    launch counters zeroed just before; raises unless it completes and both
    kernels launched. Returns (CLI result, pipeline log lines, launches,
    seconds); the log is kept whole in build/chip_smoke/<log_name>."""
    import contextlib
    import io
    import logging

    from tpu_splat_torch.cli.main import main as cli_main
    from tpu_splat_torch.gs import cuda_raster as cr

    lines = []
    log_path = os.path.join(OUT_DIR, log_name)

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg = logging.getLogger("tpu_splat_torch.pipeline")
    keep = Keep(level=logging.INFO)
    lg.addHandler(keep)
    lg.setLevel(logging.INFO)
    stdout = io.StringIO()
    cr.reset_launch_counts()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(stdout):
            rc = cli_main(["run", job_path])
    finally:
        lg.removeHandler(keep)
        with open(log_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    job_s = time.time() - t0
    launches = main_path_launches(path)
    if rc != 0:
        raise AssertionError(f"the CLI run exited {rc}; its log: {log_path}")
    res = json.loads(stdout.getvalue())
    if res["status"] != "Complete":
        raise AssertionError(f"job status {res['status']}")
    return res, lines, launches, job_s


DEFAULT_ARTIFACTS = ("colmap_db", "transforms_json", "ply", "spz")


def check_job_artifacts(root: str, out: str, uuid: str, res: dict, n_frames: int,
                        artifacts: tuple = DEFAULT_ARTIFACTS):
    """Every artifact of a completed job is present and reads back: the
    database (where the job makes one: incremental SfM) holds every frame,
    the text and binary models hold the registered ones, the .ply and .spz
    the trained gaussian count, and every pose, point and gaussian is finite.
    `artifacts` names what the job delivers. Returns (database or None,
    sparse point count)."""
    import shutil

    from tpu_splat_torch.core.ply import load_ply
    from tpu_splat_torch.core.spz import load_spz
    from tpu_splat_torch.sfm.colmap_db import read_database
    from tpu_splat_torch.sfm.colmap_io import count_points3d, read_colmap_model

    metrics = res["metrics"]
    n_reg = int(metrics["num_registered"])
    colmap, sparse = os.path.join(out, "colmap"), os.path.join(out, "colmap", "sparse", "0")
    wanted = [os.path.join(colmap, "transforms.json"), os.path.join(out, "exports", "splat.ply"),
              os.path.join(out, "exports", "splat.spz"), os.path.join(out, "jobs", f"{uuid}.json")]
    if "colmap_db" in artifacts:
        wanted.append(os.path.join(colmap, "database.db"))
    wanted += [os.path.join(sparse, f"{f}.{e}") for f in ("cameras", "images", "points3D")
               for e in ("txt", "bin")]
    missing = [p for p in wanted if not os.path.isfile(p)]
    missing += [p for p in res["artifacts"].values() if not os.path.isfile(p)]
    if missing or set(res["artifacts"]) != set(artifacts):
        raise AssertionError(f"artifacts missing: {missing}; delivered {res['artifacts']}")
    with open(os.path.join(out, "jobs", f"{uuid}.json")) as f:
        if json.load(f)["status"] != "Complete":
            raise AssertionError("the job store does not say Complete")

    db = None
    if "colmap_db" in artifacts:
        db = read_database(os.path.join(colmap, "database.db"))
        if len(db["images"]) != n_frames or len(db["keypoints"]) != n_frames:
            raise AssertionError(f"the database holds {len(db['images'])} images")
    models = {}
    for kind in ("txt", "bin"):
        d = os.path.join(root, f"model_{kind}")
        os.makedirs(d, exist_ok=True)
        for f in ("cameras", "images", "points3D"):
            shutil.copy(os.path.join(sparse, f"{f}.{kind}"), d)
        models[kind] = read_colmap_model(d)
    n_pts = count_points3d(sparse)
    for kind, (cams, imgs, pts, _) in models.items():
        poses = np.array([np.concatenate([r["qvec"], r["tvec"]]) for r in imgs.values()])
        if len(imgs) != n_reg or len(pts) != n_pts or len(cams) != 1:
            raise AssertionError(f"{kind} model: {len(imgs)} images, {len(pts)} points, "
                                 f"against {n_reg} registered and {n_pts} points")
        if not (np.isfinite(poses).all() and np.isfinite(pts).all()):
            raise AssertionError(f"{kind} model holds a non-finite pose or point")
    ply = load_ply(os.path.join(out, "exports", "splat.ply"))
    spz = load_spz(os.path.join(out, "exports", "splat.spz"))
    if ply.num_points != spz.num_points or ply.num_points != int(metrics["num_gaussians"]):
        raise AssertionError(f".ply {ply.num_points} / .spz {spz.num_points} gaussians, "
                             f"trained {metrics['num_gaussians']}")
    for name in ("means", "scales", "quats", "opacities", "sh0", "shN"):
        if not np.isfinite(getattr(ply, name)).all():
            raise AssertionError(f"the delivered .ply has a non-finite {name}")
    return db, n_pts


def log_job(tag: str, res: dict, lines: list, steps: int) -> None:
    """A job's component seconds, mapper timers and training rate."""
    metrics, timings = res["metrics"], res["timings"]
    sfm_timers = [s for s in lines if s.startswith("sfm timers")][-1]
    rates = [s for s in lines if s.startswith("step ") and "it/s" in s]
    train_s = timings["Train-Stage1"]
    log(f"[{tag}] components, s: " + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()))
    log(f"[{tag}] {sfm_timers}")
    log(f"[{tag}] training: {steps} steps in {train_s:.2f} s = "
        f"{1e3 * train_s / steps:.2f} ms/step with evaluation and export of the cloud "
        f"({rates[-1] if rates else 'no rate logged'}); "
        + (f"held-out psnr {metrics['psnr']:.3f} over {int(metrics['eval_views'])} views"
           if metrics["eval_views"] else
           f"train-view psnr {metrics['psnr']:.3f} (under 16 registered: no held-out split)")
        + f"; {int(metrics['num_gaussians'])} gaussians")
    log(f"[{tag}] artifacts: " + ", ".join(
        f"{k} {os.path.getsize(v) / 2**20:.2f} MiB" for k, v in res["artifacts"].items()))


def job_phase(images: np.ndarray, job_steps: int) -> None:
    """Phase 7 (see the module docstring): a default job through the CLI."""
    import shutil

    root = os.path.join(OUT_DIR, "job")
    shutil.rmtree(root, ignore_errors=True)  # no checkpoint of an earlier run resumes
    os.makedirs(root)
    zip_path = os.path.join(root, "capture.zip")
    t0 = time.time()
    zip_frames(images, zip_path)
    uuid, out = "chip-smoke-default-job", os.path.join(root, "out")
    job_path = os.path.join(root, "job.json")
    with open(job_path, "w") as f:  # the reference's defaults, but for maxSteps
        json.dump({"uuid": uuid, "inputPath": zip_path, "outputPath": out,
                   "training": {"maxSteps": job_steps}}, f)
    log(f"[job] {len(images)} frames {images.shape[2]}x{images.shape[1]} as 8-bit PNGs in "
        f"{os.path.relpath(zip_path, ROOT)} ({os.path.getsize(zip_path) / 2**20:.1f} MiB, "
        f"{time.time() - t0:.1f} s); job: defaults, maxSteps {job_steps}")

    res, lines, launches, job_s = run_cli_job(job_path, "default job (CLI run)", "job_log.txt")
    n_reg = int(res["metrics"]["num_registered"])
    if n_reg < 14:
        raise AssertionError(f"the job registered {n_reg} of {len(images)} frames")
    db, n_pts = check_job_artifacts(root, out, uuid, res, len(images))
    cam = db["cameras"][1]
    k1 = float(cam["params"][3]) if cam["model"] == 2 else 0.0

    undistorted = next((s for s in lines if s.startswith("undistorting")), None)
    log_job("job", res, lines, job_steps)
    log(f"[job] registered {n_reg}/{len(images)}, {n_pts} points; self-calibrated k1 "
        f"{k1:+.5f}; undistortion "
        + (f"ran ({undistorted})" if undistorted else "did not run"))
    log(f"[job] CLI run {job_s:.1f} s (launches {launches}); its log: "
        f"{os.path.relpath(os.path.join(OUT_DIR, 'job_log.txt'), ROOT)}")
    log(f"[job] {card_line()}")


def conv_flops(net, shape, device) -> float:
    """The FLOPs of a net's convolutions on one input of `shape` (two per
    multiply-add), counted from their output sizes in a forward pass."""
    import torch

    total = [0]

    def count(mod, _, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            net(torch.zeros(shape, device=device))
    finally:
        for h in hooks:
            h.remove()
    return float(total[0])


def generated_job(root: str, capture: str, flags: list, edits: dict, tag: str) -> tuple:
    """Write a job JSON with the port's generator, as a user would
    (`python -m tpu_splat_torch.cli.generate_splat <capture> -o <out> <flags>
    --job-only`), then apply the smoke's `edits` ({section: {key: value}}).
    Returns (job path, job dict)."""
    import contextlib
    import io

    from tpu_splat_torch.cli import generate_splat

    out = os.path.join(root, "out")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = generate_splat.main([capture, "-o", out, *flags, "--job-only"])
    if rc != 0:
        raise AssertionError(f"generate_splat {flags} exited {rc}")
    job_path = stdout.getvalue().strip().splitlines()[-1].split("job JSON: ", 1)[1]
    with open(job_path) as f:
        job = json.load(f)
    for section, values in edits.items():
        job[section].update(values)
    with open(job_path, "w") as f:
        json.dump(job, f, indent=2)
    log(f"[{tag}] generate_splat {' '.join(flags)} --job-only wrote "
        f"{os.path.relpath(job_path, ROOT)}; the smoke sets only {json.dumps(edits)}")
    return job_path, job


def remove_background_phase(dev, steps: int) -> None:
    """Phase 8 (see the module docstring): a --remove-background job, then
    MatNet and the full U2Net held against the port on the CPU."""
    import shutil

    import torch

    from tpu_splat_torch.gs import pipeline as gs_pipeline
    from tpu_splat_torch.matting import remove
    from tpu_splat_torch.matting.matnet import (_RES, bundled_weights_path, load_matnet,
                                                matnet_saliency, resize_bilinear)
    from tpu_splat_torch.matting.u2net import load_u2net, u2net_apply

    root = os.path.join(OUT_DIR, "remove_background")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n_views, width, height, focal = 16, 1280, 720, 700.0
    t0 = time.time()
    scene, n_rock = subject_scene(np.random.default_rng(8))
    vms = arc_viewmats(n_views)
    images = render_capture(scene, vms, focal, width, height, background=SUBJECT_BACKGROUND,
                            max_per_tile=1024, device=dev)
    frames = np.round(np.clip(images, 0, 1) * 255) / 255  # the job's 8-bit frames
    zip_path = os.path.join(root, "capture.zip")
    zip_frames(images, zip_path)
    log(f"[matting] capture: subject_scene's rock ({n_rock} of {len(scene[0])} gaussians) "
        f"on a 120-degree arc, {n_views} frames {width}x{height}, fx {focal}, rendered and "
        f"zipped in {time.time() - t0:.1f} s")

    job_path, job = generated_job(root, zip_path, ["--remove-background"],
                                  {"training": {"maxSteps": steps}}, "matting")
    seen = {}
    removal, train = remove.remove_background_batch, gs_pipeline.train_splat

    def spy_removal(*args, **kw):
        out = removal(*args, **kw)
        seen["masks"] = out[1]
        return out

    def spy_train(scene, images, **kw):
        seen["train_masks"] = kw.get("masks")
        seen["train_images"] = len(images)
        return train(scene, images, **kw)

    remove.remove_background_batch, gs_pipeline.train_splat = spy_removal, spy_train
    try:
        res, lines, launches, job_s = run_cli_job(job_path, "--remove-background job",
                                                  "remove_background_log.txt")
    finally:
        remove.remove_background_batch, gs_pipeline.train_splat = removal, train
    frac = seen["masks"].reshape(len(seen["masks"]), -1).mean(axis=1)
    log(f"[matting] mask fraction per frame: {[round(float(f), 4) for f in frac]}")
    if not ((frac > 0.05) & (frac < 0.80)).all():
        raise AssertionError(f"a mask covers {frac.min():.4f}-{frac.max():.4f} of its frame, "
                             "outside (0.05, 0.80)")
    n_reg = int(res["metrics"]["num_registered"])
    tm = seen["train_masks"]
    if tm is None or len(tm) != n_reg or seen["train_images"] != n_reg:
        raise AssertionError(f"masks did not reach Train-Stage1 for the {n_reg} registered "
                             f"frames: {None if tm is None else tm.shape}")
    _, n_pts = check_job_artifacts(root, job["outputPath"], job["uuid"], res, n_views)
    log_job("matting", res, lines, steps)
    log(f"[matting] registered {n_reg}/{n_views}, {n_pts} points; masks reached "
        f"Train-Stage1: {tm.shape[0]} of {tm.shape[1]}x{tm.shape[2]}, mean fraction "
        f"{float(tm.mean()):.4f}")
    log(f"[matting] CLI run {job_s:.1f} s (launches {launches})")

    # MatNet: the card against the CPU on two of the job's frames, its IoU on
    # the matting test's composite capture, and its time per frame
    pair = frames[[0, n_views // 2]].astype(np.float32)
    sal_card, sal_cpu = matnet_saliency(pair, device=dev), matnet_saliency(pair, device="cpu")
    with torch.no_grad():  # the exact result: the same net and resizes in f64
        x = torch.from_numpy(pair.astype(np.float64)).permute(0, 3, 1, 2)
        net64 = load_matnet(bundled_weights_path(), "cpu").double()
        sal_f64 = resize_bilinear(torch.sigmoid(net64(resize_bilinear(x, (_RES, _RES))))[:, None],
                                  (height, width))[:, 0].numpy()
    err = float(np.abs(sal_card - sal_cpu).max())
    err64 = {k: float(np.abs(v - sal_f64).max()) for k, v in (("card", sal_card),
                                                               ("cpu", sal_cpu))}
    flips = float(np.mean((sal_card > 0.5) != (sal_cpu > 0.5)))
    log(f"[matting] MatNet saliency on frames 0 and {n_views // 2}, card against CPU: max abs "
        f"{err:.3e}, {flips:.2e} of the pixels on the other side of 0.5; against f64: card "
        f"{err64['card']:.3e}, CPU {err64['cpu']:.3e}")
    # An f32 result can sit 1e-4 or more from the exact one on these frames
    # (group norms of near-flat groups amplify the convolutions' rounding;
    # the CPU's result sat 1.2e-4 away on the H100's host), so two f32
    # results cannot be held within 1e-4 of each other: the bar is 1e-3 on
    # the saliency, and 0.1% of pixels on the mask it cuts.
    if not (err <= 1e-3 and flips <= 1e-3):
        raise AssertionError(f"MatNet on the card differs from the CPU by {err:.3e} "
                             f"({flips:.2e} of the mask)")
    comp, gt = composite_scene()
    iou = {}
    for model in ("u2net", "sam2"):
        _, masks = remove.remove_background_batch(comp, model=model, keyframe_every=4,
                                                  device=dev)
        iou[model] = float(np.mean([mask_iou(m, g) for m, g in zip(masks, gt)]))
    log(f"[matting] composite capture IoU on the card: MatNet (u2net mode) "
        f"{iou['u2net']:.4f}, sam2 mode {iou['sam2']:.4f}")
    if not iou["u2net"] > 0.9:
        raise AssertionError(f"MatNet IoU {iou['u2net']:.4f} <= 0.9")
    net = load_matnet(bundled_weights_path(), dev)
    x = torch.rand((8, 3, _RES, _RES), device=dev)
    with torch.no_grad():
        matnet_ms = time_ms(lambda: net(x), 10) / 8
    flop = conv_flops(net, (1, 3, _RES, _RES), dev)
    log(f"[matting] MatNet {_RES}x{_RES}, batch 8: {matnet_ms:.3f} ms a frame; "
        f"{flop / 1e9:.3f} GFLOP of convolutions a frame, {flop / matnet_ms / 1e9:.2f} TFLOP/s")

    # the full U2Net from a standard .pth, through TPU_SPLAT_U2NET_WEIGHTS
    pth = os.path.join(OUT_DIR, "u2net_seeded.pth")
    torch.save(seeded_u2net_state_dict(0, device=dev), pth)
    os.environ["TPU_SPLAT_U2NET_WEIGHTS"] = pth
    try:
        t0 = time.time()
        _, masks = remove.remove_background_batch(frames[:4].astype(np.float32),
                                                  model="u2net", device=dev)
        u2_s = time.time() - t0
        one = frames[:1].astype(np.float32)
        sal_card = remove._u2net_masks(one, pth, dev)
        sal_cpu = remove._u2net_masks(one, pth, "cpu")
    finally:
        del os.environ["TPU_SPLAT_U2NET_WEIGHTS"]
    with torch.no_grad():
        sal_f64 = u2net_apply(load_u2net(pth, "cpu").double(),
                              torch.from_numpy(one.astype(np.float64))).numpy()
    err = float(np.abs(sal_card - sal_cpu).max())
    err64 = float(np.abs(sal_cpu - sal_f64).max())
    ufrac = masks.reshape(4, -1).mean(axis=1)
    net = load_u2net(pth, dev)
    x = torch.rand((4, 3, 320, 320), device=dev)
    with torch.no_grad():
        u2_ms = time_ms(lambda: net(x), 5) / 4
    u2_flop = conv_flops(net, (1, 3, 320, 320), dev)
    log(f"[matting] full U2Net ({sum(p.numel() for p in net.parameters())} parameters, "
        f"seeded, from {os.path.relpath(pth, ROOT)}): remove_background_batch(u2net) on 4 "
        f"frames in {u2_s:.2f} s, mask fractions {[round(float(f), 4) for f in ufrac]}; "
        f"saliency of frame 0, card against CPU: max abs {err:.3e} (CPU f32 against f64: "
        f"{err64:.3e}); 320x320, batch 4: {u2_ms:.3f} ms a frame, {u2_flop / 1e9:.1f} GFLOP "
        f"of convolutions, {u2_flop / u2_ms / 1e9:.2f} TFLOP/s")
    # The seeded net's saliency is min-max normalised after 119 convolutions,
    # and f32 rounding alone moves it by err64 (1.3e-4 on the H100's host):
    # each device may differ from the exact result by about that much, so
    # the bar is 1e-3, about four times the sum.
    if not (np.isfinite(masks).all() and err <= 1e-3):
        raise AssertionError(f"U2Net saliency on the card differs from the CPU by {err:.3e}")
    log(f"[matting] {card_line()}")


def spherical_capture(dev) -> tuple:
    """Phase 9's capture: testing.room_scene's room seen from SPHERICAL_FRAMES
    eyes on an arc, as equirectangular frames of SPHERICAL_ERP_HEIGHT rows
    stitched from cube faces the port rendered on `dev`; (scene, frames)."""
    scene = room_scene(np.random.default_rng(9))
    return scene, render_erp(scene, spherical_eyes(), SPHERICAL_ERP_HEIGHT,
                             SPHERICAL_ERP_HEIGHT, device=dev)


def spherical_eyes() -> np.ndarray:
    """The (SPHERICAL_FRAMES, 3) eyes of phase 9's ERP frames, on an arc."""
    return np.stack([[1.5 * np.cos(a), -0.3, 1.5 * np.sin(a)]
                     for a in np.linspace(0.2, 1.6, SPHERICAL_FRAMES)])


def spherical_eye_span() -> float:
    """The distance between phase 9's first and last eye."""
    eyes = spherical_eyes()
    return float(np.linalg.norm(eyes[-1] - eyes[0]))


def spherical_rmse(poses: dict) -> float:
    """Camera-centre RMSE, in world units, of a --spherical job's registered
    views (model_poses) after a similarity alignment: every view of an ERP
    frame sits at that frame's eye."""
    from tpu_splat_torch.core.config import SphericalCameraConfig
    from tpu_splat_torch.spherical.pipeline import view_sequence

    cfg = SphericalCameraConfig(enable=True, cube_faces_to_remove="up,down")
    eyes = spherical_eyes()[[fi for fi, _, _ in view_sequence(SPHERICAL_FRAMES, cfg)]]
    viewmats = np.tile(np.eye(4), (len(eyes), 1, 1))
    viewmats[:, :3, 3] = -eyes  # only the centres are compared
    return model_rmse(poses, viewmats)


def spherical_job_edits(steps: int) -> dict:
    """What phase 9 changes in the generator's `--spherical --preset fast`
    job: maxSteps (0 turns training off) and the faces it removes."""
    training = {"maxSteps": steps} if steps else {"enable": False}
    return {"training": training, "sphericalCamera": {"cubeFacesToRemove": "up,down"}}


def multivideo_capture(directory: str) -> tuple:
    """Phase 15's capture: core/meshrender's capture scene rendered on the
    host from MULTIVIDEO_ANGLES of its orbit and written with cv2 as the
    mp4v videos of MULTIVIDEO_SEGMENTS into `directory`, as
    tests/test_spherical_multivideo_e2e.py writes them. Returns the videos'
    paths."""
    import cv2

    from tpu_splat_torch.core.meshrender import make_capture_scene, orbit_w2c, render_mesh

    mesh = make_capture_scene(7)
    (w, h), f = MULTIVIDEO_SIZE, MULTIVIDEO_FOCAL
    frames = [(np.clip(render_mesh(mesh, orbit_w2c(a), f, f, w / 2, h / 2, w, h)[..., ::-1],
                       0, 1) * 255).astype(np.uint8) for a in MULTIVIDEO_ANGLES]
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, idx in MULTIVIDEO_SEGMENTS:
        paths.append(os.path.join(directory, name))
        vw = cv2.VideoWriter(paths[-1], cv2.VideoWriter_fourcc(*"mp4v"), MULTIVIDEO_FPS,
                             (w, h))
        if not vw.isOpened():
            raise AssertionError("cv2 cannot write mp4v video")
        for i in idx:
            vw.write(frames[i])
        vw.release()
    return paths


def multivideo_job(paths: list, uuid: str, out: str, steps: int) -> dict:
    """Phase 15's job: the videos as one comma-separated input, every frame
    kept (no blur filter), exhaustive matching, maxSteps `steps` (0 turns
    training off); the reference's defaults otherwise."""
    return {"uuid": uuid, "inputPath": ",".join(paths), "outputPath": out,
            "videoProcessing": {"maxNumImages": MULTIVIDEO_MAX_IMAGES},
            "imageProcessing": {"filterBlurryImages": False},
            "sfm": {"enable": True, "matchingMethod": "exhaustive"},
            "training": {"enable": True, "maxSteps": steps} if steps else {"enable": False}}


def multivideo_viewmats() -> np.ndarray:
    """The true world-to-camera matrix of each frame of phase 15's videos, in
    the order the job merges them."""
    from tpu_splat_torch.core.meshrender import orbit_w2c

    return np.stack([orbit_w2c(MULTIVIDEO_ANGLES[i]) for _, idx in MULTIVIDEO_SEGMENTS
                     for i in idx])


@contextlib.contextmanager
def decoded_media(runner):
    """For the block, `runner`'s Media-To-Images stage (either package's
    pipeline.runner) also keeps, in the dict it yields, the frames it
    decoded and the frames each video gave (ctx["segments"])."""
    fn = runner._media_to_images
    seen = {}

    def spy(ctx):
        fn(ctx)
        seen["images"], seen["segments"] = ctx["images"], ctx.get("segments")

    runner._media_to_images = spy
    try:
        yield seen
    finally:
        runner._media_to_images = fn


def registered_per_segment(frame_ids, segments) -> list:
    """How many of the registered frame indices fall in each video's run of
    the merged image set."""
    ends = np.cumsum(segments)
    return np.bincount(np.searchsorted(ends, np.asarray(list(frame_ids)), side="right"),
                       minlength=len(segments)).tolist()


def spherical_phase(dev, steps: int) -> None:
    """Phase 9 (see the module docstring): a --spherical job on ERP frames
    that the port rendered."""
    import shutil

    import torch

    from tpu_splat_torch.core.config import SphericalCameraConfig
    from tpu_splat_torch.core.spz import load_spz
    from tpu_splat_torch.spherical.pipeline import view_sequence
    from tpu_splat_torch.spherical.projections import erp_to_perspective, rotation_yaw_pitch

    root = os.path.join(OUT_DIR, "spherical")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n_frames, erp_height = SPHERICAL_FRAMES, SPHERICAL_ERP_HEIGHT
    t0 = time.time()
    scene, erps = spherical_capture(dev)
    zip_path = os.path.join(root, "capture.zip")
    zip_frames(erps, zip_path)
    log(f"[spherical] capture: room_scene ({len(scene[0])} gaussians), {n_frames} ERP "
        f"frames {2 * erp_height}x{erp_height} from {erp_height}x{erp_height} cube faces "
        f"rendered by the port, rendered and zipped in {time.time() - t0:.1f} s")
    job_path, job = generated_job(root, zip_path, ["--spherical", "--preset", "fast"],
                                  spherical_job_edits(steps), "spherical")
    cfg = SphericalCameraConfig(enable=True, cube_faces_to_remove="up,down")
    views = view_sequence(n_frames, cfg)
    face = max(erp_height // 2, 256)

    ref = SPHERICAL_REFERENCE
    check_capture(erps, ERP_PIXELS, ref)
    res, lines, launches, job_s = run_cli_job(job_path, "--spherical job", "spherical_log.txt")
    metrics, timings = res["metrics"], res["timings"]
    n_img, n_reg = int(metrics["num_images"]), int(metrics["num_registered"])
    if "Spherical-To-Perspective" not in timings:
        raise AssertionError("the job did not time Spherical-To-Perspective")
    if not n_img == len(views) == ref["num_images"]:
        raise AssertionError(f"SfM saw {n_img} images, the expansion makes {len(views)}, the "
                             f"reference's {ref['num_images']}")
    n_g = load_spz(res["artifacts"]["spz"]).num_points
    if not (n_g == int(metrics["num_gaussians"]) and n_g > 100):
        raise AssertionError(f"the .spz holds {n_g} gaussians (trained "
                             f"{metrics['num_gaussians']}); at least 101 are needed")
    erp = torch.as_tensor(erps, device=dev)
    rots = torch.as_tensor(np.stack([rotation_yaw_pitch(y, p) for _, y, p in views]),
                           dtype=torch.float32)
    src = torch.as_tensor([fi for fi, _, _ in views])
    view_ms = time_ms(lambda: erp_to_perspective(erp, rots, face, face, 90.0, frames=src),
                      10) / len(views)
    poses = model_poses(job["outputPath"])
    rmse, span = spherical_rmse(poses), spherical_eye_span()
    bar = max(2 * ref["rmse"], 0.01 * span)
    log_job("spherical", res, lines, steps)
    log(f"[spherical] expansion: {len(views)} views of {face}x{face} in "
        f"{timings['Spherical-To-Perspective']:.2f} s; erp_to_perspective {view_ms:.4f} ms a "
        f"view ({len(views)} in one gather); registered {n_reg}/{len(views)} (reference "
        f"{ref['registered']}), views {sorted(poses)}; camera-centre RMSE against the frames' "
        f"eyes {rmse / span:.5f} of their span (reference {ref['rmse'] / span:.5f}, bar "
        f"{bar / span:.5f}); .spz read back with {n_g} gaussians")
    log(f"[spherical] CLI run {job_s:.1f} s (launches {launches})")
    log(f"[spherical] {card_line()}")
    # The mapper is chaotic: the reference's own count on this scene moved
    # from 26 to 29 views when 48-74 pixels a frame moved one level. Views
    # beyond the reference's count are held by the centre RMSE, which every
    # registered view enters; fewer than its count less 2 is a fault.
    if n_reg < ref["registered"] - 2:
        raise AssertionError(f"the --spherical job registered {n_reg} views, the reference "
                             f"{ref['registered']}")
    if rmse > bar:
        raise AssertionError(f"camera-centre RMSE {rmse:.4f} > {bar:.4f}")

@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Wrap module.<name> for the block: each call's (args, kwargs) is
    appended to `calls`, and the call goes through unchanged."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def model_poses(out: str) -> dict:
    """frame index -> world-to-camera (4, 4) f64 of a job's text model
    (colmap/sparse/0; images named frame_<index>.png)."""
    from tpu_splat_torch.sfm.colmap_io import qvec_to_rotmat, read_colmap_model

    _, images, _, _ = read_colmap_model(os.path.join(out, "colmap", "sparse", "0"))
    poses = {}
    for name, rec in images.items():
        w2c = np.eye(4)
        w2c[:3, :3] = qvec_to_rotmat(np.asarray(rec["qvec"], np.float64))
        w2c[:3, 3] = rec["tvec"]
        poses[int(re.search(r"(\d+)\.png$", name)[1])] = w2c
    return poses


def model_rmse(poses: dict, viewmats: np.ndarray) -> float:
    """Camera-centre RMSE, in world units, of a job's registered poses
    (model_poses) against the true world-to-camera matrices, after a
    similarity alignment."""
    idx = sorted(poses)
    return camera_centre_rmse(np.linalg.inv(np.stack([poses[i] for i in idx])),
                              viewmats[idx])


def read_mesh_artifacts(exports: str) -> tuple:
    """The mesh deliverables read back: (ply vertices, ply face count, obj
    vertex and face counts, glb vertex and index counts)."""
    import struct

    with open(os.path.join(exports, "poisson_mesh.ply")) as f:
        text = f.read()
    head, body = text.split("end_header\n")
    n_v = int(re.search(r"element vertex (\d+)", head)[1])
    n_f = int(re.search(r"element face (\d+)", head)[1])
    rows = body.splitlines()
    verts = np.array([[float(x) for x in r.split()[:3]] for r in rows[:n_v]]).reshape(-1, 3)
    if len(rows) != n_v + n_f or any(not r.startswith("3 ") for r in rows[n_v:]):
        raise AssertionError("poisson_mesh.ply does not read back")
    with open(os.path.join(exports, "textured", "mesh.obj")) as f:
        obj = f.read().splitlines()
    obj_v = sum(r.startswith("v ") for r in obj)
    obj_f = sum(r.startswith("f ") for r in obj)
    with open(os.path.join(exports, "textured", "mesh.glb"), "rb") as f:
        glb = f.read()
    magic, version, total = struct.unpack_from("<III", glb, 0)
    js_len, js_type = struct.unpack_from("<II", glb, 12)
    gltf = json.loads(glb[20:20 + js_len])
    if not (magic == 0x46546C67 and version == 2 and total == len(glb)
            and js_type == 0x4E4F534A):
        raise AssertionError("textured/mesh.glb is not a glTF 2.0 binary")
    acc = gltf["accessors"]
    return verts, n_f, (obj_v, obj_f), (acc[0]["count"], acc[2]["count"])


def spz_rounding_ties(native: bytes, cloud) -> int:
    """Hold the native codec's packed .spz payload to core/spz's on the same
    cloud, byte for byte, but for 8-bit values one level apart where the
    exact value sits at a rounding tie (within 1e-3 of k + 0.5): native/spz
    quantizes alphas, colours, scales and rotations in f32 and core/spz in
    f64, so a rotation component of +-1e-8 (a rotated identity quaternion)
    rounds 127.5 up in one and 127.49999 down in the other. Positions and
    SH are scaled by powers of two, exact in both, and must be equal.
    Returns the count of tie bytes; raises on any other difference."""
    from tpu_splat_torch.core.spz import COLOR_SCALE, pack_gaussians

    ref = pack_gaussians(cloud)
    if len(native) != len(ref):
        raise AssertionError(f"convert's .spz payload has {len(native)} bytes, core/spz's "
                             f"{len(ref)}")
    a, b = np.frombuffer(native, np.uint8), np.frombuffer(ref, np.uint8)
    diff = np.nonzero(a != b)[0]
    g = cloud.to_numpy()
    q = g.quats.astype(np.float64)
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    q = q / np.where(norm == 0, 1.0, norm)
    exact = np.concatenate([  # core/spz's values before rounding, in payload order
        255.0 / (1.0 + np.exp(-g.opacities.astype(np.float64))),
        (g.sh0.astype(np.float64) * (COLOR_SCALE * 255.0) + 127.5).reshape(-1),
        ((g.scales.astype(np.float64) + 10.0) * 16.0).reshape(-1),
        (q[:, 1:4] * np.where(q[:, :1] < 0, -1.0, 1.0) * 127.5 + 127.5).reshape(-1)])
    k = diff - (16 + 9 * cloud.num_points)  # offsets in the 8-bit sections
    ok = (k >= 0) & (k < len(exact))
    x = exact[k[ok]]
    ok[ok] = ((np.abs(x - np.floor(x) - 0.5) < 1e-3)
              & (np.abs(a[diff[ok]].astype(int) - b[diff[ok]]) == 1))
    if not ok.all():
        raise AssertionError(f"convert's .spz payload differs from core/spz's at bytes "
                             f"{diff[~ok][:10].tolist()} beyond rounding ties")
    return len(diff)


def pose_prior_phase(images: np.ndarray, viewmats: np.ndarray, focal: float, dev,
                     steps: int) -> None:
    """Phase 10 (see the module docstring): a pose-prior job with every
    extra, then the plane fit and the mesh on the card against the CPU."""
    import gzip
    import shutil
    import zipfile

    import torch

    from tpu_splat_torch.core.ply import load_ply
    from tpu_splat_torch.export import measurement, mesh
    from tpu_splat_torch.sfm.pose_priors import convert_pose, normalize_poses

    root = os.path.join(OUT_DIR, "pose_priors")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n, (height, width) = len(images), images.shape[1:3]
    zip_path = os.path.join(root, "capture.zip")
    zip_frames(images, zip_path)
    T = np.diag([1.0, -1.0, -1.0, 1.0])  # ARKit's basis: world-to-camera = T w2c T
    frames = [{"file_path": f"images/frame_{i:04d}.png",
               "transform_matrix": (T @ viewmats[i].astype(np.float64) @ T).tolist()}
              for i in range(n)]
    with zipfile.ZipFile(zip_path, "a") as zf:
        zf.writestr("capture/transforms-in.json", json.dumps(
            {"fl_x": focal, "fl_y": focal, "cx": width / 2, "cy": height / 2, "w": width,
             "h": height, "frames": frames}))
    c2w_true = np.stack([convert_pose(np.asarray(f["transform_matrix"]), "arkit", True)
                         for f in frames])
    priors, _, norm_scale = normalize_poses(c2w_true)
    uuid, out = "chip-smoke-pose-priors", os.path.join(root, "out")
    job_path = os.path.join(root, "job.json")
    with open(job_path, "w") as f:  # the reference's defaults, but for these
        json.dump({"uuid": uuid, "inputPath": zip_path, "outputPath": out,
                   "sfm": {"posePriors": {"usePosePriorTransformJson": {
                       "enable": True, "sourceCoordinateName": "arkit",
                       "poseIsWorldToCam": True}}},
                   "measurement": {"referenceType": "tripod", "tripodHeightM": TRIPOD_HEIGHT_M},
                   "semantic": {"enableObjectLayer": True},
                   "training": {"model": "nerfacto", "maxSteps": steps}}, f)
    log(f"[priors] {n} frames {width}x{height} with an ARKit transforms-in.json of the true "
        f"world-to-camera poses and intrinsics; job: pose priors, tripod {TRIPOD_HEIGHT_M} m, "
        f"object layer, nerfacto (mesh export), maxSteps {steps}")

    scale_calls, mesh_calls = [], []
    with recording(measurement, "estimate_scale_from_tripod", scale_calls), \
            recording(mesh, "export_mesh_artifacts", mesh_calls):
        res, lines, launches, job_s = run_cli_job(job_path, "pose-prior job",
                                                  "pose_priors_log.txt")
    n_reg = int(res["metrics"]["num_registered"])
    if n_reg != n:
        raise AssertionError(f"the pose-prior job registered {n_reg} of {n} frames")
    exports = os.path.join(out, "exports")
    with open(os.path.join(exports, "floorplan.json")) as f:
        floor = json.load(f)
    with open(os.path.join(exports, "objects.geojson")) as f:
        objects = json.load(f)["features"]
    with open(os.path.join(exports, "measurement.json")) as f:
        meas = json.load(f)
    if not (meas["valid"] and math.isfinite(meas["metersPerModelUnit"])
            and meas["metersPerModelUnit"] > 0):
        raise AssertionError(f"measurement.json is not a valid scale: {meas}")
    extras = ("mesh_ply", "mesh_obj", "mesh_glb", "measurement", "floorplan_meta",
              "objects_geojson", "objects_svg")
    if floor["valid"]:  # a polygon was found
        extras += ("floorplan_svg", "floorplan_png", "floorplan_geojson")
    _, n_pts = check_job_artifacts(root, out, uuid, res, n,
                                   ("transforms_json", "ply", "spz") + extras)
    poses = model_poses(out)
    w2c_priors = np.linalg.inv(priors)
    shift = {i: (np.abs(poses[i][:3, :3] - w2c_priors[i][:3, :3]).max(),
                 np.abs(poses[i][:3, 3] - w2c_priors[i][:3, 3]).max()) for i in poses}
    dev_R, dev_t = (max(d[k] for i, d in shift.items() if i) for k in (0, 1))
    span = WALK_SPAN / norm_scale  # the walk in model units
    log(f"[priors] exported poses against normalize_poses of the priors: camera 0 (BA's "
        f"gauge) {max(shift[0]):.3e}; the others, refined by BA: rotation max abs {dev_R:.3e}, "
        f"translation max abs {dev_t:.3e} ({dev_t / span:.5f} of the walk's {span:.3f})")
    if max(shift[0]) > PRIOR_POSE_TOL or dev_R > PRIOR_POSE_SHIFT \
            or dev_t > PRIOR_POSE_SHIFT * span:
        raise AssertionError(f"the exported poses are off the priors: {shift}")

    cloud = mesh_calls[0][0][0]
    means = np.asarray(cloud.means, np.float64)
    verts, n_faces, obj_counts, glb_counts = read_mesh_artifacts(exports)
    lo, hi = np.percentile(means, 1, axis=0), np.percentile(means, 99, axis=0)
    pad = 0.05 * float(np.max(hi - lo))
    origin, side = lo - pad, float(np.max(hi - lo)) + 2 * pad  # the grid's cube
    inside = np.all((verts >= origin - 1e-4) & (verts <= origin + side + 1e-4), axis=1)
    if not (n_faces > 0 and np.isfinite(verts).all() and inside.all()
            and obj_counts == (len(verts), n_faces) and glb_counts == (len(verts), 3 * n_faces)):
        raise AssertionError(f"the mesh: {len(verts)} vertices ({int(inside.sum())} inside the "
                             f"grid), {n_faces} faces, obj {obj_counts}, glb {glb_counts}")
    in_box = float(np.mean(np.all((verts >= lo - pad) & (verts <= hi + pad), axis=1)))

    # the card against the CPU on the job's trained splat means
    (pts, c2ws), kw = scale_calls[0]
    height_m = kw["tripod_height_m"]
    pts_d = torch.as_tensor(np.asarray(pts, np.float64), device=dev)
    pts_c = pts_d.cpu()
    centers = np.asarray(c2ws, np.float64)[:, :3, 3]
    fits = [measurement.best_plane(p, np.random.default_rng(0), camera_centers=centers)
            for p in (pts_d, pts_c, pts_d)]
    card_scale = measurement.estimate_scale_from_tripod(pts, c2ws, height_m, device=dev)
    cpu_scale = measurement.estimate_scale_from_tripod(pts, c2ws, height_m, device="cpu")
    rel = abs(card_scale["metersPerModelUnit"] / cpu_scale["metersPerModelUnit"] - 1)
    same_fit = (fits[0][0] == fits[1][0] and torch.equal(fits[0][3].cpu(), fits[1][3])
                and torch.equal(fits[0][1], fits[2][1]) and fits[0][0] == fits[2][0])
    grid_d = mesh.splat_density_grid(cloud, device=dev)
    grid_c = mesh.splat_density_grid(cloud, device="cpu")
    grid_rel = float(np.abs(grid_d[0] - grid_c[0]).max() / grid_c[0].max())
    mesh_d = [mesh.extract_mesh(cloud, device=dev) for _ in range(2)]
    mesh_c = mesh.extract_mesh(cloud, device="cpu")
    repeat = all(np.array_equal(a, b) for a, b in zip(*mesh_d))
    log(f"[priors] card against CPU: winning plane hypothesis {fits[0][0]} / {fits[1][0]} "
        f"({int(fits[0][3].sum())} inliers), metersPerModelUnit relative difference "
        f"{rel:.3e}, density grid max relative difference {grid_rel:.3e}, faces "
        f"{len(mesh_d[0][1])} / {len(mesh_c[1])}; two card plane fits and extract_mesh runs "
        + ("bit-identical" if same_fit and repeat else "DIFFER"))
    if not (same_fit and rel <= 1e-9 and grid_rel <= 1e-12 and repeat
            and len(mesh_d[0][1]) == len(mesh_c[1])):
        raise AssertionError("the plane fit or the mesh on the card differs from the CPU or "
                             "does not repeat")

    n_axis = int(np.argmax(np.abs(meas["groundPlane"]["normal"])))
    plane = {1: "the ground", 2: "the back wall"}.get(n_axis, "a side plane")
    true_scale = TRIPOD_HEIGHT_M * norm_scale  # metres per model unit
    ransac_ms = time_ms(lambda: measurement.best_plane(
        pts_d, np.random.default_rng(0), camera_centers=centers), 3)
    grid_ms = time_ms(lambda: mesh._density_grid(cloud, 128, 0.05, dev), 3)
    density = mesh._density_grid(cloud, 128, 0.05, dev)[0]
    occupied = density[density > 1e-4]
    iso = float(measurement.quantile(occupied, 0.6))
    mt_ms = time_ms(lambda: mesh._polygonize(density, iso), 3)

    # the CLI's convert on the job's .ply: its payload is the Python writer's
    conv = os.path.join(root, "convert")
    os.makedirs(conv)
    ply_path = shutil.copy(os.path.join(exports, "splat.ply"), conv)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "tpu_splat_torch.cli.main", "convert",
                           ply_path], cwd=ROOT, capture_output=True, text=True, timeout=600)
    convert_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"convert exited {proc.returncode}: {proc.stderr}")
    with open(os.path.join(conv, "splat.spz"), "rb") as f:
        ties = spz_rounding_ties(gzip.decompress(f.read()), load_ply(ply_path))

    log_job("priors", res, lines, steps)
    log(f"[priors] registered {n_reg}/{n}, {n_pts} points; plane found: {plane} (normal "
        f"{np.round(meas['groundPlane']['normal'], 4).tolist()}, {meas['numPlaneInliers']} "
        f"inliers), metersPerModelUnit {meas['metersPerModelUnit']:.5f} against a true "
        f"{true_scale:.5f} (ground {TRIPOD_HEIGHT_M} m below the eyes, normalize_poses' scale "
        f"{norm_scale:.4f}), confidence {meas['confidence']}; floorplan "
        + (f"{floor['areaM2']:.2f} m2 ({floor['quality']})" if floor["valid"] else "not found")
        + f"; {len(objects)} objects")
    log(f"[priors] mesh: {len(verts)} vertices, {n_faces} faces from {cloud.num_points} "
        f"gaussians, all inside the grid's cube, {in_box:.4f} inside the 1-99% box plus the "
        f"padding; card: density grid {grid_ms:.2f} ms, marching tetrahedra {mt_ms:.2f} ms, "
        f"plane RANSAC (500 hypotheses x {cloud.num_points} points) {ransac_ms:.2f} ms")
    log(f"[priors] convert (native C++ codec, built at first use) {convert_s:.1f} s: the "
        f".spz payload equals core/spz's but for {ties} bytes one level apart at rounding "
        f"ties (the C++ codec quantizes in f32, core/spz in f64)")
    log(f"[priors] CLI run {job_s:.1f} s (launches {launches})")
    log(f"[priors] {card_line()}")


def capture_stats(images: np.ndarray, pixels=CAPTURE_PIXELS) -> tuple:
    """The 8-bit frames' mean and their values at `pixels` (frame, y, x,
    channel)."""
    frames = np.round(np.clip(images, 0, 1) * 255) / 255
    return float(frames.mean()), [float(frames[p]) for p in pixels]


def check_capture(images: np.ndarray, pixels, ref: dict) -> None:
    """Raise unless the frames are the capture `ref` was recorded on: the
    mean and the values at `pixels` within 1e-4."""
    mean, values = capture_stats(images, pixels)
    if abs(mean - ref["capture_mean"]) > 1e-4 or np.abs(
            np.subtract(values, ref["capture_values"])).max() > 1e-4:
        raise AssertionError(f"the capture (mean {mean}, {values}) is not the one the "
                             f"reference's outcome was recorded on ({ref['capture_mean']}, "
                             f"{ref['capture_values']})")


def global_sfm_phase(images: np.ndarray, viewmats: np.ndarray, steps: int) -> None:
    """Phase 11 (see the module docstring): a global-SfM job on phase 7's
    capture, held to the reference's recorded outcome."""
    import shutil

    from tpu_splat_torch.sfm import global_mapper

    ref = GLOBAL_SFM_REFERENCE
    check_capture(images, CAPTURE_PIXELS, ref)
    root = os.path.join(OUT_DIR, "global_sfm")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    zip_path = os.path.join(root, "capture.zip")
    zip_frames(images, zip_path)
    uuid, out = "chip-smoke-global-sfm", os.path.join(root, "out")
    job_path = os.path.join(root, "job.json")
    with open(job_path, "w") as f:
        json.dump({"uuid": uuid, "inputPath": zip_path, "outputPath": out,
                   "sfm": {"softwareName": "glomap"}, "training": {"maxSteps": steps}}, f)
    rot_calls, pos_calls = [], []
    with recording(global_mapper, "rotation_averaging", rot_calls), \
            recording(global_mapper, "global_positioning", pos_calls):
        res, lines, launches, job_s = run_cli_job(job_path, "global-SfM job",
                                                  "global_sfm_log.txt")
    n_reg = int(res["metrics"]["num_registered"])
    _, n_pts = check_job_artifacts(root, out, uuid, res, len(images),
                                   ("transforms_json", "ply", "spz"))
    rmse = model_rmse(model_poses(out), viewmats)
    bar = max(2 * ref["rmse"], 0.01 * WALK_SPAN)
    rel_line = next(s for s in lines if s.startswith("global:") and "relative poses" in s)
    ba_lines = [s for s in lines if s.startswith("BA:")]
    # the job's own averaging inputs, twice more on the card: bit for bit
    (a_args, a_kw), (p_args, p_kw) = rot_calls[0], pos_calls[0]
    reps = [(global_mapper.rotation_averaging(*a_args, **a_kw),
             global_mapper.global_positioning(*p_args, **p_kw)) for _ in range(2)]
    same = (np.array_equal(reps[0][0], reps[1][0])
            and all(np.array_equal(a, b) for a, b in zip(reps[0][1], reps[1][1])))
    log_job("global", res, lines, steps)
    log(f"[global] {rel_line}; {len(p_args[5])} rays of {p_args[9]} tracks in the "
        f"positioning; " + " / ".join(ba_lines))
    log(f"[global] registered {n_reg}/{len(images)} (reference {ref['registered']}), "
        f"{n_pts} points (reference {ref['points']}), camera-centre RMSE {rmse / WALK_SPAN:.5f} "
        f"of the span (reference {ref['rmse'] / WALK_SPAN:.5f}, bar {bar / WALK_SPAN:.5f}), "
        f"final BA rms {ba_lines[-1].split('rms ')[1] if ba_lines else '-'} (reference "
        f"{ref['final_rms_px']} px); two rotation_averaging + global_positioning calls on the "
        f"job's pairs: {'bit-identical' if same else 'DIFFER'}")
    log(f"[global] CLI run {job_s:.1f} s (launches {launches})")
    log(f"[global] {card_line()}")
    if n_reg < ref["registered"] - 1:
        raise AssertionError(f"global SfM registered {n_reg}, the reference {ref['registered']}")
    if rmse > bar:
        raise AssertionError(f"global SfM camera-centre RMSE {rmse:.4f} > {bar:.4f}")
    if not same:
        raise AssertionError("two identical averaging calls differ on the card")


def state_errors(got: dict, want: dict) -> dict:
    """max|d| / max|ref| of every tensor of two states (numpy dicts of one
    layout); a bool tensor counts 1 unless equal."""
    errs = {}
    for key, ref in want.items():
        g = got[key]
        if g.shape != ref.shape:
            raise AssertionError(f"{key}: shape {g.shape} against {ref.shape}")
        if ref.dtype == bool or ref.size == 0:
            errs[key] = 0.0 if np.array_equal(g, ref) else 1.0
            continue
        d = float(np.abs(g.astype(np.float64) - ref).max())
        errs[key] = d / max(float(np.abs(ref).max()), 1e-30) if d else 0.0
    return errs


def read_launch_dir(directory: str) -> list:
    """The launch counts that each process started with TPU_SPLAT_LAUNCH_DIR
    wrote as it exited."""
    return [json.load(open(os.path.join(directory, n))) for n in sorted(os.listdir(directory))
            if n.startswith("launches_")]


@contextlib.contextmanager
def launch_dir(name: str):
    """TPU_SPLAT_LAUNCH_DIR set to a fresh directory for the processes started
    inside the block (they count from 0); yields the directory."""
    import shutil

    from tpu_splat_torch.gs import cuda_raster as cr

    directory = os.path.join(OUT_DIR, name)
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    os.environ[cr.LAUNCH_DIR_ENV] = directory
    try:
        yield directory
    finally:
        del os.environ[cr.LAUNCH_DIR_ENV]


def check_rank_launches(path: str, per_rank: list, n_ranks: int) -> None:
    log(f"[main path] {path}: launches per rank {per_rank}")
    if len(per_rank) != n_ranks:
        raise AssertionError(f"{path}: {len(per_rank)} launch records for {n_ranks} processes")
    for r, launches in enumerate(per_rank):
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched by process {r} of the "
                                     f"{path} path")


def mesh_phase(dev, scene, imgs, psnr_single: float) -> dict:
    """Phase 12 (see the module docstring): multi-card training on one card.
    Returns the launches per rank of (a), (b) and (c)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu_splat_torch.gs import cuda_raster as cr
    from tpu_splat_torch.gs.optim import adam_init
    from tpu_splat_torch.gs.params import init_params_from_points
    from tpu_splat_torch.gs.pipeline import eval_split, train_splat
    from tpu_splat_torch.gs.strategy import densify_state_init
    from tpu_splat_torch.gs.trainer import TrainConfig, train_step
    from tpu_splat_torch.mesh.distributed import make_distributed_train_step, make_mesh
    from tpu_splat_torch.mesh.launch import spawn_ranks
    from tpu_splat_torch.mesh.trainer import DistributedTrainer
    from tpu_splat_torch.testing import full_trainer_state, mesh_checks, step_state

    brng = np.random.default_rng(0)
    params = bench_params(brng, 1 << 19, 400_000, dev)
    vms, intrins, images = ring_views(8, 1280, 720, brng)
    capacity, (height, width) = params["means"].shape[0], images.shape[1:3]
    n_alive = int(params["alive"].sum())
    vms_d, images_d = torch.from_numpy(vms).to(dev), torch.from_numpy(images).to(dev)
    cfg = TrainConfig(max_steps=30000, sh_degree=3, random_background=False)
    launches = {}
    run_dir = tempfile.mkdtemp(dir=OUT_DIR)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(run_dir, 'rendezvous')}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device=dev)

        def dist_steps(p, a, d, n_views, n_steps):
            step_fn = make_distributed_train_step(mesh, cfg, width, height, 3, 2.0)
            losses = []
            for i in range(n_steps):
                p, a, d, m, _ = step_fn(p, a, d, images_d[:n_views], vms_d[:n_views],
                                        intrins[:n_views],
                                        torch.zeros((n_views, 1, 1), device=dev),
                                        torch.zeros((n_views, 6), device=dev), i, i)
                losses.append(float(m["loss"]))
            return (p, a, d), losses

        def fresh():
            return ({k: v.clone() for k, v in params.items()}, adam_init(params),
                    densify_state_init(capacity, dev))

        # (a) one NCCL rank against train_step on view 0, then twice again
        cr.reset_launch_counts()
        (pa, aa, da), loss_a = dist_steps(*fresh(), 1, 1)
        torch.cuda.synchronize()
        launches["one NCCL rank"] = [dict(cr.LAUNCHES)]
        check_rank_launches("distributed step, one NCCL rank", launches["one NCCL rank"], 1)
        dist_a = step_state(pa, aa, da)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        p1, a1, d1, m1 = train_step(*fresh(), images_d[0], vms_d[0], intrins[0], 0, gen, 2.0,
                                    cfg, width, height, 3)
        errs = state_errors(dist_a, step_state(p1, a1, d1))
        loss_err = abs(loss_a[0] - float(m1["loss"])) / abs(float(m1["loss"]))
        (pb, ab, db), loss_b = dist_steps(*fresh(), 1, 1)
        same = state_errors(step_state(pb, ab, db), dist_a)
        repeat = [k for k, e in same.items() if e != 0.0 or loss_b != loss_a]

        def timed(fn, n):
            fn()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(n):
                fn()
            ev1.record()
            torch.cuda.synchronize()
            return ev0.elapsed_time(ev1) / n

        state = fresh()
        step_fn = make_distributed_train_step(mesh, cfg, width, height, 3, 2.0)
        zeros_m, zeros_c = torch.zeros((1, 1, 1), device=dev), torch.zeros((1, 6), device=dev)
        dist_ms = timed(lambda: step_fn(*state, images_d[:1], vms_d[:1], intrins[:1], zeros_m,
                                        zeros_c, 0, 0), 5)
        # both with camera-pose gradients, as the distributed step takes them
        single_ms = timed(lambda: train_step(*state, images_d[0], vms_d[0], intrins[0], 0, gen,
                                             2.0, cfg, width, height, 3,
                                             cam_delta=zeros_c[0]), 5)
        worst = max(errs, key=errs.get)
        log(f"[mesh] (a) {{data:1, gauss:1}}, one NCCL rank, {width}x{height} SH3 K=256, "
            f"{capacity} capacity / {n_alive} alive: "
            f"against train_step on the same view: loss {loss_err:.3e} relative, largest "
            f"tensor error {errs[worst]:.3e} of its max ({worst}) over {len(errs)} tensors; "
            f"two identical distributed steps: "
            + ("bit-identical" if not repeat else f"DIFFER in {repeat}")
            + f"; {dist_ms:.2f} ms/step distributed, {single_ms:.2f} ms/step train_step")
        if loss_err > 1e-6 or errs[worst] > 1e-6:
            raise AssertionError(f"(a) the distributed step is not train_step's: {errs}")
        if repeat:
            raise AssertionError(f"(a) two identical distributed steps differ: {repeat}")
        del pa, aa, da, pb, ab, db, p1, a1, d1, state

        # (b) four gloo ranks {data:2, gauss:2} on this card against this
        # process's 2-view mean-of-views step, 2 steps each
        setup = dict(mesh=(2, 2), params={k: v.cpu().numpy() for k, v in params.items()},
                     scene_scale=2.0, full_from=[0],
                     batch=dict(images=images[:2], viewmats=vms[:2], intrins=intrins[:2],
                                masks=np.zeros((2, 1, 1), np.float32),
                                cam_deltas=np.zeros((2, 6), np.float32)),
                     runs=[("full width", cfg, False, 2)])
        t0 = time.time()
        ranks = spawn_ranks(mesh_checks, (setup,), "gloo", ["cuda:0"] * 4)
        spawn_s = time.time() - t0
        (p_ref, a_ref, d_ref), loss_r = dist_steps(*fresh(), 2, 2)
        ref = step_state(p_ref, a_ref, d_ref)
        del p_ref, a_ref, d_ref
        got = ranks[0]["runs"]["full width"]
        errs_b = state_errors(got["state"], ref)
        loss_errs = [abs(g - r) / abs(r) for g, r in zip(got["loss"], loss_r)]
        worst_b = max(errs_b, key=errs_b.get)
        launches["four gloo ranks"] = [r["launches"] for r in ranks]
        rows = [r["shard_rows"] for r in ranks]
        log(f"[mesh] (b) {{data:2, gauss:2}}, four gloo ranks on one card: rank 0 against one "
            f"process's 2-view step over 2 steps: loss {max(loss_errs):.3e} relative, largest "
            f"tensor error {errs_b[worst_b]:.3e} of its max ({worst_b}); shard rows "
            f"{sorted({n for r in rows for n in r.values()})} of {capacity}; "
            + ", ".join(f"rank {r['rank']} {r['runs']['full width']['s_per_step']:.3f} s/step "
                        f"peak {r['runs']['full width']['peak_gib'] or 0:.2f} GiB" for r in ranks)
            + f"; spawn to results {spawn_s:.1f} s")
        check_rank_launches("four gloo ranks", launches["four gloo ranks"], 4)
        if max(loss_errs) > 1e-5 or errs_b[worst_b] > 1e-6:
            raise AssertionError(f"(b) four ranks against one process: {loss_errs} {errs_b}")
        if any(set(r.values()) != {capacity // 2} for r in rows):
            raise AssertionError(f"(b) a rank holds more than its shard: {rows}")
        del ranks, got, ref

        # (c) train_splat(distributed=True) on phase 5's scene, one NCCL rank
        # spawned by the launcher, through the refine at step 500
        ckpt = os.path.join(OUT_DIR, "mesh_checkpoints")
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.time()
        with launch_dir("mesh_launches") as ldir:
            cloud, metrics = train_splat(scene, imgs, max_steps=520, downscale_factor=1,
                                         sh_degree=3, seed=0, checkpoint_dir=ckpt,
                                         checkpoint_every=260, distributed=True,
                                         log_fn=lambda s: log(f"[mesh] (c) {s}"), device=dev)
        train_s = time.time() - t0
        launches["train_splat"] = read_launch_dir(ldir)
        check_rank_launches("train_splat(distributed=True)", launches["train_splat"], 1)
        # the mid-run checkpoint, restored here (a DistributedTrainer in this
        # process's group, as under torchrun), equals the file, and runs on
        saved = torch.load(os.path.join(ckpt, "step_00000260.pt"), weights_only=True)
        n = len(imgs)
        train_idx = np.setdiff1d(np.arange(n), eval_split(n))
        cams = scene.cameras
        intr = np.stack([cams.fx, cams.fy, cams.cx, cams.cy], axis=1).astype(np.float32)
        init = init_params_from_points(scene.points, scene.point_colors,
                                       capacity=saved["params"]["means"].shape[0], sh_degree=3,
                                       device=dev)
        pts = np.asarray(scene.points)
        scale = float(np.mean(np.linalg.norm(pts - pts.mean(0), axis=1))) * 1.1
        tr = DistributedTrainer(init, imgs[train_idx], np.asarray(cams.worldtocams)[train_idx],
                                intr[train_idx], scale,
                                TrainConfig.for_model("splatfacto", 520), mesh=mesh)
        tr.load_checkpoint(ckpt, step=260)
        restored = full_trainer_state(tr)
        want = {"param " + k: v for k, v in saved["params"].items()}
        want.update({"mu " + k: v for k, v in saved["adam_mu"].items()})
        want.update({"nu " + k: v for k, v in saved["adam_nu"].items()})
        want.update({"densify grad_accum": saved["dstate_grad"],
                     "densify count_accum": saved["dstate_count"],
                     "count": saved["adam_count"], "cam_deltas": saved["cam_deltas"]})
        differ = [k for k, v in want.items()
                  if not np.array_equal(restored[k], v.float().numpy() if v.dtype ==
                                        torch.bfloat16 else v.numpy())]
        tr.run(2)
        finite = all(torch.isfinite(v).all() for k, v in tr.params.items() if k != "alive")
        log(f"[mesh] (c) train_splat(distributed=True), one NCCL rank, 520 steps in "
            f"{train_s:.1f} s: {scene.num_points} seed points -> {cloud.num_points} gaussians, "
            f"held-out psnr {metrics['psnr']:.3f} (single card, phase 5: {psnr_single:.3f}); "
            f"the step-260 checkpoint restored here: "
            + ("bit-identical" if not differ else f"DIFFERS in {differ}")
            + f", then 2 more steps {'finite' if finite else 'NOT FINITE'}")
        if not (math.isfinite(metrics["psnr"]) and cloud.num_points != scene.num_points):
            raise AssertionError(f"(c) {cloud.num_points} gaussians from {scene.num_points}, "
                                 f"psnr {metrics['psnr']}")
        if differ or not finite or int(restored["step"]) != 260:
            raise AssertionError(f"(c) the checkpoint did not restore: {differ}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(run_dir, ignore_errors=True)
    log(f"[mesh] launches per rank: {json.dumps(launches)}")
    log(f"[mesh] {card_line()}")
    return launches


def http_get(port: int, path: str, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_post(port: int, path: str, payload: dict, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode(),
                     headers=dict({"Content-Type": "application/json"}, **(headers or {})))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def web_phase(steps: int) -> None:
    """Phase 13 (see the module docstring): the web console runs phase 11's
    job and serves what it made."""
    import shutil

    from tpu_splat_torch.core.ply import load_ply
    from tpu_splat_torch.web.server import start_background
    from tpu_splat_torch.web.splat_format import cloud_to_splat_bytes

    capture = os.path.join(OUT_DIR, "global_sfm", "capture.zip")
    root = os.path.join(OUT_DIR, "web")
    shutil.rmtree(root, ignore_errors=True)
    httpd = start_background(root, port=0)
    port = httpd.server_address[1]
    uuid = "chip-smoke-web-job"
    try:
        job = {"uuid": uuid, "inputPath": capture, "sfm": {"softwareName": "glomap"},
               "training": {"maxSteps": steps}}
        codes = {"validateOnly": http_post(port, "/api/jobs", dict(job, validateOnly=True))[0],
                 "malformed": http_post(port, "/api/jobs", {"uuid": "bad", "inputPath": "",
                                                            "validateOnly": True})[0]}
        if codes != {"validateOnly": 200, "malformed": 400}:
            raise AssertionError(f"job validation answered {codes}")
        t0 = time.time()
        with launch_dir("web_launches") as ldir:
            code, body = http_post(port, "/api/jobs", job)
            if code != 202:
                raise AssertionError(f"the job was not accepted: {code} {body}")
            while True:
                status, raw = http_get(port, f"/api/jobs/{uuid}")
                rec = json.loads(raw) if status == 200 else {}
                if rec.get("status") in ("Complete", "Error") and not rec.get("running"):
                    break
                if status == 200 and not rec.get("running") and rec.get("status") is None:
                    raise AssertionError("the job process ended without a record")
                if time.time() - t0 > 300:
                    raise AssertionError("the web job did not complete within 300 s")
                time.sleep(1.0)
        job_s = time.time() - t0
        job_log = os.path.join(root, "web_jobs", f"{uuid}.log")
        if rec["status"] != "Complete":
            raise AssertionError(f"the web job ended {rec['status']}: see {job_log}")
        per_process = read_launch_dir(ldir)
        check_rank_launches("web console job", per_process, 1)
        ply_path = rec["artifacts"]["ply"]
        status, served = http_get(port, f"/api/splat/{uuid}")
        want = cloud_to_splat_bytes(load_ply(ply_path))
        status_ply, served_ply = http_get(port, f"/artifacts/{uuid}/splat.ply")
        with open(ply_path, "rb") as f:
            ply_bytes = f.read()
        refused = {"..": http_get(port, f"/artifacts/{uuid}/../splat.ply")[0],
                   "cross-origin": http_post(port, "/api/jobs", dict(job, validateOnly=True),
                                             {"Origin": "http://elsewhere.example"})[0]}
        log(f"[web] job {uuid} (phase 11's capture, glomap, maxSteps {steps}) through the "
            f"console: {rec['status']} in {job_s:.1f} s (its record: {rec.get('elapsed', 0):.1f} "
            f"s; {int(rec['metrics']['num_gaussians'])} gaussians, psnr "
            f"{rec['metrics']['psnr']:.3f}); /api/splat {len(served)} bytes, "
            f"{'byte-identical' if served == want else 'DIFFERS'} to cloud_to_splat_bytes of "
            f"its splat.ply; /artifacts splat.ply "
            f"{'byte-identical' if served_ply == ply_bytes else 'DIFFERS'}; refused {refused}; "
            f"launches {per_process}; the job's log: {os.path.relpath(job_log, ROOT)}")
        if status != 200 or served != want:
            raise AssertionError(f"/api/splat answered {status}, not the splat's buffer")
        if status_ply != 200 or served_ply != ply_bytes:
            raise AssertionError(f"/artifacts answered {status_ply}, not the .ply")
        if refused != {"..": 400, "cross-origin": 403}:
            raise AssertionError(f"the server did not refuse: {refused}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[web] {card_line()}")


def matnet_grads(seed: int, device, dtype, imgs, masks) -> dict:
    """MatNet's loss gradients at init_params(seed) on one batch, computed
    in `dtype` on `device`, as f64 CPU tensors by parameter name."""
    import torch

    from tpu_splat_torch.matting import train as mtrain

    net = mtrain.init_train_state(seed, device).net.to(dtype)
    x = torch.from_numpy(imgs).to(device, dtype).permute(0, 3, 1, 2).contiguous()
    with mtrain.deterministic_cudnn():
        loss, _ = mtrain.matnet_loss(net(x), torch.from_numpy(masks).to(device, dtype))
        loss.backward()
    return {k: p.grad.double().cpu() for k, p in net.named_parameters()}


def matnet_train_phase(dev) -> None:
    """Phase 14 (see the module docstring): MatNet training at full width."""
    import torch

    from tpu_splat_torch.matting import train as mtrain
    from tpu_splat_torch.matting.matnet import (bundled_weights_path, load_matnet,
                                                matnet_params, matnet_saliency)
    from tpu_splat_torch.matting.synthdata import make_batch

    batch, lr, seed = 16, 3e-4, 0
    rng = np.random.default_rng(seed + 1)  # train_matnet's own first batches
    t0 = time.perf_counter()
    batches = [make_batch(rng, batch) for _ in range(MATNET_REPEAT_STEPS)]
    batch_s = (time.perf_counter() - t0) / len(batches)

    # the first 3 steps on the card against the CPU, on the same batches
    states = {"card": mtrain.init_train_state(seed, dev),
              "cpu": mtrain.init_train_state(seed, "cpu")}
    errs = []
    for i, (imgs, masks) in enumerate(batches[:3], 1):
        out = {d: [float(v) for v in mtrain.train_step(st, imgs, masks, i, lr, MATNET_STEPS)]
               for d, st in states.items()}
        errs.append([abs(out["card"][j] - out["cpu"][j]) / abs(out["cpu"][j]) for j in (0, 1)])
        if i == 1:
            grads = {d: {k: p.grad.double().cpu() for k, p in st.net.named_parameters()}
                     for d, st in states.items()}
    params = {d: matnet_params(st.net) for d, st in states.items()}
    del states
    diffs = np.concatenate([np.abs(params["card"][k] - v).ravel()
                            for k, v in params["cpu"].items()])
    # step 1's gradients once more in f64 on each device: the exact yardstick
    grads64 = {d: matnet_grads(seed, dv, torch.float64, *batches[0])
               for d, dv in (("card", dev), ("cpu", "cpu"))}

    def grad_gap(a, b):  # the largest over tensors of max |a - b| / max |b|
        return max(float((a[k] - g).abs().max() / g.abs().max()) for k, g in b.items())

    gap32, gap64 = grad_gap(grads["card"], grads["cpu"]), grad_gap(grads64["card"],
                                                                   grads64["cpu"])
    exact = {d: grad_gap(grads[d], grads64["cpu"]) for d in grads}
    log(f"[matnet-train] batch {batch}, 256x256, steps 1-3, card against CPU: loss "
        f"{', '.join(f'{e[0]:.2e}' for e in errs)} and soft IoU "
        f"{', '.join(f'{e[1]:.2e}' for e in errs)} relative; step 1's gradients "
        f"{gap64:.2e} of each tensor's max in f64, {gap32:.2e} in f32 (f32 against f64: card "
        f"{exact['card']:.2e}, CPU {exact['cpu']:.2e}); parameters after 3 steps max abs "
        f"{diffs.max():.3e}, {np.mean(diffs <= 1e-5):.4%} of {diffs.size} within 1e-5")
    # At this size each device's f32 gradients sit 1e-4 or more of a tensor's
    # max from the exact ones (the biases of the convolutions before each
    # group norm get small residuals of sums over a million terms; 1.02e-4 on
    # the CPU and 3.09e-4 on the card on the H100's machine): two f32
    # results cannot be held within 1e-4 of each other. So the CPU test's
    # 1e-4 holds the f64 gradients and the f32 losses, and 1e-3 the f32
    # gradients and the parameters.
    if not (max(max(e) for e in errs) <= 1e-4 and gap64 <= 1e-4 and gap32 <= 1e-3
            and diffs.max() <= 1e-3):
        raise AssertionError("MatNet training on the card differs from the CPU")

    # two runs of MATNET_REPEAT_STEPS steps from one seed on the same batches
    on_card = [(torch.from_numpy(i).to(dev), torch.from_numpy(m).to(dev)) for i, m in batches]
    runs, run_ms = [], []
    for _ in range(2):
        st = mtrain.init_train_state(seed, dev)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        for i, (imgs, masks) in enumerate(on_card, 1):
            mtrain.train_step(st, imgs, masks, i, lr, MATNET_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        run_ms.append(ev0.elapsed_time(ev1) / len(on_card))
        runs.append({**{k: p.detach().clone() for k, p in st.net.named_parameters()},
                     **{f"m.{k}": t for k, t in st.m.items()},
                     **{f"v.{k}": t for k, t in st.v.items()}})
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    log(f"[matnet-train] two {MATNET_REPEAT_STEPS}-step runs from seed {seed}: "
        + ("bit-identical" if not differ else f"{len(differ)} tensors differ: {differ}")
        + f" over {len(runs[0])} tensors (parameters and both moments); "
        f"{run_ms[0]:.2f} and {run_ms[1]:.2f} ms a step with the batches on the card")
    if differ:
        raise AssertionError(f"two identical MatNet training runs differ: {differ}")
    busy_ms = profile_steps(lambda i: mtrain.train_step(st, *on_card[i % len(on_card)], i, lr,
                                                        MATNET_STEPS),
                            len(on_card) + 1, 3, run_ms[1], "matnet-profile")
    del runs, on_card, st

    # the script's run, cut to MATNET_STEPS steps
    path = os.path.join(OUT_DIR, "matnet_trained.npz")
    res = mtrain.train_matnet(MATNET_STEPS, batch, lr, seed, out=path, device=dev,
                              log_fn=lambda s: log(f"[matnet-train] {s}"))
    losses = res["losses"]
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    step_ms = float(np.median(res["step_ms"]))
    wall_ms = res["seconds"] * 1e3 / MATNET_STEPS
    log(f"[matnet-train] train_matnet {MATNET_STEPS} steps in {res['seconds']:.1f} s: mean loss "
        f"{first:.4f} over steps 1-20, {last:.4f} over the last 20; card {step_ms:.2f} ms a "
        f"step (median of CUDA events around each step), host {res['data_s'] / MATNET_STEPS:.3f} "
        f"s a step making batches ({batch_s:.3f} s for the first {MATNET_REPEAT_STEPS}), "
        f"{wall_ms:.1f} ms a step of wall-clock: the device is idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}% of it (busy {busy_ms:.2f} ms a step)")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"MatNet's loss did not fall: {first:.4f} -> {last:.4f}")
    with np.load(path) as z, np.load(bundled_weights_path()) as zb:
        layout = {k: (z[k].shape, z[k].dtype) for k in z.files}
        want = {k: (zb[k].shape, zb[k].dtype) for k in zb.files}
    if layout != want:
        raise AssertionError(f"the trained npz's layout differs from the bundled file's: "
                             f"{sorted(set(layout.items()) ^ set(want.items()))}")
    load_matnet(path, dev)
    imgs = batches[0][0][:4]
    sal = matnet_saliency(imgs, path, device=dev)
    if not (sal.shape == imgs.shape[:3] and np.isfinite(sal).all()):
        raise AssertionError(f"matnet_saliency on the trained weights: {sal.shape}")
    held = {name: mtrain.evaluate(p, dev, lambda s, n=name: log(f"[matnet-train] {n}: {s}"))
            for name, p in (("trained", path), ("bundled", bundled_weights_path()))}
    log(f"[matnet-train] held-out IoU, trained {MATNET_STEPS} steps against bundled: scene "
        f"{held['trained']['scene'][0]:.3f} / {held['bundled']['scene'][0]:.3f}, fresh batch "
        f"{held['trained']['fresh'][0]:.3f} / {held['bundled']['fresh'][0]:.3f}")
    log(f"[matnet-train] {card_line()}")


def multivideo_phase(steps: int) -> None:
    """Phase 15 (see the module docstring): a multi-video property scan
    through the CLI, held to the reference's recorded outcome."""
    import shutil

    from tpu_splat_torch.core.spz import load_spz
    from tpu_splat_torch.pipeline import runner

    ref = MULTIVIDEO_REFERENCE
    root = os.path.join(OUT_DIR, "multivideo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.time()
    paths = multivideo_capture(root)
    (w, h), n_views = MULTIVIDEO_SIZE, len(MULTIVIDEO_ANGLES)
    log(f"[multivideo] capture: core/meshrender's capture scene from {n_views} angles of its "
        f"orbit, {w}x{h}, fx {MULTIVIDEO_FOCAL}, as two mp4v videos of frames "
        + " and ".join(f"{idx.start}-{idx.stop - 1}" for _, idx in MULTIVIDEO_SEGMENTS)
        + f" ({sum(os.path.getsize(p) for p in paths) / 2**20:.2f} MiB), rendered on the "
        f"host and written in {time.time() - t0:.1f} s")
    uuid, out = "chip-smoke-multivideo", os.path.join(root, "out")
    job_path = os.path.join(root, "job.json")
    with open(job_path, "w") as f:
        json.dump(multivideo_job(paths, uuid, out, steps), f)
    with decoded_media(runner) as seen:
        res, lines, launches, job_s = run_cli_job(job_path, "multi-video job",
                                                  "multivideo_log.txt")
    check_capture(seen["images"], MULTIVIDEO_PIXELS, ref)
    metrics, segments = res["metrics"], seen["segments"]
    n_img, n_reg = int(metrics["num_images"]), int(metrics["num_registered"])
    if n_img != sum(segments):
        raise AssertionError(f"SfM saw {n_img} images, the videos gave {segments}")
    _, n_pts = check_job_artifacts(root, out, uuid, res, n_img)
    poses = model_poses(out)
    per_video = registered_per_segment(poses, segments)
    rmse = model_rmse(poses, multivideo_viewmats())
    bar = max(2 * ref["rmse"], 0.01 * ORBIT_DIAMETER)
    n_g = load_spz(res["artifacts"]["spz"]).num_points
    n_eval = int(metrics["eval_views"])
    # the forward renders each held-out view once more; under 16 registered
    # train_splat scores every (n // 4)-th train view instead
    n_scored = n_eval or len(range(0, n_reg, max(n_reg // 4, 1)))
    log_job("multivideo", res, lines, steps)
    log(f"[multivideo] {n_img} frames (per video {segments}, reference {ref['segments']}); "
        f"registered {n_reg} (per video {per_video}; reference {ref['registered']}), {n_pts} "
        f"points; camera-centre RMSE {rmse / ORBIT_DIAMETER:.5f} of the orbit's diameter "
        f"(reference {ref['rmse'] / ORBIT_DIAMETER:.5f}, bar {bar / ORBIT_DIAMETER:.5f}); "
        f".spz read back with {n_g} gaussians")
    log(f"[multivideo] CLI run {job_s:.1f} s (launches {launches}; {steps} steps and "
        f"{n_scored} views scored)")
    log(f"[multivideo] {card_line()}")
    if segments != ref["segments"]:
        raise AssertionError(f"the videos gave {segments} frames, the reference's "
                             f"{ref['segments']}")
    # each video alone holds 13 frames: more than 13, and some of each, is
    # both videos in one model
    if not (min(per_video) > 0 and n_reg > 13):
        raise AssertionError(f"registered {n_reg} frames, per video {per_video}: not both "
                             "videos in one model")
    if abs(n_reg - ref["registered"]) > 2:
        raise AssertionError(f"the multi-video job registered {n_reg}, the reference "
                             f"{ref['registered']}")
    if rmse > bar:
        raise AssertionError(f"camera-centre RMSE {rmse:.4f} > {bar:.4f}")
    if not (n_g == int(metrics["num_gaussians"]) and n_g > 100):
        raise AssertionError(f"the .spz holds {n_g} gaussians (trained "
                             f"{metrics['num_gaussians']}); at least 101 are needed")
    if launches != {"composite_fwd": steps + n_scored, "composite_bwd": steps, "adam": steps}:
        raise AssertionError(f"launches {launches}: {steps} steps and {n_scored} scored views "
                             "were expected")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpu_splat_torch import kernel_build
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.core.ply import load_ply, save_ply
    from tpu_splat_torch.core.spz import load_spz, save_spz
    from tpu_splat_torch.gs import cuda_raster as cr
    from tpu_splat_torch.gs.optim import adam_init
    from tpu_splat_torch.gs.pipeline import train_splat
    from tpu_splat_torch.gs.strategy import densify_state_init
    from tpu_splat_torch.gs.trainer import TrainConfig, train_step

    t_start = time.time()
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. card
    log(card_line())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    for lib_name in ("composite", "adam"):
        t0 = time.time()
        lib_path, build_log = kernel_build.build(lib_name)
        log(f"[build] {os.path.relpath(lib_path, ROOT)} in {time.time() - t0:.1f} s")
        for line in build_log.splitlines():
            keys = ("entry function", "registers", "spill")
            if any(key in line for key in keys) or "error" in line.lower():
                log(f"[build] {line.strip()}")
            if re.search(r"\b[1-9]\d* bytes spill", line):
                raise AssertionError(f"a kernel spills registers: {line.strip()}")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(1)
    for fx_name, fx_count in (("fixture", None), ("ragged fixture", RAGGED_COUNTS)):
        fx_packed, fx_counts = build_packed(rng, 12, 2 * cr.CHUNK, 4, counts=fx_count)
        compare(fx_name, torch.from_numpy(fx_packed).to(dev),
                torch.from_numpy(fx_counts).to(dev), 4, 3, rng)

    width, height, capacity, n_alive = 1280, 720, 1 << 19, 400_000
    tx, ty = math.ceil(width / 16), math.ceil(height / 16)
    brng = np.random.default_rng(0)
    params = bench_params(brng, capacity, n_alive, dev)
    vms, intrins, images = ring_views(8, width, height, brng)
    vms_d = torch.from_numpy(vms).to(dev)
    images_d = torch.from_numpy(images).to(dev)
    measured = {}
    for k in (256, 1024):
        packed, counts = real_packed(params, vms_d[0], [float(v) for v in intrins[0]],
                                     width, height, k)
        measured[k] = compare(f"1280x720 K={k}", packed, counts, tx, ty, rng, timing_reps=20)
        del packed, counts
    torch.cuda.empty_cache()
    adam_measured = compare_adam(dev)
    torch.cuda.empty_cache()

    # 4. full width: bench.py's train_step workload (K=256)
    cfg = TrainConfig(max_steps=30000, sh_degree=3, random_background=False)
    adam = adam_init(params)
    dstate = densify_state_init(capacity, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()

    def step(i, state):
        p, a, d = state
        v = i % 8
        p, a, d, m = train_step(p, a, d, images_d[v], vms_d[v], intrins[v], i, gen, 2.0,
                                cfg, width, height, 3)
        return (p, a, d), m

    state = (params, adam, dstate)
    cr.reset_launch_counts()
    for i in range(3):  # warm-up
        state, metrics = step(i, state)
    torch.cuda.synchronize()
    n_steps = 20
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for i in range(3, 3 + n_steps):
        state, metrics = step(i, state)
    ev1.record()
    torch.cuda.synchronize()
    step_ms = ev0.elapsed_time(ev1) / n_steps
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"full-width loss is not finite: {loss}")
    for name, v in state[0].items():
        if v.dtype.is_floating_point and not torch.isfinite(v).all():
            raise AssertionError(f"full-width parameter {name} is not finite")
    log(f"[full] 512K capacity / 400K alive, 1280x720, SH3, K=256: {step_ms:.2f} ms/step "
        f"over {n_steps} steps ({1000.0 / step_ms:.2f} it/s), final loss {loss:.5f}, "
        f"psnr {float(metrics['psnr']):.3f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(lambda i: step(i, state), 3 + n_steps, 5, step_ms)
    launches_full = main_path_launches("full-width train_step")
    if launches_full["adam"] != launches_full["composite_bwd"]:
        raise AssertionError(f"launches {launches_full}: one Adam launch a step was expected")
    # two identical steps must agree bit for bit (then again with the
    # parent's atomic pack-gather backward, for the record)
    diffs = repeat_step(step, state, 3 + n_steps)
    diffs_parent = repeat_step(step, state, 3 + n_steps, atomic_pack_gather_bwd)
    log(f"[determinism] two identical train_steps from one state: "
        f"{'bit-identical' if not diffs else f'{len(diffs)} tensors differ: {diffs}'} "
        f"over {len(state[0]) + 2 * len(state[1].mu) + len(state[2])} tensors; with the "
        f"parent's index_add_ backward: "
        + ("bit-identical" if not diffs_parent else
           f"{len(diffs_parent)} differ, the largest by "
           f"{max(d for _, d in diffs_parent):.3e} ({[n for n, _ in diffs_parent]})"))
    if diffs:
        raise AssertionError(f"two identical train_steps differ: {diffs}")
    layers = layer_times(state[0], vms_d[0], [float(v) for v in intrins[0]], images_d[0],
                         width, height, cfg.max_per_tile)
    layers.update(pack_gather_bwd_times(state[0], vms_d[0], [float(v) for v in intrins[0]],
                                        width, height, cfg.max_per_tile))
    log("[layers] alone, ms: " + ", ".join(f"{n} {t:.3f}" for n, t in layers.items())
        + f"; kernels fwd {measured[256]['fwd_ms']:.3f} bwd {measured[256]['bwd_ms']:.3f}")
    del state, params, adam, dstate, images_d
    torch.cuda.empty_cache()

    # 5. end to end: train_splat through one refine pass, then export
    scene, imgs = smoke_scene(dev)
    _, metrics0 = train_splat(scene, imgs, max_steps=0, downscale_factor=1, sh_degree=3,
                              device=dev)
    cr.reset_launch_counts()
    t0 = time.time()
    cloud, metrics5 = train_splat(scene, imgs, max_steps=520, downscale_factor=1,
                                  sh_degree=3, seed=0, log_fn=lambda s: log(f"[e2e] {s}"),
                                  device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    launches_e2e = main_path_launches("train_splat")
    if launches_e2e["adam"] != launches_e2e["composite_bwd"]:
        raise AssertionError(f"launches {launches_e2e}: one Adam launch a step was expected")
    # the refine pass at step 500 must have changed the population
    if not (math.isfinite(metrics5["psnr"]) and cloud.num_points != scene.num_points):
        raise AssertionError(f"train_splat produced {cloud.num_points} gaussians from "
                             f"{scene.num_points}, held-out psnr {metrics5['psnr']}")
    os.makedirs(OUT_DIR, exist_ok=True)
    ply_path = os.path.join(OUT_DIR, "smoke.ply")
    spz_path = os.path.join(OUT_DIR, "smoke.spz")
    save_ply(cloud, ply_path)
    save_spz(cloud, spz_path)
    n_ply, n_spz = load_ply(ply_path).num_points, load_spz(spz_path).num_points
    if not n_ply == n_spz == cloud.num_points:
        raise AssertionError(f"export counts {n_ply}/{n_spz} != {cloud.num_points}")
    log(f"[e2e] train_splat 520 steps in {e2e_s:.1f} s: {scene.num_points} seed points -> "
        f"{cloud.num_points} gaussians, held-out psnr {metrics0['psnr']:.3f} -> "
        f"{metrics5['psnr']:.3f} "
        f"over {int(metrics5['eval_views'])} views; .ply/.spz reloaded with {n_ply} gaussians")

    # 6. SfM at a real size
    sfm_images = sfm_phase(dev, np.random.default_rng(6))

    # 7. a default job on phase 6's frames, through the CLI
    job_phase(sfm_images, JOB_STEPS)

    # 8. a --remove-background job, and the matting nets against the CPU
    remove_background_phase(dev, OPTION_STEPS)

    # 9. a --spherical job on ERP frames rendered by the port
    spherical_phase(dev, OPTION_STEPS)

    # 10. a pose-prior job with every extra, on phase 6's frames
    walk = walk_viewmats(len(sfm_images))
    pose_prior_phase(sfm_images, walk, SFM_FOCAL, dev, OPTION_STEPS)

    # 11. a global-SfM job on phase 7's capture
    global_sfm_phase(sfm_images, walk, OPTION_STEPS)
    del sfm_images
    torch.cuda.empty_cache()

    # 12. multi-card training on the one card: one NCCL rank, four gloo
    # ranks, and train_splat's launcher on phase 5's scene
    mesh_phase(dev, scene, imgs, metrics5["psnr"])
    torch.cuda.empty_cache()

    # 13. the web console runs phase 11's job and serves its splat
    web_phase(OPTION_STEPS)

    # 14. MatNet training at full width
    t0 = time.time()
    matnet_train_phase(dev)
    log(f"[matnet-train] phase 14 in {time.time() - t0:.1f} s")

    # 15. a multi-video property scan, through the CLI
    t0 = time.time()
    multivideo_phase(OPTION_STEPS)
    log(f"[multivideo] phase 15 in {time.time() - t0:.1f} s")

    m1024 = measured[1024]
    log("[kernels] K=1024 full-width: " + json.dumps({
        key: m1024[key] for key in ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "bwd_ms",
                                    "bwd_plain_ms", "bwd_bound_ms")}))
    log(f"[done] {time.time() - t_start:.1f} s")

    m = measured[256]
    src = "tpu_splat_torch/csrc/composite.cu"
    kernels = [
        {"name": "composite_fwd", "route": "cuda", "source": src,
         "replaces": "tpu_splat/gs/pallas_raster.py:328",
         "launches": launches_full["composite_fwd"],
         "max_abs_err": m["fwd_err"], "ms": m["fwd_ms"], "plain_ms": m["fwd_plain_ms"],
         "bound_ms": m["fwd_bound_ms"], "bound_by": m["fwd_bound_by"], "library_ms": None},
        {"name": "composite_bwd", "route": "cuda", "source": src,
         "replaces": "tpu_splat/gs/pallas_raster.py:366",
         "launches": launches_full["composite_bwd"],
         "max_abs_err": m["bwd_abs"], "ms": m["bwd_ms"], "plain_ms": m["bwd_plain_ms"],
         "bound_ms": m["bwd_bound_ms"], "bound_by": m["bwd_bound_by"], "library_ms": None},
        {"name": "adam", "route": "cuda", "source": "tpu_splat_torch/csrc/adam.cu",
         "replaces": None, "launches": launches_full["adam"],
         "max_rel_err": adam_measured["max_rel"], "ms": adam_measured["ms"],
         "plain_ms": adam_measured["plain_ms"], "bound_ms": adam_measured["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
