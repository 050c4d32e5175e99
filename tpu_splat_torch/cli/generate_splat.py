"""generate_splat: build and run a reconstruction job with the PyTorch/CUDA
port (the port of tpu_splat/cli/generate_splat.py; the reference's
source/generate_splat.py analog, local-first).

    python -m tpu_splat_torch.cli.generate_splat capture.zip -o out/ \\
        [--preset fast|medium|high] [--remove-background] [--spherical] [--job-only]

Writes a reference-schema job JSON and either runs it with the port's CLI
(`tpu_splat_torch.cli.main run`, on the GPU; `--device cpu` for the CPU) or,
with --job-only, just emits the file. --remove-background and --spherical
exclude each other: the background masks are made per equirectangular
frame, and the job runner refuses the pair. Quality presets mirror
submit_property_job.py:67-143: fast (5k steps / sequential / <=150 images),
medium (15k / spatial / <=300), high (30k / exhaustive / <=500).
"""

from __future__ import annotations

import argparse
import json
import os
import uuid as uuid_mod

PRESETS = {
    "fast": dict(max_steps=5000, matching="sequential", max_images=150),
    "medium": dict(max_steps=15000, matching="spatial", max_images=300),
    "high": dict(max_steps=30000, matching="exhaustive", max_images=500),
}


def build_job_json(
    input_path: str,
    output_path: str = "output",
    preset: str = "medium",
    model: str = "splatfacto",
    remove_background: bool = False,
    spherical: bool = False,
    job_uuid: str = "",
) -> dict:
    p = PRESETS[preset]
    return {
        "uuid": job_uuid or str(uuid_mod.uuid4()),
        "instanceType": "gpu-h100",
        "logVerbosity": "info",
        "inputPath": input_path,
        "outputPath": output_path,
        "s3": {"bucketName": "", "inputPrefix": "", "inputKey": os.path.basename(input_path),
               "outputPrefix": "workflow-output"},
        "videoProcessing": {"maxNumImages": p["max_images"]},
        "imageProcessing": {"filterBlurryImages": True},
        "sfm": {
            "enable": True,
            "softwareName": "native",
            "enableEnhancedFeatureExtraction": True,
            "matchingMethod": p["matching"],
            "posePriors": {
                "usePosePriorColmapModelFiles": False,
                "usePosePriorTransformJson": {
                    "enable": False,
                    "sourceCoordinateName": "arkit",
                    "poseIsWorldToCam": True,
                },
            },
        },
        "training": {
            "enable": True,
            "maxSteps": p["max_steps"],
            "model": model,
            "enableMultiGpu": False,
            "rotateSplat": True,
        },
        "sphericalCamera": {
            "enable": spherical,
            "cubeFacesToRemove": "",
            "optimizeSequentialFrameOrder": True,
        },
        "segmentation": {
            "removeBackground": remove_background,
            "backgroundRemovalModel": "u2net",
            "maskThreshold": 0.6,
            "removeHumanSubject": False,
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="video, zip of images, or image directory")
    p.add_argument("--output", "-o", default="output")
    p.add_argument("--preset", choices=list(PRESETS), default="medium")
    p.add_argument("--model", default="splatfacto")
    p.add_argument("--remove-background", action="store_true")
    p.add_argument("--spherical", action="store_true")
    p.add_argument("--job-only", action="store_true",
                   help="write the job JSON without running")
    p.add_argument("--device", default=None,
                   help="torch device for the run (default: cuda)")
    args = p.parse_args(argv)
    if args.remove_background and args.spherical:
        # the job runner refuses the pair (runner._refuse_unsupported)
        p.error("--remove-background and --spherical cannot be combined: the background "
                "masks are made per equirectangular frame, not per cube-face view")

    job = build_job_json(
        args.input, args.output, args.preset, args.model,
        args.remove_background, args.spherical,
    )
    os.makedirs(args.output, exist_ok=True)
    job_path = os.path.join(args.output, f"{job['uuid']}.json")
    with open(job_path, "w") as f:
        json.dump(job, f, indent=2)
    print(f"job JSON: {job_path}")
    if args.job_only:
        return 0
    from tpu_splat_torch.cli.main import cmd_run

    return cmd_run(argparse.Namespace(job=job_path, input=None, output=None,
                                      device=args.device))


if __name__ == "__main__":
    import sys

    sys.exit(main())
