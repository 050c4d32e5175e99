"""tpu-splat-torch CLI: run a reconstruction job with the PyTorch/CUDA port.

Usage:
  tpu-splat-torch run job.json
  tpu-splat-torch run --input capture.mp4 --output out/ --max-steps 7000 --model splatfacto
  tpu-splat-torch convert splat.ply      # .ply <-> .spz via the native codec
  tpu-splat-torch serve out/             # web console + in-browser viewer
  tpu-splat-torch status out/ <uuid>     # job store lookup

(or `python -m tpu_splat_torch.cli.main ...`). Jobs run on the GPU; `--device
cpu` runs one on the CPU (for `serve`, every job it runs). The job-JSON schema
matches the reference toolbox (generate_splat.py:48-96), so existing job
files drive this CLI unchanged. `convert` builds the repo's C++ codec
(native/spz) with the C++ compiler at first use.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _setup_logging(verbosity: str):
    level = {"debug": logging.DEBUG, "info": logging.INFO, "error": logging.ERROR}.get(
        verbosity, logging.INFO
    )
    logging.basicConfig(level=level, format="%(asctime)s %(name)s: %(message)s")


def cmd_run(args) -> int:
    from tpu_splat_torch.core.config import JobConfig, job_config_from_json
    from tpu_splat_torch.core.errors import PipelineError
    from tpu_splat_torch.pipeline.runner import run_job

    if args.job:
        with open(args.job) as f:
            cfg = job_config_from_json(json.load(f))
        if args.input:
            cfg.input_path = args.input
        if args.output:
            cfg.output_path = args.output
    else:
        cfg = JobConfig(input_path=args.input or "", output_path=args.output or "output")
        if args.max_steps:
            cfg.training.max_steps = args.max_steps
        if args.model:
            cfg.training.model = args.model
        if args.matching:
            cfg.sfm.matching_method = args.matching
        if args.max_images:
            cfg.video_processing.max_num_images = args.max_images
        if args.max_features:
            cfg.sfm.max_features_per_image = args.max_features
    _setup_logging(cfg.log_verbosity)
    try:
        result = run_job(cfg, log_fn=None, device=args.device)
    except PipelineError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "uuid": result.uuid,
        "status": result.status,
        "artifacts": result.artifacts,
        "metrics": result.metrics,
        "timings": result.timings,
    }, indent=2))
    return 0


def cmd_convert(args) -> int:
    from tpu_splat_torch.export.native import run_splat_converter

    out = run_splat_converter(args.input)
    print(f"Converted {args.input} to {out}")
    return 0


def cmd_serve(args) -> int:
    from tpu_splat_torch.web.server import serve

    serve(args.output, host=args.host, port=args.port, open_browser=not args.no_browser,
          device=args.device)
    return 0


def cmd_status(args) -> int:
    from tpu_splat_torch.pipeline.runner import JobStore

    store = JobStore(args.output)
    print(json.dumps(store.get(args.uuid), indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-splat-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a reconstruction job")
    pr.add_argument("job", nargs="?", help="job JSON path (reference schema)")
    pr.add_argument("--input", "-i", help="input media (video/zip/image dir)")
    pr.add_argument("--output", "-o", help="output directory")
    pr.add_argument("--max-steps", type=int, default=0)
    pr.add_argument("--model", default="")
    pr.add_argument("--matching", default="")
    pr.add_argument("--max-images", type=int, default=0)
    pr.add_argument("--max-features", type=int, default=0)
    pr.add_argument("--device", default=None,
                    help="torch device of the job (default: cuda; 'cpu' runs it on the CPU)")
    pr.set_defaults(fn=cmd_run)

    pc = sub.add_parser("convert", help="convert .ply <-> .spz (native codec)")
    pc.add_argument("input")
    pc.set_defaults(fn=cmd_convert)

    pv = sub.add_parser("serve", help="web console + splat viewer for an output directory")
    pv.add_argument("output", nargs="?", default="output",
                    help="output directory (job store root)")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8085)
    pv.add_argument("--no-browser", action="store_true")
    pv.add_argument("--device", default=None,
                    help="torch device of the jobs it runs (default: cuda)")
    pv.set_defaults(fn=cmd_serve)

    ps = sub.add_parser("status", help="look up job status in the job store")
    ps.add_argument("output", help="output directory used by the job")
    ps.add_argument("uuid")
    ps.set_defaults(fn=cmd_status)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
