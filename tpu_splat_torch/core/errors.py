"""Pipeline error-code taxonomy (the port's copy of tpu_splat/core/errors.py).

Mirrors the reference's numbered error codes (main.py:45-70) so users of the
reference can map failures 1:1. Codes are raised as PipelineError and surfaced by
the orchestrator in the completion report.
"""

from __future__ import annotations

ERROR_MESSAGES = {
    700: "Error reading camera parameters from file",
    705: (
        "Input file type not supported. Only .mp4, .mov, and .zip with .png or "
        ".jpeg/.jpg files are supported for input"
    ),
    710: "Required configuration fields not set. Check that the job payload has the required fields",
    715: (
        "Configuration not supported. Only pose prior transform json or pose prior "
        "colmap model files can be enabled, not both."
    ),
    720: "Improper file type given for prior pose transformations. Only '.zip' is supported.",
    725: "Issue transforming pose to Colmap component",
    730: "Issue creating video to images component",
    735: "Issue creating spherical image component",
    740: "Issue creating background removal component",
    745: "Issue creating human subject removal component",
    750: "SfM software name given not implemented",
    755: "Issue creating the SfM component",
    760: "Issue creating the camera-conversion component",
    765: "Model not supported",
    767: "Trainer specified does not match proper configuration",
    770: "Issue running the training session, stage 1",
    780: "Issue exporting splat",
    781: "Issue rotating splat before SPZ conversion",
    782: "Issue mirroring the splat before SPZ conversion",
    783: "Issue creating compressed SPZ splat",
    784: "Issue rotating splat after SPZ conversion",
    785: "Issue mirroring splat after SPZ conversion",
    786: "Issue uploading asset to artifact sink",
    790: "The archive doesn't contain supported image files .jpg, .jpeg, or .png",
    795: "General error running the pipeline",
}


class PipelineError(RuntimeError):
    """A pipeline failure with a numbered error code from the taxonomy above."""

    def __init__(self, code: int, detail: str = ""):
        self.code = code
        base = ERROR_MESSAGES.get(code, "Unknown error")
        msg = f"[{code}] {base}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def is_sfm_failure(message: str) -> bool:
    """Classify an error message as an SfM convergence failure.

    Port of the failure-fingerprint logic in the reference completion Lambda
    (workflow_complete.py:125-139): these patterns indicate the input capture had
    insufficient overlap/features rather than a software fault.
    """
    patterns = [
        "sfm failed to converge",
        "keeplargestconnectedcomponents",
        "torch.multinomial",
        "no images are registered",
        "not enough sparse points",
        "not enough registered frames",
        "solverfailure",
    ]
    low = message.lower()
    return any(p in low for p in patterns)


SFM_FAILURE_REMEDIATION = (
    "Structure-from-motion could not reconstruct the scene from the provided media. "
    "This usually means the capture has insufficient overlap between frames, too much "
    "motion blur, or too few distinctive features. Try: capturing with more overlap "
    "(60-80% between consecutive frames), moving the camera more slowly, adding more "
    "images of textured surfaces, or using the 'exhaustive' matching method for small "
    "image sets."
)
