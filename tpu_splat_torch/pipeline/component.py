"""Typed in-process pipeline framework (the port's copy of
tpu_splat/pipeline/component.py).

Replaces the reference's subprocess-based Pipeline/Component classes
(pipeline.py:32-244): components become functions over a shared typed context
instead of argv-built subprocesses, but keep the same surface — names, types,
status enum, per-component timing, and the numbered error-code reporting — so
logs and failure handling map 1:1.
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpu_splat_torch.core.errors import ERROR_MESSAGES, PipelineError, is_sfm_failure

logger = logging.getLogger("tpu_splat_torch.pipeline")


class ComponentType(enum.Enum):
    LOADER = "loader"
    FILTER = "filter"
    TRANSFORM = "transform"
    RENDERER = "renderer"
    EXPORTER = "exporter"


class Status(enum.Enum):
    INIT = "init"
    RUN = "run"
    STOP = "stop"
    ERROR = "error"


@dataclass
class Component:
    name: str
    ctype: ComponentType
    fn: Callable[["PipelineContext"], None]
    error_code: int = 795
    enabled: bool = True
    elapsed_s: float = 0.0
    status: Status = Status.INIT


class PipelineContext(dict):
    """Shared mutable state passed between components (images, scene, splat...)."""

    def require(self, key: str, code: int = 795):
        if key not in self or self[key] is None:
            raise PipelineError(code, f"missing pipeline artifact {key!r}")
        return self[key]


@dataclass
class Pipeline:
    """Ordered component executor with timing + error reporting."""

    name: str
    uuid: str = ""
    components: List[Component] = field(default_factory=list)
    status: Status = Status.INIT
    log_fn: Optional[Callable[[str], None]] = None

    def log(self, msg: str):
        # log_fn when provided, ELSE the module logger: with both, a log_fn
        # job would print every component line twice (run_job bridges the
        # module logger back into log_fn for the components' internals).
        if self.log_fn:
            self.log_fn(msg)
        else:
            logger.info(msg)

    def create_component(
        self,
        name: str,
        ctype: ComponentType,
        fn: Callable[[PipelineContext], None],
        error_code: int = 795,
        enabled: bool = True,
    ) -> Component:
        comp = Component(name=name, ctype=ctype, fn=fn, error_code=error_code,
                         enabled=enabled)
        self.components.append(comp)
        return comp

    def run(self, ctx: Optional[PipelineContext] = None) -> PipelineContext:
        ctx = ctx if ctx is not None else PipelineContext()
        self.status = Status.RUN
        t_all = time.time()
        for comp in self.components:
            if not comp.enabled:
                self.log(f"[{comp.name}] skipped")
                continue
            comp.status = Status.RUN
            t0 = time.time()
            self.log(f"[{comp.name}] starting")
            try:
                comp.fn(ctx)
            except PipelineError as e:
                comp.status = Status.ERROR
                self.status = Status.ERROR
                self.report_error(e.code, str(e))
                raise
            except Exception as e:  # noqa: BLE001 - wrap into the taxonomy
                comp.status = Status.ERROR
                self.status = Status.ERROR
                detail = f"{comp.name}: {e}"
                self.report_error(comp.error_code, detail)
                raise PipelineError(comp.error_code, detail) from e
            comp.elapsed_s = time.time() - t0
            comp.status = Status.STOP
            self.log(f"[{comp.name}] done in {comp.elapsed_s:.1f}s")
        self.status = Status.STOP
        self.log(f"pipeline complete in {time.time() - t_all:.1f}s")
        return ctx

    def report_error(self, code: int, detail: str = ""):
        """Structured error reporting (pipeline.py report_error analog). Also
        classifies SfM-convergence failures like the reference completion Lambda."""
        base = ERROR_MESSAGES.get(code, "Unknown error")
        self.log(f"ERROR {code}: {base}" + (f" — {detail}" if detail else ""))
        if is_sfm_failure(detail):
            from tpu_splat_torch.core.errors import SFM_FAILURE_REMEDIATION

            self.log(f"DIAGNOSIS: {SFM_FAILURE_REMEDIATION}")

    def timings(self) -> Dict[str, float]:
        return {c.name: c.elapsed_s for c in self.components if c.status == Status.STOP}
