"""Local web console + viewer server (the port of tpu_splat/web/server.py;
stdlib http.server, no framework deps).

The self-hosted equivalent of the reference's Gradio console
(Gradio/app.py:237-331: submit job, poll status, inspect artifacts) and its
embedded splat web viewer (generate_splat_gradio.py:883-1017,1309-1376).
A submitted job runs as `python -m tpu_splat_torch.cli.main run <job>`, on the
card unless the server was given a device (`--device <device>` is passed on).

Endpoints:
  GET  /                      console page
  GET  /viewer?uuid=<id>      WebGL2 splat viewer for a finished job
  GET  /api/jobs              all jobs in the store (most recent first)
  GET  /api/jobs/<uuid>       one job record
  POST /api/jobs              submit a job JSON; runs it in a subprocess
                              (one at a time — this box trains one job at a
                              time anyway). {"validateOnly": true} only checks.
  GET  /api/splat/<uuid>      packed web-format splat buffer for the viewer
  GET  /artifacts/<uuid>/<n>  raw artifact download (splat.ply / splat.spz ...)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


def _safe_segment(s: str) -> bool:
    """True for path segments that cannot traverse out of the store: a URL
    segment like `..` (or anything with a separator) in /artifacts/<uuid>/<n>
    would otherwise escape workflow-output/."""
    return bool(s) and s not in (".", "..") and "/" not in s and "\\" not in s


class _State:
    """Server-side state: the output root (job store + artifacts) and the
    currently-running job subprocess, if any."""

    def __init__(self, output_root: str, device: str | None = None):
        self.output_root = os.path.abspath(output_root)
        self.device = device
        os.makedirs(os.path.join(self.output_root, "jobs"), exist_ok=True)
        self.lock = threading.Lock()
        self.proc: subprocess.Popen | None = None
        self.proc_uuid: str | None = None
        self._splat_cache: dict = {}

    # ---- jobs ----

    def list_jobs(self) -> list:
        jdir = os.path.join(self.output_root, "jobs")
        out = []
        for name in os.listdir(jdir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(jdir, name)) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            rec["uuid"] = name[:-5]
            out.append(rec)
        out.sort(key=lambda r: r.get("start", 0), reverse=True)
        return out

    def get_job(self, uuid: str) -> dict | None:
        path = os.path.join(self.output_root, "jobs", f"{uuid}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            rec = json.load(f)
        rec["uuid"] = uuid
        with self.lock:
            rec["running"] = (
                self.proc_uuid == uuid
                and self.proc is not None
                and self.proc.poll() is None
            )
        return rec

    def submit(self, payload: dict) -> tuple[int, dict]:
        from tpu_splat_torch.core.config import job_config_from_json

        validate_only = bool(payload.pop("validateOnly", False))
        payload.setdefault("outputPath", self.output_root)
        # jobs submitted through this console always share the server's store
        payload["outputPath"] = self.output_root
        try:
            cfg = job_config_from_json(payload)
            cfg.validate()
            if not cfg.input_path:
                raise ValueError("inputPath is required")
        except Exception as e:
            return 400, {"error": str(e)}
        if validate_only:
            return 200, {"uuid": cfg.uuid, "valid": True}
        with self.lock:
            if self.proc is not None and self.proc.poll() is None:
                return 409, {"error": f"job {self.proc_uuid} still running"}
            job_dir = os.path.join(self.output_root, "web_jobs")
            os.makedirs(job_dir, exist_ok=True)
            job_path = os.path.join(job_dir, f"{cfg.uuid}.json")
            with open(job_path, "w") as f:
                json.dump(payload, f, indent=2)
            log_path = os.path.join(job_dir, f"{cfg.uuid}.log")
            cmd = [sys.executable, "-m", "tpu_splat_torch.cli.main", "run", job_path]
            if self.device:
                cmd += ["--device", self.device]
            with open(log_path, "w") as log:
                self.proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            self.proc_uuid = cfg.uuid
        return 202, {"uuid": cfg.uuid, "submitted": True}

    # ---- artifacts ----

    def artifact_path(self, uuid: str, name: str) -> str | None:
        rec = self.get_job(uuid)
        if rec is None:
            return None
        arts = rec.get("artifacts") or {}
        for p in arts.values():
            if os.path.basename(p) == name and os.path.exists(p):
                return p
        # fall back to the conventional layout
        cand = os.path.join(self.output_root, "workflow-output", uuid, name)
        return cand if os.path.exists(cand) else None

    def splat_buffer(self, uuid: str) -> bytes | None:
        """Viewer buffer for a job's splat, converted from .ply/.spz on first
        request and cached by artifact mtime."""
        src = self.artifact_path(uuid, "splat.ply") or self.artifact_path(
            uuid, "splat.spz"
        )
        if src is None:
            return None
        key = (uuid, src, os.path.getmtime(src))
        with self.lock:
            if key in self._splat_cache:
                return self._splat_cache[key]
        from tpu_splat_torch.web.splat_format import cloud_to_splat_bytes

        if src.endswith(".spz"):
            from tpu_splat_torch.core.spz import load_spz

            cloud = load_spz(src)
        else:
            from tpu_splat_torch.core.ply import load_ply

            cloud = load_ply(src)
        data = cloud_to_splat_bytes(cloud)
        with self.lock:
            self._splat_cache = {key: data}  # keep only the latest
        return data


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj, default=str).encode(),
                       "application/json")

        def _static(self, name: str, ctype: str):
            path = os.path.join(_STATIC, name)
            if not os.path.exists(path):
                self._json(404, {"error": f"missing static {name}"})
                return
            with open(path, "rb") as f:
                self._send(200, f.read(), ctype)

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if not all(_safe_segment(p) for p in parts):
                self._json(400, {"error": "bad path"})
                return
            try:
                if not parts:
                    self._static("index.html", "text/html")
                elif parts[0] == "viewer":
                    self._static("viewer.html", "text/html")
                elif parts[:2] == ["api", "jobs"] and len(parts) == 2:
                    self._json(200, state.list_jobs())
                elif parts[:2] == ["api", "jobs"] and len(parts) == 3:
                    rec = state.get_job(parts[2])
                    self._json(200, rec) if rec else self._json(
                        404, {"error": "unknown job"})
                elif parts[:2] == ["api", "splat"] and len(parts) == 3:
                    uuid = parts[2].removesuffix(".splat")
                    data = state.splat_buffer(uuid)
                    if data is None:
                        self._json(404, {"error": "no splat artifact yet"})
                    else:
                        self._send(200, data, "application/octet-stream")
                elif parts[0] == "artifacts" and len(parts) == 3:
                    path = state.artifact_path(parts[1], parts[2])
                    if path is None:
                        self._json(404, {"error": "no such artifact"})
                    else:
                        with open(path, "rb") as f:
                            self._send(200, f.read(),
                                       "application/octet-stream")
                else:
                    self._json(404, {"error": "not found"})
            except BrokenPipeError:
                pass

        def do_POST(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if parts[:2] != ["api", "jobs"]:
                self._json(404, {"error": "not found"})
                return
            # Reject cross-origin submissions: any web page in the same browser
            # could otherwise POST a job (drive-by subprocess launch). Same-
            # origin requests carry either no Origin or one matching Host.
            origin = self.headers.get("Origin")
            host = self.headers.get("Host", "")
            if origin is not None and urlparse(origin).netloc != host:
                self._json(403, {"error": "cross-origin submit rejected"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._json(400, {"error": f"bad JSON: {e}"})
                return
            code, body = state.submit(payload)
            self._json(code, body)

    return Handler


def serve(output_root: str, host: str = "127.0.0.1", port: int = 8085,
          open_browser: bool = False, device: str | None = None) -> ThreadingHTTPServer:
    """Start the console server (blocking). Returns after shutdown(). Jobs run
    on `device` (the CLI's default, the card, when None)."""
    state = _State(output_root, device)
    httpd = ThreadingHTTPServer((host, port), _make_handler(state))
    httpd.state = state  # for tests
    if open_browser:
        import webbrowser

        webbrowser.open(f"http://{host}:{httpd.server_address[1]}/")
    print(f"tpu-splat-torch console: http://{host}:{httpd.server_address[1]}/ "
          f"(store: {state.output_root})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return httpd


def start_background(output_root: str, host: str = "127.0.0.1", port: int = 0,
                     device: str | None = None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread (tests); port 0 = auto-assign."""
    state = _State(output_root, device)
    httpd = ThreadingHTTPServer((host, port), _make_handler(state))
    httpd.state = state
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
