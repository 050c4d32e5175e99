"""The port's web console (tpu_splat_torch/web/{splat_format,server}.py and
static/) against the JAX package's: the packed splat buffer byte for byte,
and the server's API surface with the reference test's requests
(tests/test_web.py), plus the path-segment check, the cross-origin refusal
and the job subprocess it starts (Popen replaced: no job runs)."""

import http.client
import json
import os
import sys
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.types import GaussianCloud as JCloud
from tpu_splat.web import splat_format as jformat
from tpu_splat_torch.core.ply import save_ply
from tpu_splat_torch.core.types import GaussianCloud
from tpu_splat_torch.web import server as tserver
from tpu_splat_torch.web import splat_format as tformat

torch.set_num_threads(1)


def seeded_cloud(n, seed, sh_rest=0):
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return dict(means=rng.normal(size=(n, 3)).astype(np.float32),
                scales=np.log(rng.uniform(0.01, 0.1, (n, 3))).astype(np.float32),
                quats=quats.astype(np.float32),
                opacities=rng.normal(size=(n,)).astype(np.float32),
                sh0=rng.normal(0, 0.5, (n, 3)).astype(np.float32),
                shN=rng.normal(0, 0.1, (n, sh_rest, 3)).astype(np.float32))


@pytest.mark.parametrize("n,seed,sh_rest,max_splats",
                         [(64, 0, 0, 0), (128, 1, 15, 16), (500, 2, 3, 499), (7, 3, 0, 100)])
def test_splat_bytes_match_reference(n, seed, sh_rest, max_splats):
    arrays = seeded_cloud(n, seed, sh_rest)
    # ties in visual mass keep their order in both (a stable sort)
    arrays["scales"][1] = arrays["scales"][0]
    arrays["opacities"][1] = arrays["opacities"][0]
    want = jformat.cloud_to_splat_bytes(JCloud(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                        max_splats=max_splats)
    got = tformat.cloud_to_splat_bytes(GaussianCloud(**arrays), max_splats=max_splats)
    assert got == want
    assert len(got) == min(n, max_splats or n) * tformat.BYTES_PER_SPLAT
    for a, b in zip(tformat.splat_bytes_to_arrays(got), jformat.splat_bytes_to_arrays(want)):
        assert np.array_equal(a, b)


def test_static_pages_are_the_reference_pages():
    ref = os.path.join(os.path.dirname(jformat.__file__), "static")
    port = os.path.join(os.path.dirname(tformat.__file__), "static")
    with open(os.path.join(ref, "viewer.html"), "rb") as a, \
            open(os.path.join(port, "viewer.html"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(ref, "index.html")) as a, open(os.path.join(port, "index.html")) as b:
        ref_lines, port_lines = a.read().splitlines(), b.read().splitlines()
    # only the console's subtitle differs
    diff = [(r, p) for r, p in zip(ref_lines, port_lines) if r != p]
    assert len(ref_lines) == len(port_lines) and len(diff) == 1 and "sub" in diff[0][1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    httpd = tserver.start_background(root, port=0)
    yield httpd, root
    httpd.shutdown()
    httpd.server_close()


def _get(httpd, path, expect=200):
    port = httpd.server_address[1]
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}")
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        assert e.code == expect, f"{path}: {e.code}"
        return e.code, e.read()


def _post(httpd, path, payload, expect=200, headers=None):
    port = httpd.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), headers=headers or {})
    try:
        r = urllib.request.urlopen(req)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, f"{path}: {e.code}"
        return e.code, json.loads(e.read())


def test_console_and_viewer_pages(server):
    httpd, _ = server
    status, body = _get(httpd, "/")
    assert status == 200 and b"tpu-splat" in body
    status, body = _get(httpd, "/viewer?uuid=x")
    assert status == 200 and (b"WebGL2" in body or b"webgl2" in body)


def test_job_listing_and_status(server):
    httpd, root = server
    jobs_dir = os.path.join(root, "jobs")
    for name in os.listdir(jobs_dir):
        os.remove(os.path.join(jobs_dir, name))
    status, body = _get(httpd, "/api/jobs")
    assert status == 200 and json.loads(body) == []
    rec = {"status": "Complete", "start": 1.0, "metrics": {"psnr": 30.0, "num_gaussians": 1000.0}}
    with open(os.path.join(jobs_dir, "abc.json"), "w") as f:
        json.dump(rec, f)
    with open(os.path.join(jobs_dir, "newer.json"), "w") as f:
        json.dump(dict(rec, start=2.0), f)
    jobs = json.loads(_get(httpd, "/api/jobs")[1])
    assert [j["uuid"] for j in jobs] == ["newer", "abc"]
    got = json.loads(_get(httpd, "/api/jobs/abc")[1])
    assert got["status"] == "Complete" and got["running"] is False
    _get(httpd, "/api/jobs/nope", expect=404)
    _get(httpd, "/nowhere", expect=404)


def test_submit_validate_only(server):
    httpd, _ = server
    job = {"uuid": "v1", "inputPath": "/nonexistent.mp4", "validateOnly": True,
           "training": {"maxSteps": 100}}
    status, body = _post(httpd, "/api/jobs", job)
    assert status == 200 and body["valid"] and body["uuid"] == "v1"
    status, body = _post(httpd, "/api/jobs", {"uuid": "v2", "inputPath": "",
                                              "validateOnly": True}, expect=400)
    assert "error" in body
    status, body = _post(httpd, "/api/jobs", {"uuid": "v3", "inputPath": "x.zip",
                                              "training": {"model": "nope"}}, expect=400)
    assert "error" in body


def test_splat_buffer_and_artifact_download(server):
    httpd, root = server
    _get(httpd, "/api/splat/job1.splat", expect=404)
    art_dir = os.path.join(root, "workflow-output", "job1")
    os.makedirs(art_dir)
    ply = os.path.join(art_dir, "splat.ply")
    cloud = GaussianCloud(**seeded_cloud(32, 5))
    save_ply(cloud, ply)
    with open(os.path.join(root, "jobs", "job1.json"), "w") as f:
        json.dump({"status": "Complete", "artifacts": {"ply": ply}}, f)
    status, body = _get(httpd, "/api/splat/job1.splat")
    assert status == 200 and body == tformat.cloud_to_splat_bytes(cloud)
    assert _get(httpd, "/api/splat/job1")[1] == body  # served from the cache
    status, body = _get(httpd, "/artifacts/job1/splat.ply")
    with open(ply, "rb") as f:
        assert status == 200 and body == f.read()
    _get(httpd, "/artifacts/job1/nothing.ply", expect=404)


def test_traversal_and_cross_origin_are_refused(server):
    httpd, root = server
    with open(os.path.join(root, "secret.txt"), "w") as f:
        f.write("x")
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=10)
    try:
        for path in ("/artifacts/../secret.txt", "/artifacts/job1/..", "/api/jobs/.."):
            conn.request("GET", path)
            resp = conn.getresponse()
            assert resp.status == 400, path
            resp.read()
    finally:
        conn.close()
    job = {"inputPath": "/nonexistent.mp4", "validateOnly": True}
    status, body = _post(httpd, "/api/jobs", job, expect=403,
                         headers={"Origin": "http://elsewhere.example"})
    assert status == 403 and "cross-origin" in body["error"]
    port = httpd.server_address[1]
    status, _ = _post(httpd, "/api/jobs", job, headers={"Origin": f"http://127.0.0.1:{port}"})
    assert status == 200


@pytest.mark.parametrize("device", [None, "cpu"])
def test_submission_runs_the_port_cli(tmp_path, monkeypatch, device):
    """A submitted job runs `python -m tpu_splat_torch.cli.main run <job>`,
    with --device only when the server was given one; one job at a time."""
    started = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            started.append(cmd)

        def poll(self):
            return None  # still running

    monkeypatch.setattr(tserver.subprocess, "Popen", FakeProc)
    httpd = tserver.start_background(str(tmp_path), port=0, device=device)
    try:
        job = {"uuid": "run-1", "inputPath": str(tmp_path / "capture.zip"),
               "training": {"maxSteps": 10}}
        status, body = _post(httpd, "/api/jobs", job, expect=202)
        assert status == 202 and body == {"uuid": "run-1", "submitted": True}
        job_path = os.path.join(str(tmp_path), "web_jobs", "run-1.json")
        want = [sys.executable, "-m", "tpu_splat_torch.cli.main", "run", job_path]
        assert started == [want + (["--device", device] if device else [])]
        with open(job_path) as f:
            assert json.load(f)["outputPath"] == str(tmp_path)
        status, body = _post(httpd, "/api/jobs", dict(job, uuid="run-2"), expect=409)
        assert "still running" in body["error"]
        with open(os.path.join(str(tmp_path), "jobs", "run-1.json"), "w") as f:
            json.dump({"status": "In-Progress"}, f)
        assert json.loads(_get(httpd, "/api/jobs/run-1")[1])["running"] is True
    finally:
        httpd.shutdown()
        httpd.server_close()
