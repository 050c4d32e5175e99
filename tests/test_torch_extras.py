"""The port's measurement, floorplan and object layer
(tpu_splat_torch/export/{measurement,floorplan,objects}.py) against the JAX
package's, on the CPU, on tests/test_extras.py's room (a floor, four walls
and six tripod cameras), with and without a box on the floor.

The clouds go to both packages in f64: the reference computes in its input's
dtype, the port always in f64, so with f64 input both run the same
arithmetic. Both draw the same RANSAC triples from numpy's generator, so the
same hypothesis wins and the inlier masks are equal; JSON numbers agree
within 1e-9 relative, polygons have equal vertex counts, and the .svg and
.png files are byte-equal where the polygons are."""

import json
import os

import numpy as np
import pytest
import torch

from test_extras import room_scene
from tpu_splat.export import floorplan as jfloor
from tpu_splat.export import measurement as jmeas
from tpu_splat.export import objects as jobj
from tpu_splat_torch.export import floorplan as tfloor
from tpu_splat_torch.export import measurement as tmeas
from tpu_splat_torch.export import objects as tobj

torch.set_num_threads(1)
REL = 1e-9


def assert_json_close(got, want, path="$"):
    """Equal structure and strings; numbers within REL relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, path
    else:
        assert got == pytest.approx(want, rel=REL, abs=1e-12), path


def room(seed, box=False):
    rng = np.random.default_rng(seed)
    pts, cams = room_scene(rng)
    if box:
        n_box = 1500
        pts = np.concatenate([pts, np.stack([
            1.0 + rng.uniform(0, 1.0, n_box), -rng.uniform(0.2, 1.0, n_box),
            1.0 + rng.uniform(0, 1.0, n_box)], axis=1).astype(np.float32)])
    return pts.astype(np.float64), cams.astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_ground_plane_ransac_matches_reference(seed):
    pts, cams = room(seed)
    centers = cams[:, :3, 3]
    for kw in ({}, {"camera_centers": centers}, {"iterations": 700}):
        want = jmeas.fit_ground_plane_ransac(pts, np.random.default_rng(seed), **kw)
        got = tmeas.fit_ground_plane_ransac(pts, np.random.default_rng(seed), device="cpu",
                                            **kw)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=REL, atol=1e-15)
        assert got[1] == pytest.approx(want[1], rel=REL, abs=1e-15)
    assert tmeas.fit_ground_plane_ransac(pts[:9], np.random.default_rng(0), device="cpu") is None


def test_quantile_is_numpys():
    x = np.random.default_rng(3).normal(size=(1001, 3))
    for q in (0.0, 0.01, 0.02, 0.5, 0.6, 0.98, 0.99, 1.0):
        np.testing.assert_array_equal(tmeas.quantile(torch.as_tensor(x), q).numpy(),
                                      np.quantile(x, q, axis=0))


@pytest.mark.parametrize("height", [1.2, 0.0])
def test_estimate_scale_matches_reference(height):
    pts, cams = room(0)
    want = jmeas.estimate_scale_from_tripod(pts, cams, tripod_height_m=height)
    got = tmeas.estimate_scale_from_tripod(pts, cams, tripod_height_m=height, device="cpu")
    assert_json_close(got, want)
    assert got["valid"] == (height > 0)


@pytest.mark.parametrize("case", ["room", "blob"])
def test_floorplan_matches_reference(tmp_path, case):
    if case == "room":
        pts, _ = room(0)
    else:  # unstructured: no polygon
        pts = np.random.default_rng(0).normal(0, 1, (50, 3))
    arts = {}
    for pkg, mod, kw in (("ref", jfloor, {}), ("port", tfloor, {"device": "cpu"})):
        arts[pkg] = mod.extract_floorplan(pts, scale_m_per_unit=0.8,
                                          out_dir=str(tmp_path / pkg), **kw)
    assert arts["port"].keys() == arts["ref"].keys()
    meta = [json.load(open(arts[p]["floorplan_meta"])) for p in ("port", "ref")]
    assert_json_close(*meta)
    if case == "room":
        assert meta[0]["valid"] and abs(meta[0]["areaM2"] - 7.68) < 1.8
        geo = [json.load(open(arts[p]["floorplan_geojson"])) for p in ("port", "ref")]
        assert_json_close(*geo)
        for key in ("floorplan_svg", "floorplan_png"):
            assert open(arts["port"][key], "rb").read() == open(arts["ref"][key], "rb").read()


def test_object_layer_matches_reference(tmp_path):
    pts, _ = room(0, box=True)
    arts = {}
    for pkg, mod, kw in (("ref", jobj, {}), ("port", tobj, {"device": "cpu"})):
        arts[pkg] = mod.extract_object_layer(pts, scale_m_per_unit=0.8,
                                             min_object_area_m2=0.1,
                                             out_dir=str(tmp_path / pkg), **kw)
    assert arts["port"].keys() == arts["ref"].keys()
    geo = [json.load(open(arts[p]["objects_geojson"])) for p in ("port", "ref")]
    assert_json_close(*geo)
    areas = [f["properties"]["footprintAreaM2"] for f in geo[0]["features"]]
    assert any(abs(a - 0.64) < 0.4 for a in areas), areas
    assert open(arts["port"]["objects_svg"], "rb").read() == \
        open(arts["ref"]["objects_svg"], "rb").read()
    assert os.path.getsize(arts["port"]["objects_svg"]) > 200
