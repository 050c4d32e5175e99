"""The port's mesh export (tpu_splat_torch/export/mesh.py) against the JAX
package's, on the CPU: the density grid of a seeded splat shell with
footprints of every radius (within 1e-12 relative), marching tetrahedra fed
the reference's own grid (identical faces, vertices within 1e-9), the whole
extraction, and byte-equal .ply/.obj/.glb files from the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.types import GaussianCloud as JCloud
from tpu_splat.export import mesh as jmesh
from tpu_splat_torch.core.types import GaussianCloud as TCloud
from tpu_splat_torch.export import mesh as tmesh

torch.set_num_threads(1)
RES = 32


def shell(n=2000, seed=0):
    """Splats on a unit sphere, log-scales spread so that every footprint
    radius (0, 1 and 2 cells at RES) occurs, random opacities and colours."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    arrays = dict(
        means=(dirs * rng.uniform(0.9, 1.1, (n, 1))).astype(np.float32),
        scales=rng.uniform(np.log(0.01), np.log(0.2), (n, 3)).astype(np.float32),
        quats=np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
        opacities=rng.normal(1.0, 1.0, n).astype(np.float32),
        sh0=rng.normal(0, 0.5, (n, 3)).astype(np.float32),
        shN=np.zeros((n, 0, 3), np.float32))
    return (JCloud(**{k: jnp.asarray(v) for k, v in arrays.items()}), TCloud(**arrays))


@pytest.fixture(scope="module")
def clouds():
    return shell()


@pytest.fixture(scope="module")
def ref_grid(clouds):
    return jmesh.splat_density_grid(clouds[0], resolution=RES)


def test_density_grid_matches_reference(clouds, ref_grid):
    density, color, origin, cell = ref_grid
    got = tmesh.splat_density_grid(clouds[1], resolution=RES, device="cpu")
    r_cells = np.clip(np.round(np.exp(np.asarray(clouds[1].scales, np.float64)).mean(1)
                               / cell).astype(int), 0, 2)
    assert set(r_cells.tolist()) == {0, 1, 2}
    np.testing.assert_allclose(got[2], origin, rtol=1e-12, atol=0)
    assert got[3] == pytest.approx(cell, rel=1e-12)
    np.testing.assert_allclose(got[0], density, rtol=1e-12, atol=1e-12 * density.max())
    np.testing.assert_allclose(got[1], color, rtol=1e-12, atol=1e-12)
    assert (density > 1e-4).mean() > 0.05


def analytic_sphere(r=24):
    ax = np.arange(r) - r / 2
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.clip(10.0 - np.sqrt(x**2 + y**2 + z**2), 0, None)


@pytest.mark.parametrize("grid", ["analytic", "splats"])
def test_marching_tetrahedra_matches_reference(ref_grid, grid):
    if grid == "analytic":
        density, iso = analytic_sphere(), 4.0
    else:
        density = ref_grid[0]
        iso = float(np.quantile(density[density > 1e-4], 0.6))
    want_v, want_f = jmesh.marching_tetrahedra(density, iso)
    got_v, got_f = tmesh.marching_tetrahedra(density, iso, device="cpu")
    assert len(want_f) > 300
    assert got_f.dtype == want_f.dtype and got_v.dtype == want_v.dtype
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-9)


def test_extract_mesh_and_writers_match_reference(clouds, tmp_path):
    want = jmesh.extract_mesh(clouds[0], resolution=RES)
    got = tmesh.extract_mesh(clouds[1], resolution=RES, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    verts, faces, colors = want
    for name, ext in (("save_mesh_ply", "ply"), ("save_mesh_obj", "obj"),
                      ("save_mesh_glb", "glb")):
        paths = [str(tmp_path / f"{pkg}.{ext}") for pkg in ("port", "ref")]
        getattr(tmesh, name)(paths[0], verts, faces, colors)
        getattr(jmesh, name)(paths[1], verts, faces, colors)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read(), ext
    arts = {pkg: mod.export_mesh_artifacts(cloud, str(tmp_path / pkg), resolution=24, **kw)
            for pkg, mod, cloud, kw in (("ref", jmesh, clouds[0], {}),
                                        ("port", tmesh, clouds[1], {"device": "cpu"}))}
    assert arts["port"]["n_faces"] == arts["ref"]["n_faces"] > 100
    assert arts["port"]["n_vertices"] == arts["ref"]["n_vertices"]
    for key in ("mesh_ply", "mesh_obj", "mesh_glb"):
        assert open(arts["port"][key], "rb").read() == open(arts["ref"][key], "rb").read()


def test_empty_grid_gives_an_empty_mesh():
    v, f = tmesh.marching_tetrahedra(np.zeros((8, 8, 8)), 0.5, device="cpu")
    assert v.shape == (0, 3) and f.shape == (0, 3)
