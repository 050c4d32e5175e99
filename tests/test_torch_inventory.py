"""The port's inventory against the JAX package, read from both packages'
sources with `ast` (nothing of tpu_splat is imported): every module has a
same-path counterpart, every Pallas kernel a hand-written one, and every
top-level function, class and method name a counterpart name, but for the
listed names, each with its reason and the evidence that its work is
mapped, inlined or JAX-only."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "tpu_splat"), os.path.join(ROOT, "tpu_splat_torch")

# reference module -> port module, where the paths differ
MODULE_MAP = {"gs/pallas_raster.py": "gs/cuda_raster.py"}
# every function that reaches pl.pallas_call -> its port kernel in csrc/composite.cu
PALLAS_KERNELS = {"_composite_fwd_impl": ("_forward_kernel", "composite_fwd_kernel"),
                  "_composite_bwd": ("_backward_kernel", "composite_bwd_kernel")}

# Reference names with no same-named counterpart in the same-path port module.
# kind "mapped": `evidence` is a name the port module defines (AST), or the
# hand-written kernel in csrc/composite.cu that does its work;
# "inlined": a pattern found in the port module's source;
# "jax": a pattern found in the reference definition's own source.
EXCEPTIONS = {
    ("cli/main.py", "_apply_platform_env"): (
        "jax", None, r"jax\.config", "re-pins JAX's platform list; torch has none"),
    ("pipeline/runner.py", "_enable_compile_cache"): (
        "jax", None, r"jax_compilation_cache_dir", "XLA's compile cache; eager torch compiles "
        "nothing"),
    ("core/types.py", "Cameras.intrinsics_matrix"): (
        "inlined", "sfm/mapper.py", r"\(xy\[:, 0\] - self\.cx\) / self\.fx",
        "the port applies (fx, fy, cx, cy) directly, as the mapper's normalised coordinates"),
    ("core/types.py", "Cameras.single"): (
        "inlined", "gs/trainer.py", r"fx, fy, cx, cy = \(float\(v\) for v in intrin\)",
        "one view is a viewmat and its (fx, fy, cx, cy), as train_step takes them"),
    ("core/types.py", "Cameras.take"): (
        "inlined", "gs/pipeline.py", r"viewmats\[train_idx\], intrin\[train_idx\]",
        "a camera subset is a row selection of the view arrays"),
    ("core/types.py", "GaussianCloud.empty"): (
        "inlined", "gs/params.py", r"quats\[:, 0\] = 1\.0",
        "zero gaussians with identity rotations are built where the parameters are"),
    ("gs/projection.py", "covariance_3d"): (
        "inlined", "gs/projection.py", r"M = M \* torch\.exp\(log_scales\)",
        "R S is formed inside project_gaussians, which takes (W R S)(W R S)^T"),
    ("gs/sh.py", "num_sh_bases"): (
        "inlined", "core/types.py", r"SH_DIM_FOR_DEGREE = \{0: 0, 1: 3, 2: 8, 3: 15\}",
        "the port counts higher-order bases by degree in SH_DIM_FOR_DEGREE"),
    ("gs/rasterize.py", "pack_quantization"): (
        "inlined", "gs/rasterize.py", r"f16 = feat\.to\(torch\.bfloat16\)",
        "the bf16 hi+lo rounding happens in _PackGather.forward"),
    ("gs/rasterize.py", "_pack_gather"): (
        "mapped", "gs/rasterize.py", "_PackGather",
        "the custom-VJP gather is a torch.autograd.Function"),
    ("gs/rasterize.py", "_pack_gather_fwd"): (
        "mapped", "gs/rasterize.py", "_PackGather.forward", "its forward"),
    ("gs/rasterize.py", "_pack_gather_bwd"): (
        "mapped", "gs/rasterize.py", "_PackGather.backward", "its backward"),
    ("gs/rasterize.py", "_use_pallas"): (
        "jax", None, r"jax\.default_backend", "picks Pallas or XLA by JAX backend; the port "
        "picks kernel or plain version by the tensor's device"),
    ("gs/trainer.py", "Trainer._sanitize"): (
        "jax", None, r"orbax|jax\.tree", "orbax cannot store empty arrays; torch.save can"),
    ("gs/trainer.py", "train_steps_scan"): (
        "mapped", "gs/trainer.py", "Trainer.run", "lax.scan's chunk of steps is the "
        "Trainer's per-chunk Python loop"),
    ("matting/matnet.py", "_conv"): (
        "mapped", "matting/matnet.py", "_Block", "lax.conv is nn.Conv2d inside the net's "
        "modules"),
    ("matting/matnet.py", "_gn"): (
        "mapped", "matting/matnet.py", "_Block.forward", "the group norm is nn.GroupNorm in "
        "each block"),
    ("matting/matnet.py", "apply"): (
        "mapped", "matting/matnet.py", "MatNet.forward", "the functional apply is the "
        "module's forward"),
    ("matting/u2net.py", "REBNCONV.__call__"): (
        "mapped", "matting/u2net.py", "REBNCONV.forward", "flax's __call__ is forward"),
    ("matting/u2net.py", "RSU.__call__"): (
        "mapped", "matting/u2net.py", "RSU.forward", "flax's __call__ is forward"),
    ("matting/u2net.py", "RSU4F.__call__"): (
        "mapped", "matting/u2net.py", "RSU4F.forward", "flax's __call__ is forward"),
    ("matting/u2net.py", "U2Net.__call__"): (
        "mapped", "matting/u2net.py", "U2Net.forward", "flax's __call__ is forward"),
    ("matting/u2net.py", "convert_torch_checkpoint"): (
        "mapped", "matting/u2net.py", "load_u2net", "a .pth state dict loads as it is "
        "(load_state_dict), with no conversion to flax variables"),
    ("mesh/trainer.py", "DistributedTrainer._reshard_adam"): (
        "inlined", "mesh/trainer.py", r"mu=shard_params\(adam\.mu, self\.mesh\)",
        "_set_full_state reshards the moments"),
    ("mesh/trainer.py", "DistributedTrainer._reshard_dstate"): (
        "inlined", "mesh/trainer.py", r"DensifyState\(\*shard_params\(dstate",
        "_set_full_state reshards the densify accumulators"),
    ("sfm/features.py", "_extract_features_vmapped"): (
        "jax", None, r"jax\.vmap", "jax.vmap; the port's features take a batch dimension"),
    ("sfm/geometry.py", "_decompose_essential_vmapped"): (
        "jax", None, r"jax\.vmap", "jax.vmap; the port's geometry is batched"),
    ("sfm/geometry.py", "_essential_ransac_vmapped"): (
        "jax", None, r"jax\.vmap", "jax.vmap; the port's geometry is batched"),
    ("sfm/geometry.py", "_fib_sphere_dirs"): (
        "mapped", "sfm/geometry.py", "_fib_sphere_dirs_np", "the numpy directions, moved to "
        "the device where used"),
    ("sfm/matching.py", "_guided_match_vmapped"): (
        "jax", None, r"jax\.vmap", "jax.vmap; the port's matching is batched"),
    ("sfm/matching.py", "_match_pairs_vmapped"): (
        "jax", None, r"jax\.vmap", "jax.vmap; the port's matching is batched"),
    ("sfm/mapper.py", "IncrementalMapper._next_key"): (
        "jax", None, r"jax\.random\.split", "splits a jax.random key; the port draws from "
        "one torch.Generator"),
    ("sfm/mapper.py", "IncrementalMapper._ransac_padded"): (
        "jax", None, r"compile", "pads to a power of two against XLA recompiles; eager torch "
        "takes any shape"),
    ("sfm/mapper.py", "_pad_bucket"): (
        "jax", None, r"compile|bucket", "pads shapes against XLA recompiles"),
    ("sfm/mapper.py", "_pad_pow2"): (
        "jax", None, r"1 << int\(math\.ceil\(math\.log2",
        "pads shapes to a power of two against XLA recompiles"),
    ("gs/pallas_raster.py", "composite_tiles_reference"): (
        "mapped", "gs/cuda_raster.py", "composite_tiles_plain",
        "the XLA twin of the kernels is their plain PyTorch version"),
}
# the Pallas kernels and their helpers: the work of composite.cu's two kernels,
# which cuda_raster.composite_tiles launches
for _kernel, _names in (
        ("composite_fwd_kernel", ("_forward_kernel", "_forward_one", "_composite_fwd",
                                  "_composite_fwd_impl", "_composite_tiles_counted",
                                  "_pad_tiles", "_prefix_products")),
        ("composite_bwd_kernel", ("_backward_kernel", "_backward_one", "_bwd_chunk",
                                  "_composite_bwd", "_triu_strict"))):
    for _name in _names:
        EXCEPTIONS[("gs/pallas_raster.py", _name)] = (
            "mapped", "csrc/composite.cu", _kernel,
            f"a part of the Pallas kernel that {_kernel} replaces")


def modules(root: str) -> dict:
    """Relative path -> parsed module, for every .py file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    out[os.path.relpath(path, root)] = ast.parse(fh.read())
    return out


def definitions(tree: ast.Module) -> dict:
    """Top-level function and class names, and Class.method names -> node."""
    defs = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defs[node.name] = node
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        defs[f"{node.name}.{m.name}"] = m
    return defs


REF_MODULES, PORT_MODULES = modules(REF), modules(PORT)


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def test_every_reference_module_has_a_port_counterpart():
    missing = [rel for rel in REF_MODULES if MODULE_MAP.get(rel, rel) not in PORT_MODULES]
    assert missing == []
    assert all(rel not in PORT_MODULES for rel in MODULE_MAP)  # mapped, not duplicated


def test_every_pallas_call_has_a_hand_written_kernel():
    sites = {}
    for rel, tree in REF_MODULES.items():
        if "pallas_call" not in read(os.path.join(REF, rel)):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for call in ast.walk(fn):
                if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "pallas_call"):
                    sites[fn.name] = (rel, call.lineno, ast.get_source_segment(
                        read(os.path.join(REF, rel)), fn))
    assert sorted(sites) == sorted(PALLAS_KERNELS)
    cu = read(os.path.join(PORT, "csrc", "composite.cu"))
    for fn, (rel, line, src) in sites.items():
        tpu_kernel, port_kernel = PALLAS_KERNELS[fn]
        assert rel == "gs/pallas_raster.py" and tpu_kernel in src, (fn, line)
        assert re.search(r"__global__\s+void\s+(__launch_bounds__\([^)]*\)\s+)?"
                         + port_kernel + r"\s*\(", cu), port_kernel


def test_every_reference_name_has_a_port_counterpart_or_a_listed_reason():
    missing = []
    for rel, tree in REF_MODULES.items():
        port_defs = definitions(PORT_MODULES[MODULE_MAP.get(rel, rel)])
        for name in definitions(tree):
            if name not in port_defs and (rel, name) not in EXCEPTIONS:
                missing.append(f"{rel}:{name}")
    assert missing == []


@pytest.mark.parametrize("key", sorted(EXCEPTIONS), ids=lambda k: f"{k[0]}:{k[1]}")
def test_listed_names_are_mapped_inlined_or_jax_only(key):
    rel, name = key
    kind, port_rel, evidence, reason = EXCEPTIONS[key]
    assert reason
    ref_defs = definitions(REF_MODULES[rel])
    assert name in ref_defs, "a listed name the reference no longer defines"
    assert name not in definitions(PORT_MODULES[MODULE_MAP.get(rel, rel)]), \
        "listed, but the port has the same name"
    if kind == "jax":
        src = ast.get_source_segment(read(os.path.join(REF, rel)), ref_defs[name])
        assert re.search(evidence, src), evidence
    elif port_rel.endswith(".cu"):
        assert re.search(r"__global__\s+void\s+(__launch_bounds__\([^)]*\)\s+)?"
                         + evidence + r"\s*\(", read(os.path.join(PORT, port_rel)))
    elif kind == "mapped":
        assert evidence in definitions(PORT_MODULES[port_rel]), f"{port_rel}:{evidence}"
    else:
        assert kind == "inlined" and re.search(evidence, read(os.path.join(PORT, port_rel)))
