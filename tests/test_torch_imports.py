"""The port's import boundary: diff3dhpe_torch and chip_smoke.py load
without jax, flax or the JAX package, and the port's entry points refuse a
missing GPU instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import ast, importlib, pkgutil, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "diff3dhpe_tpu")
for banned in BANNED:
    sys.modules[banned] = None  # any import of these now raises ImportError
import diff3dhpe_torch
names = [m.name for m in pkgutil.walk_packages(diff3dhpe_torch.__path__, "diff3dhpe_torch.")]
for name in names:
    importlib.import_module(name)
tree = ast.parse(open("chip_smoke.py").read())
imported = set()
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        imported.update(a.name.split(".")[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
        imported.add(node.module.split(".")[0])
loaded = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and m.split(".")[0] in BANNED
)
print("MODULES", sorted(names), "LOADED", loaded, "CHIP_SMOKE_IMPORTS", sorted(imported))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert "LOADED []" in line, line
    smoke_imports = set(ast.literal_eval(line.split("CHIP_SMOKE_IMPORTS ", 1)[1]))
    assert not smoke_imports & {"jax", "jaxlib", "flax", "optax", "orbax",
                                "diff3dhpe_tpu"}, smoke_imports
    # Every sub-package was walked, the evaluate path's among them.
    walked = set(ast.literal_eval(line.split("MODULES ", 1)[1].split(" LOADED", 1)[0]))
    assert {f"diff3dhpe_torch.{name}" for name in (
        "cli.args", "cli.run", "config.config", "data.chunking", "data.dataset", "data.h36m",
        "data.mocap", "data.synthetic", "diffusion.gaussian_diffusion", "engine.runner",
        "engine.steps", "geometry.camera", "geometry.quaternion", "geometry.skeleton",
        "io.checkpoint", "io.convert", "metrics.metrics", "models.fast_eval", "models.mixste",
        "models.registry", "ops.attention", "ops.fused_block", "utils.misc", "utils.profiling",
    )} <= walked, sorted(walked)


def test_default_device_raises_without_gpu(monkeypatch):
    from diff3dhpe_torch.diffusion import GaussianDiffusion
    from diff3dhpe_torch.engine import make_eval_step
    from diff3dhpe_torch.models import MixSTEDenoiser

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MixSTEDenoiser(embed_dim=32, depth=1, num_heads=4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_eval_step(GaussianDiffusion.create(None, 10, 2), [1], [4])
    cpu_model = MixSTEDenoiser(embed_dim=32, depth=1, num_heads=4, device="cpu")
    assert next(cpu_model.parameters()).device.type == "cpu"


def test_every_binding_names_a_function_of_its_source():
    """Each library in SOURCES has its csrc/<name>.cu, every function the
    ctypes binding declares is exported there with the declared number of
    parameters (a mismatch would pass garbage without any error), and every
    function a source exports (the f32 and bf16 blocks among them) has a
    binding."""
    import re

    from diff3dhpe_torch.ops._build import CSRC, SIGNATURES, SOURCES

    assert set(SIGNATURES) == set(SOURCES)
    for name in SOURCES:
        src = (CSRC / f"{name}.cu").read_text()
        for fn, argtypes in SIGNATURES[name].items():
            m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
            assert m, f"{fn} is not exported by {name}.cu"
            params = [p for p in m.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), (fn, len(params), len(argtypes))
        exported = set(re.findall(r'extern "C" int (\w+)\(', src))
        assert exported == set(SIGNATURES[name]), (name, exported ^ set(SIGNATURES[name]))
    assert {"diff3dhpe_fused_block_f32", "diff3dhpe_fused_block_bf16"} <= set(
        SIGNATURES["fused_block"])
