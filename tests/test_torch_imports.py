"""The port's import boundary: diff3dhpe_torch, chip_smoke.py and the
port's bench and study scripts (bench_torch.py,
scripts/accuracy_study_torch.py, scripts/train_bench_torch.py,
scripts/study_training_check_torch.py, scripts/c9_check_torch.py) load
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
# The training slice's entry points among them.
from diff3dhpe_torch.engine import make_val_step
from diff3dhpe_torch.engine.runner import Runner, check_trainable
from diff3dhpe_torch.parallel import DataMesh, entry_ranks, start_ranks
from diff3dhpe_torch.parallel.tensor import gather_params, shard_model, shard_params
from diff3dhpe_torch.io import (load_matching_params, restore_checkpoint, rng_state_from_json,
                                rng_state_to_json, save_checkpoint)
assert callable(Runner.fit) and callable(Runner._validate) and callable(Runner._export_curves)
# The entry points beside the package: imported as modules, and every
# import statement in them (function bodies included) read from the source.
sys.path[:0] = [".", "scripts"]
scripts = {"chip_smoke": "chip_smoke.py", "bench_torch": "bench_torch.py",
           "accuracy_study_torch": "scripts/accuracy_study_torch.py",
           "train_bench_torch": "scripts/train_bench_torch.py",
           "study_training_check_torch": "scripts/study_training_check_torch.py",
           "c9_check_torch": "scripts/c9_check_torch.py"}
imported = {}
for module, path in scripts.items():
    importlib.import_module(module)
    found = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module.split(".")[0])
    imported[path] = sorted(found)
loaded = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and m.split(".")[0] in BANNED
)
print("MODULES", sorted(names), "LOADED", loaded, "SCRIPT_IMPORTS", imported)
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert "LOADED []" in line, line
    script_imports = ast.literal_eval(line.split("SCRIPT_IMPORTS ", 1)[1])
    assert set(script_imports) == {"chip_smoke.py", "bench_torch.py",
                                   "scripts/accuracy_study_torch.py",
                                   "scripts/train_bench_torch.py",
                                   "scripts/study_training_check_torch.py",
                                   "scripts/c9_check_torch.py"}
    for path, imports in script_imports.items():
        assert "diff3dhpe_torch" in imports, (path, imports)
        assert not set(imports) & {"jax", "jaxlib", "flax", "optax", "orbax",
                                   "diff3dhpe_tpu"}, (path, imports)
    # Every sub-package was walked, the evaluate path's among them.
    walked = set(ast.literal_eval(line.split("MODULES ", 1)[1].split(" LOADED", 1)[0]))
    assert {f"diff3dhpe_torch.{name}" for name in (
        "cli.args", "cli.run", "cli.run_3dhp", "config.config", "data.chunking",
        "data.custom", "data.dataset", "data.h36m", "data.humaneva", "data.mpiinf3dhp",
        "data.prepare_h36m", "device",
        "data.mocap", "data.synthetic", "diffusion.gaussian_diffusion", "engine.runner",
        "engine.steps", "geometry.camera", "geometry.quaternion", "geometry.skeleton",
        "io.checkpoint", "io.convert", "metrics.metrics", "models.fast_eval", "models.mixste",
        "models.registry", "ops.attention", "ops.fused_block", "utils.misc", "utils.profiling",
        "utils.supervise", "utils.sync",
        # The serving and visualisation slice's.
        "cli.export", "cli.viz", "io.export", "ops._library", "viz", "viz.render",
        # The data-parallel slice's.
        "parallel", "parallel.mesh",
        # The tensor-parallel slice's.
        "parallel.tensor",
    )} <= walked, sorted(walked)


_PROBE_NO_MPL = r"""
import sys
for banned in ("jax", "jaxlib", "flax", "optax", "orbax", "diff3dhpe_tpu", "matplotlib", "PIL",
               "imageio"):
    sys.modules[banned] = None
import diff3dhpe_torch.viz, diff3dhpe_torch.cli.viz, diff3dhpe_torch.io.export
from diff3dhpe_torch.cli.viz import compute, main, render, world_views
from diff3dhpe_torch.viz.render import _import_mpl
try:
    _import_mpl()
except ImportError:
    print("RENDER_REFUSED")
"""


def test_visualisation_imports_without_matplotlib():
    """The render layer imports matplotlib (and PIL, imageio) inside each
    function, as JAX's ``_import_mpl`` does: the package, ``cli.viz`` and its
    model work import without them, and rendering raises an ImportError."""
    proc = subprocess.run([sys.executable, "-c", _PROBE_NO_MPL], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "RENDER_REFUSED"


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


def test_bench_and_study_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """bench_torch.py, scripts/train_bench_torch.py and
    scripts/accuracy_study_torch.py measure on the card unless the caller
    asks for the CPU: without one they raise before any work."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import accuracy_study_torch
    import bench_torch
    import train_bench_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_torch.measure(frames=9, embed=32, depth=1, heads=4, ddim=2, iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        train_bench_torch.measure("fast_f32", 2, 9, embed=32, depth=1, heads=4)
    with pytest.raises(RuntimeError, match="cuda"):
        accuracy_study_torch.main({"STUDY_DIR": str(tmp_path)})
    assert list(tmp_path.iterdir()) == []


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
