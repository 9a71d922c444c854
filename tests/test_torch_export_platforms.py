"""The export's platforms (ROADMAP A.13) on the CPU: the artifact records
the device types it may be restored on (JAX's lowering platforms,
diff3dhpe_tpu/cli/export.py:112-116), ``restore_eval_step(device=...)``
runs it on one of them and refuses another, naming it, and
``cli.export --export-platforms cpu,cuda`` writes such an artifact. The
mixed step records its final step's contraction mode. A CUDA artifact
restored on the CPU and a CPU one on the card run in chip_smoke.py phase
18, where both devices exist."""
import numpy as np
import pytest
import torch

from diff3dhpe_torch.cli.export import main as export_main
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.io.export import check_platforms, export_eval_step, restore_eval_step
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F = 9
BASE = dict(stride=F, number_of_frames=F, embed_dim=32, transformer_depth=1, num_heads=4,
            timesteps=20, sampling_timesteps=2, batch_size=4, batch_size_eval=4, seed=3,
            mesh_shape="data:1")
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True)
CONFIG = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"


@pytest.fixture(scope="module")
def mixed_artifact():
    """A mixed eval step at final mode "default", exported on the CPU for
    the CPU and the card, and its runner."""
    runner = Runner(Config(**BASE, **MIXED, eval_final_prec="default"), 17, JOINTS_LEFT,
                    JOINTS_RIGHT, device="cpu")
    return export_eval_step(runner, batch_size=2, platforms=["cpu", "cuda"]), runner


def test_platforms_and_the_final_mode_are_recorded(mixed_artifact):
    data, _ = mixed_artifact
    meta = restore_eval_step(data).meta
    assert meta["platforms"] == ["cpu", "cuda"] and meta["device"] == "cpu"
    assert meta["final_prec"] == "default"


def test_restored_on_a_listed_device_equals_the_live_step(mixed_artifact):
    data, runner = mixed_artifact
    step = restore_eval_step(data, device="cpu")
    rng = np.random.default_rng(0)
    x, xf = (rng.standard_normal((2, F, 17, 2)).astype(np.float32) for _ in range(2))
    x_init = rng.standard_normal((4, F, 17, 3)).astype(np.float32)
    served = step(runner.model.state_dict(), x, xf, x_init)
    torch.testing.assert_close(served, runner.eval_step(x, xf, x_init=x_init), rtol=0, atol=0)


def test_a_device_not_listed_is_refused(tmp_path):
    runner = Runner(Config(**BASE, fast_eval=True), 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    data = export_eval_step(runner, batch_size=2)
    meta = restore_eval_step(data).meta
    assert meta["platforms"] == ["cpu"] and meta["final_prec"] is None
    with pytest.raises(ValueError, match=r"device='cuda:0' is not among this artifact's "
                                         r"platforms \['cpu'\]"):
        restore_eval_step(data, device="cuda:0")


@pytest.mark.parametrize("platforms,ok", [
    (None, True), (["cpu"], True), (["cuda", "cpu"], True), (["cpu", "cpu"], True),
    (["cuda"], False), (["tpu"], False), ([], False),
])
def test_check_platforms(platforms, ok):
    """The list must name the export's device type and only "cpu" and
    "cuda"; None is the export's device type alone."""
    if ok:
        got = check_platforms(platforms, "cpu")
        assert "cpu" in got and len(got) == len(set(got))
    else:
        with pytest.raises(ValueError, match="^export_platforms="):
            check_platforms(platforms, "cpu", field="export_platforms")


def test_cli_export_platforms(tmp_path):
    out = str(tmp_path / "eval.pt2")
    export_main(["--config", CONFIG, "-c", str(tmp_path), "--synthetic", "-frame", "9", "-s", "9",
                 "--embed_dim", "32", "--transformer_depth", "1", "--timesteps", "20",
                 "--sampling_timesteps", "2", "--batch-size-eval", "4", "--fast-eval",
                 "--output", out, "--export-platforms", "cpu, cuda"], device="cpu")
    assert restore_eval_step(out).meta["platforms"] == ["cpu", "cuda"]
