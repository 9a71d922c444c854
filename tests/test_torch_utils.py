"""The port's measurement helpers against the JAX package's:
``utils/sync.py::device_sync``, ``utils/profiling.py``'s ``param_count``,
``flops_of`` and ``trace``, and ``utils/supervise.py::run_supervised`` on
the cases of tests/test_supervise.py, on the CPU."""
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.models import MixSTEDenoiser as TorchMixSTE
from diff3dhpe_torch.utils.profiling import denoiser_matmul_flops, flops_of, param_count, trace
from diff3dhpe_torch.utils.supervise import run_supervised
from diff3dhpe_torch.utils.sync import device_sync
from diff3dhpe_tpu.utils.profiling import param_count as jax_param_count
from diff3dhpe_tpu.utils.sync import device_sync as jax_device_sync
from torch_port_helpers import build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

PY = sys.executable
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RNG = np.random.default_rng(0)
_A, _B = _RNG.standard_normal((3, 4)).astype(np.float32), _RNG.standard_normal(5).astype(np.float32)
SYNC_CASES = {
    "array": _A,
    "dict_in_key_order": {"b": _B, "a": _A},
    "nested_list": [[_B, _A], _A],
    "tuple": (_A[1:], _B),
    "empty_leaf": [np.zeros((0, 3), np.float32), _A],
    "no_leaves": [],
}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_device_sync_matches_jax(case):
    tree = SYNC_CASES[case]
    got = device_sync(_tree_map(torch.from_numpy, tree))
    assert isinstance(got, float)
    assert got == jax_device_sync(_tree_map(jnp.asarray, tree))


def test_param_count_matches_jax():
    _, params, port = build_pair(np.random.default_rng(1), embed_dim=32, depth=2, num_heads=4)
    expected = jax_param_count(params)
    assert param_count(port) == param_count(port.state_dict()) == expected > 0


def test_flops_of_counts_the_plain_module():
    """flops_of on the plain module against the analytic count, at the bar
    of tests/test_metrics.py::test_analytic_denoiser_flops_vs_xla: the
    analytic count leaves out the time MLP and the elementwise work, so it
    lands below the counted total, within 35%."""
    frames, joints, embed, depth = 9, 17, 64, 2
    model = TorchMixSTE(num_frame=frames, num_joints=joints, embed_dim=embed, depth=depth,
                        num_heads=8, device="cpu").eval()
    counted = flops_of(model, torch.zeros(1, frames, joints, 5), torch.zeros(1))
    analytic = denoiser_matmul_flops(frames, joints, embed, depth)
    assert counted is not None
    assert 0.65 * counted <= analytic <= counted * 1.001
    # Twice the rows, twice the FLOPs.
    assert flops_of(model, torch.zeros(2, frames, joints, 5), torch.zeros(2)) == 2 * counted
    # Nothing the counter has a formula for: None.
    assert flops_of(lambda x: x + 1, torch.zeros(3)) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = [p for p in log_dir.iterdir() if p.name.endswith(".pt.trace.json")]
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "traceEvents" in files[0].read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# run_supervised on the cases of tests/test_supervise.py.

def test_supervised_success_passthrough():
    rc, out = run_supervised([PY, "-c", "print('{\"metric\": \"ok\"}')"], timeout_s=30,
                             retries=0)
    assert rc == 0
    assert out.strip() == b'{"metric": "ok"}'


def test_supervised_stall_is_killed_and_retried(tmp_path):
    # Attempt 1 finds no marker, drops it and hangs past the timeout;
    # attempt 2 sees the marker and succeeds.
    marker = tmp_path / "attempted"
    child = (
        "import os, sys, time\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    time.sleep(60)\n"
        "print('recovered')\n"
    )
    t0 = time.time()
    rc, out = run_supervised([PY, "-c", child], timeout_s=6, retries=1)
    assert rc == 0
    assert out.strip() == b"recovered"
    assert time.time() - t0 < 55  # the stalled attempt did not run its 60 s


def test_supervised_stall_exhausts_retries():
    rc, out = run_supervised([PY, "-c", "import time; time.sleep(60)"], timeout_s=1, retries=1)
    assert rc == 124
    assert out == b""


def test_supervised_nonzero_exit_is_retried(tmp_path):
    marker = tmp_path / "attempted"
    child = (
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    sys.exit(3)\n"
        "print('second try')\n"
    )
    rc, out = run_supervised([PY, "-c", child], timeout_s=30, retries=1)
    assert rc == 0
    assert out.strip() == b"second try"


def test_supervised_sigterm_kills_child_group(tmp_path):
    # A killed supervisor must not leave its child group running.
    pidfile = tmp_path / "grandchild.pid"
    grandchild = (
        "import os, time\n"
        f"open({str(pidfile)!r}, 'w').write(str(os.getpid()))\n"
        "time.sleep(120)\n"
    )
    supervisor = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from diff3dhpe_torch.utils.supervise import run_supervised\n"
        f"run_supervised([sys.executable, '-c', {grandchild!r}], timeout_s=120, retries=0)\n"
    )
    sup = subprocess.Popen([PY, "-c", supervisor])
    deadline = time.time() + 60
    while not (pidfile.exists() and pidfile.read_text()) and time.time() < deadline:
        time.sleep(0.2)
    assert pidfile.exists(), "grandchild never started"
    gpid = int(pidfile.read_text())
    sup.send_signal(signal.SIGTERM)
    assert sup.wait(timeout=30) != 0
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            os.kill(gpid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.2)
    else:
        os.kill(gpid, 9)
        raise AssertionError("grandchild survived the supervisor's SIGTERM")


def test_supervised_env_is_forwarded():
    env = dict(os.environ, SUPERVISE_TEST_VAR="42")
    rc, out = run_supervised([PY, "-c", "import os; print(os.environ['SUPERVISE_TEST_VAR'])"],
                             timeout_s=30, retries=0, env=env)
    assert rc == 0
    assert out.strip() == b"42"
