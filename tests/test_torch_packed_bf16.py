"""B6 at bfloat16: the port's ``packed_grand_attention`` on bf16 tensors
against the JAX package's ``packed_grand_attention`` (interpret mode) at
bf16, under the repo's bf16 bars (max |diff| <= 1e-2 and mean <= 1e-3 of
max|jax|): both round P to bf16 after the normalisation and the output
once, and float32 sums taken in another order flip single bf16 roundings.
On the CPU the wrapper runs its plain version (B3's at bf16); the CUDA
kernel is held against that plain version by
tests/test_torch_cuda_kernels.py and chip_smoke.py.

JAX compiles once for the file: one jitted function computes every case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops import attention as port
from diff3dhpe_tpu.ops.attention import packed_grand_attention as jax_packed
from torch_port_helpers import assert_bf16_bars
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# (g, n, d): g is no multiple of the 7, 4 and 2 groups JAX packs into a
# tile at n = 17, 27 and 64.
CASES = [(10, 17, 64), (9, 27, 64), (5, 64, 64), (10, 17, 128), (9, 27, 128), (5, 64, 128)]


def _bf16_operands(g, n, d):
    rng = np.random.default_rng(g * n + d)
    return [torch.from_numpy(rng.standard_normal((g, n, d)).astype(np.float32)).bfloat16()
            for _ in range(3)]


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def jax_results():
    """{case: ((q, k, v) bf16 torch tensors, JAX's output in float32)}."""
    inputs = {case: _bf16_operands(*case) for case in CASES}
    run_all = jax.jit(lambda ops: [jax_packed(*qkv, interpret=True, tiles_per_step=2)
                                   for qkv in ops])
    outs = run_all([[_to_jax(t) for t in inputs[case]] for case in CASES])
    return {case: (inputs[case], np.asarray(out.astype(jnp.float32)))
            for case, out in zip(CASES, outs)}


@pytest.mark.parametrize("case", CASES, ids=[f"g{g}-n{n}-d{d}" for g, n, d in CASES])
def test_packed_bf16_matches_jax_kernel(jax_results, case):
    (q, k, v), expected = jax_results[case]
    out = port.packed_grand_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # A CPU tensor takes the plain version: B3's at bf16.
    torch.testing.assert_close(out, port.packed_grand_attention_ref(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(out, port.grand_attention_fullseq_ref(q, k, v), rtol=0, atol=0)
    assert_bf16_bars(out.float().numpy(), expected)


@pytest.mark.parametrize("case", [CASES[0], CASES[5]], ids=["n17-d64", "n64-d128"])
def test_dispatcher_sends_bf16_small_groups_to_b6(jax_results, case, monkeypatch):
    """[B, H, N, D] bf16 through the dispatcher: N <= 64 reaches B6's
    wrapper (not B3's), as at float32, and matches JAX's packed kernel."""
    (q, k, v), expected = jax_results[case]
    g, n, d = case
    calls = []
    for name in ("packed_grand_attention", "grand_attention_fullseq"):
        fn = getattr(port, name)
        monkeypatch.setattr(port, name, lambda *a, _fn=fn, _name=name: (calls.append(_name),
                                                                         _fn(*a))[1])
    out = port.fused_grand_attention(*(t.view(g // 5, 5, n, d) for t in (q, k, v)))
    assert calls == ["packed_grand_attention"] and out.dtype == torch.bfloat16
    assert_bf16_bars(out.reshape(g, n, d).float().numpy(), expected)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_the_plain_version(dtype, monkeypatch):
    """On CPU tensors of either dtype B6 runs its plain version: it loads no
    library and counts no launch."""
    def no_library(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel path")

    monkeypatch.setattr(port, "_library", no_library)
    q, k, v = (t.to(dtype) for t in _bf16_operands(7, 17, 64))
    before = (port.packed_grand_attention.launches, port.packed_grand_attention.launches_bf16)
    out = port.packed_grand_attention(q, k, v)
    assert out.dtype == dtype
    torch.testing.assert_close(out, port.packed_grand_attention_ref(q, k, v), rtol=0, atol=0)
    assert (port.packed_grand_attention.launches,
            port.packed_grand_attention.launches_bf16) == before
