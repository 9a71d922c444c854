"""B1's exact-sum oracle at bf16 and its controlled run (ROADMAP C.16),
the checks ``chip_smoke.py`` phase 22c holds B1's max with:
``round_to`` rounds float64 to bf16 once (torch's own cast rounds twice,
through float32), ``fused_transformer_block_exact`` is B1 at JAX's
rounding points with float64 sums (against JAX's interpreted kernel at
bf16 within ``torch_port_helpers.assert_bf16_bars``, and the plain
version within the same bars of it), and ``fused_transformer_block_flipped``
turns exactly one rounding of the residual stream before the out-LN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops.fused_block import (
    fused_transformer_block_exact, fused_transformer_block_flipped, fused_transformer_block_ref,
    round_to,
)
from diff3dhpe_tpu.ops.fused_block import fused_transformer_block as jax_fused_block
from torch_port_helpers import assert_bf16_bars, build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

C, HEADS, N, GROUPS = 32, 4, 17, 6


def test_round_to_is_one_rounding():
    """float64 to bf16 to nearest even, at and beside the midpoints where
    a cast through float32 rounds twice."""
    g = torch.Generator().manual_seed(0)
    b = torch.randn(4096, generator=g).bfloat16()
    inf = torch.tensor(float("inf"), dtype=torch.bfloat16)
    lo, hi = b.double(), torch.nextafter(b, inf).double()
    mid, eps = (lo + hi) / 2, (hi - lo) * 2.0 ** -20
    a = torch.cat([torch.randn(4096, dtype=torch.float64, generator=g), mid - eps, mid + eps, mid])
    c = a.bfloat16()
    near = torch.stack([torch.nextafter(c, -inf), c, torch.nextafter(c, inf)]).double()
    got = round_to(a, torch.bfloat16)
    assert torch.equal((got.double() - a).abs(), (near - a).abs().min(0).values)
    assert not (got[-4096:].view(torch.int16) & 1).any()  # ties to even
    assert not torch.equal(c, got)  # torch's cast through float32 errs beside the midpoints


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    _, params, port = build_pair(rng, embed_dim=C, depth=1, num_heads=HEADS)
    # A residual stream whose rows sit far from 0 beside their spread: the
    # out-LN amplifies a turned rounding there.
    x = (rng.standard_normal((GROUPS * N, C)) + 8.0).astype(np.float32)
    t = rng.standard_normal((2, C)).astype(np.float32)
    return params, port, x, t


def _kw(port, t):
    return dict(t_rows=torch.from_numpy(t), rows_per_item=GROUPS * N // 2,
                out_ln=port.Spatial_norm)


def test_oracle_matches_jax_at_bf16(case):
    params, port, x, t = case
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    expected = jax.jit(lambda a: jax_fused_block(
        a, params["ste_block_0"], n=N, heads=HEADS, interpret=True, t_rows=jnp.asarray(t),
        rows_per_item=GROUPS * N // 2, out_ln_params=params["spatial_norm"]))(xb)
    expected = np.asarray(expected.astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        exact = fused_transformer_block_exact(xt, port.STEblocks[0], N, HEADS, **_kw(port, t))
        plain = fused_transformer_block_ref(xt, port.STEblocks[0], N, HEADS, **_kw(port, t))
    assert exact.dtype == torch.bfloat16
    assert_bf16_bars(exact.float().numpy(), expected)
    assert_bf16_bars(plain.float().numpy(), exact.float().numpy())


def test_flipped_turns_one_rounding(case):
    """At an element whose residual is not a bf16 value, the flipped run
    differs from the plain version in that row only, most at the element,
    by the out-LN's image of one bf16 step there."""
    _, port, x, t = case
    xt = torch.from_numpy(x).bfloat16()
    blk = port.STEblocks[0]
    with torch.no_grad():
        plain = fused_transformer_block_ref(xt, blk, N, HEADS, **_kw(port, t)).float()
        flipped = fused_transformer_block_flipped(xt, blk, N, HEADS, 5, 7, **_kw(port, t)).float()
    diff = (flipped - plain).abs()
    assert diff[5, 7] > 0 and diff[5, 7] == diff.max()
    assert torch.equal(diff[torch.arange(diff.shape[0]) != 5], torch.zeros_like(diff[1:]))
