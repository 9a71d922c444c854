"""ROADMAP C.9 on the CPU: B4's plain version at bf16 (the rounding points
of JAX's Pallas tile, which the CUDA kernel keeps) against JAX's
interpreted ``grand_attention_bwd_pallas`` at bf16, at the attention
scores where the 4-head bf16 training stalls (max |q·kᵀ·d^-½| about 70,
head_dim 128, 243 frames), and both against the float64 gradients of the
same bf16 operands. On the card, scripts/c9_check_torch.py holds the
kernel against the same plain version and against float64 in every call
of that training."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops.attention import grand_attention_bwd, grand_attention_bwd_ref
from diff3dhpe_tpu.ops.attention import grand_attention_bwd_pallas
from torch_port_helpers import assert_bf16_bars
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

G, N, D = 3, 243, 128


def _operands(smax, seed):
    """bf16 q, k, v, dO [G, N, D] (as float32 arrays holding bf16 values),
    q and k scaled so that the largest |q·kᵀ·d^-½| is ``smax``."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((G, N, D)).astype(np.float32) for _ in range(4))
    s = np.abs(q @ k.transpose(0, 2, 1)).max() * D ** -0.5
    q, k = q * np.sqrt(smax / s), k * np.sqrt(smax / s)
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v, do)]


def _exact(q, k, v, do):
    q, k, v, do = (a.astype(np.float64) for a in (q, k, v, do))
    s = q @ k.transpose(0, 2, 1) * D ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = do @ v.transpose(0, 2, 1)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True)) * D ** -0.5
    return ds @ k, ds.transpose(0, 2, 1) @ q, p.transpose(0, 2, 1) @ do - do


def _rel_l2(a, exact):
    return np.linalg.norm(a.astype(np.float64) - exact) / np.linalg.norm(exact)


@pytest.mark.parametrize("smax,seed", [(70.0, 0), (70.0, 1), (5.0, 2)])
def test_b4_plain_version_at_the_stall_scores_matches_pallas(smax, seed):
    q, k, v, do = _operands(smax, seed)
    got_smax = np.abs(q @ k.transpose(0, 2, 1)).max() * D ** -0.5
    assert abs(got_smax - smax) <= 0.02 * smax
    with jax.default_matmul_precision("highest"):
        compiled = jax.jit(lambda *a: grand_attention_bwd_pallas(
            *(x.astype(jnp.bfloat16) for x in a), interpret=True)).lower(
                q, k, v, do).compile(compiler_options={"xla_allow_excess_precision": False})
        expected = [np.asarray(g, np.float32) for g in compiled(q, k, v, do)]
    tensors = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    got = grand_attention_bwd(*tensors)  # on the CPU: the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, grand_attention_bwd_ref(*tensors)))
    exact = _exact(q, k, v, do)
    for a, b, e in zip(got, expected, exact):
        a = a.float().numpy()
        assert_bf16_bars(a, b)
        # Both round at the same points: as near the float64 gradients as
        # JAX's, to a tenth of a bf16 step (2^-8) of relative L2 error.
        assert abs(_rel_l2(a, e) - _rel_l2(b, e)) <= 2 ** -8 / 10
        assert _rel_l2(a, e) <= 2 ** -5


def test_study_trains_as_jax_did_without_the_attention_backward_kernels(tmp_path):
    """STUDY_ATTN_BWD=0 trains the study as JAX's did (fast_train without
    the attention backward kernels) into its own files, beside the default
    run's; a tiny run writes them."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import accuracy_study_torch as study
    from test_torch_accuracy_study import TINY

    default, jax_like = study.settings(TINY), study.settings({**TINY, "STUDY_ATTN_BWD": "0"})
    assert study.study_config(default, "x").fast_train_attn_bwd
    cfg = study.study_config(jax_like, "x")
    assert cfg.fast_train and not cfg.fast_train_attn_bwd
    assert (default["suffix"], jax_like["suffix"]) == ("_h4", "_h4_no_attn_bwd")
    assert study.fingerprint(jax_like) == dict(study.fingerprint(default), attn_bwd=False)
    table = study.main({**TINY, "STUDY_ATTN_BWD": "0", "STUDY_DIR": str(tmp_path),
                        "STUDY_EPOCHS": "1", "STUDY_VARIANTS": "fast_mixed1"})
    assert table["config"]["train_attn_bwd"] is False
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "accuracy_study_torch_h4_no_attn_bwd.json", "study_ckpt_torch_h4_no_attn_bwd",
        "study_out_torch_h4_no_attn_bwd"]
