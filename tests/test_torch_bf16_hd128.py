"""The bf16 path at head width 128 (embed 256 with 2 heads, the width of
``configs/h36m_gt_s2s_243f_tpu.json``'s 4 heads at embed 512) through the
port's plain versions on the CPU, against the JAX package (Pallas in
interpret mode):

- B3 at bf16 (``grand_attention_fullseq``) against
  ``grand_attention_pallas_3d``, and B1's plain version at bf16 against
  JAX ``fused_transformer_block``, under the bf16 bars of
  ``torch_port_helpers.assert_bf16_bars`` (both round at the same points);
- ``Runner.evaluate`` in the mixed mode with ``remat=True`` against JAX's
  runner (rtol 2e-3, as tests/test_torch_runner.py holds the mixed case),
  and against the port's own ``remat=False`` run, bit for bit;
- the TPU-recommended config file through the port's loader, accepted by
  ``check_supported`` on a CUDA device.

The CUDA kernels are held against the same plain versions at head_dim 128
by tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.config import Config, load_config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine.runner import Runner, check_supported
from diff3dhpe_torch.ops import attention as port
from diff3dhpe_torch.ops.fused_block import fused_transformer_block, fused_transformer_block_ref
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.ops.attention import grand_attention_pallas_3d
from diff3dhpe_tpu.ops.fused_block import fused_transformer_block as jax_fused_block
from torch_port_helpers import (
    JOINTS_LEFT, JOINTS_RIGHT, assert_bf16_bars, build_pair, jax_x_init, perturb,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

EMBED, HEADS, D = 256, 2, 128
TPU_CONFIG = "configs/h36m_gt_s2s_243f_tpu.json"


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("n", [9, 27])
def test_fullseq_bf16_matches_jax_at_head_dim_128(rng, n):
    q, k, v = (_bf16(rng, 3, n, D) for _ in range(3))
    expected = jax.jit(lambda a, b, c: grand_attention_pallas_3d(a, b, c, interpret=True))(
        *map(_to_jax, (q, k, v)))
    out = port.grand_attention_fullseq(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out, port.grand_attention_fullseq_ref(q, k, v), rtol=0, atol=0)
    assert_bf16_bars(out.float().numpy(), np.asarray(expected.astype(jnp.float32)))


@pytest.fixture(scope="module")
def pair():
    """(flax model, numpy params, port model) at embed 256, 2 heads, depth 1."""
    return build_pair(np.random.default_rng(1), num_frame=9, embed_dim=EMBED, depth=1,
                      num_heads=HEADS)


@pytest.mark.parametrize("n,n_pad", [(17, None), (27, 32)])
def test_bf16_block_matches_jax_at_head_dim_128(rng, pair, n, n_pad):
    """With the time add, the out-LN and drop-path; with n_pad > n the pad
    rows are masked as keys in both."""
    _, params, model = pair
    groups, items = 4, 2
    r = groups * (n_pad or n)
    x = jnp.asarray(rng.standard_normal((r, EMBED)).astype(np.float32)).astype(jnp.bfloat16)
    t = rng.standard_normal((items, EMBED)).astype(np.float32)
    dp = ((rng.random((r, 2)) < 0.6) / 0.6).astype(np.float32)
    expected = jax.jit(lambda a: jax_fused_block(
        a, params["ste_block_0"], n=n, heads=HEADS, interpret=True, pre_padded_n8=n_pad,
        out_ln_params=params["spatial_norm"], t_rows=jnp.asarray(t), rows_per_item=r // items,
        dp_scales=jnp.asarray(dp)))(x)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    kw = dict(n_pad=n_pad, t_rows=torch.from_numpy(t), rows_per_item=r // items,
              out_ln=model.Spatial_norm, dp_scales=torch.from_numpy(dp))
    with torch.no_grad():
        ref = fused_transformer_block_ref(xt, model.STEblocks[0], n, HEADS, **kw)
        out = fused_transformer_block(xt, model.STEblocks[0], n, HEADS, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    real = lambda a: np.asarray(a, np.float32).reshape(groups, n_pad or n, EMBED)[:, :n]
    assert_bf16_bars(real(ref.float().numpy()), real(expected.astype(jnp.float32)))


BASE = dict(subjects_train="S1", subjects_test="S9", number_of_frames=9, stride=9,
            embed_dim=EMBED, transformer_depth=1, num_heads=HEADS, timesteps=50,
            sampling_timesteps=3, batch_size_eval=4, actions="*", mesh_shape="data:1", seed=5,
            fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1,
            eval_f32_head=True)


@pytest.fixture(scope="module")
def evaluated():
    """JAX's mixed evaluate at head_dim 128 with remat on, the x_T it drew,
    and the port's runners with remat on and off on the same weights and
    dataset."""
    kw = {**BASE, "remat": True}
    cfg, jax_cfg = Config(**kw), JaxConfig(**kw)
    data_kw = dict(subjects=("S1", "S9"), n_frames=100, seed=1)
    ds, kps = make_synthetic_h36m_like(**data_kw)
    jds, jkps = jax_make_synthetic(**data_kw)
    test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
    jax_runner = JaxRunner(jax_cfg, 17, JOINTS_LEFT, JOINTS_RIGHT)
    params = perturb(jax.tree.map(np.asarray, jax_runner.init_params()), np.random.default_rng(2))
    jax_runner.set_params(params)
    key = jax.random.PRNGKey(11)
    expected = jax_runner.evaluate(JaxPoseDataset(jax_cfg, jds, "data", "test",
                                                  keypoints_data=jkps),
                                   action="Walking", key=key)
    subkeys = []
    for _ in test_ds.batches(cfg.batch_size_eval):
        key, sub = jax.random.split(key)
        subkeys.append(sub)
    x_init = lambda i: jax_x_init(subkeys[i], 2 * cfg.batch_size_eval, (9, 17, 3))
    runners = {}
    for remat in (True, False):
        runners[remat] = Runner(Config(**{**kw, "remat": remat}), 17, JOINTS_LEFT, JOINTS_RIGHT,
                                device="cpu")
        runners[remat].set_params(params)
    return expected, test_ds, x_init, runners


def test_mixed_evaluate_with_remat_matches_jax_at_head_dim_128(evaluated):
    expected, test_ds, x_init, runners = evaluated
    out = runners[True].evaluate(test_ds, action="Walking", x_init=x_init)
    assert out["n_frames"] == expected["n_frames"] > 0
    for k in ("e1", "e2", "e3", "ev"):
        assert np.isfinite(out[k])
        np.testing.assert_allclose(out[k], expected[k], rtol=2e-3, atol=1e-3, err_msg=k)


def test_remat_changes_nothing_on_evaluate(evaluated):
    """remat only chooses what the backward of training recomputes: the
    evaluation with it on gives the bits of the one without it."""
    _, test_ds, x_init, runners = evaluated
    on, off = (runners[r].evaluate(test_ds, action="Walking", x_init=x_init) for r in (True, False))
    np.testing.assert_array_equal(on["predictions"], off["predictions"])
    for k in ("e1", "e2", "e3", "ev"):
        assert on[k] == off[k]


def test_tpu_config_is_accepted_on_a_gpu():
    """The TPU-recommended config as a whole: head_dim 128 in the mixed
    mode with remat on."""
    cfg = load_config(TPU_CONFIG)
    assert (cfg.num_heads, cfg.embed_dim, cfg.remat, cfg.fast_eval) == (4, 512, True, True)
    assert (cfg.compute_dtype, cfg.eval_f32_final_steps, cfg.eval_f32_head) == ("bfloat16", 1,
                                                                                True)
    check_supported(cfg, torch.device("cuda"))
    check_supported(cfg)
