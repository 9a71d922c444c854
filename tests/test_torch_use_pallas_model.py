"""The port's denoiser with ``use_pallas=True`` (attention through the
dispatcher: B6 for the joints, B3 for frames beyond 64) against the flax
model with ``use_pallas=True`` (Pallas in interpret mode off the TPU), to
1e-4 abs as tests/test_torch_model.py, and against the port without it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.models import HPE_model, MixSTEDenoiser
from diff3dhpe_torch.ops import attention as port_attention
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from torch_port_helpers import build_pair, port_model


@pytest.mark.parametrize("num_frame,mode", [(9, "s2s"), (81, "s2s"), (9, "s2f")])
def test_use_pallas_model_matches_flax(rng, num_frame, mode, monkeypatch):
    kw = dict(num_frame=num_frame, num_joints=17, in_chans=2, embed_dim=32, depth=1,
              num_heads=4, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode=mode)
    _, params, plain = build_pair(rng, num_frame=num_frame, embed_dim=32, depth=1, mode=mode)
    fused = port_model(params, use_pallas=True, **kw)
    flax = FlaxMixSTE(drop_path_rate=0.0, use_pallas=True, **kw)
    x = rng.standard_normal((2, num_frame, 17, 5)).astype(np.float32)
    t = np.array([3.0, 41.0], np.float32)
    expected = np.asarray(jax.jit(lambda p, a, b: flax.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    calls = []
    for name in ("packed_grand_attention", "grand_attention_fullseq"):
        fn = getattr(port_attention, name)
        monkeypatch.setattr(port_attention, name,
                            lambda *a, _fn=fn, _name=name: (calls.append(_name), _fn(*a))[1])
    with torch.no_grad():
        out = fused(torch.from_numpy(x), torch.from_numpy(t))
        calls_fused = list(calls)
        ref = plain(torch.from_numpy(x), torch.from_numpy(t))
    # One spatial and one temporal block: small groups to B6, frames > 64 to B3.
    temporal = "grand_attention_fullseq" if num_frame > 64 else "packed_grand_attention"
    assert calls_fused == ["packed_grand_attention", temporal]
    assert calls == calls_fused  # the plain module calls neither
    assert out.shape == expected.shape
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_bf16_model_with_use_pallas_raises():
    model = MixSTEDenoiser(embed_dim=32, depth=1, num_heads=4, use_pallas=True, device="cpu")
    x, t = torch.zeros(1, 9, 17, 5), torch.zeros(1)
    model(x, t)
    with pytest.raises(ValueError, match="float32"):
        model.bfloat16()(x.bfloat16(), t)


def test_registry_names_the_two_modes():
    s2s = HPE_model("ConditionalDiffusionMixSTES2SGRANDLinLift")(
        embed_dim=32, depth=1, num_heads=4, use_pallas=True, device="cpu")
    s2f = HPE_model("ConditionalDiffusionMixSTES2FGRANDLinLift")(
        embed_dim=32, depth=1, num_heads=4, device="cpu")
    assert (s2s.mode, s2s.use_pallas, s2f.mode, s2f.use_pallas) == ("s2s", True, "s2f", False)
    with pytest.raises(KeyError, match="unknown model"):
        HPE_model("NoSuchModel")
