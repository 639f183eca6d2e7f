"""The PyTorch port's models against the JAX package's, on the CPU: the tiny
UNet forward (with and without the CFG shared prefix, both dispatch routes),
the tiny 3D-VAE decode and a tiny CLIP, all in float32 from the same
weights; and, at released width, that the converted JAX parameter trees give
exactly the port's state-dict keys and shapes (``jax.eval_shape`` and the
``meta`` device: nothing is allocated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.config import UNetVideoConfig as JUNetConfig
from upscale_a_video_tpu.config import VaeConfig as JVaeConfig
from upscale_a_video_tpu.models import AutoencoderKLVideo as JVae
from upscale_a_video_tpu.models import UNetVideoModel as JUNet
from upscale_a_video_tpu.models.clip_text import CLIPTextConfig as JClipConfig
from upscale_a_video_tpu.models.clip_text import CLIPTextModel as JClip
from upscale_a_video_tpu_torch import resolve_device
from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig
from upscale_a_video_tpu_torch.models import (AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel,
                                              UNetVideoModel)
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.weights import (CLIP_RENAMES, flatten_tree, init_random_,
                                               to_state_dict, torch_key, torch_shape)

torch.set_num_threads(1)

TINY_UNET = dict(block_out_channels=(8, 16, 16, 32), attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
TINY_VAE = dict(block_out_channels=(8, 16, 16), norm_num_groups=4)
TINY_CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=2)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + rand(rng, *np.shape(v), scale=0.1)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def tiny_unet():
    rng = np.random.default_rng(0)
    s, lr = rand(rng, 2, 8, 16, 16, 4), rand(rng, 2, 8, 16, 16, 3)
    ctx = rand(rng, 4, 7, 16)
    jm = JUNet(JUNetConfig(**TINY_UNET))
    params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), s[:1], 10, lr[:1], ctx[:1], 20))()
    flat = perturbed(params["params"], 1)
    tm = UNetVideoModel(UNetVideoConfig(**TINY_UNET)).eval()
    tm.load_state_dict(to_state_dict(flat), strict=True)
    apply = jax.jit(lambda p, a, b, c, d: jm.apply(p, a, 500, b, c, d, cfg_dup=True))
    want = np.asarray(apply({"params": unflatten(flat)}, s, lr, ctx, jnp.full((2,), 120)))
    return tm, (s, lr, ctx), want


def test_unet_forward_cfg_prefix(tiny_unet):
    tm, (s, lr, ctx), want = tiny_unet
    with torch.no_grad():
        got = tm(T(s), 500, T(lr), T(ctx), torch.full((2,), 120), cfg_dup=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_unet_module_route_and_duplicated_batch(tiny_unet):
    """The module chain (no fused ops) gives the same output, and cfg_dup
    equals running the duplicated batch."""
    tm, (s, lr, ctx), want = tiny_unet
    with torch.no_grad(), _cuda.plain_path():
        chain = tm(T(s), 500, T(lr), T(ctx), 120, cfg_dup=True)
    np.testing.assert_allclose(chain.numpy(), want, atol=1e-4 * np.abs(want).max())
    with torch.no_grad():
        dup = tm(T(np.concatenate([s, s])), 500, T(np.concatenate([lr, lr])), T(ctx), 120)
    np.testing.assert_allclose(dup.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_vae_decode():
    rng = np.random.default_rng(2)
    z = rand(rng, 1, 3, 4, 4, 4)
    jm = JVae(JVaeConfig(**TINY_VAE))
    params = jm.init(jax.random.PRNGKey(1), z, method=jm.decode)["params"]
    flat = perturbed(params, 3)
    tm = AutoencoderKLVideo(VaeConfig(**TINY_VAE)).eval()
    tm.load_state_dict(to_state_dict(flat), strict=True)
    want = np.asarray(jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(
        {"params": unflatten(flat)}, z))
    with torch.no_grad():
        got = tm.decode(T(z))
    assert got.shape == (1, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


def test_clip_text():
    ids = np.array([[49406 % 64, 5, 9, 63, 63, 63, 63], [1, 2, 3, 4, 5, 6, 7]], np.int32)
    jm = JClip(JClipConfig(**TINY_CLIP))
    params = jm.init(jax.random.PRNGKey(2), ids)["params"]
    flat = perturbed(params, 4)
    tm = CLIPTextModel(CLIPTextConfig(**TINY_CLIP)).eval()
    tm.load_state_dict(to_state_dict(flat, CLIP_RENAMES), strict=True)
    want = np.asarray(jm.apply({"params": unflatten(flat)}, ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def _keyset(jtree, renames=None):
    flat = flatten_tree(jtree)
    return {torch_key(p, renames): torch_shape(p, leaf.shape) for p, leaf in flat.items()}


def _port_keyset(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_full_width_unet_keys_and_shapes():
    jm = JUNet(JUNetConfig())
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 16, 16, 4)), 0, jnp.zeros((1, 2, 16, 16, 3)),
        jnp.zeros((1, 77, 1024)), 0))["params"]
    with torch.device("meta"):
        tm = UNetVideoModel(UNetVideoConfig())
    want = _keyset(tree)
    assert _port_keyset(tm) == want
    assert sum(np.prod(s) for s in want.values()) > 5e8


def test_full_width_vae_decoder_and_clip_keys_and_shapes():
    jv = JVae(JVaeConfig())
    tree = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 8, 8, 4)),
                                          method=jv.decode))["params"]
    with torch.device("meta"):
        tv = AutoencoderKLVideo(VaeConfig())
        tc = CLIPTextModel(CLIPTextConfig())
    assert _port_keyset(tv) == _keyset(tree)
    jc = JClip(JClipConfig())
    ctree = jax.eval_shape(lambda: jc.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 77), jnp.int32)))["params"]
    assert _port_keyset(tc) == _keyset(ctree, CLIP_RENAMES)


def test_key_rules():
    assert torch_key(("down_blocks_1", "attentions_0", "transformer_blocks_0", "attn1",
                      "to_out_0", "kernel")) == \
        "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0.weight"
    assert torch_key(("up_blocks_0", "upsamplers_0", "conv", "conv", "kernel")) == \
        "up_blocks.0.upsamplers.0.conv.weight"
    assert torch_key(("attn_temporal", "relative_attention_bias")) == \
        "attn_temporal.time_rel_pos_bias.relative_attention_bias.weight"
    assert torch_key(("time_embedding", "linear_1", "bias")) == "time_embedding.linear_1.bias"
    assert torch_shape(("conv1", "kernel"), (5, 1, 1, 8, 16)) == (16, 8, 5, 1, 1)
    assert torch_shape(("to_q", "kernel"), (8, 16)) == (16, 8)


def test_random_init_is_seeded_and_nonzero():
    def make(seed):
        with torch.device("meta"):
            m = UNetVideoModel(UNetVideoConfig(**TINY_UNET))
        return init_random_(m.to_empty(device="cpu"), torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if va.ndim > 1:
            assert va.abs().sum() > 0 and not torch.equal(va, vc), k


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
