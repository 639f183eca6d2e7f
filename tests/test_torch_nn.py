"""The PyTorch port's ``nn`` modules against the JAX package's, on the CPU.

Each JAX module is initialised, every parameter is moved off its initial
value with seeded noise (so no zero-initialised gate hides a path), the tree
goes through the port's ``weights.to_state_dict`` into the torch module with
``strict=True``, and both run the same numpy inputs in float32. Modules that
dispatch to a fused op run twice on the port side: through the fused op's
plain version (the route the card's kernels take) and through the module
chain (``plain_path``, the route the card takes when a gate fails).
Tolerances are float32 rounding of the same arithmetic in another order.
"""

import jax
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.nn import attention as ja
from upscale_a_video_tpu.nn import blocks as jb
from upscale_a_video_tpu.nn import temporal as jt
from upscale_a_video_tpu.nn import unet_blocks as ju
from upscale_a_video_tpu_torch.nn import attention as ta
from upscale_a_video_tpu_torch.nn import blocks as tb
from upscale_a_video_tpu_torch.nn import temporal as tt
from upscale_a_video_tpu_torch.nn import unet_blocks as tu
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.weights import flatten_tree, to_state_dict

torch.set_num_threads(1)


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


def port(jmodule, tmodule, args, seed=0):
    """Init ``jmodule`` on ``args``, perturb every parameter, load the same
    numbers into ``tmodule``; return (jax apply fn, torch module)."""
    params = jmodule.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed + 100)
    flat = {k: np.asarray(v) + rand(rng, *np.shape(v), scale=0.1)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}
    tmodule.load_state_dict(to_state_dict(flat), strict=True)
    tmodule.eval()
    pj = {"params": unflatten(flat)}

    def run_jax(*a):
        return np.asarray(jmodule.apply(pj, *a))

    return run_jax, tmodule


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def check(j, t, atol):
    np.testing.assert_allclose(t.detach().numpy(), j, atol=atol, rtol=0)


def both_routes(fn):
    """Port output through the fused-op route and through the module chain."""
    with torch.no_grad():
        fused = fn()
        with _cuda.plain_path():
            chain = fn()
    return fused, chain


def test_resnet_block_3d_with_temb_and_shortcut():
    rng = np.random.default_rng(0)
    x, temb = rand(rng, 2, 3, 8, 8, 16), rand(rng, 2, 64)
    run, m = port(jb.ResnetBlock3D(in_channels=16, out_channels=32, temb_channels=64, groups=4,
                                   eps=1e-5), tb.ResnetBlock3D(16, 32, 64, groups=4, eps=1e-5),
                  (x, temb))
    with torch.no_grad():
        check(run(x, temb), m(T(x), T(temb)), 5e-5)


@pytest.mark.parametrize("k,temb", [((5, 1, 1), True), ((3, 1, 1), False)])
def test_resnet_block_3dcnn_both_routes(k, temb):
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 8, 4, 4, 32)
    te = rand(rng, 2, 64) if temb else None
    tch = 64 if temb else None
    run, m = port(jb.ResnetBlock3DCNN(in_channels=32, temporal_kernel=k, temb_channels=tch,
                                      groups=8, groups_out=8),
                  tb.ResnetBlock3DCNN(32, temb_channels=tch, groups=8, groups_out=8,
                                      temporal_kernel=k), (x, te))
    want = run(x, te)
    fused, chain = both_routes(lambda: m(T(x), None if te is None else T(te)))
    check(want, fused, 5e-5)
    check(want, chain, 5e-5)


@pytest.mark.parametrize("size", [None, (7, 9)])
def test_upsample_3d(size):
    rng = np.random.default_rng(2)
    x = rand(rng, 1, 2, 4, 5, 8)
    run, m = port(jb.Upsample3D(channels=8), tb.Upsample3D(8), (x,))
    with torch.no_grad():
        check(run(x, size), m(T(x), size), 2e-5)


def test_downsample_and_timestep_embedding():
    rng = np.random.default_rng(3)
    x = rand(rng, 1, 2, 8, 8, 8)
    run, m = port(jb.Downsample3D(channels=8, padding=1), tb.Downsample3D(8), (x,))
    with torch.no_grad():
        check(run(x), m(T(x)), 2e-5)
    e = rand(rng, 3, 16)
    run, m = port(jb.TimestepEmbedding(time_embed_dim=64), tb.TimestepEmbedding(16, 64), (e,))
    with torch.no_grad():
        check(run(e), m(T(e)), 2e-5)


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(cross):
    rng = np.random.default_rng(4)
    x, ctx = rand(rng, 2, 10, 16), rand(rng, 2, 7, 12)
    args = (x, ctx) if cross else (x,)
    run, m = port(ja.CrossAttention(query_dim=16, cross_attention_dim=12 if cross else None,
                                    heads=2, dim_head=8),
                  ta.CrossAttention(16, 12 if cross else None, 2, 8), args)
    with torch.no_grad():
        check(run(*args), m(*(T(a) for a in args)), 2e-5)


def test_temporal_attention():
    rng = np.random.default_rng(5)
    x = rand(rng, 6, 8, 32)
    run, m = port(ja.TemporalAttention(query_dim=32, heads=2, dim_head=16),
                  ta.TemporalAttention(32, 2, 16), (x,))
    with torch.no_grad():
        check(run(x), m(T(x)), 2e-5)


@pytest.mark.parametrize("only_cross", [False, True])
def test_basic_transformer_block_both_routes(only_cross):
    rng = np.random.default_rng(6)
    b, t, s, c = 2, 8, 6, 32
    x, ctx = rand(rng, b * t, s, c), rand(rng, b, 7, 12)
    ctx_rep = np.repeat(ctx, t, axis=0)
    run, m = port(ja.BasicTransformerBlock(dim=c, heads=2, dim_head=16, cross_attention_dim=12,
                                           only_cross_attention=only_cross),
                  ta.BasicTransformerBlock(c, 2, 16, 12, only_cross), (x, ctx_rep, t))
    want = run(x, ctx_rep, t)
    fused, chain = both_routes(lambda: m(T(x), T(ctx), t))
    check(want, fused, 5e-5)
    check(want, chain, 5e-5)


def test_transformer_3d_model():
    rng = np.random.default_rng(7)
    x, ctx = rand(rng, 2, 8, 4, 4, 32), rand(rng, 2, 7, 12)
    run, m = port(ja.Transformer3DModel(heads=2, dim_head=16, in_channels=32,
                                        cross_attention_dim=12, norm_num_groups=8,
                                        only_cross_attention=True),
                  ta.Transformer3DModel(2, 16, 32, cross_attention_dim=12, norm_num_groups=8,
                                        only_cross_attention=True), (x, ctx))
    want = run(x, ctx)
    fused, chain = both_routes(lambda: m(T(x), T(ctx)))
    check(want, fused, 1e-4)
    check(want, chain, 1e-4)


def test_temporal_module_3d():
    rng = np.random.default_rng(8)
    x, temb = rand(rng, 2, 8, 4, 4, 16), rand(rng, 2, 64)
    run, m = port(jt.TemporalModule3D(in_channels=16, temb_channels=64, groups=4),
                  tt.TemporalModule3D(16, 64, 4), (x, temb))
    with torch.no_grad():
        check(run(x, temb), m(T(x), T(temb)), 1e-4)


def test_vae_mid_block_spatial_attention_bf16_operands():
    """The VAE attention takes bf16 q/k/v on the fp32 path on both sides."""
    rng = np.random.default_rng(9)
    x = rand(rng, 1, 2, 4, 4, 32)
    run, m = port(ju.UNetMidBlock3D(in_channels=32, resnet_groups=8),
                  tu.UNetMidBlock3D(32, resnet_groups=8), (x,))
    with torch.no_grad():
        check(run(x), m(T(x)), 2e-4)


def test_group_norm_and_layer_norm():
    rng = np.random.default_rng(10)
    x = rand(rng, 2, 3, 4, 4, 16) + 3.0
    gn = tb.GroupNorm(4, 16, 1e-6)
    xf = x.reshape(2, -1, 4, 4)
    want = (xf - xf.mean(axis=(1, 3), keepdims=True)) / np.sqrt(
        xf.var(axis=(1, 3), keepdims=True) + 1e-6)
    with torch.no_grad():
        check(want.reshape(x.shape), gn(T(x)), 5e-5)
        ln = tb.LayerNorm(16, eps=1e-5)
        check(torch.nn.functional.layer_norm(T(x), (16,), eps=1e-5).numpy(), ln(T(x)), 5e-5)
