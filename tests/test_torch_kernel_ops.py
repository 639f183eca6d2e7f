"""The plain versions of the port's fused temporal attention, fused GroupNorm
and temporal conv against the JAX package's functions, their Hopper gates,
and the two modules that route to them (``TemporalAttention`` on its kernel
route and on its module route, ``FusedGroupNorm``), on the CPU.

Inputs come from numpy with a seed. The JAX functions run through their
non-Pallas references (``use_pallas=False`` / ``_reference``), the port's
wrappers take their plain versions because the tensors lie on the CPU.
Float32 tolerances are rounding of the same arithmetic in another order;
bf16 ones are one bf16 unit in the last place of the largest value (both
sides compute in float32 and round once, so a rare element lands on the
other side of a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.nn import attention as ja
from upscale_a_video_tpu.nn import blocks as jb
from upscale_a_video_tpu.ops import fused_groupnorm as j_gn
from upscale_a_video_tpu.ops import fused_temporal_attention as j_fta
from upscale_a_video_tpu.ops import temporal_conv as j_tc
from upscale_a_video_tpu_torch.nn import attention as ta
from upscale_a_video_tpu_torch.nn import blocks as tb
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.ops import fused_groupnorm as t_gn
from upscale_a_video_tpu_torch.ops import fused_temporal_attention as t_fta
from upscale_a_video_tpu_torch.ops import temporal_attention_block as t_tab
from upscale_a_video_tpu_torch.ops import temporal_conv as t_tc
from upscale_a_video_tpu_torch.weights import flatten_tree, to_state_dict

torch.set_num_threads(1)
BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(j, t, atol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, dtype=np.float32),
                               atol=atol, rtol=0)


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
    return (lambda *a: np.asarray(jmodule.apply(pj, *a))), tmodule


# ------------------------------------------------- fused temporal attention

@pytest.mark.parametrize("t", [5, 8])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_temporal_attention_plain(t, with_bias):
    rng = np.random.default_rng(t)
    q, k, v = (rand(rng, 6, t, 3, 16) for _ in range(3))
    bias = rand(rng, 3, t, t) if with_bias else None
    want = j_fta._reference(q, k, v, bias)
    np.testing.assert_array_equal(
        want, j_fta.fused_temporal_attention(q, k, v, bias, use_pallas=False))
    got = t_fta.fused_temporal_attention(T(q), T(k), T(v), None if bias is None else T(bias))
    close(want, got, 1e-5)


def test_temporal_attention_plain_is_shared_with_the_block():
    """One plain version of the attention core serves both kernels."""
    assert t_tab.temporal_attention_plain is t_fta.temporal_attention_plain


def test_fused_temporal_attention_gate():
    bf = dict(dtype=torch.bfloat16, device="meta")
    for bp, t, h, d in ((7680, 5, 8, 64), (1920, 5, 8, 64), (480, 5, 8, 128), (2048, 8, 8, 64),
                        (4, 16, 8, 128), (3, 1, 2, 16)):
        assert t_fta.fused_temporal_attention_fits(torch.empty(bp, t, h, d, **bf))
    assert not t_fta.fused_temporal_attention_fits(torch.empty(4, 17, 8, 64, **bf))
    assert not t_fta.fused_temporal_attention_fits(torch.empty(4, 5, 8, 40, **bf))
    assert not t_fta.fused_temporal_attention_fits(torch.empty(4, 5, 8, 64, device="meta"))
    assert not t_fta.fused_temporal_attention_fits(torch.empty(4, 16, 64, 64, **bf))


@pytest.mark.parametrize("t", [5, 8])
def test_temporal_attention_module_both_routes(t):
    """TemporalAttention through the fused op's plain version (the route of
    the card's kernel) and through the module chain (the plain attention)."""
    rng = np.random.default_rng(20 + t)
    x = rand(rng, 6, t, 32)
    run, m = port(ja.TemporalAttention(query_dim=32, heads=2, dim_head=16),
                  ta.TemporalAttention(32, 2, 16), (x,))
    want = run(x)
    with torch.no_grad():
        fused = m(T(x))
        with _cuda.plain_path():
            chain = m(T(x))
    close(want, fused, 2e-5)
    close(want, chain, 2e-5)


# ------------------------------------------------------------- GroupNorm

@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_group_norm_plain(act, dtype):
    rng = np.random.default_rng(30)
    x = rand(rng, 2, 3, 4, 5, 32) * 2 + 0.5
    scale, bias = 1 + rand(rng, 32, scale=0.1), rand(rng, 32, scale=0.1)
    if dtype == "bfloat16":
        xt = T(x).to(torch.bfloat16)
        xj = jnp.asarray(x, dtype=jnp.bfloat16)
    else:
        xt, xj = T(x), x
    want = np.asarray(j_gn.fused_group_norm(xj, scale, bias, 8, eps=1e-6, act=act,
                                            use_pallas=False)).astype(np.float32)
    got = t_gn.fused_group_norm(xt, T(scale), T(bias), 8, eps=1e-6, act=act)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    atol = 2e-5 if dtype == "float32" else BF16_ULP * np.abs(want).max()
    close(want, got, atol)


def test_fused_group_norm_gate():
    meta = dict(device="meta")
    for shape, dt in (((1, 3, 96, 160, 512), torch.float32), ((1, 3, 384, 640, 128), torch.float32),
                      ((4, 8, 64, 64, 256), torch.bfloat16)):
        x = torch.empty(shape, dtype=dt, **meta)
        assert t_gn.fused_group_norm_fits(x, 32, "silu") and t_gn.fused_group_norm_fits(x, 32, None)
    assert not t_gn.fused_group_norm_fits(torch.empty(2, 8, 8, 6, **meta), 3, None)  # C % 4
    assert not t_gn.fused_group_norm_fits(torch.empty(2, 8, 8, 64, **meta), 32, "gelu")
    assert not t_gn.fused_group_norm_fits(torch.empty(2, 8, 64, dtype=torch.float16, **meta), 8)


@pytest.mark.parametrize("act", [None, "silu"])
def test_fused_group_norm_module(act):
    rng = np.random.default_rng(31)
    x = rand(rng, 2, 3, 4, 4, 16)
    run, m = port(jb.FusedGroupNorm(num_groups=4, act=act),
                  tb.FusedGroupNorm(4, 16, act=act), (x,))
    want = run(x)
    with torch.no_grad():
        fused = m(T(x))
        with _cuda.plain_path():
            chain = m(T(x))
    close(want, fused, 2e-5)
    close(want, chain, 2e-5)


# ---------------------------------------------------------- temporal conv

@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("with_bias", [True, False])
def test_temporal_conv_plain(k, with_bias):
    rng = np.random.default_rng(40 + k)
    cin, cout = 16, 24
    x = rand(rng, 2, 6, 3, 4, cin)
    w = rand(rng, k, 1, 1, cin, cout, scale=(k * cin) ** -0.5)  # DHWIO
    bias = rand(rng, cout, scale=0.1) if with_bias else None
    want = j_tc.temporal_conv(x, w, bias, use_pallas=False)
    got = t_tc.temporal_conv(T(x), T(w).permute(4, 3, 0, 1, 2),
                             None if bias is None else T(bias))
    assert got.shape == (2, 6, 3, 4, cout)
    close(want, got, 2e-5)


@pytest.mark.parametrize("b,t,h,w,cin,cout,k", [
    (1, 9, 3, 5, 32, 48, 3),    # T > 8, a 15-pixel frame, Cout > Cin
    (2, 11, 5, 3, 48, 16, 5),   # T > 8, Cout < Cin
    (1, 12, 7, 7, 64, 32, 5),   # a 49-pixel frame
])
def test_temporal_conv_plain_at_newly_admitted_shapes(b, t, h, w, cin, cout, k):
    """Shapes the TMA kernel's gate admits and the earlier one refused."""
    rng = np.random.default_rng(b * 100 + t)
    x = rand(rng, b, t, h, w, cin)
    wt = rand(rng, k, 1, 1, cin, cout, scale=(k * cin) ** -0.5)  # DHWIO
    bias = rand(rng, cout, scale=0.1)
    want = j_tc.temporal_conv(x, wt, bias, use_pallas=False)
    got = t_tc.temporal_conv(T(x), T(wt).permute(4, 3, 0, 1, 2), T(bias))
    assert got.shape == (b, t, h, w, cout)
    assert t_tc.temporal_conv_fits(T(x).to(torch.bfloat16),
                                   T(wt).permute(4, 3, 0, 1, 2).to(torch.bfloat16))
    close(want, got, 2e-5)


def test_temporal_conv_gate():
    bf = dict(dtype=torch.bfloat16, device="meta")
    for b, hw, c, k in ((4, 64, 256, 5), (2, 64, 256, 5), (4, 32, 512, 5), (4, 16, 512, 5),
                        (4, 32, 512, 3), (4, 16, 512, 3)):
        assert t_tc.temporal_conv_fits(torch.empty(b, 8, hw, hw, c, **bf),
                                       torch.empty(c, c, k, 1, 1, **bf))
    x = torch.empty(1, 8, 4, 4, 32, **bf)
    assert t_tc.temporal_conv_fits(x, torch.empty(48, 32, 3, 1, 1, **bf))
    assert not t_tc.temporal_conv_fits(x, torch.empty(48, 32, 3, 3, 3, **bf))
    assert not t_tc.temporal_conv_fits(x, torch.empty(48, 32, 2, 1, 1, **bf))
    # no limit on T or on the frame size: both were refused before the TMA kernel
    assert t_tc.temporal_conv_fits(torch.empty(1, 9, 4, 4, 32, **bf),
                                   torch.empty(32, 32, 3, 1, 1, **bf))
    assert t_tc.temporal_conv_fits(torch.empty(1, 8, 3, 3, 32, **bf),
                                   torch.empty(32, 32, 3, 1, 1, **bf))
    # Cin = 1024 (the UNet's widest level) and T = 32 (the flagship clip)
    assert t_tc.temporal_conv_fits(torch.empty(1, 32, 10, 10, 1024, **bf),
                                   torch.empty(1024, 1024, 3, 1, 1, **bf))
    # TMA needs 16-byte rows: channels a multiple of 16; bf16 only
    assert not t_tc.temporal_conv_fits(torch.empty(1, 8, 4, 4, 40, **bf),
                                       torch.empty(48, 40, 3, 1, 1, **bf))
    assert not t_tc.temporal_conv_fits(x, torch.empty(40, 32, 3, 1, 1, **bf))
    assert not t_tc.temporal_conv_fits(torch.empty(1, 8, 4, 4, 32, device="meta"),
                                       torch.empty(48, 32, 3, 1, 1, device="meta"))


def test_temporal_conv_gate_admits_every_resblock_conv():
    """The card check holds the conv at each resblock conv of both paths,
    with the site's k and with conv2's k = 3; the gate admits every one."""
    import chip_smoke

    sites = chip_smoke.RESBLOCK_P1 + chip_smoke.RESBLOCK_P2
    want = {(*s[:5], s[4], k) for s in sites for k in (s[5], 3)}
    assert set(chip_smoke.CONV_SITES) == want and len(chip_smoke.CONV_SITES) == len(want)
    bf = dict(dtype=torch.bfloat16, device="meta")
    for (b, t, h, w, cin, cout, k) in chip_smoke.CONV_SITES + (chip_smoke.CONV_WIDE,):
        assert t_tc.temporal_conv_fits(torch.empty(b, t, h, w, cin, **bf),
                                       torch.empty(cout, cin, k, 1, 1, **bf))


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    names = ("fused_temporal_attention", "fused_group_norm", "temporal_conv")
    assert set(names) <= set(_cuda.KERNELS)
    _cuda.reset_launch_counts()
    q = torch.randn(2, 5, 2, 16)
    t_fta.fused_temporal_attention(q, q, q, torch.zeros(2, 5, 5))
    t_gn.fused_group_norm(torch.randn(1, 2, 4, 4, 8), torch.ones(8), torch.zeros(8), 4)
    t_tc.temporal_conv(torch.randn(1, 4, 2, 2, 16), torch.randn(16, 16, 3, 1, 1))
    assert all(_cuda.LAUNCHES[n] == 0 and not _cuda.SHAPES[n] for n in names)
    assert {p.name for p in _cuda.sources()} >= {
        "fused_temporal_attention.cu", "fused_groupnorm.cu", "temporal_conv.cu",
        "group_norm.cuh", "temporal_conv.cuh", "hopper.cuh"}


def test_launches_are_counted_by_shape():
    """Each launch adds one to its kernel's count and to its shape's count;
    a reset clears both (the card check reads them per path)."""
    _cuda.reset_launch_counts()
    for shape in ((10, 240, 1024), (10, 960, 512), (10, 240, 1024)):
        _cuda.count("fused_feedforward", shape)
    assert _cuda.LAUNCHES["fused_feedforward"] == 3
    assert _cuda.SHAPES["fused_feedforward"] == {(10, 240, 1024): 2, (10, 960, 512): 1}
    _cuda.reset_launch_counts()
    assert set(_cuda.SHAPES) == set(_cuda.KERNELS)
    assert not any(_cuda.SHAPES.values()) and not any(_cuda.LAUNCHES.values())
