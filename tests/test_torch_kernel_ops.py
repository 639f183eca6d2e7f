"""The plain versions of the port's fused temporal attention, fused GroupNorm
and temporal conv against the JAX package's functions, their Hopper gates,
and the two modules that route to them (``TemporalAttention`` on its kernel
route and on its module route, ``FusedGroupNorm``), on the CPU; for the
kernels on the GEMM core (temporal resblock, feed-forward), their gates, the
resblock's GroupNorm partials and finalize, and the weight-operand cache;
for the TMA + wgmma cross-attention and temporal attention blocks, their
decompositions (the kernels' algorithms in plain PyTorch, on the layouts the
kernels read) against the JAX references, and their gates; for the fused
temporal attention, its lane decomposition, and for the GroupNorm passes,
their block plan and fixed-order finalize; the T5 bias the temporal
attentions take.

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
from upscale_a_video_tpu.ops import fused_feedforward as j_ff
from upscale_a_video_tpu.ops import fused_groupnorm as j_gn
from upscale_a_video_tpu.ops import fused_temporal_attention as j_fta
from upscale_a_video_tpu.ops import cross_attention_block as j_cab
from upscale_a_video_tpu.ops import fused_temporal_resblock as j_res
from upscale_a_video_tpu.ops import temporal_attention_block as j_tab
from upscale_a_video_tpu.ops import temporal_conv as j_tc
from upscale_a_video_tpu_torch.nn import attention as ta
from upscale_a_video_tpu_torch.nn import blocks as tb
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.ops import cross_attention_block as t_cab
from upscale_a_video_tpu_torch.ops import fused_feedforward as t_ff
from upscale_a_video_tpu_torch.ops import fused_groupnorm as t_gn
from upscale_a_video_tpu_torch.ops import fused_temporal_attention as t_fta
from upscale_a_video_tpu_torch.ops import fused_temporal_resblock as t_res
from upscale_a_video_tpu_torch.ops import temporal_attention_block as t_tab
from upscale_a_video_tpu_torch.ops import temporal_conv as t_tc
from upscale_a_video_tpu_torch.ops.relpos import relative_position_buckets
from upscale_a_video_tpu_torch.ops.rope import rotary_tables
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


@pytest.mark.parametrize("t,d", [(5, 128), (1, 16), (16, 16)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_temporal_attention_plain_at_the_kernel_edges(t, d, with_bias):
    """The plain route at path 2's widest head (D = 128) and at both ends of
    the gate's frame range (T = 1: one key; T = 16: the streaming kernel's
    largest), against JAX ``_reference``."""
    rng = np.random.default_rng(40 + t + d)
    q, k, v = (rand(rng, 5, t, 2, d) for _ in range(3))
    bias = rand(rng, 2, t, t) if with_bias else None
    want = j_fta._reference(q, k, v, bias)
    got = t_fta.fused_temporal_attention(T(q), T(k), T(v), None if bias is None else T(bias))
    close(want, got, 1e-5)


def _fta_lanes(q, k, v, bias):
    """The fused temporal attention kernel's algorithm (T <= 8, D <= 256) on
    the CPU: each (row, head) on ``group_lanes(D)`` lanes of 8 channels (lanes
    past D / 8 hold zeros); a score is the lanes' partial dot products summed
    in a butterfly, then the bias, the exp2 softmax and the probabilities in
    v's dtype."""
    bp, t, h, d = q.shape
    lanes = t_fta.group_lanes(d)
    qf, kf = (torch.nn.functional.pad(a, (0, lanes * 8 - d)).reshape(bp, t, h, lanes, 8)
              for a in (q, k))
    part = torch.einsum("bihle,bjhle->bhijl", qf, kf)
    o = lanes // 2
    while o:
        part = part + part[..., torch.arange(lanes) ^ o]
        o //= 2
    s = part[..., 0] + (0.0 if bias is None else bias[None])
    e = torch.exp2((s - s.amax(dim=-1, keepdim=True)) * 1.4426950408889634)
    p = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(v.dtype)
    return torch.einsum("bhij,bjhd->bihd", p, v)


@pytest.mark.parametrize("t,d", [(5, 64), (5, 128), (8, 64), (5, 48), (1, 16), (8, 256)])
def test_fused_temporal_attention_lane_decomposition(t, d):
    """The kernel's lane decomposition (8 channels a lane; idle lanes at
    D = 48; a whole warp at D = 256) and exp2 softmax against JAX
    ``_reference``, in float32."""
    rng = np.random.default_rng(50 + t + d)
    q, k, v = (rand(rng, 4, t, 3, d, scale=0.5) for _ in range(3))
    bias = rand(rng, 3, t, t)
    close(j_fta._reference(q, k, v, bias), _fta_lanes(T(q), T(k), T(v), T(bias)), 2e-5)


def test_fused_temporal_attention_group_lanes():
    """Lanes per (row, head): D / 8 rounded up to a power of two, one warp
    at most (past D = 256 the shared-memory variant runs; the kernel still
    checks the count)."""
    want = {16: 2, 32: 4, 48: 8, 64: 8, 80: 16, 128: 16, 256: 32, 320: 32, 1024: 32}
    for d, lanes in want.items():
        assert t_fta.group_lanes(d) == lanes, d
        assert lanes * 8 >= min(d, 256)


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


@pytest.mark.parametrize("t", [5, 8])
def test_relative_position_bias_matches_jax(t):
    """The (H, T, T) T5 bias looked up through the cached flat index equals
    the JAX TemporalAttention's bias (its parameter twin's ``bias_hss``) on
    the same table, contiguous, as the fused kernels read it."""
    heads = 3
    jm = ja._TemporalAttnParams(query_dim=16, heads=heads, dim_head=8)
    params = jm.init(jax.random.PRNGKey(0), t)["params"]
    table = rand(np.random.default_rng(60 + t), 32, heads)
    params = {**params, "relative_attention_bias": jnp.asarray(table)}
    want = np.asarray(jm.apply({"params": params}, t)[-1])
    rb = ta.RelativePositionBias(heads)
    with torch.no_grad():
        rb.relative_attention_bias.weight.copy_(T(table))
    got = rb(t)
    assert got.shape == (heads, t, t) and got.is_contiguous()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert rb(t).data_ptr() != got.data_ptr()  # a lookup per call, not a cached bias


def test_relative_position_bias_follows_loaded_weights():
    """The index is cached per (T, device) outside the state dict, so a
    strict load still sees one key; the bias is read from the table on every
    call, so it follows ``load_state_dict`` and in-place updates."""
    rb = ta.RelativePositionBias(2)
    assert set(rb.state_dict()) == {"relative_attention_bias.weight"}
    first = rb(5).detach().clone()
    index = rb._index[(5, torch.device("cpu"))]
    table = torch.arange(64, dtype=torch.float32).reshape(32, 2)
    rb.load_state_dict({"relative_attention_bias.weight": table}, strict=True)
    got = rb(5)
    assert rb._index[(5, torch.device("cpu"))] is index
    buckets = torch.from_numpy(relative_position_buckets(5, 32, 32).astype(np.int64))
    assert torch.equal(got, table[buckets].permute(2, 0, 1)) and not torch.equal(got, first)
    with torch.no_grad():
        rb.relative_attention_bias.weight.mul_(-1)
    assert torch.equal(rb(5), -got)
    assert set(rb.state_dict()) == {"relative_attention_bias.weight"}


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


@pytest.mark.parametrize("n,rows,c,groups,fp32", [
    (1, 20000, 16, 4, True),    # 40 blocks: the finalize's lanes take two blocks each
    (4, 4096, 256, 32, False),  # the bf16 UNet site's channels, a sample per block row
    (2, 301, 100, 4, False),    # bf16 in 8-byte chunks, a ragged last block
    (1, 37, 4104, 8, True),     # three channel passes, groups split between them
])
def test_gn_stats_plan_and_finalize_match_jax(n, rows, c, groups, fp32):
    """The statistics pass's plan covers each sample's rows once with no
    block empty, about two blocks per SM and no more blocks than give each
    ``UNROLL`` row steps; its per-(sample, group, block) sums, reduced in the
    finalize's fixed lane order, give the affine of JAX's
    ``_affine_from_partials`` on the same sums and of ``_gn_affine`` on x,
    and the halves at scale 1/2 (the resblock's)."""
    sms = 132
    nb, rpb = t_gn.stats_plan(n, rows, c, fp32, sms)
    assert nb * rpb >= rows > (nb - 1) * rpb and nb <= -(-2 * sms // n)
    tpr = min(c // t_gn.chunk_width(c, fp32), t_gn.THREADS)
    assert nb <= -(-rows // (t_gn.UNROLL * (t_gn.THREADS // tpr)))
    rng = np.random.default_rng(rows + c)
    x = rand(rng, n, rows, c) * 1.5 + 0.3
    scale, bias = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    part = t_gn.block_sums(T(x), groups, nb, rpb)
    assert part.shape == (n, groups, nb, 2) and part.dtype == torch.float64
    count = rows * (c // groups)
    a, d = t_gn.affine_from_block_sums(part, count, T(scale), T(bias), 1e-6)
    jpart = np.zeros((n, 2, j_res._GPAD), np.float32)
    jpart[:, :, :groups] = part.sum(dim=2).permute(0, 2, 1).numpy()
    ja, jd = j_res._affine_from_partials(jnp.asarray(jpart), rows, groups, c, 1e-6,
                                         jnp.asarray(scale), jnp.asarray(bias))
    close(ja, a, 2e-5)
    close(jd, d, 2e-5)
    ga, gd = j_res._gn_affine(jnp.asarray(x.reshape(n, rows, 1, 1, c)), jnp.asarray(scale),
                              jnp.asarray(bias), groups, 1e-6)
    close(ga, a, 2e-5)
    close(gd, d, 2e-5)
    ha, hd = t_gn.affine_from_block_sums(part, count, T(scale), T(bias), 1e-6, 0.5)
    assert torch.equal(ha, a * 0.5) and torch.equal(hd, d * 0.5)


def test_lane_order_sum_is_the_sum():
    """The finalize's fixed order (lane-strided, then a butterfly) is a sum:
    equal to the plain float64 sum to rounding at lengths below, at and past
    the lanes, for each lane count, and the same bits on every call. The
    lanes per group put all of a sample's groups in one round of its last
    block's threads: 16 for 32 groups."""
    rng = np.random.default_rng(7)
    for lanes in (32, 16, 4, 1):
        for length in (1, 5, 31, 32, 33, 264):
            v = torch.from_numpy(rng.standard_normal((3, length)))
            got = t_gn.lane_order_sum(v, lanes)
            assert torch.allclose(got, v.sum(dim=-1), rtol=1e-12, atol=1e-12), (lanes, length)
            assert torch.equal(got, t_gn.lane_order_sum(v.clone(), lanes))
    assert [t_gn.finalize_lanes(p) for p in (1, 16, 32, 64, 128, 512, 1024)] == [
        32, 32, 16, 8, 4, 1, 1]


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
        "group_norm.cuh", "gemm_core.cuh", "hopper.cuh"}


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


# ------------------------------------------- kernels on the GEMM core

BF = dict(dtype=torch.bfloat16, device="meta")


def test_feedforward_gate():
    """Every feed-forward shape of both paths, and shapes the earlier gate
    refused (rows not a multiple of 32 or 16, C = 192 or 64); not fp32, not
    C off the 64-channel slices, not C > 1024 (the JAX gate's bound)."""
    import chip_smoke

    for shape in chip_smoke.FF_SITES + ((7, 45, 512), (3, 33, 192), (1, 1, 64), (5, 99, 1024)):
        assert t_ff.feedforward_fits(torch.empty(shape, **BF)), shape
    assert not t_ff.feedforward_fits(torch.empty(4, 64, 512, device="meta"))
    assert not t_ff.feedforward_fits(torch.empty(4, 64, 96, **BF))
    assert not t_ff.feedforward_fits(torch.empty(4, 64, 1280, **BF))
    assert not t_ff.feedforward_fits(torch.empty(0, 64, 512, **BF))


def test_resblock_gate():
    """Every resblock site of the paths, and shapes the WMMA conv refused
    (T = 12, 300- and 15-pixel frames, C = 320); not fp32, not C off the
    64-channel slices or the group counts, not C > 512 (the card check holds
    no wider site)."""
    import chip_smoke

    sites = (chip_smoke.RESBLOCK_P1 + chip_smoke.RESBLOCK_P2 + chip_smoke.RESBLOCK_P4
             + chip_smoke.RESBLOCK_P6)
    for (b, t, h, w, c, _) in sites:
        assert t_res.fused_resblock_fits(torch.empty(b, t, h, w, c, **BF), 32, 32)
    for shape in ((1, 12, 15, 20, 320), (2, 3, 3, 5, 64), (1, 1, 1, 1, 512), (2, 16, 8, 8, 256)):
        assert t_res.fused_resblock_fits(torch.empty(shape, **BF), 32), shape
    assert not t_res.fused_resblock_fits(torch.empty(2, 8, 8, 8, 256, device="meta"), 32)
    assert not t_res.fused_resblock_fits(torch.empty(2, 8, 8, 8, 96, **BF), 32)
    assert not t_res.fused_resblock_fits(torch.empty(2, 8, 8, 8, 1024, **BF), 32)
    assert not t_res.fused_resblock_fits(torch.empty(2, 8, 8, 8, 128, **BF), 48)
    assert not t_res.fused_resblock_fits(torch.empty(2, 8, 8, 8, 128, **BF), 32, 48)


@pytest.mark.parametrize("k1,temb", [(5, True), (3, False)])
def test_temporal_resblock_plain_at_newly_admitted_shapes(k1, temb):
    """T = 12 and a 300-pixel frame (15 x 20, a multiple of no tile), C = 64,
    against the JAX reference."""
    rng = np.random.default_rng(50 + k1)
    c = 64
    x = rand(rng, 1, 12, 15, 20, c)
    n1w, n1b = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    n2w, n2b = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    w1 = rand(rng, k1, 1, 1, c, c, scale=(k1 * c) ** -0.5)
    w2 = rand(rng, 3, 1, 1, c, c, scale=(3 * c) ** -0.5)
    b1, b2 = rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    te = rand(rng, 1, c) if temb else None
    want = j_res.fused_temporal_resblock(x, n1w, n1b, w1, b1, te, n2w, n2b, w2, b2, groups=32,
                                         eps=1e-6, dtype=jnp.float32, use_pallas=False)
    tw = lambda w: T(w).permute(4, 3, 0, 1, 2)
    assert t_res.fused_resblock_fits(T(x).to(torch.bfloat16), 32)
    got = t_res.fused_temporal_resblock(T(x), T(n1w), T(n1b), tw(w1), T(b1),
                                        None if te is None else T(te), T(n2w), T(n2b), tw(w2),
                                        T(b2), groups=32, eps=1e-6)
    close(want, got, 2e-5)


@pytest.mark.parametrize("rows,c", [(45, 128), (7, 192)])
def test_feedforward_plain_at_newly_admitted_shapes(rows, c):
    """Row counts that are a multiple of neither 32 nor 16, and C = 192,
    against the JAX reference."""
    rng = np.random.default_rng(rows)
    x = rand(rng, 3, rows, c)
    lw, lb = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    w1, b1 = rand(rng, c, 8 * c, scale=c ** -0.5), rand(rng, 8 * c, scale=0.1)
    w2, b2 = rand(rng, 4 * c, c, scale=(4 * c) ** -0.5), rand(rng, c, scale=0.1)
    want = j_ff.fused_feedforward(x, lw, lb, w1, b1, w2, b2, use_pallas=False,
                                  add_residual=True)
    assert t_ff.feedforward_fits(T(x).to(torch.bfloat16))
    got = t_ff.fused_feedforward(T(x), T(lw), T(lb), T(w1).t(), T(b1), T(w2).t(), T(b2),
                                 add_residual=True)
    close(want, got, 2e-5)


@pytest.mark.parametrize("hw,rows", [(300, 128), (240, 128), (64, 64), (100, 64)])
def test_gn_finalize_plain_matches_jax_affine_from_partials(hw, rows):
    """The first conv's per-(tile, channel) partials, with the rows past the
    frame in the last tile holding garbage (as bias + temb after the
    epilogue) and left out, give through the plain finalize the affine of
    JAX's ``_affine_from_partials`` on the same sums, and of ``_gn_affine``
    on the frame itself."""
    rng = np.random.default_rng(hw + rows)
    b, t, c, groups = 2, 5, 64, 16
    n = -(-hw // rows)
    h = rand(rng, b, t, n * rows, c) * 1.5 + 0.3
    h[:, :, hw:] = 7.0 + rand(rng, b, t, n * rows - hw, c)  # the zero fill after the epilogue
    scale, bias = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    part = t_res.tile_partials(T(h), hw, rows)
    assert part.shape == (b, t * n, c, 2)
    a, d = t_res.gn_affine_from_partials(part, t * hw * (c // groups), T(scale), T(bias), groups,
                                         1e-6)
    valid = h[:, :, :hw].astype(np.float64)
    sums = np.stack([valid.sum(axis=(1, 2)), (valid ** 2).sum(axis=(1, 2))], axis=1)
    jpart = np.zeros((b, 2, j_res._GPAD), np.float32)  # JAX's (B, 2, GPAD) per-group sums
    jpart[:, :, :groups] = sums.reshape(b, 2, groups, c // groups).sum(axis=-1)
    ja, jd = j_res._affine_from_partials(jnp.asarray(jpart), t * hw, groups, c, 1e-6,
                                         jnp.asarray(scale), jnp.asarray(bias))
    close(ja, a, 2e-5)
    close(jd, d, 2e-5)
    ga, gd = j_res._gn_affine(jnp.asarray(h[:, :, :hw].reshape(b, t, hw, 1, c)),
                              jnp.asarray(scale), jnp.asarray(bias), groups, 1e-6)
    close(ga, a, 2e-5)
    close(gd, d, 2e-5)


def test_resblock_partial_counts():
    """The wrapper's tile height and partial-row count at every resblock
    site of the paths (and ragged frames) against a direct count: the
    tiles the kernel's grid walks, and the distinct (frame, tile) pairs of
    the frame's rows."""
    import chip_smoke

    sites = [s[:5] for s in
             chip_smoke.RESBLOCK_P1 + chip_smoke.RESBLOCK_P2 + chip_smoke.RESBLOCK_P4
             + chip_smoke.RESBLOCK_P6]
    sites += [(1, 12, 15, 20, 320), (2, 3, 3, 5, 64)]
    for sms in (132, 114):
        for (b, t, h, w, c) in sites:
            hw = h * w
            rows = t_res.tile_rows(b * t, hw, c, sms)
            big_tiles = b * t * int(np.ceil(hw / 128)) * int(np.ceil(c / 256))
            assert rows == (64 if hw <= 64 or big_tiles < sms else 128)
            pairs = {(f, r // rows) for f in range(t) for r in range(hw)}
            assert t_res.partial_rows(t, hw, rows) == len(pairs)
    # the path shapes fall on both sides of the rule
    assert t_res.tile_rows(32, 4096, 512, 132) == 128
    assert t_res.tile_rows(32, 256, 512, 132) == 64   # 128 big tiles < 132 SMs
    assert t_res.tile_rows(10, 240, 512, 132) == 64   # 40 big tiles


def test_weight_operand_cache_follows_updates_and_loads():
    """A converted weight operand is made once per version of the weight:
    an in-place update and ``load_state_dict`` both give the new layout, and
    the cache adds no key to the module's state dict."""
    from upscale_a_video_tpu_torch.ops.temporal_conv import tap_major

    torch.manual_seed(0)
    m = tb.ResnetBlock3DCNN(64, temb_channels=None, groups=32, temporal_kernel=(5, 1, 1))
    keys = set(m.state_dict())
    w = m.conv1.weight
    made = []
    make = lambda t: made.append(1) or tap_major(t)
    first = _cuda.cached(w, "taps", make)
    assert torch.equal(first, tap_major(w)) and first.shape == (5, 64, 64)
    assert _cuda.cached(w, "taps", make) is first and len(made) == 1
    with torch.no_grad():
        w.mul_(2.0)
    second = _cuda.cached(w, "taps", make)
    assert len(made) == 2 and torch.equal(second, tap_major(w))
    state = {k: v.clone() for k, v in m.state_dict().items()}
    state["conv1.weight"].fill_(0.5)
    m.load_state_dict(state, strict=True)
    third = _cuda.cached(w, "taps", make)
    assert len(made) == 3 and torch.all(third == 0.5)
    assert set(m.state_dict()) == keys
    # a weight already in the kernel's dtype and layout is its own operand
    same = torch.ones(8, 8)
    assert _cuda.cached(same, "id", lambda t: t) is same


# ------------------------- cross-attention and temporal attention blocks

@pytest.mark.parametrize("skv,kp", [(77, 80), (77, 128), (80, 80), (100, 128), (5, 80)])
def test_cross_attention_fold_in_the_kernel_layout(skv, kp):
    """The fold as the kernel reads it ((H, B, Skv, C), each head's keys a
    tile of kp rows, the rows past Skv zero) through the kernel's algorithm
    (per head: scores over the kp keys with the padding masked, softmax, P
    Vo, heads summed) matches JAX's fused_cross_attention_block on its
    128-key layout, and the 80- and 128-key tiles give the same result.
    Float32; tolerance: the same sums in another order."""
    rng = np.random.default_rng(skv + kp)
    c, heads, d = 64, 2, 32
    x = rand(rng, 6, 20, c)
    lw, lb = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    wq, wo = rand(rng, c, c, scale=c ** -0.5), rand(rng, c, c, scale=c ** -0.5)
    k, v, bo = rand(rng, 2, skv, c), rand(rng, 2, skv, c), rand(rng, c, scale=0.1)
    want = j_cab.fused_cross_attention_block(x, lw, lb, wq, k, v, wo, bo, heads=heads,
                                             dim_head=d, t_repeat=3, use_pallas=False,
                                             add_residual=True)
    mt, vo = t_cab.fold_keys(T(wq).t(), T(k), T(v), T(wo).t(), heads, d)
    assert mt.shape == vo.shape == (heads, 2, skv, c)
    m_kp, vo_kp = t_cab.key_tiles(mt, vo, kp)
    got = t_cab.cross_attention_block_plain(T(x), T(lw), T(lb), m_kp, vo_kp, skv, T(bo), 3,
                                            1e-5, True, kp=kp)
    close(want, got, 2e-5)
    m_128, vo_128 = t_cab.key_tiles(mt, vo, 128)
    same = t_cab.cross_attention_block_plain(T(x), T(lw), T(lb), m_128, vo_128, skv, T(bo), 3,
                                             1e-5, True)
    close(same.numpy(), got, 2e-6)


def _tab_decomposed(x, lw, lb, wq, wk, wv, wo, bo, bias, t, rot, eps, residual):
    """Kernel 1 step by step in plain PyTorch on the (B*T*S, C) rows: LN,
    the product with the stacked (3C, C) weight, q scaled, RoPE per column
    pair (2i, 2i + 1) with the frame (row // S) % T, the attention of each
    pixel over its T frames, the out-projection (+ residual)."""
    bt, s, c = x.shape
    heads = bias.shape[0]
    d, m = c // heads, bt * s
    rows = x.reshape(m, c)
    hn = t_ff.layer_norm(rows, lw, lb, eps)
    q, k, v = (hn @ t_tab.stacked_qkv(wq, wk, wv, torch.float32).t()).split(c, dim=1)
    q = q * d ** -0.5
    frame = (torch.arange(m) // s) % t
    cos, sin = (a[frame][:, None, :] for a in rotary_tables(t, rot))

    def rope(a):
        a = a.reshape(m, heads, d).clone()
        a0, a1 = a[..., 0:rot:2].clone(), a[..., 1:rot:2].clone()
        a[..., 0:rot:2], a[..., 1:rot:2] = a0 * cos - a1 * sin, a1 * cos + a0 * sin
        return a

    per_pixel = lambda a: a.reshape(bt // t, t, s, heads, d)
    q, k, v = per_pixel(rope(q)), per_pixel(rope(k)), per_pixel(v.reshape(m, heads, d))
    scores = torch.einsum("bishd,bjshd->bshij", q, k) + bias[None, None]
    o = torch.einsum("bshij,bjshd->bishd", torch.softmax(scores, dim=-1), v)
    out = o.reshape(m, c) @ wo.t() + bo
    return (out + rows if residual else out).reshape(bt, s, c)


@pytest.mark.parametrize("t,s,c,heads,residual", [(8, 6, 128, 2, True), (4, 5, 64, 1, False),
                                                   (2, 3, 128, 4, True)])
def test_temporal_attention_block_decomposition(t, s, c, heads, residual):
    """Kernel 1's decomposition matches JAX's ``_reference`` (float32; the
    same sums in another order)."""
    rng = np.random.default_rng(t * s + c)
    x = rand(rng, 2 * t, s, c)
    lw, lb = 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    wq, wk, wv, wo = (rand(rng, c, c, scale=c ** -0.5) for _ in range(4))
    bo, bias = rand(rng, c, scale=0.1), rand(rng, heads, t, t)
    rot = min(32, c // heads)
    want = j_tab._reference(x, lw, lb, wq, wk, wv, wo, bo, bias, t, 32, 1e-5, residual)
    got = _tab_decomposed(T(x), T(lw), T(lb), T(wq).t(), T(wk).t(), T(wv).t(), T(wo).t(),
                          T(bo), T(bias), t, rot, 1e-5, residual)
    close(want, got, 2e-5)


def test_stacked_qkv_weight_follows_updates_and_loads():
    """The stacked (3C, C) q/k/v operand is made once per version of the
    three weights: an in-place update of any of them and ``load_state_dict``
    give the new stack, and the cache adds no key to the state dict."""
    torch.manual_seed(0)
    m = ta.TemporalAttention(32, heads=2, dim_head=16)
    keys = set(m.state_dict())
    wq, wk, wv = m.to_q.weight, m.to_k.weight, m.to_v.weight
    stack = lambda: t_tab.stacked_qkv(wq, wk, wv, torch.float32)
    first = stack()
    assert torch.equal(first, torch.cat([wq, wk, wv])) and first.shape == (96, 32)
    assert stack() is first
    with torch.no_grad():
        wk.mul_(2.0)
    second = stack()
    assert second is not first and torch.equal(second[32:64], wk)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    state["to_v.weight"].fill_(0.5)
    m.load_state_dict(state, strict=True)
    third = stack()
    assert torch.all(third[64:] == 0.5) and torch.equal(third[:32], wq)
    assert set(m.state_dict()) == keys


def test_attention_block_gates_at_the_path_sites():
    """Kernel 1 admits the path-1 and path-4 sites (T = 8) and refuses path 2's
    T = 5 (the JAX gate's ROWS % t, so path 2 keeps the fused temporal
    attention) and heads it is not built for (64 and 128 channels); kernel 3 admits the
    path sites and any token count, and refuses C = 1024 (as the JAX gate),
    more than 128 keys and fp32."""
    import chip_smoke

    for bt, s, c in chip_smoke.TAB_SITES:
        assert t_tab.temporal_attention_block_fits(torch.empty(bt, s, c, **BF), 8, 8)
    for s, c in ((3840, 512), (960, 512), (240, 1024)):
        assert not t_tab.temporal_attention_block_fits(torch.empty(10, s, c, **BF), 5, 8)
    x = torch.empty(32, 100, 512, **BF)
    assert t_tab.temporal_attention_block_fits(x, 4, 8)       # any S, T | 128
    assert t_tab.temporal_attention_block_fits(x, 16, 4)       # T = 16, heads of 128
    assert not t_tab.temporal_attention_block_fits(x, 8, 8, rot_dim=21)  # an odd RoPE width
    assert not t_tab.temporal_attention_block_fits(x, 8, 16)   # heads of 32
    assert not t_tab.temporal_attention_block_fits(torch.empty(32, 100, 576, **BF), 8, 3)
    assert not t_tab.temporal_attention_block_fits(torch.empty(32, 100, 512), 8, 8)
    for bt, s in ((32, 1024), (32, 256), (10, 3840), (10, 960), (32, 6144), (32, 1536), (6, 100)):
        assert t_cab.cross_attention_block_fits(torch.empty(bt, s, 512, **BF), 77, 8, 64)
    assert not t_cab.cross_attention_block_fits(torch.empty(32, 64, 1024, **BF), 77, 8, 128)
    assert not t_cab.cross_attention_block_fits(torch.empty(32, 64, 512, **BF), 129, 8, 64)
    assert not t_cab.cross_attention_block_fits(torch.empty(32, 64, 512), 77, 8, 64)
    assert not t_cab.cross_attention_block_fits(torch.empty(32, 64, 320, **BF), 77, 5, 64)


def test_resblock_device_parts_split_the_convs_from_the_gn_passes():
    """The profiled forward's temporal resblock time by part: its two convs
    (K1Epilogue, K2Epilogue) apart from its GroupNorm passes (gn_stats,
    gn_finalize); other kernels' device time is not counted."""
    import types

    import chip_smoke

    ev = lambda key, us: types.SimpleNamespace(key=key, device_time_total=us)
    events = [ev("void uav::(anonymous namespace)::gemm_kernel<128, 256, uav::(anonymous "
                 "namespace)::K1Epilogue>(CUtensorMap_st)", 400.0),
              ev("void uav::(anonymous namespace)::gemm_kernel<128, 256, uav::(anonymous "
                 "namespace)::K2Epilogue>(CUtensorMap_st)", 300.0),
              ev("void uav::(anonymous namespace)::gn_stats_kernel<false, 8>(uav::(anonymous "
                 "namespace)::GnStatsArgs)", 30.0),
              ev("uav::(anonymous namespace)::gn_finalize_kernel(float const*)", 5.0),
              ev("void uav::(anonymous namespace)::fta_regs_kernel<5>(FtaArgs)", 50.0),
              ev("nvjet_tst_128x80_64x8_1x2_h_bz_TNT", 7.0)]
    parts = chip_smoke.device_parts(types.SimpleNamespace(key_averages=lambda: events),
                                    "fused_temporal_resblock")
    assert parts == pytest.approx({"K1Epilogue": 400e-6, "K2Epilogue": 300e-6, "gn_": 35e-6})
    text = "".join(p.read_text() for p in _cuda.sources())
    assert "gn_stats_kernel" in text and "gn_finalize_kernel" in text


def test_device_split_names_are_in_the_sources():
    """Every name part by which the card check attributes a profiled
    forward's device time occurs in the kernels' sources and names a port
    kernel; the split sums each port kernel's device kernels and counts the
    rest as PyTorch's."""
    import types

    import chip_smoke

    text = "".join(p.read_text() for p in _cuda.sources())
    for part, kernel in chip_smoke.DEVICE_KERNELS:
        assert part in text and kernel in _cuda.KERNELS, part
    ev = lambda key, us: types.SimpleNamespace(key=key, device_time_total=us)
    events = [ev("void uav::(anonymous namespace)::cab_kernel<4, 80>(CUtensorMap_st)", 300.0),
              ev("uav::(anonymous namespace)::tab_layernorm_kernel(__nv_bfloat16 const*)", 20.0),
              ev("void uav::(anonymous namespace)::gemm_kernel<128, 192, uav::(anonymous "
                 "namespace)::QkvAttnEpilogue<64> >(CUtensorMap_st)", 200.0),
              ev("uav::(anonymous namespace)::layernorm_kernel(__nv_bfloat16 const*)", 10.0),
              ev("nvjet_tst_128x80_64x8_1x2_h_bz_TNT", 5.0), ev("cudaLaunchKernel", 0.0)]
    split, total = chip_smoke.device_split(types.SimpleNamespace(key_averages=lambda: events))
    assert split == pytest.approx({"cross_attention_block": 300e-6,
                                   "temporal_attention_block": 220e-6,
                                   "fused_feedforward": 10e-6, "PyTorch": 5e-6})
    assert total == pytest.approx(535e-6)
