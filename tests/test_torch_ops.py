"""The PyTorch port's samplers, primitive ops and the plain versions of its
five CUDA kernels, held against the JAX package on the CPU.

Inputs come from numpy with a seed; both sides run in float32. The JAX
kernels run through their non-Pallas references (``use_pallas=False``), the
port's wrappers take their plain versions because the tensors lie on the CPU.
Tolerances are float32 rounding of the same arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.ops import attention as j_attn
from upscale_a_video_tpu.ops import cross_attention_block as j_cab
from upscale_a_video_tpu.ops import fused_feedforward as j_ff
from upscale_a_video_tpu.ops import fused_temporal_resblock as j_res
from upscale_a_video_tpu.ops import temporal_attention_block as j_tab
from upscale_a_video_tpu.ops.embeddings import get_timestep_embedding as j_temb
from upscale_a_video_tpu.ops.relpos import relative_position_buckets as j_buckets
from upscale_a_video_tpu.ops.rope import apply_rotary as j_rope
from upscale_a_video_tpu.pipeline import windows as j_win
from upscale_a_video_tpu.sampling import DDIMScheduler as JDDIM
from upscale_a_video_tpu.sampling import DDIMSchedulerConfig as JDDIMConfig
from upscale_a_video_tpu.sampling import DDPMScheduler as JDDPM
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.ops import attention as t_attn
from upscale_a_video_tpu_torch.ops import cross_attention_block as t_cab
from upscale_a_video_tpu_torch.ops import fused_feedforward as t_ff
from upscale_a_video_tpu_torch.ops import fused_temporal_resblock as t_res
from upscale_a_video_tpu_torch.ops import temporal_attention_block as t_tab
from upscale_a_video_tpu_torch.ops.embeddings import get_timestep_embedding as t_temb
from upscale_a_video_tpu_torch.ops.relpos import relative_position_buckets as t_buckets
from upscale_a_video_tpu_torch.ops.rope import apply_rotary as t_rope
from upscale_a_video_tpu_torch.pipeline import windows as t_win
from upscale_a_video_tpu_torch.sampling import DDIMScheduler as TDDIM
from upscale_a_video_tpu_torch.sampling import DDIMSchedulerConfig as TDDIMConfig
from upscale_a_video_tpu_torch.sampling import DDPMScheduler as TDDPM

torch.set_num_threads(1)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(j, t, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ samplers

@pytest.mark.parametrize("pred", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_ddim_step_matches(pred, schedule):
    rng = np.random.default_rng(0)
    jc = dict(beta_schedule=schedule, prediction_type=pred)
    js, ts = JDDIM(JDDIMConfig(**jc)), TDDIM(TDDIMConfig(**jc))
    np.testing.assert_array_equal(js.timesteps(7), ts.timesteps(7))
    np.testing.assert_array_equal(js.alphas_cumprod, ts.alphas_cumprod)
    x, m = rand(rng, 2, 3, 4, 4), rand(rng, 2, 3, 4, 4)
    for t in ts.timesteps(7):
        jp, jx0 = js.step(m, int(t), x, 7)
        tp, tx0 = ts.step(T(m), int(t), T(x), 7)
        close(jp, tp, 2e-5, 2e-5)
        close(jx0, tx0, 2e-5, 2e-5)


def test_ddim_split_step_requantizes_like_reference():
    """step_v0 → (modified x̂0) → step_vt, with the re-clip quirk."""
    rng = np.random.default_rng(1)
    cfg = dict(beta_schedule="scaled_linear")
    js, ts = JDDIM(JDDIMConfig(**cfg)), TDDIM(TDDIMConfig(**cfg))
    x, m = rand(rng, 1, 4, 6, 6, 4), rand(rng, 1, 4, 6, 6, 4, scale=3.0)
    for t in ts.timesteps(5):
        jv0, tv0 = js.step_v0(m, int(t), x), ts.step_v0(T(m), int(t), T(x))
        close(jv0, tv0, 2e-5, 2e-5)
        mod = np.asarray(jv0) * 1.7  # outside [-1, 1]: step_vt must clip again
        close(js.step_vt(mod, m, int(t), x, 5), ts.step_vt(T(mod), T(m), int(t), T(x), 5),
              2e-5, 2e-5)


def test_ddim_eta_and_thresholding():
    rng = np.random.default_rng(2)
    cfg = dict(thresholding=True, sample_max_value=1.5)
    js, ts = JDDIM(JDDIMConfig(**cfg)), TDDIM(TDDIMConfig(**cfg))
    x, m, z = rand(rng, 2, 8, 8), rand(rng, 2, 8, 8, scale=4.0), rand(rng, 2, 8, 8)
    jp, _ = js.step(m, 500, x, 10, eta=0.7, variance_noise=z)
    tp, _ = ts.step(T(m), 500, T(x), 10, eta=0.7, variance_noise=T(z))
    close(jp, tp, 5e-5, 5e-5)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction", "sample"])
def test_ddpm_step_matches(pred):
    """The mean path and, with the reference's own draw handed over, the
    noised path (the noise is recovered from the JAX key exactly as drawn)."""
    from upscale_a_video_tpu.sampling import DDPMSchedulerConfig as JDDPMConfig
    from upscale_a_video_tpu_torch.sampling import DDPMSchedulerConfig as TDDPMConfig

    rng = np.random.default_rng(12)
    js, ts = JDDPM(JDDPMConfig(prediction_type=pred)), TDDPM(TDDPMConfig(prediction_type=pred))
    x, m = rand(rng, 2, 3, 4, 4), rand(rng, 2, 3, 4, 4)
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    for t in (999, 500, 1, 0):
        jp, jx0 = js.step(m, t, x)
        tp, tx0 = ts.step(T(m), t, T(x))
        close(jp, tp, 2e-5, 2e-5)
        close(jx0, tx0, 2e-5, 2e-5)
        close(js.step(m, t, x, key=key)[0], ts.step(T(m), t, T(x), noise=T(z))[0], 2e-5, 2e-5)


def test_add_noise_and_velocity():
    rng = np.random.default_rng(3)
    x, n = rand(rng, 3, 2, 4, 4, 3), rand(rng, 3, 2, 4, 4, 3)
    t = np.array([0, 120, 999])
    close(JDDPM().add_noise(x, n, t), TDDPM().add_noise(T(x), T(n), t), 1e-6)
    js, ts = JDDIM(), TDDIM()
    close(js.add_noise(x, n, t), ts.add_noise(T(x), T(n), t), 1e-6)
    close(js.get_velocity(x, n, t), ts.get_velocity(T(x), T(n), t), 1e-6)


# ---------------------------------------------------------------- primitives

def test_timestep_embedding():
    """sin/cos of arguments up to 999 rad: one float32 ulp of the argument
    (6e-5) after exp rounding differs by a few ulps between libraries."""
    t = np.array([0, 1, 37, 500, 999], np.float32)
    for dim, flip in ((256, True), (33, False)):
        close(j_temb(jnp.asarray(t), dim, flip), t_temb(T(t), dim, flip), 3e-4)


@pytest.mark.parametrize("axis", [-2, -3])
def test_rope(axis):
    rng = np.random.default_rng(4)
    x = rand(rng, 3, 8, 2, 64) if axis == -3 else rand(rng, 3, 2, 8, 64)
    close(j_rope(jnp.asarray(x), 32, seq_axis=axis), t_rope(T(x), 32, seq_axis=axis), 1e-5)


def test_relpos_buckets():
    for n in (1, 8, 14, 40):
        np.testing.assert_array_equal(j_buckets(n, 32, 32), t_buckets(n, 32, 32))


def test_attention_plain_and_dispatch_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = rand(rng, 2, 3, 600, 32), rand(rng, 2, 3, 520, 32), rand(rng, 2, 3, 520, 32)
    bias = rand(rng, 1, 3, 600, 520)
    close(j_attn.attention_xla(q, k, v, 0.2), t_attn.attention(T(q), T(k), T(v), 0.2), 1e-5)
    close(j_attn.attention_xla(q, k, v, 0.2, bias), t_attn.attention(T(q), T(k), T(v), 0.2,
                                                                     T(bias)), 1e-5)


@pytest.mark.parametrize("t", [1, 8, 14, 20, 32])
def test_window_plan(t):
    assert j_win.window_starts(t) == t_win.window_starts(t)
    js, jb = j_win.unique_window_plan(t)
    ts, tb = t_win.unique_window_plan(t)
    assert js == ts
    np.testing.assert_array_equal(jb, tb)
    assert j_win.chunk_starts(t, 3) == t_win.chunk_starts(t, 3)


def test_window_plan_collapses_duplicate_tail():
    """T=14: starts 0, 6, 6 → two unique windows carrying all the weight."""
    assert t_win.window_starts(14) == (0, 6, 6)
    starts, blend = t_win.unique_window_plan(14)
    assert starts == (0, 6)
    np.testing.assert_allclose(blend.sum(axis=(0, 1)), 1.0)


# ------------------------------------------------ plain versions of kernels

C, HEADS, DH = 128, 2, 64  # gate-shaped toy sizes


def _ln(rng, c):
    return 1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)


@pytest.mark.parametrize("residual", [False, True])
def test_feedforward_plain(residual):
    rng = np.random.default_rng(6)
    x = rand(rng, 16, 64, C)
    lw, lb = _ln(rng, C)
    w1, b1 = rand(rng, C, 8 * C, scale=C ** -0.5), rand(rng, 8 * C, scale=0.1)
    w2, b2 = rand(rng, 4 * C, C, scale=(4 * C) ** -0.5), rand(rng, C, scale=0.1)
    j = j_ff.fused_feedforward(x, lw, lb, w1, b1, w2, b2, use_pallas=False,
                               add_residual=residual)
    t = t_ff.fused_feedforward(T(x), T(lw), T(lb), T(w1).t(), T(b1), T(w2).t(), T(b2),
                               add_residual=residual)
    close(j, t, 2e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_cross_attention_block_plain(residual):
    rng = np.random.default_rng(7)
    x = rand(rng, 16, 64, C)
    lw, lb = _ln(rng, C)
    wq, wo = rand(rng, C, C, scale=C ** -0.5), rand(rng, C, C, scale=C ** -0.5)
    k, v, bo = rand(rng, 2, 77, C), rand(rng, 2, 77, C), rand(rng, C, scale=0.1)
    j = j_cab.fused_cross_attention_block(x, lw, lb, wq, k, v, wo, bo, heads=HEADS,
                                          dim_head=DH, t_repeat=8, use_pallas=False,
                                          add_residual=residual)
    t = t_cab.fused_cross_attention_block(T(x), T(lw), T(lb), T(wq).t(), T(k), T(v), T(wo).t(),
                                          T(bo), heads=HEADS, dim_head=DH, t_repeat=8,
                                          add_residual=residual)
    close(j, t, 2e-5)


def test_cross_attention_fold_equals_unfolded_attention():
    """M = Wq·Kᵀ and Vo = blockdiag(V)·Wo give the plain multi-head attention."""
    rng = np.random.default_rng(8)
    x, k, v = T(rand(rng, 4, 32, C)), T(rand(rng, 1, 77, C)), T(rand(rng, 1, 77, C))
    lw, lb = (T(a) for a in _ln(rng, C))
    wq, wo = T(rand(rng, C, C, scale=C ** -0.5)), T(rand(rng, C, C, scale=C ** -0.5))
    bo = T(rand(rng, C, scale=0.1))
    got = t_cab.fused_cross_attention_block(x, lw, lb, wq, k, v, wo, bo, heads=HEADS,
                                            dim_head=DH, t_repeat=4)
    hn = t_ff.layer_norm(x, lw, lb, 1e-5)
    split = lambda a: a.reshape(a.shape[0], a.shape[1], HEADS, DH).transpose(1, 2)
    q = split(hn @ wq.t())
    out = t_attn.attention_plain(q, split(k).expand(4, -1, -1, -1),
                                 split(v).expand(4, -1, -1, -1), DH ** -0.5)
    want = out.transpose(1, 2).reshape(4, 32, C) @ wo.t() + bo
    close(want.numpy(), got, 2e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_temporal_attention_block_plain(residual):
    rng = np.random.default_rng(9)
    x = rand(rng, 16, 32, C)
    lw, lb = _ln(rng, C)
    wq, wk, wv, wo = (rand(rng, C, C, scale=C ** -0.5) for _ in range(4))
    bo, bias = rand(rng, C, scale=0.1), rand(rng, HEADS, 8, 8)
    j = j_tab.fused_temporal_attention_block(x, lw, lb, wq, wk, wv, wo, bo, bias,
                                             video_length=8, use_pallas=False,
                                             add_residual=residual)
    t = t_tab.fused_temporal_attention_block(T(x), T(lw), T(lb), T(wq).t(), T(wk).t(),
                                             T(wv).t(), T(wo).t(), T(bo), T(bias),
                                             video_length=8, add_residual=residual)
    close(j, t, 2e-5)


@pytest.mark.parametrize("k1,temb", [(5, True), (3, False)])
def test_temporal_resblock_plain(k1, temb):
    rng = np.random.default_rng(10)
    x = rand(rng, 2, 8, 4, 4, C)
    n1w, n1b = _ln(rng, C)
    n2w, n2b = _ln(rng, C)
    w1 = rand(rng, k1, 1, 1, C, C, scale=(k1 * C) ** -0.5)
    w2 = rand(rng, 3, 1, 1, C, C, scale=(3 * C) ** -0.5)
    b1, b2 = rand(rng, C, scale=0.1), rand(rng, C, scale=0.1)
    te = rand(rng, 2, C) if temb else None
    j = j_res.fused_temporal_resblock(x, n1w, n1b, w1, b1, te, n2w, n2b, w2, b2, groups=32,
                                      eps=1e-6, dtype=jnp.float32, use_pallas=False)
    tw = lambda w: T(w).permute(4, 3, 0, 1, 2)
    t = t_res.fused_temporal_resblock(T(x), T(n1w), T(n1b), tw(w1), T(b1),
                                      None if te is None else T(te), T(n2w), T(n2b), tw(w2),
                                      T(b2), groups=32, eps=1e-6)
    close(j, t, 2e-5)


def test_flash_attention_plain_on_cpu():
    """On a CPU tensor the flash wrapper is the plain attention (the Pallas
    kernel's oracle is ``attention_xla``)."""
    from upscale_a_video_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(11)
    q, k, v = rand(rng, 1, 2, 512, 64), rand(rng, 1, 2, 576, 64), rand(rng, 1, 2, 576, 64)
    close(j_attn.attention_xla(q, k, v, 0.125), flash_attention(T(q), T(k), T(v), 0.125), 1e-5)


@pytest.mark.parametrize("d", [128, 512, 80])
def test_attention_plain_matches_xla_at_flash_widths(d):
    """The flash kernel's plain version against its oracle at the widths the
    kernel runs (128, 512) and one it pads (80 -> 128), with key counts that
    are a multiple of no key tile (32, 64, 128)."""
    rng = np.random.default_rng(d)
    q, k, v = rand(rng, 2, 37, d), rand(rng, 2, 75, d), rand(rng, 2, 75, d)
    want = j_attn.attention_xla(q, k, v, d ** -0.5)
    close(want, t_attn.attention_plain(T(q), T(k), T(v), d ** -0.5), 1e-5)


def test_flash_kernel_widths():
    """Each head_dim the gate admits runs at one of the widths the kernel is
    built for, zero-padded up to it."""
    from upscale_a_video_tpu_torch.ops.flash_attention import WIDTHS, kernel_width

    assert WIDTHS == (64, 128, 256, 512)
    assert [kernel_width(d) for d in (16, 64, 80, 128, 144, 256, 384, 512)] == [
        64, 64, 128, 128, 256, 256, 512, 512]


def test_port_gates_cover_the_slice_shapes():
    """The Hopper gates admit every shape the released config gives each
    kernel at the 64x64-latent slice (bf16 tensors on the meta device)."""
    bf = dict(dtype=torch.bfloat16, device="meta")
    for s, c in ((1024, 512), (256, 512), (64, 1024)):
        x = torch.empty(32, s, c, **bf)
        assert t_tab.temporal_attention_block_fits(x, 8, 8)
        assert t_ff.feedforward_fits(x)
        assert t_cab.cross_attention_block_fits(x, 77, 8, c // 8) == (c <= 512)
    for b, hw, c in ((2, 64, 256), (4, 64, 256), (4, 32, 512), (4, 16, 512)):
        assert t_res.fused_resblock_fits(torch.empty(b, 8, hw, hw, c, **bf), 32, 32)
    from upscale_a_video_tpu_torch.ops.flash_attention import flash_attention_fits
    q = torch.empty(3, 1, 4096, 512, **bf)
    assert flash_attention_fits(q, q)
    assert not flash_attention_fits(torch.empty(32, 8, 64, 128, **bf),
                                    torch.empty(32, 8, 64, 128, **bf))


@pytest.mark.parametrize("d", [512, 320, 64])
def test_flash_gate_admits_fp32_operands(d):
    """fp32 q/k/v (``--decode_attn fp32``) pass the gate at D <= 512 with
    Sq, Sk >= 512, run on the fp32 kernel's widths (256 or 512, zero-padded
    up to them), and a bias or a short sequence still keeps them off it."""
    from upscale_a_video_tpu_torch.ops.flash_attention import (F32_WIDTHS, flash_attention_fits,
                                                               kernel_width)

    f32 = dict(dtype=torch.float32, device="meta")
    q, k = torch.empty(3, 1, 4096, d, **f32), torch.empty(3, 1, 512, d, **f32)
    assert flash_attention_fits(q, k)
    assert not flash_attention_fits(q, k, bias=torch.empty(1, 4096, 512, **f32))
    assert not flash_attention_fits(q, torch.empty(3, 1, 511, d, **f32))
    assert not flash_attention_fits(torch.empty(3, 1, 4096, d, dtype=torch.float16,
                                                device="meta"), k)
    assert kernel_width(d, torch.float32) == (256 if d <= 256 else 512) in F32_WIDTHS


@pytest.mark.parametrize("sk", [64, 1000, 37])
def test_f32_value_layout_gives_pv(sk):
    """The fp32 kernel's value layout (V^T, keys permuted inside each group
    of 8, zero keys past Sk), with P in the order the kernel's A fragments
    take its score columns (k-index t of a group from column 2t, t + 4 from
    2t + 1), gives P V: the pad keys add nothing whatever P holds there."""
    from upscale_a_video_tpu_torch.ops.flash_attention import f32_value_layout

    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((2, sk, 48)).astype(np.float32))
    p = torch.from_numpy(rng.random((2, 16, sk)).astype(np.float32))
    vt = f32_value_layout(v)
    skp = -(-sk // 8) * 8
    assert vt.shape == (2, 48, skp) and vt.is_contiguous()
    pp = torch.nn.functional.pad(p, (0, skp - sk), value=1.0)
    frag = pp.reshape(2, 16, skp // 8, 4, 2).transpose(-1, -2).reshape(2, 16, skp)
    torch.testing.assert_close(frag @ vt.transpose(1, 2), p @ v, rtol=1e-5, atol=1e-5)


def test_launch_counts_reset():
    _cuda.LAUNCHES["fused_feedforward"] += 3
    _cuda.reset_launch_counts()
    assert set(_cuda.LAUNCHES) == set(_cuda.KERNELS)
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


def test_build_is_keyed_by_source_hash():
    path = _cuda.library_path()
    assert path.parent.name == "_build" and _cuda.source_hash() in path.name
    assert {p.name for p in _cuda.sources()} >= {
        "flash_attention.cu", "temporal_attention_block.cu", "cross_attention_block.cu",
        "fused_feedforward.cu", "fused_temporal_resblock.cu", "common.cuh", "hopper.cuh"}
