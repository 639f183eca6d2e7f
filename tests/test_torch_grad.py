"""Gradients through the port's kernel wrappers, on the CPU.

On the card each wrapper called under autograd runs its kernel forward
through ``_cuda.ViaPlain``, whose backward is the plain version's gradient
(JAX's custom VJPs: the Pallas forward, the reference's backward). Here:

- for every kernel, the port plain version's gradients with respect to
  every input and weight against ``jax.grad`` of the JAX function with
  ``use_pallas=False`` (flash: ``attention_xla``, which its VJP
  differentiates), for one seeded upstream gradient, at small shapes;
- the Function, with the plain version standing in for the kernel, gives
  exactly the plain version's gradients (cross-attention: on the folded M
  and Vo, the fold under ordinary autograd, as the wrapper calls it);
- under ``no_grad``, or when no input requires grad, the Function is not
  entered.

Tolerance: gradients within 5e-5 of the largest value of each (float32 sums
of the same products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.ops import attention as j_attn
from upscale_a_video_tpu.ops import cross_attention_block as j_cab
from upscale_a_video_tpu.ops import fused_feedforward as j_ff
from upscale_a_video_tpu.ops import fused_groupnorm as j_gn
from upscale_a_video_tpu.ops import fused_temporal_attention as j_fta
from upscale_a_video_tpu.ops import fused_temporal_resblock as j_res
from upscale_a_video_tpu.ops import temporal_attention_block as j_tab
from upscale_a_video_tpu.ops import temporal_conv as j_tc
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.ops import cross_attention_block as t_cab
from upscale_a_video_tpu_torch.ops import fused_feedforward as t_ff
from upscale_a_video_tpu_torch.ops import fused_groupnorm as t_gn
from upscale_a_video_tpu_torch.ops import fused_temporal_attention as t_fta
from upscale_a_video_tpu_torch.ops import fused_temporal_resblock as t_res
from upscale_a_video_tpu_torch.ops import temporal_attention_block as t_tab
from upscale_a_video_tpu_torch.ops import temporal_conv as t_tc
from upscale_a_video_tpu_torch.ops.attention import attention_plain

torch.set_num_threads(1)

TOL = 5e-5
C, HEADS, DH = 64, 2, 32


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def lin(w):
    """A JAX (in, out) kernel as a torch Linear weight (out, in)."""
    return w.T


def conv(w):
    """A JAX DHWIO (k, 1, 1, Cin, Cout) kernel as torch's (Cout, Cin, k, 1, 1)."""
    return w.transpose(4, 3, 0, 1, 2)


def case(name, rng):
    """(JAX function of the float inputs, port function of the float
    inputs, the JAX inputs, the port layout of each input)."""
    ln = lambda c: (1 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1))
    same = lambda a: a
    if name == "temporal_attention_block":
        x = rand(rng, 8, 6, C)
        lw, lb = ln(C)
        wq, wk, wv, wo = (rand(rng, C, C, scale=C ** -0.5) for _ in range(4))
        args = (x, lw, lb, wq, wk, wv, wo, rand(rng, C, scale=0.1), rand(rng, HEADS, 4, 4))
        jf = lambda *a: j_tab.fused_temporal_attention_block(*a, video_length=4,
                                                             use_pallas=False, add_residual=True)
        tf = lambda *a: t_tab.fused_temporal_attention_block(*a, video_length=4,
                                                             add_residual=True)
        return jf, tf, args, (same, same, same, lin, lin, lin, lin, same, same)
    if name == "fused_temporal_resblock":
        x = rand(rng, 2, 5, 3, 2, C)
        (n1w, n1b), (n2w, n2b) = ln(C), ln(C)
        w1, w2 = rand(rng, 5, 1, 1, C, C, scale=(5 * C) ** -0.5), rand(
            rng, 3, 1, 1, C, C, scale=(3 * C) ** -0.5)
        args = (x, n1w, n1b, w1, rand(rng, C, scale=0.1), rand(rng, 2, C), n2w, n2b, w2,
                rand(rng, C, scale=0.1))
        jf = lambda *a: j_res.fused_temporal_resblock(*a, groups=8, eps=1e-6, dtype=jnp.float32,
                                                      use_pallas=False)
        tf = lambda *a: t_res.fused_temporal_resblock(*a, groups=8, eps=1e-6)
        return jf, tf, args, (same, same, same, conv, same, same, same, same, conv, same)
    if name == "cross_attention_block":
        x = rand(rng, 6, 10, C)
        lw, lb = ln(C)
        args = (x, lw, lb, rand(rng, C, C, scale=C ** -0.5), rand(rng, 2, 7, C),
                rand(rng, 2, 7, C), rand(rng, C, C, scale=C ** -0.5), rand(rng, C, scale=0.1))
        kw = dict(heads=HEADS, dim_head=DH, t_repeat=3, add_residual=True)
        jf = lambda *a: j_cab.fused_cross_attention_block(*a, use_pallas=False, **kw)
        tf = lambda *a: t_cab.fused_cross_attention_block(*a, **kw)
        return jf, tf, args, (same, same, same, lin, same, same, lin, same)
    if name == "fused_feedforward":
        x = rand(rng, 4, 6, C)
        lw, lb = ln(C)
        args = (x, lw, lb, rand(rng, C, 8 * C, scale=C ** -0.5), rand(rng, 8 * C, scale=0.1),
                rand(rng, 4 * C, C, scale=(4 * C) ** -0.5), rand(rng, C, scale=0.1))
        jf = lambda *a: j_ff.fused_feedforward(*a, use_pallas=False, add_residual=True)
        tf = lambda *a: t_ff.fused_feedforward(*a, add_residual=True)
        return jf, tf, args, (same, same, same, lin, same, lin, same)
    if name == "flash_attention":
        from upscale_a_video_tpu_torch.ops.flash_attention import flash_attention

        args = (rand(rng, 2, 2, 40, 32), rand(rng, 2, 2, 50, 32), rand(rng, 2, 2, 50, 32))
        jf = lambda *a: j_attn.attention_xla(*a, 0.2)
        tf = lambda *a: flash_attention(*a, 0.2)
        return jf, tf, args, (same, same, same)
    if name == "fused_temporal_attention":
        args = tuple(rand(rng, 6, 5, HEADS, 16, scale=0.5) for _ in range(3)) + (
            rand(rng, HEADS, 5, 5),)
        jf = lambda *a: j_fta.fused_temporal_attention(*a, use_pallas=False)
        return jf, t_fta.fused_temporal_attention, args, (same,) * 4
    if name == "fused_group_norm":
        x = rand(rng, 2, 3, 4, 5, 32) * 2 + 0.5
        args = (x, 1 + rand(rng, 32, scale=0.1), rand(rng, 32, scale=0.1))
        jf = lambda *a: j_gn.fused_group_norm(*a, 8, eps=1e-6, act="silu", use_pallas=False)
        tf = lambda *a: t_gn.fused_group_norm(*a, 8, eps=1e-6, act="silu")
        return jf, tf, args, (same,) * 3
    if name == "temporal_conv":
        args = (rand(rng, 2, 6, 3, 2, 32), rand(rng, 3, 1, 1, 32, 48, scale=0.1),
                rand(rng, 48, scale=0.1))
        jf = lambda *a: j_tc.temporal_conv(*a, use_pallas=False)
        return jf, t_tc.temporal_conv, args, (same, conv, same)
    raise KeyError(name)


KERNELS = ("temporal_attention_block", "fused_temporal_resblock", "cross_attention_block",
           "fused_feedforward", "flash_attention", "fused_temporal_attention",
           "fused_group_norm", "temporal_conv")


@pytest.mark.parametrize("name", KERNELS)
def test_plain_gradients_match_jax(name):
    rng = np.random.default_rng(KERNELS.index(name))
    jf, tf, args, layouts = case(name, rng)
    out = np.asarray(jf(*args))
    g = rand(rng, *out.shape)
    want = jax.grad(lambda *a: jnp.sum(jf(*a) * g), argnums=tuple(range(len(args))))(*args)
    ts = [torch.from_numpy(np.ascontiguousarray(f(a))).requires_grad_() for f, a in
          zip(layouts, args)]
    got = torch.autograd.grad(tf(*ts), ts, torch.from_numpy(g))
    for i, (w, t, f) in enumerate(zip(want, got, layouts)):
        w = f(np.asarray(w))
        np.testing.assert_allclose(t.numpy(), w, atol=TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{name}: input {i}")


def plain_pairs(rng):
    """(name, plain, args, leaves) as each wrapper hands them to
    ``_cuda.differentiable``; ``leaves`` are the tensors whose gradients are
    owed (the cross-attention's weights and text keys behind the fold)."""
    out = []
    for name in KERNELS:
        _, _, args, layouts = case(name, rng)
        ts = [torch.from_numpy(np.ascontiguousarray(f(a))).requires_grad_() for f, a in
              zip(layouts, args)]
        if name == "temporal_attention_block":
            call = (t_tab.temporal_attention_block_plain, (*ts, 4, 32, 1e-5, True))
        elif name == "fused_temporal_resblock":
            call = (t_res.fused_temporal_resblock_plain, (*ts, 8, 1e-6, None))
        elif name == "cross_attention_block":
            x, lw, lb, wq, k, v, wo, bo = ts
            mt, vo = t_cab.fold_keys(wq, k, v, wo, HEADS, DH)
            call = (t_cab.folded_plain, (x, lw, lb, mt, vo, bo, 3, 1e-5, True))
        elif name == "fused_feedforward":
            call = (t_ff.fused_feedforward_plain, (*ts, 1e-5, True))
        elif name == "flash_attention":
            call = (attention_plain, (*ts, 0.2))
        elif name == "fused_temporal_attention":
            call = (t_fta.temporal_attention_plain, tuple(ts))
        elif name == "fused_group_norm":
            call = (t_gn.group_norm_plain, (*ts, 8, 1e-6, "silu"))
        else:
            call = (t_tc.temporal_conv_plain, tuple(ts))
        out.append((name, *call, ts))
    return out


@pytest.mark.parametrize("index", range(len(KERNELS)))
def test_function_gives_the_plain_gradients_exactly(index):
    name, plain, args, leaves = plain_pairs(np.random.default_rng(50))[index]
    out = _cuda.differentiable(plain, plain, *args)
    assert isinstance(out.grad_fn, _cuda.ViaPlain._backward_cls)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(index))
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    want = torch.autograd.grad(plain(*args), leaves, g)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.abs().sum() > 0, f"{name}: input {i} got no gradient"
        assert torch.equal(a, b), f"{name}: input {i}"


def test_function_not_entered_without_autograd(monkeypatch):
    calls = []
    monkeypatch.setattr(_cuda.ViaPlain, "apply",
                        classmethod(lambda cls, *a: calls.append(a) or a[1](*a[2:])))
    kernel = lambda x, w: x * w
    x = torch.randn(3, requires_grad=True)
    w = torch.randn(3)
    with torch.no_grad():
        assert _cuda.differentiable(kernel, kernel, x, w).grad_fn is None
    assert _cuda.differentiable(kernel, kernel, x.detach(), w).grad_fn is None
    assert calls == []
    _cuda.differentiable(kernel, kernel, x, w)
    assert len(calls) == 1


def test_function_saves_the_callers_tensors():
    """The backward reads the tensors the caller passed (a parameter written
    in place after the forward is caught by autograd's version check)."""
    w = torch.nn.Parameter(torch.randn(4))
    x = torch.randn(4, requires_grad=True)
    out = _cuda.differentiable(torch.mul, torch.mul, x, w)
    with torch.no_grad():
        w.add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        out.sum().backward()
