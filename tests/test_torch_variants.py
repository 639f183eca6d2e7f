"""The variants off the released config (ROADMAP A7) against the JAX
package's on the CPU, float32: ``mish``/``get_activation``, the DCNv2
``deform_conv2d`` (deformable groups, stride, dilation, mask, samples
outside the frame), ``temporal_shift`` and the cross-frame key concat,
``SparseCausalAttention``, ``TemporalModule3D``'s attention branch in every
attention mode (AdaLayerNorm or LayerNorm, the DCN and the flow
``WarpModule``) and its ``use_scale_shift`` ending, ``InflatedConvZero``,
``TemporalModule3DVAE`` and ``LearnablePropagation``.

Every JAX parameter is moved off its initial value with seeded noise (so the
zero-initialised gates and offset convs act) and reaches the port through
``weights.to_state_dict`` (``propagator_state_dict`` for the propagator)
with ``strict=True``. Tolerance: 1e-4 of the output's largest value (float32
sums in another order; the propagator's recurrent steps 2e-4). The
propagator's noise is 0.02, not 0.1: each recurrent step multiplies the
rounding of the step before by the step's gain, and at 0.1 its six steps
took a 3e-6 difference of the first to 3e-2. At 0.1 in float64 on both
sides the two agree to 1e-10 (fault C9: rounding, not a fault of the port).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.models.propagation_learnable import LearnablePropagation as JProp
from upscale_a_video_tpu.nn import attention as ja
from upscale_a_video_tpu.nn import blocks as jb
from upscale_a_video_tpu.nn import temporal as jt
from upscale_a_video_tpu.nn import temporal_transformer as jtt
from upscale_a_video_tpu.ops import deform_conv as j_deform_module
from upscale_a_video_tpu.ops import warp as j_warp
from upscale_a_video_tpu.ops.deform_conv import deform_conv2d as j_deform
from upscale_a_video_tpu_torch.models.propagation_learnable import LearnablePropagation
from upscale_a_video_tpu_torch.nn import attention as ta
from upscale_a_video_tpu_torch.nn import blocks as tb
from upscale_a_video_tpu_torch.nn import temporal as tt
from upscale_a_video_tpu_torch.nn import temporal_transformer as ttt
from upscale_a_video_tpu_torch.ops.deform_conv import deform_conv2d
from upscale_a_video_tpu_torch.weights import flatten_tree, propagator_state_dict, to_state_dict

torch.set_num_threads(1)

TOL = 1e-4


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1e-6))


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def ported(jmodule, tmodule, args, seed=0, convert=to_state_dict, noise=0.1, **kw):
    """Init ``jmodule`` on ``args``, move every parameter by seeded noise of
    scale ``noise``, load the port with ``strict=True``; returns (JAX
    output, port module)."""
    params = jmodule.init(jax.random.PRNGKey(seed), *args, **kw)["params"]
    rng = np.random.default_rng(seed + 100)
    flat = {k: np.asarray(v) + rand(rng, *np.shape(v), scale=noise)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}
    tmodule.load_state_dict(convert(flat), strict=True)
    return np.asarray(jmodule.apply({"params": unflatten(flat)}, *args, **kw)), tmodule


@pytest.mark.parametrize("name", ["swish", "silu", "mish", "gelu"])
def test_activations(name):
    x = rand(np.random.default_rng(0), 64, scale=3.0)
    close(jb.get_activation(name)(x), tb.get_activation(name)(T(x)), 1e-6)


def test_unknown_activation():
    with pytest.raises(ValueError):
        tb.get_activation("relu6")


@pytest.mark.parametrize("groups,stride,dilation,masked", [(1, 1, 1, True), (2, 1, 1, False),
                                                           (2, 2, 1, True), (1, 1, 2, True)])
def test_deform_conv_matches_jax(groups, stride, dilation, masked):
    rng = np.random.default_rng(groups + 10 * stride + 100 * dilation)
    b, h, w, cin, cout = 2, 9, 7, 4, 6
    x = rand(rng, b, h, w, cin)
    ho = (h + 2 - dilation * 2 - 1) // stride + 1
    wo = (w + 2 - dilation * 2 - 1) // stride + 1
    offset = rand(rng, b, ho, wo, 2 * groups * 9, scale=2.5)  # many samples leave the frame
    mask = rand(rng, b, ho, wo, groups * 9) if masked else None
    weight, bias = rand(rng, 3, 3, cin, cout), rand(rng, cout)
    want = j_deform(x, offset, weight, bias, stride=stride, padding=1, dilation=dilation,
                    mask=mask)
    got = deform_conv2d(T(x), T(offset), T(weight).permute(3, 2, 0, 1), T(bias), stride=stride,
                        padding=1, dilation=dilation, mask=None if mask is None else T(mask))
    close(want, got)


def test_shift_and_token_concat_match_jax():
    x = rand(np.random.default_rng(1), 2 * 4, 3, 6)
    close(jtt.temporal_shift(x, 4, 2), ttt.temporal_shift(T(x), 4, 2), 0)
    close(jtt.temporal_shift(x, 4, 3), ttt.temporal_shift(T(x), 4, 3), 0)
    for mode in ("0_i-1", "i-1_i", "0_i-1_i", "i-1_i_i+1", None):
        close(jtt.temporal_token_concat(x, 4, mode), ttt.temporal_token_concat(T(x), 4, mode), 0)
    with pytest.raises(NotImplementedError):
        ttt.temporal_token_concat(T(x), 4, "all")


def test_sparse_causal_attention_matches_jax():
    x = rand(np.random.default_rng(2), 3 * 4, 5, 16)
    want, tm = ported(ja.SparseCausalAttention(16, heads=2, dim_head=8),
                      ta.SparseCausalAttention(16, heads=2, dim_head=8), (x, 4))
    close(want, tm(T(x), 4))


BRANCHES = {
    "temporal": dict(attention_block_types=("Temporal", "Temporal")),
    "spatial-crossframe": dict(attention_block_types=("Spatial", "CrossFrame"),
                               cross_frame_attention_mode="0_i-1_i"),
    "shift": dict(attention_block_types=("", "SpatialTemporalShift")),
    "dcn-warp": dict(attention_block_types=("Spatial", "Temporal"), use_dcn_warpping=True),
    "flow-warp": dict(attention_block_types=("", "Temporal"), use_dcn_warpping=True,
                      use_deformable_conv=False),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_temporal_module_attention_branch_matches_jax(branch):
    rng = np.random.default_rng(3)
    x, temb = rand(rng, 2, 4, 4, 4, 32), rand(rng, 2, 16)
    kw = BRANCHES[branch]
    jm = jt.TemporalModule3D(32, temb_channels=16, groups=8, num_attention_heads=2, **kw)
    tm = tt.TemporalModule3D(32, temb_channels=16, groups=8, num_attention_heads=2, **kw)
    timesteps = np.array([3, 700], np.int32)
    want, tm = ported(jm, tm, (x, temb), timesteps=timesteps)
    close(want, tm(T(x), T(temb), timesteps=torch.as_tensor(timesteps)))


def test_temporal_transformer_without_ada_norm_matches_jax():
    x = rand(np.random.default_rng(4), 1, 3, 4, 4, 16)
    kw = dict(heads=2, dim_head=4, in_channels=16, norm_num_groups=4,
              attention_block_types=("Spatial", "Temporal"), num_embeds_ada_norm=None)
    want, tm = ported(jtt.TemporalTransformer3DModel(**kw), ttt.TemporalTransformer3DModel(**kw),
                      (x, 0))
    close(want, tm(T(x), 0))


def test_temporal_module_scale_shift_matches_jax():
    rng = np.random.default_rng(5)
    x, temb = rand(rng, 1, 3, 4, 4, 32), rand(rng, 1, 16)
    want, tm = ported(jt.TemporalModule3D(32, temb_channels=16, groups=8, use_scale_shift=True),
                      tt.TemporalModule3D(32, temb_channels=16, groups=8, use_scale_shift=True),
                      (x, temb))
    close(want, tm(T(x), T(temb)))


def test_zero_init_gates():
    x = T(rand(np.random.default_rng(6), 1, 2, 4, 4, 32))
    gate = tt.InflatedConvZero(32, 32, 3)
    assert gate.padding == (1, 1) and torch.equal(gate(x), torch.zeros_like(x))
    vae = tt.TemporalModule3DVAE(32)
    with torch.no_grad():
        assert torch.equal(vae(x), x)  # fresh: the zero gate passes x through
    fresh = tt.TemporalModule3D(32, temb_channels=None, groups=8)
    with torch.no_grad():
        assert torch.equal(fresh(x), x)


def test_temporal_module_vae_matches_jax():
    x = rand(np.random.default_rng(7), 1, 3, 4, 4, 32)
    want, tm = ported(jt.TemporalModule3DVAE(32), tt.TemporalModule3DVAE(32), (x,))
    close(want, tm(T(x)))


@pytest.fixture(scope="module")
def propagation_case():
    rng = np.random.default_rng(8)
    x = rand(rng, 1, 4, 8, 8, 4)
    ff, fb = rand(rng, 1, 3, 16, 16, 2, scale=3.0), rand(rng, 1, 3, 16, 16, 2, scale=3.0)
    jm = JProp(in_channels=4, mid_channels=16, num_blocks=1)
    want, tm = ported(jm, LearnablePropagation(4, 16, 1), (x, ff, fb),
                      convert=propagator_state_dict, noise=0.02)
    return want, tm, (x, ff, fb)


def test_learnable_propagation_matches_jax(propagation_case):
    want, tm, (x, ff, fb) = propagation_case
    with torch.no_grad():
        close(want, tm(T(x), T(ff), T(fb)), 2e-4)


class _Float64Numpy(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def test_learnable_propagation_float64_at_full_noise(monkeypatch):
    """Fault C9 (ROADMAP C): the case above at the weight noise of every
    other case, 0.1, in float64 on both sides: JAX with ``jax_enable_x64``
    for this test only, the port's module, weights and inputs in float64.
    JAX's ``flow_warp`` and ``deform_conv2d`` cast their sample positions and
    sums to float32 (``ops/warp.py:42-43,102-105``, ``ops/deform_conv.py:81-
    100``), which would leave float32 rounding inside the recurrence, so the
    test reads ``jnp.float32`` as float64 in those two modules (their files
    are untouched). The float32 gap at 0.1 is rounding that the recurrence
    amplifies when float64 closes it: the two then agree to 1e-10 of the
    output's largest value."""
    rng = np.random.default_rng(8)
    x = rand(rng, 1, 4, 8, 8, 4).astype(np.float64)
    ff = rand(rng, 1, 3, 16, 16, 2, scale=3.0).astype(np.float64)
    fb = rand(rng, 1, 3, 16, 16, 2, scale=3.0).astype(np.float64)
    for module in (j_warp, j_deform_module):
        monkeypatch.setattr(module, "jnp", _Float64Numpy("jnp"))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JProp(in_channels=4, mid_channels=16, num_blocks=1)
        params = jm.init(jax.random.PRNGKey(0), x, ff, fb)["params"]
        noise = np.random.default_rng(100)
        flat = {k: np.asarray(v, np.float64) + noise.standard_normal(np.shape(v)) * 0.1
                for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}
        want = np.asarray(jm.apply({"params": unflatten(flat)}, x, ff, fb))
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert want.dtype == np.float64
    tm = LearnablePropagation(4, 16, 1).double()
    tm.load_state_dict(propagator_state_dict(flat, torch.float64), strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, ff, fb)))
    assert got.dtype == torch.float64
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-10, err


def test_learnable_propagation_nearest_and_shapes(propagation_case):
    _, tm, (x, ff, fb) = propagation_case
    with torch.no_grad():
        out = tm(T(x), T(ff), T(fb), interpolation="nearest")
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_propagator_keys_are_the_references():
    keys = set(LearnablePropagation(4, 16, 2).state_dict())
    assert {"deform_align.backward_prop.weight", "deform_align.forward_prop.conv_offset.6.bias",
            "backbone.backward_prop.main.2.1.conv2.weight", "fuse.main.0.weight",
            "input_layer.weight", "output_layer.bias"} <= keys
