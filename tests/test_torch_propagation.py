"""The propagation path of the PyTorch port against the JAX package's, on the
CPU, in float32: ``grid_sample`` and ``flow_warp`` in every mode, padding and
``align_corners``; ``resize_2d``'s nearest, bilinear and area modes;
``propagate_latents`` at T = 1, 2 and 5 with nearest and bilinear warps; the
flow colour wheel; and the tiny pipeline with ``flows_bi`` and
``propagation_steps`` through the ``latents``/``lr_noise`` seams. Inputs are
made by numpy from a seed. Tolerances: 1e-5 absolute on values of order 1 to
10 (float32 rounding of the same arithmetic in another order), and the
pipeline's 1e-3 absolute of ``tests/test_torch_pipeline.py``.
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
from upscale_a_video_tpu.models import propagation as jprop
from upscale_a_video_tpu.models.clip_text import CLIPTextConfig as JClipConfig
from upscale_a_video_tpu.models.clip_text import CLIPTextModel as JClip
from upscale_a_video_tpu.ops import warp as jwarp
from upscale_a_video_tpu.ops.resize import resize_2d as j_resize
from upscale_a_video_tpu.pipeline.pipeline import PipelineModules as JModules
from upscale_a_video_tpu.pipeline.pipeline import VideoUpscalePipeline as JPipeline
from upscale_a_video_tpu.sampling import DDIMScheduler as JDDIM
from upscale_a_video_tpu.sampling import DDIMSchedulerConfig as JDDIMConfig
from upscale_a_video_tpu.sampling import DDPMScheduler as JDDPM
from upscale_a_video_tpu.utils import flow_viz as j_flow_viz
from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig
from upscale_a_video_tpu_torch.models import (AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel,
                                              UNetVideoModel)
from upscale_a_video_tpu_torch.models.propagation import (fb_consistency_check,
                                                          propagate_latents)
from upscale_a_video_tpu_torch.ops.resize import resize_2d
from upscale_a_video_tpu_torch.ops.warp import flow_warp, grid_sample
from upscale_a_video_tpu_torch.pipeline import PipelineModules, VideoUpscalePipeline
from upscale_a_video_tpu_torch.pipeline.pipeline import FixedTokenizer
from upscale_a_video_tpu_torch.sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler
from upscale_a_video_tpu_torch.utils import flow_viz
from upscale_a_video_tpu_torch.weights import CLIP_RENAMES, flatten_tree, to_state_dict

torch.set_num_threads(1)

MODES = [(m, p, a) for m in ("bilinear", "nearest") for p in ("zeros", "border")
         for a in (True, False)]
MODE_IDS = [f"{m}-{p}-{'ac' if a else 'hp'}" for m, p, a in MODES]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------- warp

@pytest.mark.parametrize("mode,padding,align", MODES, ids=MODE_IDS)
def test_grid_sample(mode, padding, align):
    """A grid reaching 30 % past every border, so both paddings act."""
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 7, 9, 3)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    want = np.asarray(jwarp.grid_sample(jnp.asarray(x), jnp.asarray(grid), mode, padding, align))
    got = grid_sample(T(x), T(grid), mode, padding, align)
    assert got.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_grid_sample_nearest_rounds_half_to_even():
    """Pixel coordinates 0.5, 1.5, 2.5, 3.5 (exact in float32) take columns
    0, 2, 2, 4, as torch's nearbyint and the JAX package's round do."""
    x = np.arange(5, dtype=np.float32).reshape(1, 1, 5, 1)
    gx = np.array([-0.75, -0.25, 0.25, 0.75], np.float32)
    grid = np.stack([gx, np.zeros_like(gx)], axis=-1).reshape(1, 1, 4, 2)
    got = grid_sample(T(x), T(grid), "nearest", "zeros", True).numpy().ravel()
    want = np.asarray(jwarp.grid_sample(jnp.asarray(x), jnp.asarray(grid), "nearest", "zeros",
                                        True)).ravel()
    np.testing.assert_array_equal(got, [0, 2, 2, 4])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,padding,align", MODES, ids=MODE_IDS)
def test_flow_warp(mode, padding, align):
    """Flows of up to ±3 pixels on an 8×10 frame: some taps leave it."""
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 8, 10, 4)
    flow = rng.uniform(-3, 3, (2, 8, 10, 2)).astype(np.float32)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode, padding, align))
    got = flow_warp(T(x), T(flow), mode, padding, align)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_fb_consistency_check():
    rng = np.random.default_rng(2)
    fw = rng.uniform(-2, 2, (1, 6, 8, 2)).astype(np.float32)
    bw = -fw + rng.uniform(-0.4, 0.4, fw.shape).astype(np.float32)
    want = np.asarray(jprop.fb_consistency_check(jnp.asarray(fw), jnp.asarray(bw), 1e-3, 0.05))
    got = fb_consistency_check(T(fw), T(bw), 1e-3, 0.05).numpy()
    assert 0 < want.mean() < 1  # both outcomes occur
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize("method,align", [("nearest", False), ("bilinear", False),
                                          ("bilinear", True), ("area", False)])
@pytest.mark.parametrize("out_hw", [(14, 20), (3, 4), (7, 9), (5, 13)])
def test_resize_2d_modes(method, align, out_hw):
    """Up ×2, down, equal size (area averages even then) and mixed."""
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 7, 9, 3)
    want = np.asarray(j_resize(jnp.asarray(x), out_hw, method, align))
    got = resize_2d(T(x), out_hw, method, align)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_resize_2d_default_is_bicubic():
    rng = np.random.default_rng(4)
    x = T(rand(rng, 1, 5, 6, 3))
    assert torch.equal(resize_2d(x, (10, 12)), resize_2d(x, (10, 12), "bicubic"))


# ------------------------------------------------------------ propagation

@pytest.mark.parametrize("t", [1, 2, 5])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
def test_propagate_latents(t, interpolation):
    """Latents (1, T, 6, 8, 4), flows at 4× the latent size (pixel units):
    area-resized and scaled inside, both sweeps chained."""
    rng = np.random.default_rng(5 + t)
    x = rand(rng, 1, t, 6, 8, 4)
    ff = rng.uniform(-6, 6, (1, max(t - 1, 1), 24, 32, 2)).astype(np.float32)
    fb = -ff + rng.uniform(-1, 1, ff.shape).astype(np.float32)
    ff, fb = ff[:, :t - 1], fb[:, :t - 1]
    want = np.asarray(jprop.propagate_latents(jnp.asarray(x), jnp.asarray(ff), jnp.asarray(fb),
                                              interpolation=interpolation))
    got = propagate_latents(T(x), T(ff), T(fb), interpolation=interpolation)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if t == 1:
        assert torch.equal(got, T(x))
    else:
        assert not np.allclose(got.numpy(), x)


# ---------------------------------------------------------------- flow_viz

def test_flow_viz_equals_the_jax_copy():
    rng = np.random.default_rng(6)
    flow = rng.uniform(-5, 5, (12, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(flow_viz.make_colorwheel(), j_flow_viz.make_colorwheel())
    for clip in (None, 2.0):
        np.testing.assert_array_equal(flow_viz.flow_to_image(flow, clip),
                                      j_flow_viz.flow_to_image(flow, clip))
    for mode in ("sintel", "kitti"):
        a = flow_viz.InputPadder(12, 17, mode)
        b = j_flow_viz.InputPadder(12, 17, mode)
        (pa,), (pb,) = a.pad(flow), b.pad(flow)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(a.unpad(pa), flow)
    with pytest.raises(ValueError):
        flow_viz.flow_to_image(flow[..., :1])


# --------------------------------------------------------------- pipeline

TINY_UNET = dict(block_out_channels=(8, 16, 16, 32), attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
TINY_VAE = dict(block_out_channels=(8, 16, 16), norm_num_groups=4)
TINY_CLIP = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=2)
B, FRAMES, H, W, STEPS = 1, 5, 8, 8, 3


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def seeded(module, *args, seed, **kwargs):
    """A parameter tree of ``module``'s shapes (``jax.eval_shape``: no
    initialiser runs) drawn by numpy: norm scales 1 + N(0, 0.1²), every other
    leaf N(0, 0.1²)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return {k: (float(k[-1] == "scale") + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(shapes["params"]).items()}


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (B, FRAMES, H, W, 3)).astype(np.float32)
    latents = rng.standard_normal((B, FRAMES, H, W, 4)).astype(np.float32)
    lr_noise = rng.standard_normal((B, FRAMES, H, W, 3)).astype(np.float32)
    ff = rng.uniform(-2, 2, (B, FRAMES - 1, H, W, 2)).astype(np.float32)
    fb = -ff + rng.uniform(-0.3, 0.3, ff.shape).astype(np.float32)

    ju, jv, jc = (JUNet(JUNetConfig(**TINY_UNET)), JVae(JVaeConfig(**TINY_VAE)),
                  JClip(JClipConfig(**TINY_CLIP)))
    up = seeded(ju, latents, 0, image, np.zeros((1, 77, 16), np.float32), 0, seed=1)
    vp = seeded(jv, np.zeros((1, 1, 4 * H, 4 * W, 3), np.float32), seed=2)
    cp = seeded(jc, np.zeros((1, 77), np.int32), seed=3)
    sched = dict(beta_schedule="scaled_linear")
    jpipe = JPipeline(JModules(
        unet=ju, unet_params={"params": unflatten(up)}, vae=jv,
        vae_params={"params": unflatten(vp)}, text_encoder=jc,
        text_params={"params": unflatten(cp)},
        tokenizer=lambda p: FixedTokenizer()(p).astype(np.int32),
        scheduler=JDDIM(JDDIMConfig(**sched)), low_res_scheduler=JDDPM()),
        dtype=jnp.float32, decode_dtype=jnp.float32, step_mode="host")

    def load(module, flat, renames=None):
        module.load_state_dict(to_state_dict(flat, renames), strict=True)
        return module.eval()

    tpipe = VideoUpscalePipeline(PipelineModules(
        unet=load(UNetVideoModel(UNetVideoConfig(**TINY_UNET)), up),
        vae=load(AutoencoderKLVideo(VaeConfig(**TINY_VAE)), vp),
        text_encoder=load(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), cp, CLIP_RENAMES),
        tokenizer=FixedTokenizer(), scheduler=DDIMScheduler(DDIMSchedulerConfig(**sched)),
        low_res_scheduler=DDPMScheduler()), device="cpu")
    return jpipe, tpipe, (image, latents, lr_noise, ff, fb)


@pytest.mark.parametrize("steps", [(0, 2), (1,)])
def test_pipeline_with_propagation_matches_jax(both, steps):
    """CFG 6, noise level 120, 3 DDIM steps, x̂0 propagated at the given step
    indices along the same flows on both sides."""
    jpipe, tpipe, (image, latents, lr_noise, ff, fb) = both
    kw = dict(num_inference_steps=STEPS, guidance_scale=6.0, noise_level=120)
    want = np.asarray(jpipe("a clip", jnp.asarray(image), flows_bi=(jnp.asarray(ff),
                                                                     jnp.asarray(fb)),
                            propagation_steps=steps, latents=jnp.asarray(latents),
                            lr_noise=jnp.asarray(lr_noise), **kw))
    got = tpipe("a clip", T(image), flows_bi=(T(ff), T(fb)), propagation_steps=steps,
                latents=T(latents), lr_noise=T(lr_noise), **kw)
    assert tpipe.propagated_steps == steps
    assert got.shape == (B, FRAMES, 4 * H, 4 * W, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    plain = tpipe("a clip", T(image), latents=T(latents), lr_noise=T(lr_noise), **kw)
    assert tpipe.propagated_steps == ()
    assert (got - plain).abs().max() > 1e-2  # the propagation changed the result


def test_pipeline_propagates_only_with_flows_and_steps(both):
    """No flows, or no step index in range: the plain call, bit for bit."""
    _, tpipe, (image, latents, lr_noise, ff, fb) = both
    kw = dict(num_inference_steps=2, guidance_scale=6.0, latents=T(latents),
              lr_noise=T(lr_noise))
    plain = tpipe("a clip", T(image), **kw)
    no_flows = tpipe("a clip", T(image), propagation_steps=(0, 1), **kw)
    assert tpipe.propagated_steps == ()
    out_of_range = tpipe("a clip", T(image), flows_bi=(T(ff), T(fb)), propagation_steps=(5,),
                         **kw)
    assert tpipe.propagated_steps == ()
    assert torch.equal(plain, no_flows) and torch.equal(plain, out_of_range)
