"""The video-VAE configuration of the PyTorch port against the JAX package's,
on the CPU: its blocks (``ResnetBlock3DPlus``, ``FuseSFTBlock``), the tiny
video VAE's conditional decode at two ``w_lr``, the full-width decoder's
state-dict keys and shapes, ``resize_2d``, the colour fix, and the tiny
pipeline with the video VAE at T = 5 (one 5-frame window, two decode chunks)
through the ``latents``/``lr_noise`` seams.

Every JAX parameter is moved off its initial value with seeded noise (so the
zero-initialised (3,3,3) branches run), the tree goes through the port's
``weights.to_state_dict`` into the torch module with ``strict=True``, and
both sides run the same numpy inputs in float32. Tolerances are float32
rounding of the same arithmetic in another order, scaled to the output's
size where the output is large.
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
from upscale_a_video_tpu.nn import blocks as jb
from upscale_a_video_tpu.ops.resize import resize_2d as j_resize
from upscale_a_video_tpu.pipeline import color as j_color
from upscale_a_video_tpu.pipeline.pipeline import PipelineModules as JModules
from upscale_a_video_tpu.pipeline.pipeline import VideoUpscalePipeline as JPipeline
from upscale_a_video_tpu.sampling import DDIMScheduler as JDDIM
from upscale_a_video_tpu.sampling import DDIMSchedulerConfig as JDDIMConfig
from upscale_a_video_tpu.sampling import DDPMScheduler as JDDPM
from upscale_a_video_tpu_torch.config import VIDEO_VAE, UNetVideoConfig, VaeConfig
from upscale_a_video_tpu_torch.models import (AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel,
                                              UNetVideoModel)
from upscale_a_video_tpu_torch.nn import blocks as tb
from upscale_a_video_tpu_torch.ops.resize import resize_2d
from upscale_a_video_tpu_torch.pipeline import PipelineModules, VideoUpscalePipeline
from upscale_a_video_tpu_torch.pipeline.color import apply_color_fix
from upscale_a_video_tpu_torch.pipeline.pipeline import FixedTokenizer, random_pipeline
from upscale_a_video_tpu_torch.sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler
from upscale_a_video_tpu_torch.weights import (CLIP_RENAMES, flatten_tree, to_state_dict,
                                               torch_key, torch_shape)

torch.set_num_threads(1)

VIDEO = dict(up_block_types=("UpDecoderBlock3D_plus",) * 3, condition_img=True,
             use_temporal_block=True)
TINY_VAE_VIDEO = dict(block_out_channels=(8, 16, 16), norm_num_groups=4, condition_channels=8,
                      **VIDEO)
TINY_UNET = dict(block_out_channels=(8, 16, 16, 32), attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
TINY_CLIP = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=2)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


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


def loaded(tmodule, flat, renames=None):
    tmodule.load_state_dict(to_state_dict(flat, renames), strict=True)
    return tmodule.eval()


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("cin,cout,groups,groups_out", [(3, 8, 3, 4), (8, 8, 4, 4)])
def test_resnet_block_3d_plus(cin, cout, groups, groups_out):
    """With a shortcut (the LR condition's first block) and without."""
    rng = np.random.default_rng(cin)
    x = rand(rng, 1, 3, 6, 5, cin)
    jm = jb.ResnetBlock3DPlus(in_channels=cin, out_channels=cout, temb_channels=None,
                              groups=groups, groups_out=groups_out)
    flat = perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 1)
    assert any("conv_3d" in p for p in flat)
    tm = loaded(tb.ResnetBlock3DPlus(cin, cout, None, groups=groups, groups_out=groups_out), flat)
    want = np.asarray(jm.apply({"params": unflatten(flat)}, x))
    with torch.no_grad():
        got = tm(T(x))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("w", [1.0, 0.5])
def test_fuse_sft_block(w):
    rng = np.random.default_rng(2)
    enc, dec = rand(rng, 1, 2, 4, 4, 8), rand(rng, 1, 2, 4, 4, 16)
    jm = jb.FuseSFTBlock(enc_channels=8, dec_channels=16, groups=4)
    flat = perturbed(jm.init(jax.random.PRNGKey(0), enc, dec)["params"], 3)
    tm = loaded(tb.FuseSFTBlock(8, 16, 4), flat)
    want = np.asarray(jm.apply({"params": unflatten(flat)}, enc, dec, w))
    with torch.no_grad():
        got = tm(T(enc), T(dec), w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# ------------------------------------------------------------------- VAE

@pytest.fixture(scope="module")
def tiny_video_vae():
    rng = np.random.default_rng(4)
    z, img = rand(rng, 1, 3, 4, 4, 4), rand(rng, 1, 3, 4, 4, 3)
    jm = JVae(JVaeConfig(**TINY_VAE_VIDEO))
    flat = perturbed(jm.init(jax.random.PRNGKey(1), np.zeros((1, 3, 16, 16, 3), np.float32),
                             img=img)["params"], 5)
    tm = loaded(AutoencoderKLVideo(VaeConfig(**TINY_VAE_VIDEO)), flat)
    decode = jax.jit(lambda p, z, img, w: jm.apply(p, z, img, w, method=jm.decode),
                     static_argnums=3)
    return tm, lambda z, img, w: np.asarray(decode({"params": unflatten(flat)}, z, img, w)), z, img


@pytest.mark.parametrize("w_lr", [1.0, 0.5])
def test_video_vae_conditional_decode(tiny_video_vae, w_lr):
    tm, jdecode, z, img = tiny_video_vae
    want = jdecode(z, img, w_lr)
    with torch.no_grad():
        got = tm.decode(T(z), T(img), w_lr)
    assert got.shape == (1, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


def test_video_vae_needs_the_lr_frames(tiny_video_vae):
    tm, _, z, _ = tiny_video_vae
    with pytest.raises(ValueError, match="img"):
        tm.decode(T(z))


def test_full_width_video_vae_keys_and_shapes():
    """The preset is the released video VAE: the JAX decoder at released
    width converts to exactly the port's keys and shapes."""
    jcfg = JVaeConfig(condition_channels=128, **VIDEO)
    for f in ("up_block_types", "condition_img", "condition_channels", "use_temporal_block",
              "block_out_channels", "norm_num_groups", "layers_per_block", "scaling_factor"):
        assert getattr(VIDEO_VAE, f) == getattr(jcfg, f), f
    jv = JVae(jcfg)
    tree = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
                                          img=jnp.zeros((1, 1, 8, 8, 3))))["params"]
    with torch.device("meta"):
        tv = AutoencoderKLVideo(VIDEO_VAE)
    want = {torch_key(p): torch_shape(p, leaf.shape) for p, leaf in flatten_tree(tree).items()}
    assert {k: tuple(v.shape) for k, v in tv.state_dict().items()} == want
    assert "decoder.condition_fuse.shared.0.conv_shortcut.weight" in want
    assert "decoder.up_blocks.2.resnets.2.conv_3d.weight" in want
    assert "encoder.mid_block.attentions.0.query.weight" in want


# ------------------------------------------------------ resize, colour fix

@pytest.mark.parametrize("out_hw", [(20, 28), (3, 4), (11, 13), (10, 4), (5, 7)])
def test_resize_2d(out_hw):
    """Bicubic, float32 on both sides: x4 up (the colour fix), down, a
    non-integer ratio, up in one axis and down in the other, and the
    identity, at 2e-6 absolute on values of order 1."""
    rng = np.random.default_rng(6)
    x = rand(rng, 2, 5, 7, 3)
    want = np.asarray(j_resize(jnp.asarray(x), out_hw, "bicubic", False))
    got = resize_2d(T(x), out_hw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("mode", ["AdaIn", "Wavelet"])
def test_apply_color_fix(mode):
    rng = np.random.default_rng(7)
    lr = rng.uniform(-1, 1, (5, 6, 8, 3)).astype(np.float32)
    out = np.clip(rand(rng, 5, 24, 32, 3, scale=0.5), -1, 1)
    want = j_color.apply_color_fix(mode, out, lr, chunk_frames=2)
    got = apply_color_fix(mode, T(out), T(lr), chunk_frames=2)
    assert got.shape == out.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert torch.equal(apply_color_fix("None", T(out), T(lr)), T(out))


# -------------------------------------------------------------- pipeline

def test_pipeline_with_video_vae_matches_jax_at_five_frames():
    """CFG 6, noise level 120, 3 DDIM steps, w_lr 0.5, float32 on both sides."""
    b, frames, h, w, steps, w_lr = 1, 5, 8, 8, 3, 0.5
    rng = np.random.default_rng(8)
    image = rng.uniform(-1, 1, (b, frames, h, w, 3)).astype(np.float32)
    latents = rng.standard_normal((b, frames, h, w, 4)).astype(np.float32)
    lr_noise = rng.standard_normal((b, frames, h, w, 3)).astype(np.float32)

    ju, jv, jc = (JUNet(JUNetConfig(**TINY_UNET)), JVae(JVaeConfig(**TINY_VAE_VIDEO)),
                  JClip(JClipConfig(**TINY_CLIP)))
    up = perturbed(ju.init(jax.random.PRNGKey(0), latents, 0, image,
                           np.zeros((1, 77, 16), np.float32), 0)["params"], 1)
    vp = perturbed(jv.init(jax.random.PRNGKey(1), np.zeros((1, 1, 4 * h, 4 * w, 3), np.float32),
                           img=image[:, :1])["params"], 2)
    cp = perturbed(jc.init(jax.random.PRNGKey(2), np.zeros((1, 77), np.int32))["params"], 3)

    sched = dict(beta_schedule="scaled_linear")
    jpipe = JPipeline(JModules(
        unet=ju, unet_params={"params": unflatten(up)}, vae=jv,
        vae_params={"params": unflatten(vp)}, text_encoder=jc,
        text_params={"params": unflatten(cp)},
        tokenizer=lambda p: FixedTokenizer()(p).astype(np.int32),
        scheduler=JDDIM(JDDIMConfig(**sched)), low_res_scheduler=JDDPM()),
        dtype=jnp.float32, decode_dtype=jnp.float32, step_mode="host")
    want = np.asarray(jpipe("a clip", jnp.asarray(image), num_inference_steps=steps,
                            guidance_scale=6.0, noise_level=120, latents=jnp.asarray(latents),
                            lr_noise=jnp.asarray(lr_noise), w_lr=w_lr))

    tpipe = VideoUpscalePipeline(PipelineModules(
        unet=loaded(UNetVideoModel(UNetVideoConfig(**TINY_UNET)), up),
        vae=loaded(AutoencoderKLVideo(VaeConfig(**TINY_VAE_VIDEO)), vp),
        text_encoder=loaded(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), cp, CLIP_RENAMES),
        tokenizer=FixedTokenizer(), scheduler=DDIMScheduler(DDIMSchedulerConfig(**sched)),
        low_res_scheduler=DDPMScheduler()), device="cpu")
    got = tpipe("a clip", torch.from_numpy(image), num_inference_steps=steps,
                guidance_scale=6.0, noise_level=120, latents=torch.from_numpy(latents),
                lr_noise=torch.from_numpy(lr_noise), w_lr=w_lr)
    assert got.shape == (b, frames, 4 * h, 4 * w, 3) == want.shape
    assert np.isfinite(got.numpy()).all() and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_random_pipeline_takes_the_video_vae_preset():
    pipe = random_pipeline(device="cpu", seed=0, unet_config=UNetVideoConfig(**TINY_UNET),
                           vae_config=VaeConfig(**TINY_VAE_VIDEO),
                           clip_config=CLIPTextConfig(**TINY_CLIP), dtype=torch.float32)
    assert pipe.m.vae.config.condition_img and pipe.m.vae.decoder.condition_img
    out = pipe("a clip", torch.zeros(1, 5, 8, 8, 3), num_inference_steps=2)
    assert out.shape == (1, 5, 32, 32, 3) and torch.isfinite(out).all()
    fixed = apply_color_fix("Wavelet", out[0], torch.zeros(5, 8, 8, 3))
    assert fixed.shape == (5, 32, 32, 3) and torch.isfinite(fixed).all()
