"""The PyTorch port's VideoUpscalePipeline end to end against the JAX
pipeline on the CPU: tiny UNet, VAE and CLIP with the same (perturbed random)
weights, a 14-frame clip (window starts 0, 6, 6: the blend and the duplicate
window both run), CFG 6, noise level 120, 3 DDIM steps, identical initial
latents and LR noise through the ``latents``/``lr_noise`` seams, float32 on
both sides. Tolerance: float32 rounding carried through 3 steps × 2 windows of
the UNet and the decode. Both take their arguments in the same order: the
flows third (fault C2), passed positionally to both.
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
from upscale_a_video_tpu.pipeline.pipeline import PipelineModules as JModules
from upscale_a_video_tpu.pipeline.pipeline import VideoUpscalePipeline as JPipeline
from upscale_a_video_tpu.sampling import DDIMScheduler as JDDIM
from upscale_a_video_tpu.sampling import DDIMSchedulerConfig as JDDIMConfig
from upscale_a_video_tpu.sampling import DDPMScheduler as JDDPM
from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig
from upscale_a_video_tpu_torch.models import (AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel,
                                              UNetVideoModel)
from upscale_a_video_tpu_torch.pipeline import PipelineModules, VideoUpscalePipeline
from upscale_a_video_tpu_torch.pipeline.pipeline import FixedTokenizer, random_pipeline
from upscale_a_video_tpu_torch.sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler
from upscale_a_video_tpu_torch.weights import CLIP_RENAMES, flatten_tree, to_state_dict

torch.set_num_threads(1)

TINY_UNET = dict(block_out_channels=(8, 16, 16, 32), attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
TINY_VAE = dict(block_out_channels=(8, 16, 16), norm_num_groups=4)
TINY_CLIP = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=2)
B, FRAMES, H, W, STEPS = 1, 14, 8, 8, 3


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
    return {k: np.asarray(v) + (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}


class JaxFixedTokenizer:
    def __call__(self, prompts):
        return FixedTokenizer()(prompts).astype(np.int32)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (B, FRAMES, H, W, 3)).astype(np.float32)
    latents = rng.standard_normal((B, FRAMES, H, W, 4)).astype(np.float32)
    lr_noise = rng.standard_normal((B, FRAMES, H, W, 3)).astype(np.float32)

    ju, jv, jc = (JUNet(JUNetConfig(**TINY_UNET)), JVae(JVaeConfig(**TINY_VAE)),
                  JClip(JClipConfig(**TINY_CLIP)))
    up = perturbed(ju.init(jax.random.PRNGKey(0), latents[:, :8], 0, image[:, :8],
                           np.zeros((1, 77, 16), np.float32), 0)["params"], 1)
    vp = perturbed(jv.init(jax.random.PRNGKey(1), np.zeros((1, 1, 4 * H, 4 * W, 3),
                                                            np.float32))["params"], 2)
    cp = perturbed(jc.init(jax.random.PRNGKey(2), np.zeros((1, 77), np.int32))["params"], 3)

    sched_cfg = dict(beta_schedule="scaled_linear")
    jpipe = JPipeline(JModules(
        unet=ju, unet_params={"params": unflatten(up)}, vae=jv,
        vae_params={"params": unflatten(vp)}, text_encoder=jc,
        text_params={"params": unflatten(cp)}, tokenizer=JaxFixedTokenizer(),
        scheduler=JDDIM(JDDIMConfig(**sched_cfg)), low_res_scheduler=JDDPM()),
        dtype=jnp.float32, decode_dtype=jnp.float32, step_mode="host")
    want = np.asarray(jpipe("a clip", jnp.asarray(image), num_inference_steps=STEPS,
                            guidance_scale=6.0, noise_level=120, latents=jnp.asarray(latents),
                            lr_noise=jnp.asarray(lr_noise)))

    unet = UNetVideoModel(UNetVideoConfig(**TINY_UNET)).eval()
    unet.load_state_dict(to_state_dict(up), strict=True)
    vae = AutoencoderKLVideo(VaeConfig(**TINY_VAE)).eval()
    vae.load_state_dict(to_state_dict(vp), strict=True)
    clip = CLIPTextModel(CLIPTextConfig(**TINY_CLIP)).eval()
    clip.load_state_dict(to_state_dict(cp, CLIP_RENAMES), strict=True)
    tpipe = VideoUpscalePipeline(PipelineModules(
        unet=unet, vae=vae, text_encoder=clip, tokenizer=FixedTokenizer(),
        scheduler=DDIMScheduler(DDIMSchedulerConfig(**sched_cfg)),
        low_res_scheduler=DDPMScheduler()), device="cpu")
    return tpipe, (image, latents, lr_noise), want, jpipe


def test_pipeline_matches_jax_end_to_end(both):
    tpipe, (image, latents, lr_noise), want, _ = both
    got = tpipe("a clip", torch.from_numpy(image), num_inference_steps=STEPS,
                guidance_scale=6.0, noise_level=120, latents=torch.from_numpy(latents),
                lr_noise=torch.from_numpy(lr_noise))
    assert got.shape == (B, FRAMES, 4 * H, 4 * W, 3) == want.shape
    assert np.isfinite(got.numpy()).all() and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_pipeline_without_cfg_is_deterministic_per_seed(both):
    tpipe, (image, _, _), _, _ = both
    run = lambda seed: tpipe("a clip", torch.from_numpy(image[:, :6]), num_inference_steps=2,
                             guidance_scale=1.0,
                             generator=torch.Generator().manual_seed(seed))
    a, b, c = run(5), run(5), run(6)
    assert a.shape == (B, 6, 4 * H, 4 * W, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_pipeline_input_checks(both):
    tpipe = both[0]
    with pytest.raises(ValueError, match="noise_level"):
        tpipe("x", torch.zeros(1, 2, 8, 8, 3), noise_level=351)
    with pytest.raises(ValueError, match=r"\(B, T, H, W, 3\)"):
        tpipe("x", torch.zeros(1, 2, 3, 8, 8))
    with pytest.raises(ValueError, match="batch mismatch"):
        tpipe(["x", "y"], torch.zeros(1, 2, 8, 8, 3))


def test_flows_are_the_third_argument_as_in_jax(both):
    """``pipe(prompt, image, flows_bi, steps, guidance, noise_level,
    negative_prompt, propagation_steps)`` positionally, on both pipelines:
    the same output, propagated at step 1 along a consistent flow pair
    (backward = -forward, so that the warp and the fusion act)."""
    tpipe, (image, latents, lr_noise), no_flows, jpipe = both
    flow = np.random.default_rng(7).uniform(-1.5, 1.5, (B, FRAMES - 1, H, W, 2)).astype(np.float32)
    want = np.asarray(jpipe("a clip", jnp.asarray(image), (jnp.asarray(flow), jnp.asarray(-flow)),
                            STEPS, 6.0, 120, None, (1,), latents=jnp.asarray(latents),
                            lr_noise=jnp.asarray(lr_noise)))
    flows = (torch.from_numpy(flow), torch.from_numpy(-flow))
    got = tpipe("a clip", torch.from_numpy(image), flows, STEPS, 6.0, 120, None, (1,),
                latents=torch.from_numpy(latents),
                lr_noise=torch.from_numpy(lr_noise))
    assert tpipe.propagated_steps == (1,)
    assert np.abs(want - no_flows).max() > 1e-2  # the propagation changed the output
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_pipeline_input_checks_match_jax(both):
    """The checks JAX's ``check_inputs`` has beyond the shape ones: a
    ``negative_prompt`` that is no str or list, and no image."""
    tpipe, _, _, jpipe = both
    for pipe, image in ((tpipe, torch.zeros(1, 2, 8, 8, 3)), (jpipe, jnp.zeros((1, 2, 8, 8, 3)))):
        with pytest.raises(ValueError, match="`negative_prompt` must be str or list"):
            pipe("x", image, negative_prompt=3)
        with pytest.raises(ValueError, match="`image` input cannot be undefined"):
            pipe("x", None)


def test_random_pipeline_on_cpu_at_tiny_width():
    pipe = random_pipeline(device="cpu", seed=0, unet_config=UNetVideoConfig(**TINY_UNET),
                           vae_config=VaeConfig(**TINY_VAE),
                           clip_config=CLIPTextConfig(**TINY_CLIP), dtype=torch.float32)
    out = pipe("a clip", torch.zeros(1, 3, 8, 8, 3), num_inference_steps=2)
    assert out.shape == (1, 3, 32, 32, 3) and torch.isfinite(out).all()
