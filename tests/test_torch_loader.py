"""The VAE encoder, the bundle loader and the CLIP tokenizer of the PyTorch
port, on the CPU: the encoder of both VAE configurations and the Gaussian
posterior's ``mode``/``kl``/``nll``/``sample`` against the JAX package's (float32,
1e-4 of the largest output: float32 rounding of the same convolutions in
another order); a tiny bundle (``tests/torch_bundle.py``: configs, ``.bin``
state dicts, a ``raft-things.pth`` with DataParallel's prefix, scheduler
JSONs and the synthetic BPE vocabulary of ``tests/test_clip_bpe.py``)
written to ``tmp_path`` and loaded strictly by ``load_pipeline``, whose modules, flows
and outputs equal, bit for bit, those of the modules it was written from; and
BPE ids equal to the JAX package's ``clip_bpe``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.config import VaeConfig as JVaeConfig
from upscale_a_video_tpu.models import AutoencoderKLVideo as JVae
from upscale_a_video_tpu.models.vae import DiagonalGaussianDistribution as JGaussian
from upscale_a_video_tpu.utils import clip_bpe as j_bpe
from torch_bundle import TINY_VAE, TINY_VAE_VIDEO, write_bundle, write_tokenizer
from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig, config_from_dict
from upscale_a_video_tpu_torch.models import AutoencoderKLVideo
from upscale_a_video_tpu_torch.models.raft import compute_flow_pair
from upscale_a_video_tpu_torch.models.vae import DiagonalGaussianDistribution
from upscale_a_video_tpu_torch.pipeline import (PipelineModules, VideoUpscalePipeline,
                                                load_pipeline, random_pipeline)
from upscale_a_video_tpu_torch.pipeline.loader import FallbackTokenizer
from upscale_a_video_tpu_torch.utils import clip_bpe
from upscale_a_video_tpu_torch.weights import flatten_tree, to_state_dict

torch.set_num_threads(1)

PROMPTS = ["the cat", "The   CAT and the door!", "", "her singing 42 times, 日本 café",
           "a " * 100]


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def seeded(module, *args, seed, **kwargs):
    """A parameter tree of ``module``'s shapes (``jax.eval_shape``) drawn by
    numpy: norm scales 1 + N(0, 0.1²), every other leaf N(0, 0.1²)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return {k: (float(k[-1] == "scale") + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(shapes["params"]).items()}


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- encoder

@pytest.mark.parametrize("cfg", [TINY_VAE, TINY_VAE_VIDEO], ids=["vae_3d", "vae_video"])
def test_encoder_moments(cfg):
    """Two frames of 16×24 → (1, 2, 4, 6, 8) moments: both stride-2 stages
    (bottom/right padding) and the mid block's attention run."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 2, 16, 24, 3)).astype(np.float32)
    jcfg = JVaeConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
    jm = JVae(jcfg)
    flat = seeded(jm, x, img=np.zeros((1, 2, 4, 6, 3), np.float32), seed=1)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode_moments))(
        {"params": unflatten(flat)}, x))
    tm = AutoencoderKLVideo(config_from_dict(VaeConfig, cfg)).eval()
    tm.load_state_dict(to_state_dict(flat), strict=True)
    with torch.no_grad():
        got = tm.encode_moments(T(x))
    assert got.shape == (1, 2, 4, 6, 8) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_gaussian_posterior():
    rng = np.random.default_rng(2)
    params = rng.standard_normal((2, 3, 4, 5, 8)).astype(np.float32)
    params[..., 4:] *= 3  # log-variances both sides of 0
    params[0, 0, 0, 0, 4] = 40.0  # clipped at 20
    other = rng.standard_normal(params.shape).astype(np.float32)
    sample = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    jd, jo = JGaussian(jnp.asarray(params)), JGaussian(jnp.asarray(other))
    td, to = DiagonalGaussianDistribution(T(params)), DiagonalGaussianDistribution(T(other))
    rel = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(want)).max())
    rel(td.mode(), jd.mode())
    rel(td.kl(), jd.kl())
    rel(td.kl(to), jd.kl(jo))
    rel(td.nll(T(sample)), jd.nll(jnp.asarray(sample)))
    rel(td.sample(noise=T(noise)), jd.mean + jd.std * noise)
    g = lambda: torch.Generator().manual_seed(3)
    assert torch.equal(td.sample(g()), td.sample(g())) and td.sample(g()).shape == sample.shape
    det = DiagonalGaussianDistribution(T(params), deterministic=True)
    assert torch.equal(det.sample(g()), det.mean) and torch.equal(det.kl(), torch.zeros(2))


# --------------------------------------------------------------- tokenizer

def test_bpe_ids_equal_the_jax_tokenizer(tmp_path):
    write_tokenizer(tmp_path)
    tok = clip_bpe.load_clip_tokenizer(str(tmp_path))
    jtok = j_bpe.load_clip_tokenizer(str(tmp_path))
    ids = tok(PROMPTS)
    assert ids.shape == (len(PROMPTS), 77) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jtok(PROMPTS))
    # truncated to 75 tokens after the start token; the last id is the end token
    assert ids[4, 75] != tok.eot_id and ids[4, 76] == tok.eot_id
    for p in PROMPTS[:4]:
        assert tok.encode(p) == jtok.encode(p)
        assert tok.decode(tok.encode(p)) == jtok.decode(jtok.encode(p))


# ------------------------------------------------------------------ bundle

@pytest.fixture(scope="module", params=[False, True], ids=["vae_3d", "vae_video"])
def bundle(request, tmp_path_factory):
    """A released-layout bundle of tiny modules, and the modules it holds."""
    root = tmp_path_factory.mktemp("bundle")
    return root, request.param, write_bundle(root, request.param)


def test_bundle_loads_strictly_and_matches_its_modules(bundle):
    root, video, src = bundle
    pipe = load_pipeline(str(root), use_video_vae=video, dtype=torch.float32, device="cpu")
    m = pipe.m
    assert m.vae.config.condition_img == video and m.unet.conv_in.weight.shape[0] == 8
    for name in ("unet", "vae", "text_encoder"):
        got, want = getattr(m, name).state_dict(), src[name].state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), name
    assert m.scheduler.config.beta_end == 0.013 and m.low_res_scheduler.config.beta_end == 0.021
    np.testing.assert_array_equal(m.scheduler.alphas_cumprod, src["scheduler"].alphas_cumprod)
    assert isinstance(m.tokenizer, clip_bpe.CLIPBPETokenizer)
    np.testing.assert_array_equal(
        m.tokenizer(PROMPTS), j_bpe.load_clip_tokenizer(str(root / "tokenizer"))(PROMPTS))

    rng = np.random.default_rng(5)
    frames = T(rng.uniform(-1, 1, (1, 3, 64, 64, 3)))
    assert m.raft.iters == src["raft"].iters == 20
    flows = compute_flow_pair(m.raft, frames)
    want_flows = compute_flow_pair(src["raft"], frames)
    assert all(torch.equal(a, b) for a, b in zip(flows, want_flows))

    ref = VideoUpscalePipeline(PipelineModules(
        unet=src["unet"], vae=src["vae"], text_encoder=src["text_encoder"],
        tokenizer=clip_bpe.load_clip_tokenizer(str(root / "tokenizer")),
        scheduler=src["scheduler"], low_res_scheduler=src["low_res_scheduler"]), device="cpu")
    image = T(rng.uniform(-1, 1, (1, 3, 8, 8, 3)))
    flows = T(rng.uniform(-1, 1, (1, 2, 8, 8, 2)))
    run = lambda p: p("the cat", image, num_inference_steps=2,
                      generator=torch.Generator().manual_seed(6), flows_bi=(flows, -flows),
                      propagation_steps=(1,))
    out = run(pipe)
    assert out.shape == (1, 3, 32, 32, 3) and torch.isfinite(out).all()
    assert torch.equal(out, run(ref))
    with torch.no_grad():
        assert torch.equal(m.vae.encode_moments(out), src["vae"].encode_moments(out))


def test_random_init_from_a_bundle_equals_random_pipeline(bundle):
    """``random_init`` reads the bundle's configs and tokenizer and draws the
    weights as ``random_pipeline`` does (UNet, VAE, CLIP from one seeded
    generator); no RAFT is loaded."""
    root, video, src = bundle
    pipe = load_pipeline(str(root), use_video_vae=video, random_init=True, seed=7,
                         dtype=torch.float32, device="cpu")
    ref = random_pipeline(device="cpu", seed=7, unet_config=pipe.m.unet.config,
                          vae_config=pipe.m.vae.config, clip_config=pipe.m.text_encoder.config,
                          dtype=torch.float32)
    for name in ("unet", "vae", "text_encoder"):
        got, want = getattr(pipe.m, name).state_dict(), getattr(ref.m, name).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), name
    assert pipe.m.raft is None and isinstance(pipe.m.tokenizer, clip_bpe.CLIPBPETokenizer)


def test_loader_tokenizer_rules(tmp_path):
    """No tokenizer assets and no fallback: an error before any module is
    built; the fallback's ids stay inside a small vocabulary."""
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        load_pipeline(str(tmp_path), random_init=True, allow_fallback_tokenizer=False,
                      dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="model_dir"):
        load_pipeline(None, device="cpu")
    with pytest.warns(RuntimeWarning, match="FallbackTokenizer"):
        tok = FallbackTokenizer(vocab_size=64)
    ids = tok(["abc", ""])
    assert ids.shape == (2, 77) and ids.max() < 64 and ids[0, 0] == 62


def test_config_from_dict_reads_released_jsons():
    cfg = config_from_dict(UNetVideoConfig, {"only_cross_attention": True, "unknown": 1,
                                             "block_out_channels": [8, 16, 16, 32]})
    assert cfg.only_cross_attention == (True,) * 4 and cfg.block_out_channels == (8, 16, 16, 32)
    vae = config_from_dict(VaeConfig, dict(TINY_VAE_VIDEO))
    assert vae.is_plus and vae.up_block_types == ("UpDecoderBlock3D_plus",) * 3
