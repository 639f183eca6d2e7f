"""The port's spatial tiling (``pipeline/tiling.py``), its tiled runner
(``pipeline/tiled_run.py``) and the VAE-level tiling
(``pipeline/vae_tiling.py``) against the JAX package's, on the CPU.

- ``plan_tiles`` and ``needs_tiling``: equal on a grid of sizes around the
  ``rm_end_pad`` edges (pure integer arithmetic: exact).
- ``run_tiled`` with a fake x4 pipeline (nearest upscale, so a misplaced
  tile shows) against JAX's ``run_tiled``: the same output (exact: copies),
  the same calls, per-tile flow crops and negative prompts; every call gets
  a fresh generator seeded with ``seed``.
- ``vae_tiling``: the blends, and tiled encode/decode with fake encode and
  decode functions (exact up to float32 rounding of the same blend, 1e-6)
  and with a tiny VAE of the same weights (1e-4 of the largest value: the
  same convolutions summed in another order, as ``test_torch_loader.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.config import VaeConfig as JVaeConfig
from upscale_a_video_tpu.models import AutoencoderKLVideo as JVae
from upscale_a_video_tpu.pipeline import tiled_run as j_tiled_run
from upscale_a_video_tpu.pipeline import tiling as j_tiling
from upscale_a_video_tpu.pipeline import vae_tiling as j_vae_tiling
from upscale_a_video_tpu_torch.config import VaeConfig, config_from_dict
from upscale_a_video_tpu_torch.models import AutoencoderKLVideo
from upscale_a_video_tpu_torch.pipeline import tiled_run, tiling, vae_tiling
from upscale_a_video_tpu_torch.weights import flatten_tree, to_state_dict

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------------ plan_tiles

@pytest.mark.parametrize("tile_size", [64, 128, 256])
def test_plan_tiles_equals_jax(tile_size):
    """Sizes at and around the multiples of the tile and the tile plus the
    64 px halo, where the last row or column drops its end pad."""
    sizes = sorted({max(8, m * tile_size + d) for m in range(4) for d in (-1, 0, 1, 63, 64, 65)})
    for h in sizes:
        for w in sizes:
            got = [dataclasses.astuple(s) for s in tiling.plan_tiles(h, w, tile_size, 64)]
            want = [dataclasses.astuple(s) for s in j_tiling.plan_tiles(h, w, tile_size, 64)]
            assert got == want, (h, w, tile_size)
            assert [s.in_shape for s in tiling.plan_tiles(h, w, tile_size, 64)] == \
                [s.in_shape for s in j_tiling.plan_tiles(h, w, tile_size, 64)]


def test_needs_tiling_equals_jax():
    for h in (1, 100, 383, 384, 385, 512, 1000):
        for w in (1, 100, 383, 384, 385, 512, 1000):
            assert tiling.needs_tiling(h, w) == j_tiling.needs_tiling(h, w), (h, w)
    assert tiling.needs_tiling(384, 384) and not tiling.needs_tiling(383, 384)


def test_plan_tiles_covers_the_output_once():
    """The paste regions of a plan tile the x4 output exactly (the CLI's
    path 4 plan included: two 128x192 tiles of a 128x256 clip)."""
    for h, w, ts in ((128, 256, 128), (300, 520, 256), (700, 450, 256), (64, 64, 32)):
        cover = np.zeros((4 * h, 4 * w), np.int32)
        for s in tiling.plan_tiles(h, w, ts, 64):
            cover[s.out_y0:s.out_y1, s.out_x0:s.out_x1] += 1
            assert (s.tile_y1 - s.tile_y0, s.tile_x1 - s.tile_x0) == (s.out_y1 - s.out_y0,
                                                                      s.out_x1 - s.out_x0)
        assert (cover == 1).all(), (h, w, ts)
    assert [s.in_shape for s in tiling.plan_tiles(128, 256, 128, 64)] == [(128, 192)] * 2


# ------------------------------------------------------------- run_tiled

class FakePipeline:
    """x4 nearest upscale; records what each call was given."""

    def __init__(self, framework):
        self.framework, self.calls = framework, []

    def __call__(self, prompts, tiles, flows_bi=None, generator=None, **kwargs):
        flows = None if flows_bi is None else [np.asarray(f) for f in flows_bi]
        self.calls.append(dict(prompts=list(prompts), shape=tuple(tiles.shape), flows=flows,
                               negative_prompt=kwargs.get("negative_prompt"),
                               generator=generator,
                               state=None if generator is None else generator.get_state().clone(),
                               steps=kwargs.get("num_inference_steps")))
        if generator is not None:
            torch.randn(4, generator=generator)  # a shared generator would advance
        if self.framework == "jax":
            return jnp.repeat(jnp.repeat(tiles, 4, axis=2), 4, axis=3)
        return tiles.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)


def _clip(h, w, t=2, seed=0):
    return np.random.default_rng(seed).random((1, t, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("h,w,tile_batch", [(300, 520, 1), (512, 512, 1), (512, 512, 4),
                                            (128, 256, 2)])
def test_run_tiled_equals_jax(h, w, tile_batch):
    video = _clip(h, w)
    flows = tuple(np.random.default_rng(s).random((1, 1, h, w, 2)).astype(np.float32)
                  for s in (1, 2))
    kw = dict(num_inference_steps=3, negative_prompt="blur")
    jfake, tfake = FakePipeline("jax"), FakePipeline("torch")
    want = j_tiled_run.run_tiled(jfake, "p", jnp.asarray(video),
                                 flows_bi=tuple(jnp.asarray(f) for f in flows), tile_size=256,
                                 tile_batch=tile_batch, **kw)
    got = tiled_run.run_tiled(tfake, "p", T(video), tuple(T(f) for f in flows), tile_size=256,
                              tile_batch=tile_batch, seed=5, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 2, 4 * h, 4 * w, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.repeat(np.repeat(video, 4, axis=2), 4, axis=3))
    assert len(tfake.calls) == len(jfake.calls)
    for tc, jc in zip(tfake.calls, jfake.calls):
        assert tc["prompts"] == jc["prompts"] and tc["shape"] == jc["shape"]
        assert tc["negative_prompt"] == jc["negative_prompt"] == ["blur"] * tc["shape"][0]
        assert tc["steps"] == jc["steps"] == 3
        for a, b in zip(tc["flows"], jc["flows"]):
            np.testing.assert_array_equal(a, b)


def test_run_tiled_gives_every_call_a_fresh_generator():
    """As the JAX runner passes one key to every call, each call starts from
    the same seed: a new generator, never one that earlier calls advanced."""
    fake = FakePipeline("torch")
    tiled_run.run_tiled(fake, "p", T(_clip(512, 512)), tile_size=256, tile_batch=1, seed=9)
    assert len(fake.calls) == 4
    fresh = torch.Generator().manual_seed(9).get_state()
    assert all(torch.equal(c["state"], fresh) for c in fake.calls)
    assert len({id(c["generator"]) for c in fake.calls}) == 4
    with pytest.raises(ValueError, match="one clip"):
        tiled_run.run_tiled(fake, "p", torch.zeros(2, 1, 8, 8, 3))


# ------------------------------------------------------------ vae tiling

def test_blends_equal_jax():
    rng = np.random.default_rng(0)
    a, b = rng.random((1, 2, 16, 16, 3), np.float32), rng.random((1, 2, 16, 16, 3), np.float32)
    short = {"_blend_v": rng.random((1, 2, 3, 16, 3), np.float32),  # fewer rows than the extent
             "_blend_h": rng.random((1, 2, 16, 3, 3), np.float32)}
    for fn in ("_blend_v", "_blend_h"):
        for other, extent in ((b, 4), (short[fn], 4), (b, 16), (b, 0)):
            got = getattr(vae_tiling, fn)(T(a), T(other), extent)
            want = getattr(j_vae_tiling, fn)(jnp.asarray(a), jnp.asarray(other), extent)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _fake_encode(x, xp):
    """/4 average pooling, 2 channels (a local op: tiling changes only seams)."""
    b, t, h, w, c = x.shape
    y = x.reshape(b, t, h // 4, 4, w // 4, 4, c).mean(axis=(3, 5))
    return xp.concatenate([y, y], axis=-1)[..., :2]


def _fake_decode(z, img, xp, up):
    out = up(up(z, 2), 3)
    out = xp.concatenate([out, out, out], axis=-1)[..., :3]
    return out if img is None else out + 0.1 * up(up(img, 2), 3)[..., :3]


def test_tiled_encode_and_decode_equal_jax_on_fake_functions():
    rng = np.random.default_rng(1)
    x = rng.random((1, 1, 96, 96, 1), np.float32)
    got = vae_tiling.tiled_encode_moments(lambda v: _fake_encode(v, torch), T(x), 64, 16, 0.25)
    want = j_vae_tiling.tiled_encode_moments(lambda v: _fake_encode(v, jnp), jnp.asarray(x),
                                             64, 16, 0.25)
    assert got.shape == want.shape == (1, 1, 24, 24, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    z = rng.random((1, 2, 24, 24, 4), np.float32)
    img = rng.random((1, 2, 24, 24, 3), np.float32)
    tup = lambda v, ax: v.repeat_interleave(4, dim=ax)
    jup = lambda v, ax: jnp.repeat(v, 4, axis=ax)
    for im in (img, None):
        got = vae_tiling.tiled_decode(lambda a, b: _fake_decode(a, b, torch, tup), T(z),
                                      None if im is None else T(im), 8, 6)
        want = j_vae_tiling.tiled_decode(lambda a, b: _fake_decode(a, b, jnp, jup),
                                         jnp.asarray(z), None if im is None else jnp.asarray(im),
                                         8, 6)
        assert got.shape == want.shape == (1, 2, 96, 96, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def test_tiled_encode_and_decode_equal_jax_on_a_tiny_vae():
    """The video VAE (LR-conditioned decoder) at tiny widths, same weights:
    4x4-latent decode tiles blended over 8 output pixels, 16-pixel encode
    tiles with 25 % overlap."""
    cfg = dict(block_out_channels=(8, 16, 16), norm_num_groups=4, condition_channels=8,
               up_block_types=("UpDecoderBlock3D_plus",) * 3, condition_img=True,
               use_temporal_block=True)
    jm = JVae(JVaeConfig(**cfg))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (1, 2, 28, 28, 3)).astype(np.float32)
    z = rng.standard_normal((1, 2, 8, 8, 4)).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 2, 8, 8, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x[:, :, :16, :16],
                                            img=img[:, :, :4, :4]))
    prng = np.random.default_rng(3)
    flat = {k: (float(k[-1] == "scale") + 0.1 * prng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(shapes["params"]).items()}
    params = {"params": _unflatten(flat)}
    tm = AutoencoderKLVideo(config_from_dict(VaeConfig, cfg)).eval()
    tm.load_state_dict(to_state_dict(flat), strict=True)

    jdec = jax.jit(lambda zt, it: jm.apply(params, zt, method=jm.decode, img=it, w_lr=1.0))
    jenc = jax.jit(lambda v: jm.apply(params, v, method=jm.encode_moments))
    with torch.no_grad():
        got = vae_tiling.tiled_decode(lambda a, b: tm.decode(a, b, 1.0), T(z), T(img), 4, 8)
        got_enc = vae_tiling.tiled_encode_moments(tm.encode_moments, T(x), 16, 4, 0.25)
    want = np.asarray(j_vae_tiling.tiled_decode(jdec, jnp.asarray(z), jnp.asarray(img), 4, 8))
    want_enc = np.asarray(j_vae_tiling.tiled_encode_moments(jenc, jnp.asarray(x), 16, 4, 0.25))
    assert got.shape == want.shape == (1, 2, 32, 32, 3)
    assert got_enc.shape == want_enc.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got_enc.numpy(), want_enc, atol=1e-4 * np.abs(want_enc).max())
