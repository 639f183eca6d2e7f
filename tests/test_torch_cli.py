"""The port's command line (``cli.py``) on the CPU, against the JAX
package's.

- The argv: every JAX flag with its default, plus ``--device``.
- The per-clip step (``process_clip``: uint8 in, uint8 out; not tiled,
  ``-p 1`` with given flows, Wavelet fix) against the same steps composed
  from the JAX package (``video_io``, the pipeline, ``apply_color_fix``) on
  the same tiny bundle (``tests/torch_bundle.py``, video VAE, float32), with
  the initial latents and LR noise passed through ``**call_kwargs``: within
  1 level of 255 (float32 rounding through 2 steps, then truncation).
- ``cli.main`` end to end on a tiny mp4: ``video/<save name>.mp4`` at x4 and
  PNG frames under the JAX CLI's save name; the refusals (fp32 attention
  operands on the card, no card).
- without ``--no_llava``: an empty caption when no backend is configured
  (the prompt is ``a_prompt``, as JAX's), else the backend's caption of
  frame 0 prepended (a stub backend).
- ``--decode_attn fp32``: the VAE attention with fp32 operands against JAX's
  ``UAV_VAE_ATTN_F32`` (1e-5 of the largest value: float32 attention in
  another order), and bf16 operands against JAX's default.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bundle import write_bundle
from upscale_a_video_tpu import cli as j_cli
from upscale_a_video_tpu.nn.attention import SpatialAttentionBlock as JSpatialAttention
from upscale_a_video_tpu.pipeline.color import apply_color_fix as j_apply_color_fix
from upscale_a_video_tpu.pipeline.loader import load_pipeline as jax_load_pipeline
from upscale_a_video_tpu.utils import video_io as j_video_io
from upscale_a_video_tpu_torch import cli
from upscale_a_video_tpu_torch.nn.attention import SpatialAttentionBlock
from upscale_a_video_tpu_torch.pipeline import load_pipeline
from upscale_a_video_tpu_torch.utils import video_io
from upscale_a_video_tpu_torch.weights import flatten_tree, to_state_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    write_bundle(root, video=True)
    return root


def test_parser_matches_jax():
    jp, tp = j_cli.build_parser(), cli.build_parser()
    defaults = vars(tp.parse_args([]))
    assert defaults.pop("device") == "cuda"
    assert defaults == vars(jp.parse_args([]))
    argv = ["-i", "in.mp4", "-o", "out", "-n", "100", "-g", "7.5", "-s", "20", "-p", "24,26,28",
            "--use_video_vae", "--color_fix", "Wavelet", "--no_llava", "--perform_tile",
            "--tile_size", "128", "--tile_batch", "2", "--save_image", "--save_suffix", "x",
            "--seed", "3", "--max_frames", "9", "--max_size", "640", "--decode_fp32",
            "--decode_attn", "fp32", "--w_lr", "0.5", "--random_weights"]
    got = vars(tp.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu" and got == vars(jp.parse_args(argv))


class GivenFlows:
    """A stand-in for RAFT that returns given flows, forward then backward
    (the order of ``compute_flow_pair``'s two calls)."""

    def __init__(self, forward, backward):
        self.out = [forward, backward]

    def __call__(self, image1, image2):
        return self.out.pop(0)


def test_process_clip_matches_the_jax_steps(bundle):
    rng = np.random.default_rng(0)
    t, h, w = 3, 8, 8
    frames_u8 = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    flow = rng.uniform(-1.5, 1.5, (t - 1, h, w, 2)).astype(np.float32)  # backward = -forward
    latents = rng.standard_normal((1, t, h, w, 4)).astype(np.float32)
    lr_noise = rng.standard_normal((1, t, h, w, 3)).astype(np.float32)
    args = cli.build_parser().parse_args(["-p", "1", "-s", "2", "--use_video_vae", "--no_llava",
                                          "--color_fix", "Wavelet", "--device", "cpu"])

    tpipe = load_pipeline(str(bundle), use_video_vae=True, dtype=torch.float32, device="cpu")
    got = cli.process_clip(tpipe, GivenFlows(torch.from_numpy(flow), torch.from_numpy(-flow)),
                           frames_u8, args, latents=torch.from_numpy(latents),
                           lr_noise=torch.from_numpy(lr_noise))
    assert tpipe.propagated_steps == (1,)

    jpipe = jax_load_pipeline(str(bundle), use_video_vae=True, dtype=jnp.float32,
                              decode_dtype=jnp.float32)
    video = jnp.asarray(j_video_io.to_model_range(frames_u8))[None]
    out = jpipe(args.a_prompt, video, (jnp.asarray(flow)[None], jnp.asarray(-flow)[None]),
                num_inference_steps=2, guidance_scale=args.guidance_scale,
                noise_level=args.noise_level, negative_prompt=args.n_prompt,
                propagation_steps=args.propagation_steps, latents=jnp.asarray(latents),
                lr_noise=jnp.asarray(lr_noise), w_lr=args.w_lr)
    want = j_video_io.from_model_range(np.asarray(
        j_apply_color_fix("Wavelet", np.asarray(out)[0], np.asarray(video)[0])))
    assert got.dtype == np.uint8 and got.shape == want.shape == (t, 4 * h, 4 * w, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_cli_main_end_to_end(bundle, tmp_path):
    """``--random_weights`` with the bundle's configs, RAFT from its
    ``raft-things.pth`` for ``-p 1``, 3 frames of 64x64 -> 256x256."""
    frames = np.random.default_rng(1).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    src = str(tmp_path / "in" / "clip.mp4")
    video_io.write_video(src, frames, fps=8)
    out = tmp_path / "out"
    cli.main(["-i", src, "-o", str(out), "--random_weights", "--no_llava", "--device", "cpu",
              "-s", "2", "-p", "1", "--model_dir", str(bundle), "--use_video_vae",
              "--color_fix", "Wavelet", "--save_image"])
    name = "clip_n120_g6_s2_p1"  # the JAX CLI's save name (cli.py:253-258)
    assert os.listdir(out / "video") == [f"{name}.mp4"]
    upscaled, fps, stem = video_io.read_video(str(out / "video" / f"{name}.mp4"))
    assert upscaled.shape == (3, 256, 256, 3) and fps == 8.0 and stem == name
    assert sorted(os.listdir(out / "frame" / name)) == ["0000.png", "0001.png", "0002.png"]
    png, _, _ = video_io.read_video(str(out / "frame" / name))
    assert png.shape == (3, 256, 256, 3) and png.std() > 0


def test_cli_refusals(bundle, tmp_path, monkeypatch):
    base = ["-i", str(tmp_path), "--random_weights", "--model_dir", str(bundle)]
    for var in ("UAV_CAPTION_TORCH_MODEL", "UAV_CAPTION_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="invalid input"):  # no captioner refusal any more
        cli.main(base + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(base + ["--no_llava"])
    # fp32 operands in the decode's attention are no refusal on the card
    # (the fp32 flash kernel takes them): the run stops only for want of a card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(base + ["--no_llava", "--decode_fp32", "--decode_attn", "fp32", "--device",
                         "cuda"])
    with pytest.raises(ValueError, match="invalid input"):
        cli.main(base + ["--no_llava", "--device", "cpu"])


class PromptRecorder:
    """A pipeline whose calls record their prompts."""

    def __init__(self, pipe):
        object.__setattr__(self, "pipe", pipe)
        object.__setattr__(self, "prompts", [])

    def __call__(self, prompt, *args, **kwargs):
        self.prompts.append(prompt)
        return self.pipe(prompt, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __setattr__(self, name, value):  # the CLI sets step_mode / window_group
        setattr(self.pipe, name, value)


def test_cli_without_no_llava(bundle, tmp_path, monkeypatch, capsys):
    """Without ``--no_llava``: with no backend configured the captioner is
    None and the prompt is ``a_prompt`` alone, as the JAX CLI gives; with a
    backend its caption of frame 0 is printed and prepended, and
    ``--load_8bit_llava`` reaches the backend (JAX ``cli.py:144-148,
    180-184``)."""
    for var in ("UAV_CAPTION_TORCH_MODEL", "UAV_CAPTION_ENDPOINT", "UAV_CAPTION_JAX_MODEL",
                "UAV_CAPTION_MODEL"):
        monkeypatch.delenv(var, raising=False)
    from upscale_a_video_tpu.captioner import build_captioner as j_build_captioner
    assert j_build_captioner() is None
    frames = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    src = str(tmp_path / "in" / "clip.mp4")
    video_io.write_video(src, frames, fps=8)
    recorders = []
    load_models = cli.load_models

    def recording(args, device):
        pipe, raft = load_models(args, device)
        recorders.append(PromptRecorder(pipe))
        return recorders[-1], raft

    monkeypatch.setattr(cli, "load_models", recording)
    argv = ["-i", src, "-o", str(tmp_path / "out"), "--random_weights", "--device", "cpu",
            "-s", "1", "--model_dir", str(bundle), "--use_video_vae"]
    cli.main(argv)
    a_prompt = cli.build_parser().parse_args([]).a_prompt
    assert recorders[0].prompts == [a_prompt]
    assert "Caption:" not in capsys.readouterr().out

    built, seen = [], []

    def build_captioner(load_8bit, device):
        built.append((load_8bit, device))
        return lambda frame: seen.append(frame.shape) or "a stub caption, "

    monkeypatch.setattr(cli, "build_captioner", build_captioner)
    cli.main(argv + ["--load_8bit_llava"])
    assert recorders[1].prompts == ["a stub caption, " + a_prompt]
    assert built == [(True, torch.device("cpu"))] and seen == [(32, 32, 3)]
    assert "Caption: a stub caption," in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out" / "video" / "clip_n120_g6_s1.mp4")


def test_input_list(tmp_path):
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    video_io.write_frames(str(tmp_path / "pngs"), frames)
    for name in ("b.mp4", "a.mov"):
        video_io.write_video(str(tmp_path / "videos" / name), frames)
    assert cli.input_list("x/clip.mp4") == ["x/clip.mp4"]
    assert cli.input_list(str(tmp_path / "pngs")) == [str(tmp_path / "pngs")]
    assert cli.input_list(str(tmp_path / "videos")) == [str(tmp_path / "videos" / n)
                                                       for n in ("a.mov", "b.mp4")]


def test_decode_attn_fp32_operands_match_jax(bundle, monkeypatch):
    x = np.random.default_rng(2).standard_normal((1, 2, 4, 6, 16)).astype(np.float32)
    jm = JSpatialAttention(channels=16, norm_num_groups=4, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(3)
    flat = {k: (float(k[-1] == "scale") + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(shapes["params"]).items()}
    params = {"params": {}}
    for path, v in flat.items():
        params["params"].setdefault(path[0], {})[path[1]] = v
    tm = SpatialAttentionBlock(16, norm_num_groups=4).eval()
    tm.load_state_dict(to_state_dict(flat), strict=True)
    with torch.no_grad():
        bf16_ops = tm(torch.from_numpy(x)).numpy()
        tm.fp32_operands = True
        fp32_ops = tm(torch.from_numpy(x)).numpy()
    want_bf16 = np.asarray(jm.apply(params, x))
    monkeypatch.setenv("UAV_VAE_ATTN_F32", "1")
    want_fp32 = np.asarray(jm.apply(params, x))
    np.testing.assert_allclose(fp32_ops, want_fp32, atol=1e-5 * np.abs(want_fp32).max())
    np.testing.assert_allclose(bf16_ops, want_bf16, atol=1e-5 * np.abs(want_bf16).max())
    assert np.abs(fp32_ops - bf16_ops).max() > 1e-4  # the operand type matters

    args = cli.build_parser().parse_args(["--random_weights", "--model_dir", str(bundle),
                                          "--use_video_vae", "--decode_fp32", "--decode_attn",
                                          "fp32", "--device", "cpu"])
    pipe, raft = cli.load_models(args, torch.device("cpu"))
    blocks = [m for m in pipe.m.vae.modules() if isinstance(m, SpatialAttentionBlock)]
    assert raft is None and blocks and all(m.fp32_operands for m in blocks)
    assert pipe.m.vae.post_quant_conv.weight.dtype == torch.float32
