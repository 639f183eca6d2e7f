"""A tiny bundle in the released layout, written by the port's tests.

``write_bundle`` writes configs (tiny widths), the port modules' ``.bin``
state dicts (PyTorch's initialisers from fixed seeds), a
``raft-things.pth`` with DataParallel's prefix, scheduler JSONs and the
synthetic BPE vocabulary of ``tests/test_clip_bpe.py``; both the port's and
the JAX package's ``load_pipeline`` read it.
"""

import json

import torch

from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig, config_from_dict
from upscale_a_video_tpu_torch.models import (AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel,
                                              UNetVideoModel)
from upscale_a_video_tpu_torch.models.raft import load_raft
from upscale_a_video_tpu_torch.sampling import (DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler,
                                                DDPMSchedulerConfig)
from upscale_a_video_tpu_torch.utils import clip_bpe
from upscale_a_video_tpu_torch.weights import init_random_

VIDEO = dict(up_block_types=["UpDecoderBlock3D_plus"] * 3, condition_img=True,
             use_temporal_block=True)
TINY_VAE = dict(block_out_channels=[8, 16, 16], norm_num_groups=4)
TINY_VAE_VIDEO = dict(TINY_VAE, condition_channels=8, **VIDEO)
TINY_UNET = dict(block_out_channels=[8, 16, 16, 32], attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
MERGES = [  # tests/test_clip_bpe.py's synthetic merges
    ("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"),
    ("i", "n"), ("in", "g</w>"), ("h", "e"), ("a", "n"), ("an", "d</w>"),
    ("o", "o"), ("d", "oo"), ("doo", "r</w>"), ("e", "r</w>"),
]


def _vocab():
    vocab = list(clip_bpe.bytes_to_unicode().values())
    vocab += [v + "</w>" for v in vocab]
    vocab += ["".join(m) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {tok: i for i, tok in enumerate(vocab)}


def write_tokenizer(d):
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(_vocab(), ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES),
                                  encoding="utf-8")


def _module(cls, cfg, seed):
    with torch.device("meta"):
        m = cls(cfg)
    return init_random_(m.to_empty(device="cpu"), torch.Generator().manual_seed(seed)).eval()


def write_bundle(root, video: bool) -> dict:
    """The bundle under ``root`` (the video VAE with ``video``, else the 3D
    VAE); returns the modules and schedulers it was written from."""
    name = "vae_video" if video else "vae_3d"
    vae_json = dict(TINY_VAE_VIDEO if video else TINY_VAE, _class_name="AutoencoderKLVideo")
    unet_json = dict(TINY_UNET, only_cross_attention=[True, True, True, False],
                     _class_name="UNetVideoModel", act_fn="silu")
    text_json = dict(vocab_size=len(_vocab()), hidden_size=16, intermediate_size=32,
                     num_hidden_layers=2, num_attention_heads=2, hidden_act="gelu",
                     architectures=["CLIPTextModel"])
    ddim = dict(beta_schedule="scaled_linear", beta_start=0.0009, beta_end=0.013,
                clip_sample=False, steps_offset=1, set_alpha_to_one=False, _class_name="DDIM")
    ddpm = dict(beta_schedule="scaled_linear", beta_start=0.0002, beta_end=0.021)
    src = dict(unet=_module(UNetVideoModel, config_from_dict(UNetVideoConfig, unet_json), 1),
               vae=_module(AutoencoderKLVideo, config_from_dict(VaeConfig, vae_json), 2),
               text_encoder=_module(CLIPTextModel, config_from_dict(CLIPTextConfig, text_json), 3),
               raft=load_raft(None, device="cpu", seed=4))
    for rel, obj in ((f"vae/{name}_config.json", vae_json),
                     ("unet/unet_video_config.json", unet_json),
                     ("text_encoder/config.json", text_json),
                     ("scheduler/scheduler_config.json", ddim),
                     ("low_res_scheduler/scheduler_config.json", ddpm)):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(obj))
    torch.save(src["unet"].state_dict(), root / "unet/unet_video.bin")
    torch.save(src["vae"].state_dict(), root / f"vae/{name}.bin")
    text_sd = {f"text_model.{k}": v for k, v in src["text_encoder"].state_dict().items()}
    text_sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(text_sd, root / "text_encoder/pytorch_model.bin")
    (root / "propagator").mkdir()
    torch.save({f"module.{k}": v for k, v in src["raft"].model.state_dict().items()},
               root / "propagator/raft-things.pth")
    write_tokenizer(root / "tokenizer")
    src["scheduler"] = DDIMScheduler(DDIMSchedulerConfig(**{k: v for k, v in ddim.items()
                                                            if not k.startswith("_")}))
    src["low_res_scheduler"] = DDPMScheduler(DDPMSchedulerConfig(**ddpm))
    return src
