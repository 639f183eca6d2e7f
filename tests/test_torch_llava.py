"""The port's LLaVA captioner against the JAX package on the CPU: tiny
configs, JAX parameters (seeded init plus seeded noise, so that biases and
norms are not trivial) carried into the port by ``weights.llava_state_dict``
(the released checkpoints' key names, strict loads), float32 on both sides.

- the CLIP vision tower's (-2)th-layer patch features, ``encode_image``,
  ``splice``, ``prefill`` (last logits and the KV cache) and ``decode_one``
  for the LLaMA decoder (also with grouped key/value heads) and the MPT
  decoder (ALiBi with 2 and 3 heads; learned positions with ``clip_qkv``,
  ``qk_ln``, multi-query heads, biases and ``logit_scale``);
- incremental decoding equals one full prefill of the same sequence, on the
  port alone (JAX ``tests/test_llava.py:47``) and against JAX's full pass;
- ``top_p_filter`` against a numpy copy of JAX ``sample_top_p``'s filter,
  and JAX's own draws land in its support; the port's draws too;
- the slice: ``caption()`` at temperature 0 with a fake tokenizer gives the
  same tokens and text in JAX and the port, as is and with the int8
  weights (a lower size threshold, since tiny weights are under the
  default's 16,384 values);
- ``MPTConfig.from_dict``, the ALiBi slopes and the config rule of the
  loader.

Tolerance: 1e-4 absolute (float32 rounding of the same products in another
order; logits are O(1)); greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.models.llava.clip_vision import CLIPVisionConfig as JVisionConfig
from upscale_a_video_tpu.models.llava.conversation import build_caption_prompt, preprocess_image
from upscale_a_video_tpu.models.llava.llama import LlamaConfig as JLlamaConfig
from upscale_a_video_tpu.models.llava.llava import LlavaCaptioner as JCaptioner
from upscale_a_video_tpu.models.llava.llava import LlavaConfig as JLlavaConfig
from upscale_a_video_tpu.models.llava.llava import LlavaModel as JLlavaModel
from upscale_a_video_tpu.models.llava.mpt import MPTConfig as JMPTConfig
from upscale_a_video_tpu.models.llava.mpt import alibi_slopes as j_alibi_slopes
from upscale_a_video_tpu.utils.quant import QuantizedTensor as JQuantized
from upscale_a_video_tpu.utils.quant import quantize_tree
from upscale_a_video_tpu_torch.models.llava import LlavaCaptioner, LlavaConfig, LlavaModel
from upscale_a_video_tpu_torch.models.llava.clip_vision import CLIPVisionConfig
from upscale_a_video_tpu_torch.models.llava.llama import LlamaConfig, decode_step_mask
from upscale_a_video_tpu_torch.models.llava.llava import sample_top_p, top_p_filter
from upscale_a_video_tpu_torch.models.llava.loader import llava_config
from upscale_a_video_tpu_torch.models.llava.mpt import MPTConfig, alibi_slopes
from upscale_a_video_tpu_torch.utils.quant import QuantizedLinear, quantize_module_
from upscale_a_video_tpu_torch.weights import flatten_tree, llava_state_dict

torch.set_num_threads(1)

ATOL = 1e-4
VISION = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=3, num_attention_heads=2,
              image_size=28, patch_size=14)
LLAMA = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=64)
MPT = dict(vocab_size=64, d_model=24, n_layers=2, n_heads=2, max_seq_len=64)
DECODERS = {
    "llama": dict(text=LLAMA),
    "llama-gqa": dict(text=dict(LLAMA, num_attention_heads=4, num_key_value_heads=2)),
    "mpt-alibi": dict(mpt=MPT),
    "mpt-alibi-3-heads": dict(mpt=dict(MPT, n_heads=3)),
    "mpt-options": dict(mpt=dict(MPT, alibi=False, clip_qkv=0.5, qk_ln=True, multiquery=True,
                                 no_bias=False, logit_scale=0.7)),
}
IMAGE_POS = 2


class FakeTok:
    """``tests/test_captioner.py``'s tokenizer, with a decode that shows the
    ids it gets."""

    def __call__(self, text, add_special_tokens=True):
        ids = [1] if add_special_tokens else []
        ids += [10 + (ord(c) % 50) for c in text[:20]]
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def configs(spec):
    """The same tiny config on both sides."""
    if "mpt" in spec:
        return (JLlavaConfig(vision=JVisionConfig(**VISION), text_mpt=JMPTConfig(**spec["mpt"])),
                LlavaConfig(vision=CLIPVisionConfig(**VISION), text_mpt=MPTConfig(**spec["mpt"])))
    return (JLlavaConfig(vision=JVisionConfig(**VISION), text=JLlamaConfig(**spec["text"])),
            LlavaConfig(vision=CLIPVisionConfig(**VISION), text=LlamaConfig(**spec["text"])))


def build(spec, seed=0):
    """(JAX model, its params, port model with the same weights)."""
    jcfg, tcfg = configs(spec)
    jm = JLlavaModel(jcfg, dtype=jnp.float32)

    def full(mdl, pixels, ids):
        return mdl.prefill(mdl.splice(ids, mdl.encode_image(pixels), IMAGE_POS), 16)

    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 3)),
                     jnp.zeros((1, 5), jnp.int32), method=full)["params"]
    rng = np.random.default_rng(seed + 1)
    flat = {k: np.asarray(v) + (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    tm = LlavaModel(tcfg).eval()
    tm.load_state_dict(llava_state_dict(flat, mpt="mpt" in spec), strict=True)
    return jm, {"params": tree}, tm


def inputs(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 28, 28, 3)).astype(np.float32),
            np.asarray([[1, 5, 0, 9, 3]], np.int32))


@pytest.fixture(scope="module", params=list(DECODERS))
def models(request):
    return (request.param,) + build(DECODERS[request.param])


def test_vision_projector_splice_prefill_and_decode_match_jax(models):
    _, jm, params, tm = models
    pixels, ids = inputs()
    j_feats = jm.apply(params, pixels, method=lambda m, x: m.vision_tower(x))
    j_img = jm.apply(params, pixels, method=jm.encode_image)
    j_emb = jm.apply(params, ids, j_img, IMAGE_POS, method=jm.splice)
    j_logits, j_kv = jm.apply(params, j_emb, 12, method=jm.prefill)
    j_next, _ = jm.apply(params, jnp.asarray([7], jnp.int32), j_kv, 8, method=jm.decode_one)
    with torch.no_grad():
        feats = tm.vision(torch.from_numpy(pixels))
        img = tm.encode_image(torch.from_numpy(pixels))
        emb = tm.splice(torch.from_numpy(ids), img, IMAGE_POS)
        logits, kv = tm.prefill(emb, 12)
        prefilled = kv.clone()  # decode_one writes the cache in place
        nxt, _ = tm.decode_one(torch.tensor([7]), kv, 8)
    assert feats.shape == (1, 4, 16) and emb.shape == (1, 8, tm.llava_config.lm_hidden)
    for got, want in ((feats, j_feats), (img, j_img), (emb, j_emb), (logits, j_logits),
                      (prefilled, j_kv), (nxt, j_next)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_incremental_decode_equals_one_prefill(models):
    """Prefill 3 of 8 embeddings, then decode the other 5 one at a time: the
    last logits equal one prefill of all 8, in the port and in JAX."""
    _, jm, params, tm = models
    c = tm.llava_config.lm_hidden
    embeds = np.random.default_rng(3).standard_normal((1, 8, c)).astype(np.float32)
    j_full, _ = jm.apply(params, jnp.asarray(embeds), 12, method=jm.prefill)
    with torch.no_grad():
        full, _ = tm.prefill(torch.from_numpy(embeds), 12)
        last, kv = tm.prefill(torch.from_numpy(embeds[:, :3]), 12)
        for i in range(3, 8):  # decode_one from embeddings: the LM's forward at one position
            logits, kv = tm(torch.from_numpy(embeds[:, i:i + 1]), torch.tensor([i]), kv, i,
                            decode_step_mask(i, 12))
            last = logits[:, -1]
    np.testing.assert_allclose(last.numpy(), full.numpy(), atol=ATOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=ATOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["float-weights", "int8-weights"])
def test_greedy_caption_gives_the_same_tokens_as_jax(quantized):
    """The slice: preprocessing, the vicuna prompt, prefill and 8 greedy
    decode steps, EOS cut, decode; int8 weights quantized the same way on
    both sides (per output channel; every matmul weight of 256 values or
    more, no embeddings or norms)."""
    jm, params, tm = build(DECODERS["llama"], seed=4)
    skip = ("embed", "norm", "position", "relative_attention_bias", "logit")
    pred = lambda name, w: (getattr(w, "ndim", 0) >= 2 and np.size(w) >= 256
                            and not any(s in name.lower() for s in skip))
    if quantized:
        params = {"params": quantize_tree(params["params"], should_quantize=pred)}
        quantize_module_(tm, should_quantize=lambda name, w: pred(name, w.detach().numpy()))
        n_jax = sum(isinstance(leaf, JQuantized) for leaf in jax.tree_util.tree_leaves(
            params, is_leaf=lambda x: isinstance(x, JQuantized)))
        assert sum(isinstance(m, QuantizedLinear) for m in tm.modules()) == n_jax == 2 * 6 + 2 * 7 + 3
    image = np.random.default_rng(5).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    j_cap = JCaptioner(jm, params, tokenizer=FakeTok(), max_new_tokens=8, temperature=0.0,
                       eos_token_id=63, quantized=quantized)
    t_cap = LlavaCaptioner(tm, tokenizer=FakeTok(), max_new_tokens=8, temperature=0.0,
                           eos_token_id=63)
    ids, pos = build_caption_prompt(FakeTok())
    pixels = preprocess_image(image, 28)
    want = j_cap.generate_tokens(ids[None], pixels[None], pos)
    got = t_cap.generate_tokens(ids[None], pixels[None], pos)
    np.testing.assert_array_equal(got, want)
    assert t_cap.caption(image) == j_cap.caption(image) != ""


def jax_filter(logits, temperature, top_p):
    """A numpy copy of JAX ``sample_top_p``'s filter (``llava.py:118-128``),
    in sorted order, with the order."""
    x = logits.astype(np.float64) / max(temperature, 1e-5)
    probs = np.exp(x - x.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1, kind="stable")
    sp = np.take_along_axis(probs, order, -1)
    keep = np.cumsum(sp, -1) - sp < top_p
    filtered = np.where(keep, sp, 0.0)
    return filtered / filtered.sum(-1, keepdims=True), order


@pytest.mark.parametrize("temperature,top_p", [(0.2, 0.7), (1.0, 0.5), (1.0, 0.95)])
def test_top_p_filter_matches_jax(temperature, top_p):
    from upscale_a_video_tpu.models.llava.llava import sample_top_p as j_sample_top_p

    logits = np.random.default_rng(6).standard_normal((3, 40)).astype(np.float32) * 3
    want_sorted, order = jax_filter(logits, temperature, top_p)
    want = np.zeros_like(want_sorted)
    np.put_along_axis(want, order, want_sorted, -1)
    got = top_p_filter(torch.from_numpy(logits), temperature, top_p).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    support = got > 0
    for seed in range(10):
        j_tok = np.asarray(j_sample_top_p(jax.random.PRNGKey(seed), jnp.asarray(logits),
                                          temperature, top_p))
        t_tok = sample_top_p(torch.from_numpy(logits), temperature, top_p,
                             torch.Generator().manual_seed(seed)).numpy()
        assert support[np.arange(3), j_tok].all() and support[np.arange(3), t_tok].all()


def test_mpt_config_alibi_and_the_loader_rule():
    from upscale_a_video_tpu.models.llava.mpt import alibi_key_bias as j_key_bias
    from upscale_a_video_tpu_torch.models.llava.mpt import alibi_key_bias

    for n in (2, 3, 8, 12, 16):
        np.testing.assert_allclose(alibi_slopes(n, 8).numpy(), np.asarray(j_alibi_slopes(n, 8)),
                                   rtol=1e-7)
    np.testing.assert_allclose(alibi_key_bias(12, 9, 8).numpy(),
                               np.asarray(j_key_bias(12, 9, 8)), rtol=1e-6)
    hf = {"model_type": "llava_mpt", "d_model": 64, "n_layers": 3, "n_heads": 4,
          "logit_scale": "inv_sqrt_d_model", "vocab_size": 100,
          "attn_config": {"attn_type": "multiquery_attention", "alibi": False, "clip_qkv": 8,
                          "qk_ln": True}}
    want = JMPTConfig.from_dict(hf)
    got = MPTConfig.from_dict(hf)
    assert dataclasses_equal(got, want)
    assert llava_config(hf).text_mpt == got
    llama = {"model_type": "llava", "hidden_size": 32, "num_hidden_layers": 2,
             "vision_config": {"hidden_size": 8, "image_size": 56}}
    cfg = llava_config(llama)
    assert cfg.text_mpt is None and cfg.text.hidden_size == 32 and cfg.vision.image_size == 56
    with pytest.raises(ValueError, match="logit_scale"):
        MPTConfig.from_dict({"logit_scale": "other"})


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_llava_mpt_table_maps_the_vision_attention_to_checkpoint_keys():
    """The LLaVA-MPT key table (a copy of the JAX one) maps the vision
    tower's attention projections to the checkpoint's ``self_attn.q_proj``;
    the JAX table maps them to ``self_attn_q_proj``, which no checkpoint has
    (ROADMAP C3), so its loader keeps those weights at their zero init."""
    from upscale_a_video_tpu.models.llava.convert import LLAVA_MPT_RENAMES as J_RENAMES
    from upscale_a_video_tpu.utils.convert import flax_path_to_torch_key
    from upscale_a_video_tpu_torch.weights import torch_key
    from upscale_a_video_tpu_torch.models.llava.convert import LLAVA_MPT_RENAMES

    path = ("vision_tower", "layers_0", "self_attn_q_proj", "kernel")
    want = "transformer.vision_tower.vision_tower.vision_model.encoder.layers.0.self_attn.q_proj.weight"
    assert torch_key(path, LLAVA_MPT_RENAMES) == want
    assert flax_path_to_torch_key(path, J_RENAMES) == want.replace("self_attn.q", "self_attn_q")
    _, tm = configs(DECODERS["mpt-alibi"])
    assert want in LlavaModel(tm).state_dict()
