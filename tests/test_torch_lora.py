"""The port's LoRA (``training/lora.py``) and captioner finetune
(``training/train_llava.py``) against the JAX package's on the CPU, float32,
tiny LLaVA models (LLaMA and MPT decoders) whose JAX parameters reach the
port through ``weights.llava_state_dict``:

- the targeted Linear modules are JAX's ``DEFAULT_TARGETS`` paths through
  the key conversion (LLaMA's q/k/v/o and gate/up/down, the CLIP tower's
  out_proj, the projector; MPT's fused ``Wqkv``);
- the adapted model is the base model exactly at init (B = 0); with JAX's A
  and B carried across, the adapted logits match JAX's ``apply_lora``, and
  ``merge_lora`` gives the adapted logits with plain weights;
- a LoRA step leaves every base weight bit-unchanged and moves the adapters;
- ``splice_labels`` equals JAX's; one full step (vision frozen by
  ``frozen_vision_optimizer``, Adam) and two LoRA steps (Adam) match JAX's
  ``make_caption_train_step`` and ``make_caption_lora_step``: the loss and
  the trained parameters.

Tolerances: logits 1e-4 absolute (O(1) values, float32 in another order);
losses 1e-5 relative; parameters 5e-2 x lr (each first Adam step moves a
weight by about lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upscale_a_video_tpu.models.llava.clip_vision import CLIPVisionConfig as JVisionConfig
from upscale_a_video_tpu.models.llava.llama import LlamaConfig as JLlamaConfig
from upscale_a_video_tpu.models.llava.llama import causal_prefill_mask as j_mask
from upscale_a_video_tpu.models.llava.llava import LlavaConfig as JLlavaConfig
from upscale_a_video_tpu.models.llava.llava import LlavaModel as JLlavaModel
from upscale_a_video_tpu.models.llava.mpt import MPTConfig as JMPTConfig
from upscale_a_video_tpu.training import lora as jlora
from upscale_a_video_tpu.training import train_llava as jtl
from upscale_a_video_tpu_torch.models.llava import LlavaConfig, LlavaModel
from upscale_a_video_tpu_torch.models.llava.clip_vision import CLIPVisionConfig
from upscale_a_video_tpu_torch.models.llava.convert import LLAVA_MPT_RENAMES, LLAVA_RENAMES
from upscale_a_video_tpu_torch.models.llava.llama import LlamaConfig
from upscale_a_video_tpu_torch.models.llava.mpt import MPTConfig
from upscale_a_video_tpu_torch.training import lora, train_llava
from upscale_a_video_tpu_torch.training.train_llava import caption_logits
from upscale_a_video_tpu_torch.weights import flatten_tree, llava_state_dict, torch_key

torch.set_num_threads(1)

VISION = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
              image_size=28, patch_size=14)
LLAMA = dict(vocab_size=60, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=32)
MPT = dict(vocab_size=60, d_model=32, n_layers=1, n_heads=4, expansion_ratio=2, max_seq_len=32)
IMAGE_POS, N_PATCH, PROMPT_LEN = 2, 4, 4
ATOL = 1e-4
LOSS_RTOL = 1e-5


def build(mpt: bool, seed: int = 0):
    """(JAX model, its params tree, port model with the same weights, the
    flat JAX tree)."""
    if mpt:
        jcfg = JLlavaConfig(vision=JVisionConfig(**VISION), text_mpt=JMPTConfig(**MPT))
        tcfg = LlavaConfig(vision=CLIPVisionConfig(**VISION), text_mpt=MPTConfig(**MPT))
    else:
        jcfg = JLlavaConfig(vision=JVisionConfig(**VISION), text=JLlamaConfig(**LLAMA))
        tcfg = LlavaConfig(vision=CLIPVisionConfig(**VISION), text=LlamaConfig(**LLAMA))
    jm = JLlavaModel(jcfg, dtype=jnp.float32)

    def full(mdl, pixels, ids):
        return mdl.prefill(mdl.splice(ids, mdl.encode_image(pixels), IMAGE_POS), 16)

    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 3)),
                     jnp.zeros((1, 8), jnp.int32), method=full)["params"]
    rng = np.random.default_rng(seed + 1)
    flat = {k: np.asarray(v) + (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}
    tm = LlavaModel(tcfg)
    tm.load_state_dict(llava_state_dict(flat, mpt=mpt), strict=True)
    return jm, unflatten(flat), tm, flat


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def batch(seed=0, b=2, s=8):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 60, (b, s)).astype(np.int32)
    ids[:, IMAGE_POS] = 1
    return {"pixels": rng.rand(b, 28, 28, 3).astype(np.float32), "input_ids": ids,
            "labels": jtl.splice_labels(ids, IMAGE_POS, N_PATCH, PROMPT_LEN)}


def torch_batch(b):
    return {"pixels": torch.from_numpy(b["pixels"]),
            "input_ids": torch.from_numpy(b["input_ids"]).long(),
            "labels": torch.from_numpy(np.asarray(b["labels"]))}


def jax_logits(jm, tree, b):
    def run(mdl, pixels, ids):
        emb = mdl.splice(ids, mdl.encode_image(pixels), IMAGE_POS)
        s = emb.shape[1]
        return mdl.language_model(emb, jnp.arange(s), None, 0, j_mask(s, s))[0]

    return np.asarray(jm.apply({"params": tree}, b["pixels"], b["input_ids"], method=run))


def adapter_paths(jl, path=()):
    if isinstance(jl, dict) and set(jl) == {"a", "b"}:
        yield path, jl
    elif isinstance(jl, dict):
        for k, v in jl.items():
            yield from adapter_paths(v, path + (k,))


def module_name(path, mpt):
    key = torch_key(path, LLAVA_MPT_RENAMES if mpt else LLAVA_RENAMES)
    assert key.endswith(".weight"), key
    return key[:-len(".weight")]


def carried(jl, tm, mpt, rank):
    """The port's adapters with JAX's A and B."""
    out = lora.init_lora(tm, rank)
    for path, ab in adapter_paths(jl):
        name = module_name(path, mpt)
        out[name].a.data.copy_(torch.from_numpy(np.array(ab["a"])))
        out[name].b.data.copy_(torch.from_numpy(np.array(ab["b"])))
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["llama", "mpt"])
def llava(request):
    return (request.param,) + build(request.param)


def test_targets_match_jax(llava):
    mpt, jm, tree, tm, _ = llava
    jl = jlora.init_lora(tree, rank=4)
    want = {module_name(p, mpt) for p, _ in adapter_paths(jl)}
    got = lora.init_lora(tm, rank=4, generator=torch.Generator().manual_seed(0))
    assert set(got) == want
    assert lora.num_lora_params(got) == jlora.num_lora_params(jl)
    assert any(n.endswith("Wqkv" if mpt else "q_proj") for n in got)
    assert any("mm_projector" in n for n in got) and any("vision_tower" in n for n in got)
    assert not any("embed" in n or "lm_head" in n or "norm" in n for n in got)


def test_identity_at_init_and_stddev(llava):
    _, _, _, tm, _ = llava
    b = torch_batch(batch(1))
    with torch.no_grad():
        base = caption_logits(tm, b["pixels"], b["input_ids"], IMAGE_POS)
    adapters = lora.init_lora(tm, rank=4, generator=torch.Generator().manual_seed(1))
    a = torch.cat([ad.a.flatten() for ad in adapters.values()])
    assert abs(a.std().item() - 0.01) < 2e-3
    try:
        lora.apply_lora(tm, adapters)
        with torch.no_grad():
            adapted = caption_logits(tm, b["pixels"], b["input_ids"], IMAGE_POS)
    finally:
        lora.remove_lora(tm)
    assert torch.equal(base, adapted)


def test_apply_matches_jax_and_merge_equals_apply(llava):
    mpt, jm, tree, tm, flat = llava
    jl = jax.tree.map(lambda x: x + 0.01, jlora.init_lora(tree, rank=4, seed=3))
    b = batch(2)
    want = jax_logits(jm, jlora.apply_lora(tree, jl), b)
    tb = torch_batch(b)
    adapters = carried(jl, tm, mpt, 4)
    try:
        lora.apply_lora(tm, adapters)
        with torch.no_grad():
            got = caption_logits(tm, tb["pixels"], tb["input_ids"], IMAGE_POS)
    finally:
        lora.remove_lora(tm)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    merged = LlavaModel(tm.llava_config)
    merged.load_state_dict(tm.state_dict())
    lora.merge_lora(merged, carried(jl, merged, mpt, 4))
    assert set(merged.state_dict()) == set(tm.state_dict())
    with torch.no_grad():
        m = caption_logits(merged, tb["pixels"], tb["input_ids"], IMAGE_POS)
        base = caption_logits(tm, tb["pixels"], tb["input_ids"], IMAGE_POS)
    np.testing.assert_allclose(m.numpy(), got.numpy(), atol=1e-5)
    assert not torch.allclose(base, got, atol=1e-3)


def test_lora_step_freezes_the_base_and_moves_the_adapters(llava):
    mpt, _, _, tm, _ = llava
    model = LlavaModel(tm.llava_config)
    model.load_state_dict(tm.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    adapters = lora.init_lora(model, rank=4, generator=torch.Generator().manual_seed(2))
    a0 = {n: ad.a.detach().clone() for n, ad in adapters.items()}
    opt = torch.optim.Adam(list(lora.lora_parameters(adapters)), lr=1e-2)
    step = train_llava.make_caption_lora_step(model, opt, IMAGE_POS, adapters)
    losses = [step(torch_batch(batch(3))).item() for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    lora.remove_lora(model)
    after = model.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert all(not torch.equal(ad.a, a0[n]) and ad.b.abs().sum() > 0
               for n, ad in adapters.items())


def test_splice_labels_match_jax():
    ids = np.arange(10, 18, dtype=np.int32)[None].repeat(2, 0)
    ids[:, IMAGE_POS] = 1
    for prompt_len in (2, 4, 7):
        want = jtl.splice_labels(ids, IMAGE_POS, N_PATCH, prompt_len)
        got = train_llava.splice_labels(ids, IMAGE_POS, N_PATCH, prompt_len)
        np.testing.assert_array_equal(got, want)
    assert (got[:, :7 - 1 + N_PATCH] == train_llava.IGNORE_INDEX).all()


def test_vision_frozen_mask_matches_jax():
    jm, tree, tm, _ = build(False, seed=4)
    want = {torch_key(p, LLAVA_RENAMES): label
            for p, label in flatten_tree(jtl.vision_frozen_mask(tree)).items()}
    assert train_llava.vision_frozen_mask(tm) == want


def test_full_step_matches_jax():
    """One step with the vision tower frozen (Adam 5e-3): the loss and every
    parameter against JAX's make_caption_train_step."""
    lr = 5e-3
    jm, tree, tm, _ = build(False, seed=5)
    b = batch(4)
    opt = jtl.frozen_vision_optimizer(optax.adam(lr), tree)
    step = jax.jit(jtl.make_caption_train_step(jm, opt, IMAGE_POS))
    new, _, jloss = step(tree, opt.init(tree), {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(0))
    want = llava_state_dict(flatten_tree(jax.tree.map(np.asarray, new)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    topt = train_llava.frozen_vision_optimizer(tm, lambda ps: torch.optim.Adam(ps, lr=lr))
    loss = train_llava.make_caption_train_step(tm, topt, IMAGE_POS)(torch_batch(b))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for name, value in tm.state_dict().items():
        if "vision_tower" in name:
            assert torch.equal(value, before[name]), name
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=5e-2 * lr, rtol=0,
                                   err_msg=name)
    assert not torch.equal(tm.lm_head.weight, before["lm_head.weight"])


def test_lora_steps_match_jax():
    """Two LoRA steps (Adam 1e-2) from JAX's adapters: the losses and the
    adapters against JAX's make_caption_lora_step."""
    lr = 1e-2
    jm, tree, tm, _ = build(False, seed=6)
    jl = jlora.init_lora(tree, rank=4, seed=1)
    adapters = carried(jl, tm, False, 4)
    opt = optax.adam(lr)
    step = jax.jit(jtl.make_caption_lora_step(jm, opt, IMAGE_POS))
    tstep = train_llava.make_caption_lora_step(
        tm, torch.optim.Adam(list(lora.lora_parameters(adapters)), lr=lr), IMAGE_POS, adapters)
    state = opt.init(jl)
    for i in range(2):
        b = batch(10 + i)
        jl, state, jloss = step(tree, jl, state, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(i))
        loss = tstep(torch_batch(b))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        for path, ab in adapter_paths(jl):
            ad = adapters[module_name(path, False)]
            for part in ("a", "b"):
                np.testing.assert_allclose(getattr(ad, part).detach().numpy(),
                                           np.asarray(ab[part]), atol=5e-2 * lr, rtol=0,
                                           err_msg=f"step {i}: {path} {part}")
