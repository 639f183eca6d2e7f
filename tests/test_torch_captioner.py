"""The port's captioner plumbing against the JAX package on the CPU.

- ``_resize_short_side`` and ``preprocess_image`` against JAX's (the same
  bicubic matrices: within 1 of 255 after the uint8 truncation, and 1e-5 on
  normalised pixels), the vicuna prompt exactly;
- ``build_captioner``'s backends in the JAX order, a local model that fails
  to load falling through to the next, and the endpoint's request (a PNG
  of the resized frame and the question) through a server on localhost;
- ``load_llava_captioner`` on tiny checkpoint directories in the released
  layout written from JAX parameters (``config.json`` and
  ``pytorch_model.bin``, or two ``.safetensors`` shards): LLaMA and MPT,
  the delta over a base checkpoint, ``load_8bit``; the prefill logits
  against JAX's within 1e-4 (float32; the int8 model against the int8 JAX
  tree).
"""

import http.server
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_llava import DECODERS, IMAGE_POS, VISION, FakeTok, build, inputs
from upscale_a_video_tpu import captioner as j_captioner
from upscale_a_video_tpu.models.llava import conversation as j_conversation
from upscale_a_video_tpu.utils.quant import QuantizedTensor, dequantize_tree, quantize_tree
from upscale_a_video_tpu.utils.quant import tree_nbytes
from upscale_a_video_tpu_torch import captioner
from upscale_a_video_tpu_torch.models.llava import conversation
from upscale_a_video_tpu_torch.models.llava.loader import load_llava_captioner
from upscale_a_video_tpu_torch.utils.quant import QuantizedLinear, module_nbytes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No hub access from the tokenizer lookup, no proxy between the
    endpoint test and its server on localhost, and no backend from the
    environment unless a test sets one."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    for var in ("http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY",
                "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    for var in ("UAV_CAPTION_TORCH_MODEL", "UAV_CAPTION_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)


def test_preprocessing_and_prompt_match_jax():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)
    got = captioner._resize_short_side(frame, 64)
    want = j_captioner._resize_short_side(frame, 64)
    assert got.shape == want.shape == (64, 114, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_allclose(conversation.preprocess_image(frame, 56),
                               j_conversation.preprocess_image(frame, 56), atol=1e-5)
    ids, pos = conversation.build_caption_prompt(FakeTok())
    want_ids, want_pos = j_conversation.build_caption_prompt(FakeTok())
    np.testing.assert_array_equal(ids, want_ids)
    assert pos == want_pos and captioner.CAPTION_QUESTION == j_conversation.QUESTION


def write_checkpoint(root, spec, state, safetensors=False):
    """``config.json`` in the HF layout of ``spec`` and the state dict."""
    root.mkdir(parents=True, exist_ok=True)
    if "mpt" in spec:
        m = dict(spec["mpt"])
        attn = {k: m.pop(k) for k in ("alibi", "clip_qkv", "qk_ln") if k in m}
        if m.pop("multiquery", False):
            attn["attn_type"] = "multiquery_attention"
        cfg = dict(m, model_type="llava_mpt", attn_config=attn)
    else:
        cfg = dict(spec["text"], model_type="llava")
    cfg["vision_config"] = VISION
    (root / "config.json").write_text(json.dumps(cfg))
    if safetensors:
        from safetensors.torch import save_file

        keys = sorted(state)
        for i, part in enumerate((keys[::2], keys[1::2])):
            save_file({k: state[k].contiguous() for k in part}, str(root / f"model-{i}.safetensors"))
    else:
        torch.save(state, root / "pytorch_model.bin")


def jax_prefill_logits(jm, params):
    pixels, ids = inputs()
    img = jm.apply(params, pixels, method=jm.encode_image)
    emb = jm.apply(params, ids, img, IMAGE_POS, method=jm.splice)
    return np.asarray(jm.apply(params, emb, 12, method=jm.prefill)[0])


def port_prefill_logits(cap):
    pixels, ids = inputs()
    m = cap.model
    with torch.no_grad():
        emb = m.splice(torch.from_numpy(ids), m.encode_image(torch.from_numpy(pixels)), IMAGE_POS)
        return m.prefill(emb, 12)[0].numpy()


@pytest.mark.parametrize("decoder,safetensors", [("llama", False), ("mpt-options", True)])
def test_load_llava_captioner_matches_jax(tmp_path, decoder, safetensors):
    spec = DECODERS[decoder]
    jm, params, tm = build(spec, seed=7)
    write_checkpoint(tmp_path / "ckpt", spec, tm.state_dict(), safetensors)
    cap = load_llava_captioner(str(tmp_path / "ckpt"), dtype=torch.float32, max_new_tokens=5,
                               device="cpu")
    assert cap.tokenizer is None and cap.max_new_tokens == 5  # no tokenizer files here
    assert type(cap.model) is type(tm)
    np.testing.assert_allclose(port_prefill_logits(cap), jax_prefill_logits(jm, params),
                               atol=1e-4)


def test_load_llava_captioner_delta_and_int8(tmp_path):
    spec = DECODERS["llama"]
    jm, params, tm = build(spec, seed=8)
    full = tm.state_dict()
    base, delta = {}, {}
    rng = torch.Generator().manual_seed(9)
    for k, v in full.items():  # the base vocabulary: 60 of 64 rows
        b = torch.randn(v.shape, generator=rng)
        if k in ("model.embed_tokens.weight", "lm_head.weight"):
            b = b[:60]
        base[k] = b
        delta[k] = v.clone()
        delta[k][: b.shape[0]] -= b
    write_checkpoint(tmp_path / "base", spec, base)
    write_checkpoint(tmp_path / "delta", spec, delta)
    cap = load_llava_captioner(str(tmp_path / "delta"), base_dir=str(tmp_path / "base"),
                               dtype=torch.float32, device="cpu")
    want = jax_prefill_logits(jm, params)
    np.testing.assert_allclose(port_prefill_logits(cap), want, atol=1e-4)

    # int8: a decoder of hidden 128, whose products pass the 16,384-value threshold
    spec = dict(text=dict(spec["text"], hidden_size=128, intermediate_size=256, vocab_size=200,
                          num_attention_heads=4))
    jm, params, tm = build(spec, seed=10)
    write_checkpoint(tmp_path / "full", spec, tm.state_dict())
    q = load_llava_captioner(str(tmp_path / "full"), dtype=torch.float32, load_8bit=True,
                             device="cpu")
    jq = quantize_tree(params["params"])
    n_jax = sum(isinstance(x, QuantizedTensor) for x in jax.tree_util.tree_leaves(
        jq, is_leaf=lambda x: isinstance(x, QuantizedTensor)))
    assert sum(isinstance(m, QuantizedLinear) for m in q.model.modules()) == n_jax > 0
    assert module_nbytes(q.model) == tree_nbytes(jq) < module_nbytes(tm)
    dq = {"params": dequantize_tree(jq, jnp.float32)}
    np.testing.assert_allclose(port_prefill_logits(q), jax_prefill_logits(jm, dq), atol=1e-4)


@pytest.mark.parametrize("part", ["model.vision_tower.vision_tower.vision_model.encoder.layers.0."
                                  "self_attn.q_proj.weight", "model.mm_projector.0.weight",
                                  "model.layers.1.mlp.up_proj.weight"])
def test_load_llava_captioner_refuses_a_missing_parameter(tmp_path, part):
    """A checkpoint that lacks a parameter of the vision tower, the
    projector or a decoder layer is refused (the JAX loader would keep it
    at zero); a key the model does not have is ignored."""
    spec = DECODERS["llama"]
    _, _, tm = build(spec, seed=11)
    state = tm.state_dict()
    assert part in state
    write_checkpoint(tmp_path / "ckpt", spec, {k: v for k, v in state.items() if k != part})
    with pytest.raises(KeyError, match=f"1 parameters missing .*{part}"):
        load_llava_captioner(str(tmp_path / "ckpt"), dtype=torch.float32, device="cpu")
    extra = dict(state, **{"model.vision_tower.vision_tower.vision_model.embeddings."
                           "position_ids": torch.arange(4)})
    write_checkpoint(tmp_path / "full", spec, extra)
    got = load_llava_captioner(str(tmp_path / "full"), dtype=torch.float32,
                               device="cpu").model.state_dict()
    assert got.keys() == state.keys() and all(torch.equal(got[k], v) for k, v in state.items())


class _Server(http.server.BaseHTTPRequestHandler):
    seen = []

    def do_POST(self):  # noqa: N802 (the handler's name)
        from PIL import Image

        body = self.rfile.read(int(self.headers["Content-Length"]))
        img = np.asarray(Image.open(io.BytesIO(body)))
        _Server.seen.append((self.headers["Content-Type"], self.headers["X-Question"],
                             img.shape))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b" a caption from the endpoint \n")

    def log_message(self, *args):
        pass


def test_build_captioner_backends(tmp_path, monkeypatch):
    assert captioner.build_captioner() is None  # no backend: the CLI's empty caption

    server = http.server.HTTPServer(("127.0.0.1", 0), _Server)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/caption"
        monkeypatch.setenv("UAV_CAPTION_ENDPOINT", url)
        # a local model that does not load falls through to the endpoint
        monkeypatch.setenv("UAV_CAPTION_TORCH_MODEL", str(tmp_path / "missing"))
        cap = captioner.build_captioner(device="cpu")
        assert isinstance(cap, captioner.EndpointCaptioner) and cap.url == url
        frame = np.random.default_rng(1).integers(0, 256, (64, 96, 3), dtype=np.uint8)
        assert cap(frame) == "a caption from the endpoint"
        assert _Server.seen == [("image/png", captioner.CAPTION_QUESTION, (512, 768, 3))]
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()

    spec = DECODERS["llama"]
    _, _, tm = build(spec, seed=3)
    write_checkpoint(tmp_path / "ckpt", spec, tm.state_dict())
    monkeypatch.setenv("UAV_CAPTION_TORCH_MODEL", str(tmp_path / "ckpt"))
    loaded = []
    from upscale_a_video_tpu_torch.models.llava import loader

    def spy(*args, **kwargs):
        loaded.append(kwargs)
        return loader_load(*args, **kwargs)

    loader_load = loader.load_llava_captioner
    monkeypatch.setattr(loader, "load_llava_captioner", spy)
    cap = captioner.build_captioner(load_8bit=True, device="cpu")
    assert callable(cap) and not isinstance(cap, captioner.EndpointCaptioner)
    assert loaded == [dict(load_8bit=True, device="cpu")]
