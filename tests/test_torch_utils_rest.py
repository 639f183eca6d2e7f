"""The port's last utilities against the JAX package's on the CPU
(ROADMAP A8): ``utils/profiling.py`` (``StageTimer``'s summary character
for character on the same stage times, no card sync on the CPU, a trace
written to a directory), ``utils/flops.py`` (``FlopCounterMode`` against
``attention_flops`` and hand counts of a conv and a linear; ``count_params``
and ``format_count`` against JAX's), ``utils/textual_inversion.py`` (token
ids, the grown table and the text encoder's output against JAX's on a
synthetic checkpoint of each schema; the JAX side maps placeholders through
an HF-style added-token tokenizer over its own BPE, as its loader's
``HFTokenizerAdapter`` does) and ``utils/stream.py::ClipStreamer`` (the
same clips in the same order as JAX's, a failing clip reported and
skipped). Tolerances: the summaries and ids exactly; the embedding rows
bit-equal; the text encoder 5e-5 (float32, as ``test_torch_models.py``)."""

import re
import time
import types

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_bundle import write_tokenizer
from upscale_a_video_tpu.models.clip_text import CLIPTextConfig as JClipConfig
from upscale_a_video_tpu.models.clip_text import CLIPTextModel as JClip
from upscale_a_video_tpu.utils import clip_bpe as j_bpe
from upscale_a_video_tpu.utils import flops as jflops
from upscale_a_video_tpu.utils import profiling as jprof
from upscale_a_video_tpu.utils import stream as jstream
from upscale_a_video_tpu.utils import textual_inversion as jti
from upscale_a_video_tpu_torch.models import CLIPTextConfig, CLIPTextModel
from upscale_a_video_tpu_torch.ops.attention import attention_plain
from upscale_a_video_tpu_torch.pipeline.pipeline import PipelineModules, VideoUpscalePipeline
from upscale_a_video_tpu_torch.utils import clip_bpe, flops, profiling
from upscale_a_video_tpu_torch.utils import stream
from upscale_a_video_tpu_torch.utils import textual_inversion as ti
from upscale_a_video_tpu_torch.weights import CLIP_RENAMES, flatten_tree, to_state_dict

torch.set_num_threads(1)


# ----------------------------------------------------------------- profiling

def fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("stages", [[("encode", 0.25), ("denoise", 7.5), ("decode", 1.125),
                                     ("denoise", 2.5)],
                                    [("one", 0.0)], []])
def test_stage_timer_summary_matches_jax(monkeypatch, stages):
    """Both timers on the same perf_counter readings (a stage named twice
    adds up); the port's on the CPU must not synchronise the card."""
    def fail(*args):
        raise AssertionError("StageTimer synchronised the card on the CPU")
    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    ticks = [x for i, (_, s) in enumerate(stages) for x in (10.0 * i, 10.0 * i + s)]
    summaries = []
    for timer in (jprof.StageTimer(), profiling.StageTimer("cpu")):
        fake_clock(monkeypatch, ticks)
        for name, _ in stages:
            with timer.stage(name):
                pass
        summaries.append(timer.summary())
    assert summaries[1] == summaries[0]
    if stages:
        assert summaries[1].splitlines()[1].startswith(stages[0][0])


def test_stage_timer_syncs_a_cuda_device(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    timer = profiling.StageTimer("cuda")
    with timer.stage("x"):
        pass
    assert calls == [torch.device("cuda")] * 2 and "x" in timer.stages


def test_trace_writes_into_the_directory(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("uav_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "uav_span" in files[0].read_text()
    assert any(e.key == "uav_span" for e in prof.key_averages())
    assert profiling.device_seconds(prof) == {}  # nothing ran on a card


# --------------------------------------------------------------------- flops

@pytest.mark.parametrize("b,h,s,d", [(2, 4, 16, 8), (1, 1, 33, 64)])
def test_flop_counter_matches_attention_flops(b, h, s, d):
    """FlopCounterMode counts 2 FLOPs a multiply-add; attention_flops counts
    multiply-adds (the reference hook's model), over C = heads x width."""
    q, k, v = (torch.randn(b, h, s, d) for _ in range(3))
    got = flops.flops_of(attention_plain, q, k, v, d ** -0.5)
    assert got == 2 * flops.attention_flops(b, s, h * d) == 2 * jflops.attention_flops(b, s, h * d)


def test_flop_counter_matches_hand_counts():
    x = torch.randn(2, 3, 9, 7)
    w = torch.randn(5, 3, 3, 3)
    rec = flops.cost_analysis(F.conv2d, x, w, padding=1)
    assert rec["flops"] == 2 * (2 * 9 * 7) * 5 * 3 * 9
    assert set(rec["by_operator"]) == {"aten.convolution"}
    lin = flops.cost_analysis(F.linear, torch.randn(4, 6, 12), torch.randn(10, 12),
                              torch.randn(10))
    assert lin["flops"] == 2 * 4 * 6 * 10 * 12
    assert flops.flops_of(torch.relu, x) is None  # nothing it counts


def test_count_params_and_format_match_jax():
    cfg = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
               num_attention_heads=2)
    ids = np.zeros((1, 7), np.int32)
    jparams = JClip(JClipConfig(**cfg)).init(jax.random.PRNGKey(0), ids)["params"]
    tm = CLIPTextModel(CLIPTextConfig(**cfg))
    want = jflops.count_params(jparams)
    assert flops.count_params(tm) == flops.count_params(tm.state_dict()) == want
    assert flops.count_params({"a": {"b": np.zeros((3, 4))}, "c": [torch.zeros(5)]}) == 17
    for n in (0, 999, 1234, 5.6e6, 7.89e9, 1.5e12, -2e6):
        assert flops.format_count(n) == jflops.format_count(n)


# ----------------------------------------------------------- textual inversion

DIM = 16
CLIP = dict(hidden_size=DIM, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2)


class HFStyleTokenizer:
    """The JAX side's tokenizer with placeholders: HF's ``add_tokens``
    (ids from ``len(tokenizer)``) over the JAX package's BPE, and a call
    that splits at the added tokens as HF's tokenizer does (the JAX
    loader's ``HFTokenizerAdapter`` wraps such a tokenizer as ``tok``)."""

    def __init__(self, bpe):
        self.bpe, self.tok = bpe, self
        self.added = {}

    def add_tokens(self, toks):
        for t in toks:
            self.added.setdefault(t, len(self.bpe.encoder) + len(self.added))

    def convert_tokens_to_ids(self, t):
        return self.added[t]

    def __call__(self, prompts):
        n = self.bpe.context_length
        out = np.full((len(prompts), n), self.bpe.eot_id, np.int32)
        out[:, 0] = self.bpe.sot_id
        pattern = "|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True))
        for i, p in enumerate(prompts):
            ids = []
            for piece in re.split(f"({pattern})", p) if pattern else [p]:
                ids += [self.added[piece]] if piece in self.added else self.bpe.encode(piece)
            ids = ids[:n - 2]
            out[i, 1:1 + len(ids)] = ids
        return out


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokenizer")
    write_tokenizer(d)
    return str(d)


def pipelines(tokenizer_dir):
    """(JAX stand-in, port pipeline) sharing one CLIP text model's weights;
    ``load_textual_inversion`` reads only the text encoder, its params and
    the tokenizer of either."""
    jtok = j_bpe.load_clip_tokenizer(tokenizer_dir)
    vocab = len(jtok.encoder)
    jm = JClip(JClipConfig(vocab_size=vocab, **CLIP))
    params = jm.init(jax.random.PRNGKey(3), np.zeros((1, 77), np.int32))
    rng = np.random.default_rng(5)
    flat = {k: np.asarray(v) + rng.standard_normal(np.shape(v)).astype(np.float32) * 0.1
            for k, v in flatten_tree(jax.tree.map(np.asarray, params["params"])).items()}
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = jax.numpy.asarray(v)
    jpipe = types.SimpleNamespace(m=types.SimpleNamespace(
        text_params={"params": tree}, text_encoder=jm, tokenizer=HFStyleTokenizer(jtok)))
    tm = CLIPTextModel(CLIPTextConfig(vocab_size=vocab, **CLIP)).eval()
    tm.load_state_dict(to_state_dict(flat, CLIP_RENAMES), strict=True)
    tpipe = VideoUpscalePipeline(PipelineModules(
        unet=None, vae=None, text_encoder=tm, tokenizer=clip_bpe.load_clip_tokenizer(
            tokenizer_dir), scheduler=None, low_res_scheduler=None), device="cpu")
    return jpipe, tpipe


def checkpoint(schema):
    rng = np.random.default_rng(11)
    cat, style = (rng.standard_normal((n, DIM)).astype(np.float32) for n in (1, 3))
    if schema == "diffusers":
        return {"<cat>": torch.from_numpy(cat[0]), "<my_style>": torch.from_numpy(style)}
    return {"string_to_param": {"*": torch.from_numpy(style)}, "name": "<my_style>", "step": 500}


@pytest.mark.parametrize("schema", ["diffusers", "a1111"])
def test_textual_inversion_matches_jax(tokenizer_dir, schema):
    jpipe, tpipe = pipelines(tokenizer_dir)
    vocab = tpipe.m.text_encoder.config.vocab_size
    state = checkpoint(schema)
    names = ti.load_textual_inversion(tpipe, state)
    assert names == jti.load_textual_inversion(jpipe, state)
    assert names[-3:] == ["<my_style>", "<my_style>_1", "<my_style>_2"]
    assert tpipe.m.text_encoder.config.vocab_size == vocab + len(names)

    jtable = np.asarray(jpipe.m.text_params["params"]["token_embedding"]["embedding"])
    ttable = tpipe.m.text_encoder.embeddings.token_embedding.weight.detach().numpy()
    np.testing.assert_array_equal(ttable, jtable)
    assert ttable.shape == (vocab + len(names), DIM)

    prompts = ["a <my_style> photo of the door", "the cat<my_style>and dog", "plain text"]
    if schema == "diffusers":
        prompts.append("<cat> in <my_style>")
    ids = tpipe.m.tokenizer(prompts)
    np.testing.assert_array_equal(ids, jpipe.m.tokenizer(prompts))
    assert tpipe.m.tokenizer.tokens["<my_style>_2"] in ids[0]
    want = np.asarray(jpipe.m.text_encoder.apply(jpipe.m.text_params, ids))
    got = tpipe.encode_prompt(prompts, None, False).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    without = tpipe.encode_prompt(["a  photo of the door"], None, False).numpy()
    assert not np.allclose(got[0], without[0])


def test_textual_inversion_drops_what_the_old_table_made(tokenizer_dir):
    """A held loop graph and cached kernel operands were made with the old
    table: both go."""
    _, tpipe = pipelines(tokenizer_dir)
    tpipe.graphs.key, tpipe.graphs.seen = ("held",), {("eager",): 1}
    weight = tpipe.m.text_encoder.encoder.layers[0].mlp.fc1.weight
    weight.__dict__["_uav_cached"] = {"operand": ((0, 0), None)}
    ti.load_textual_inversion(tpipe, {"<c>": np.ones(DIM, np.float32)})
    assert tpipe.graphs.key is None and not tpipe.graphs.seen
    assert "_uav_cached" not in weight.__dict__


def test_textual_inversion_errors(tokenizer_dir):
    _, tpipe = pipelines(tokenizer_dir)
    with pytest.raises(ValueError, match="dim"):
        ti.load_textual_inversion(tpipe, {"<c>": np.ones(DIM + 1, np.float32)})
    with pytest.raises(ValueError, match="no embeddings"):
        ti.parse_textual_inversion({"name": "x", "step": 3})
    fixed = ti.TextualInversionTokenizer(lambda prompts: np.zeros((len(prompts), 77)), 10)
    fixed.add_token("<c>")
    with pytest.raises(ValueError, match="placeholders require"):
        fixed(["a <c>"])
    assert fixed(["no placeholder"]).shape == (1, 77)


# ------------------------------------------------------------- clip streamer

CLIPS = {"a.mp4": [(5, 8)], "bad.mp4": "fail", "b.mp4": [(3, 8), (2, 8)], "c.mp4": [(4, 8)]}


def reader(path):
    spec = CLIPS[path]
    if spec == "fail":
        raise OSError("cannot decode")
    seed = sorted(CLIPS).index(path)
    for i, (t, hw) in enumerate(spec):
        yield np.random.default_rng(10 * seed + i).integers(0, 256, (t, hw, hw, 3), np.uint8)


@pytest.mark.parametrize("normalize", [True, False])
def test_clip_streamer_matches_jax(capsys, normalize):
    got = [(p, i, c) for p, i, c in stream.ClipStreamer(list(CLIPS), (8, 8, 3), slots=2,
                                                         reader=reader, normalize=normalize)]
    port_out = capsys.readouterr().out
    want = list(jstream.ClipStreamer(list(CLIPS), (8, 8, 3), slots=2, reader=reader,
                                     normalize=normalize))
    assert port_out == capsys.readouterr().out == "stream: skipping bad.mp4: cannot decode\n"
    assert [(p, i, c.shape, c.dtype) for p, i, c in got] == \
        [(p, i, c.shape, c.dtype) for p, i, c in want]
    assert [p for p, _, _ in got] == ["a.mp4", "b.mp4", "b.mp4", "c.mp4"]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_clip_streamer_skips_a_clip_of_another_frame_size(capsys):
    def sizes(path):
        hw = {"x": 8, "y": 6, "z": 8}[path]
        yield np.zeros((2, hw, hw, 3), np.uint8)
    got = [p for p, _, _ in stream.ClipStreamer(["x", "y", "z"], (8, 8, 3), reader=sizes)]
    assert got == ["x", "z"]
    assert "skipping y" in capsys.readouterr().out
