"""Pyramid Attention Broadcast and the step modes of the port's pipeline
against the JAX pipeline on the CPU.

Both pipelines load the same tiny bundle (``tests/torch_bundle.py``, video
VAE, float32: its UNet has cross-only levels, a spatial self-attention
level and the mid block, so every attention kind is cached) and run 6 DDIM
steps, CFG 6, noise level 120, on identical numpy-seeded inputs, initial
latents and LR noise, with the same ``PABConfig`` (``kinds=("cross",)`` as
``bench.py:159`` runs it, and every kind), in both step modes; the JAX
pipeline in the same step mode gives the reference output and progress
ticks. With the default ranges (cross 6, spatial 2, temporal 4, from step 2)
6 steps broadcast the cross-attentions on steps 3-5, the spatial ones on 3
and 5 and the temporal ones on 3-5.

Tolerance: 1e-3 absolute on outputs in [-1, 1], as
``tests/test_torch_pipeline.py`` (float32 rounding of the same operations in
another order through the steps and the decode). Exactness checks (every
flag false against the exact route, ``"scan"`` against ``"host"``) are bit
for bit: the same operations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bundle import write_bundle
from upscale_a_video_tpu.pipeline.loader import load_pipeline as jax_load_pipeline
from upscale_a_video_tpu.pipeline.pipeline import PABConfig as JPABConfig
from upscale_a_video_tpu.pipeline.pipeline import VideoUpscalePipeline as JPipeline
from upscale_a_video_tpu_torch.models import UNetVideoModel
from upscale_a_video_tpu_torch.nn.attention import BasicTransformerBlock
from upscale_a_video_tpu_torch.pipeline import PABConfig, VideoUpscalePipeline, load_pipeline
from upscale_a_video_tpu_torch.pipeline.graphs import LoopGraphs, weights_stamp

torch.set_num_threads(1)

STEPS, FRAMES, H, W, ATOL = 6, 5, 8, 8, 1e-3
KINDS = {"cross": ("cross",), "all": ("spatial", "cross", "temporal")}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    write_bundle(root, video=True)
    rng = np.random.default_rng(5)
    inputs = (rng.uniform(-1, 1, (1, FRAMES, H, W, 3)).astype(np.float32),
              rng.standard_normal((1, FRAMES, H, W, 4)).astype(np.float32),
              rng.standard_normal((1, FRAMES, H, W, 3)).astype(np.float32))
    port = load_pipeline(str(root), use_video_vae=True, dtype=torch.float32, device="cpu")
    return root, inputs, port


def run_port(pipe, inputs, **kwargs):
    image, latents, lr_noise = inputs
    ticks = []
    out = pipe("a clip", torch.from_numpy(image), num_inference_steps=STEPS,
               latents=torch.from_numpy(latents), lr_noise=torch.from_numpy(lr_noise),
               progress_cb=lambda *tick: ticks.append(tick), **kwargs)
    return out, ticks


def attention_calls(unet):
    """Counts of the attention modules' calls by kind, through hooks: cross
    (attn2 and the cross-only attn1), spatial (attn1 of the other blocks),
    temporal. Returns the counts and the hook handles."""
    counts = {"cross": 0, "spatial": 0, "temporal": 0}
    handles = []
    for block in unet.modules():
        if isinstance(block, BasicTransformerBlock):
            kinds = [(block.attn1, "cross" if block.only_cross_attention else "spatial"),
                     (block.attn2, "cross"), (block.attn_temporal, "temporal")]
            for mod, kind in kinds:
                if mod is not None:
                    handles.append(mod.register_forward_hook(
                        lambda m, a, o, kind=kind: counts.__setitem__(kind, counts[kind] + 1)))
    return counts, handles


@pytest.mark.parametrize("step_mode", ["scan", "host"])
@pytest.mark.parametrize("kinds", ["cross", "all"])
def test_pab_matches_jax(bundle, kinds, step_mode):
    root, inputs, port = bundle
    image, latents, lr_noise = inputs
    jbase = jax_load_pipeline(str(root), use_video_vae=True, dtype=jnp.float32,
                              decode_dtype=jnp.float32)
    jpipe = JPipeline(jbase.m, dtype=jnp.float32, decode_dtype=jnp.float32,
                      pab=JPABConfig(kinds=KINDS[kinds]), step_mode=step_mode)
    want_ticks = []
    want = np.asarray(jpipe("a clip", jnp.asarray(image), num_inference_steps=STEPS,
                            latents=jnp.asarray(latents), lr_noise=jnp.asarray(lr_noise),
                            progress_cb=lambda *tick: want_ticks.append(tick)))

    pipe = VideoUpscalePipeline(port.m, device="cpu", pab=PABConfig(kinds=KINDS[kinds]),
                                step_mode=step_mode)
    counts, handles = attention_calls(port.m.unet)
    try:
        got, ticks = run_port(pipe, inputs)
    finally:
        for h in handles:
            h.remove()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert ticks == want_ticks
    denoise = [t for t in ticks if t[0] == "denoise"]
    assert denoise == ([("denoise", i + 1, STEPS) for i in range(STEPS)] if step_mode == "host"
                       else [("denoise", STEPS, STEPS)])
    # each kind's attention calls against the exact route's, per computed step
    per_call, handles = attention_calls(port.m.unet)
    try:
        run_port(VideoUpscalePipeline(port.m, device="cpu", step_mode=step_mode), inputs)
    finally:
        for h in handles:
            h.remove()
    computed = {"cross": 3, "spatial": 4, "temporal": 3}  # of the 6 steps
    for kind, n in counts.items():
        steps = computed[kind] if kind in KINDS[kinds] else STEPS
        assert n == per_call[kind] // STEPS * steps, (kind, n, per_call)


def test_pab_distance_to_the_exact_route_matches_jax(bundle, capsys):
    """PAB's distance to the exact route: with 30 steps, CFG 6 and
    ``kinds=("cross",)``, as ``chip_smoke.py`` runs path 1 under PAB, the
    port moves its output as far from its exact route as the JAX reference
    moves its own (relative L2; the two distances within 1 % of each other,
    the outputs agreeing with JAX to float32 rounding)."""
    root, inputs, port = bundle
    image, latents, lr_noise = inputs
    jbase = jax_load_pipeline(str(root), use_video_vae=True, dtype=jnp.float32,
                              decode_dtype=jnp.float32)
    dist = {}
    for name, jpab, pab in (("exact", None, None),
                            ("pab", JPABConfig(kinds=("cross",)), PABConfig(kinds=("cross",)))):
        jpipe = JPipeline(jbase.m, dtype=jnp.float32, decode_dtype=jnp.float32, pab=jpab)
        dist[name] = (np.asarray(jpipe("a clip", jnp.asarray(image), num_inference_steps=30,
                                       latents=jnp.asarray(latents),
                                       lr_noise=jnp.asarray(lr_noise))),
                      VideoUpscalePipeline(port.m, device="cpu", pab=pab)(
                          "a clip", torch.from_numpy(image), num_inference_steps=30,
                          latents=torch.from_numpy(latents),
                          lr_noise=torch.from_numpy(lr_noise)).numpy())
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    want, got = (rel(dist["pab"][i], dist["exact"][i]) for i in (0, 1))
    with capsys.disabled():
        print(f"\nPAB(kinds=('cross',)) against the exact route, 30 steps, CFG 6, relative L2: "
              f"JAX {want:.4e}, port {got:.4e}")
    assert want > 0 and abs(got - want) <= 1e-2 * want


def test_pab_changes_the_output_and_all_flags_false_is_exact(bundle):
    """Ranges of 1 make every flag false: the cached route (the deltas
    computed, then added) equals the exact route bit for bit. The default
    ranges broadcast, and move the output."""
    _, inputs, port = bundle
    exact, _ = run_port(VideoUpscalePipeline(port.m, device="cpu"), inputs)
    never = PABConfig(cross_range=1, spatial_range=1, temporal_range=1)
    assert not any(f.any() for f in never.use_cached_flags(STEPS).values())
    same, _ = run_port(VideoUpscalePipeline(port.m, device="cpu", pab=never), inputs)
    assert torch.equal(same, exact)
    broadcast, _ = run_port(VideoUpscalePipeline(port.m, device="cpu", pab=PABConfig()), inputs)
    assert (broadcast - exact).abs().max() > 1e-4


def test_pab_flags_and_collect_cache_match_jax(bundle):
    """``use_cached_flags`` and ``make_pab_collect_cache`` give what the JAX
    package gives, for several configs, skips and kinds."""
    root, _, port = bundle
    jbase = jax_load_pipeline(str(root), use_video_vae=True, dtype=jnp.float32,
                              decode_dtype=jnp.float32)
    for kw in ({}, dict(cross_range=3, start_step=0, end_step=7), dict(spatial_range=1)):
        want = JPABConfig(**kw).use_cached_flags(12)
        got = PABConfig(**kw).use_cached_flags(12)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for skip, kinds in (((), None), (("down_3", "mid"), None), (("up_0",), ("cross",)),
                        ((), ("spatial", "temporal"))):
        assert (port.m.unet.make_pab_collect_cache(skip, kinds)
                == jbase.m.unet.make_pab_collect_cache(skip=skip, kinds=kinds))


def test_pab_with_a_window_group_raises_as_in_jax(bundle):
    _, inputs, port = bundle
    pipe = VideoUpscalePipeline(port.m, device="cpu", pab=PABConfig())
    pipe.window_group = 1
    with pytest.raises(ValueError, match="window_group=0"):
        run_port(pipe, inputs)
    with pytest.raises(ValueError, match="step_mode"):
        VideoUpscalePipeline(port.m, device="cpu", step_mode="graph")


def test_scan_equals_host_on_the_cpu(bundle):
    """Without PAB the two step modes run the same loop: equal outputs; the
    ticks per step against one (JAX ``:406-409``, ``:587-588``)."""
    _, inputs, port = bundle
    scan, scan_ticks = run_port(VideoUpscalePipeline(port.m, device="cpu"), inputs)
    host, host_ticks = run_port(VideoUpscalePipeline(port.m, device="cpu", step_mode="host"),
                                inputs)
    assert torch.equal(scan, host)
    decode = [t for t in host_ticks if t[0] == "decode"]
    assert scan_ticks == [("denoise", STEPS, STEPS)] + decode
    assert host_ticks == [("denoise", i + 1, STEPS) for i in range(STEPS)] + decode


def test_graph_key_follows_the_weights(bundle):
    """The captured loop holds the weights' addresses: its stamp changes
    when ``load_state_dict`` writes the weights in place and when the
    weights get new storage, a new stamp drops the loop, and moving a
    module drops it."""
    _, _, port = bundle
    unet = UNetVideoModel(port.m.unet.config).eval()
    unet.load_state_dict(port.m.unet.state_dict())
    before = weights_stamp(unet)
    assert weights_stamp(unet) == before
    unet.load_state_dict(port.m.unet.state_dict())
    loaded = weights_stamp(unet)
    assert loaded != before and [p for p, _ in loaded] == [p for p, _ in before]
    unet.double()
    assert [p for p, _ in weights_stamp(unet)] != [p for p, _ in loaded]

    graphs = LoopGraphs()
    graphs.plan("probe", before)
    graphs.key, graphs.loop = "probe", object()
    assert graphs.plan("probe", before) == "replay"
    assert graphs.plan("probe", loaded) == "eager" and graphs.loop is None

    pipe = VideoUpscalePipeline(port.m, device="cpu")
    for offload in (True, False):
        pipe.graphs.key, pipe.graphs.loop = "probe", object()
        pipe.enable_model_offload(offload)
        assert pipe.graphs.key is None and pipe.graphs.loop is None


def test_graph_captured_only_for_a_key_that_comes_back():
    """A key's first call runs eagerly, its second is captured, later ones
    replay; one graph is held, the newest; a key that alternates with the
    held one (a clip's last, smaller tile batch) stays eager and does not
    evict it; a new key seen twice in a row replaces it."""
    graphs = LoopGraphs()

    def calls(keys):
        out = []
        for key in keys:
            how = graphs.plan(key, "stamp")
            if how == "capture":  # what run() does once the capture succeeds
                graphs.key, graphs.loop = key, object()
                graphs.seen.clear()
            out.append(how)
        return out

    assert calls(["a", "a", "a"]) == ["eager", "capture", "replay"]
    assert calls(["a", "a", "b"] * 3) == ["replay", "replay", "eager"] * 3
    assert graphs.key == "a"
    assert calls(["a", "b", "a", "c", "b", "c", "c"]) == ["replay", "eager", "replay", "eager",
                                                          "eager", "capture", "replay"]
    assert graphs.key == "c"
