"""The port's multi-GPU package (``upscale_a_video_tpu_torch/parallel``,
ROADMAP A11) on real gloo groups on the CPU, against the JAX package's
``parallel`` on the 8 fake CPU devices of ``tests/conftest.py``.

The ranks (``tests/torch_parallel_ranks.py``) are spawned once for each
world size, 2 and 4, and run every case in that spawn; a join that takes
over 120 s kills them and fails, so a collective that never returns cannot
stall the run. The test process holds their results against JAX's
sharded functions (on a mesh of as many devices) and against the port's
single-device code:

- the static plans (``local_window_count``, ``_item_plan``,
  ``comm_bytes_estimate``, the partition specs with JAX's axes moved to
  torch's layout) exactly, without ranks;
- ``sharded_windowed_apply`` bit for bit against JAX's and the serial plan
  (an exact-arithmetic window function);
- ``distributed_propagate_latents`` bit for bit against the port's serial
  ``propagate_latents`` (each rank does the serial per-frame work), and
  within 1e-5 of JAX's sharded propagation (as ``test_torch_propagation``);
- ``build_sharded_decode`` bit for bit against the serial chunked decode,
  and within 2e-4 of the output's largest value of JAX's sharded decode (as
  ``test_torch_models``' VAE);
- ``build_sharded_flows`` within 2e-4 of the largest flow of JAX's sharded
  flows (as ``test_torch_raft``), and within 1e-5 of the port's serial
  flows (a rank runs its rows as a batch of its own);
- the UNet-heavy builders (``ShardedVideoUpscalePipeline`` with and without
  PAB and propagation, the CLI's sharded flows branch, and
  ``build_sharded_denoise``) against the port's single-device pipeline,
  which ``test_torch_pipeline*.py`` hold against JAX: relative L2 within
  1e-5 (float32; the partial blend and the batching sum in another order);
- every rank returns the same result, bit for bit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from torch_bundle import write_bundle
from upscale_a_video_tpu.config import UNetVideoConfig as JUNetConfig
from upscale_a_video_tpu.config import VaeConfig as JVaeConfig
from upscale_a_video_tpu.models import AutoencoderKLVideo as JVae
from upscale_a_video_tpu.models import UNetVideoModel as JUNet
from upscale_a_video_tpu.models import raft as jraft
from upscale_a_video_tpu.parallel import decode as jdecode
from upscale_a_video_tpu.parallel import flow as jflow
from upscale_a_video_tpu.parallel import mesh as jmesh
from upscale_a_video_tpu.parallel import propagation as jprop
from upscale_a_video_tpu.parallel import temporal as jtemporal
from upscale_a_video_tpu.parallel import window_parallel as jwin
from upscale_a_video_tpu_torch import cli
from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig
from upscale_a_video_tpu_torch.models import AutoencoderKLVideo, UNetVideoModel
from upscale_a_video_tpu_torch.models.propagation import propagate_latents
from upscale_a_video_tpu_torch.models.raft import RAFT, RaftRunner, compute_bidirectional_flows
from upscale_a_video_tpu_torch.parallel import (build_sharded_decode, build_sharded_flows,
                                                param_partition_spec)
from upscale_a_video_tpu_torch.parallel import propagation as tprop
from upscale_a_video_tpu_torch.parallel import temporal as ttemporal
from upscale_a_video_tpu_torch.parallel import window_parallel as twin
from upscale_a_video_tpu_torch.parallel.eval_pipeline import ShardedVideoUpscalePipeline
from upscale_a_video_tpu_torch.parallel.mesh import flax_axis_to_torch
from upscale_a_video_tpu_torch.pipeline import PABConfig, load_pipeline
from upscale_a_video_tpu_torch.pipeline.pipeline import PipelineModules, VideoUpscalePipeline
from upscale_a_video_tpu_torch.weights import flatten_tree, raft_state_dict, to_state_dict, torch_key

torch.set_num_threads(1)

TINY_UNET = dict(block_out_channels=(8, 16, 16, 32), attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
VAES = {"vae": dict(block_out_channels=[8, 16, 16], norm_num_groups=4),
        "vae_video": dict(block_out_channels=[8, 16, 16], norm_num_groups=4,
                          condition_channels=8, up_block_types=["UpDecoderBlock3D_plus"] * 3,
                          condition_img=True, use_temporal_block=True)}
PIPE_TOL = 1e-5


def rel_l2(a, b):
    a, b = (np.asarray(v, np.float64) for v in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def perturbed(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + (rng.standard_normal(np.shape(v)) * scale).astype(np.float32)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}


def jax_mesh(n, axis):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


# ------------------------------------------------------------------- setup

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights every rank and the test process load: the tiny 3D VAE
    (also as JAX params), the tiny video VAE, RAFT-small (also as JAX
    params), and the tiny bundle."""
    root = tmp_path_factory.mktemp("parallel_setup")
    write_bundle(root / "bundle", video=False)
    jvae = JVae(JVaeConfig(**VAES["vae"]))
    flat = perturbed(jvae.init(jax.random.PRNGKey(1), np.zeros((1, 1, 16, 16, 3),
                                                                np.float32))["params"], 3)
    gen = torch.Generator().manual_seed(9)
    video = AutoencoderKLVideo(VaeConfig(**VAES["vae_video"]))
    with torch.no_grad():
        for p in video.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    jr = jraft.RAFT(small=True)
    d = np.zeros((1, 64, 64, 3), np.float32)
    rflat = perturbed(jr.init(jax.random.PRNGKey(2), d, d, 1)["params"], 4, scale=0.05)
    out = dict(bundle=str(root / "bundle"), vae=to_state_dict(flat), vae_config=VAES["vae"],
               vae_video=video.state_dict(), vae_video_config=VAES["vae_video"],
               raft=raft_state_dict(rflat))
    torch.save(out, root / "setup.pt")
    return dict(out, dir=root, jvae=(jvae, {"params": unflatten(flat)}),
                jraft=jraft.RaftRunner(jr, {"params": unflatten(rflat)}, iters=2))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, setup, tmp_path_factory):
    """(world size, each rank's results) of one spawn."""
    n = request.param
    workdir = tmp_path_factory.mktemp(f"world{n}")
    os.symlink(setup["dir"] / "setup.pt", workdir / "setup.pt")
    return n, ranks.spawn(n, str(workdir))


def port_modules(setup):
    vae = AutoencoderKLVideo(VaeConfig(**VAES["vae"])).eval()
    vae.load_state_dict(setup["vae"], strict=True)
    video = AutoencoderKLVideo(VaeConfig(**VAES["vae_video"])).eval()
    video.load_state_dict(setup["vae_video"], strict=True)
    raft = RAFT(small=True).eval()
    raft.load_state_dict(setup["raft"], strict=True)
    return vae, video, RaftRunner(raft, iters=2)


def serial_decode(vae, z, img=None, w_lr=1.0):
    """The single-device pipeline's chunked decode."""
    pipe = VideoUpscalePipeline(PipelineModules(unet=None, vae=vae, text_encoder=None,
                                                tokenizer=None, scheduler=None,
                                                low_res_scheduler=None), device="cpu")
    return pipe.decode_latents(z, img, w_lr)


# -------------------------------------------------------- plans, no ranks

@pytest.mark.parametrize("t_local,n", [(12, 1), (14, 1), (18, 1), (20, 1), (8, 1), (12, 2),
                                       (12, 4), (18, 3), (24, 8)])
def test_local_window_count_matches_jax(t_local, n):
    assert ttemporal.local_window_count(t_local, n) == jtemporal.local_window_count(t_local, n)


@pytest.mark.parametrize("frames,batch,n_dev", [(5, 2, 2), (10, 2, 4), (14, 4, 8), (32, 2, 8),
                                                (3, 1, 4), (8, 2, 1)])
def test_item_plan_matches_jax(frames, batch, n_dev):
    for got, want in zip(twin._item_plan(frames, batch, n_dev, 8, 6),
                         jwin._item_plan(frames, batch, n_dev, 8, 6)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,n", [((1, 96, 40, 40, 4), 8), ((2, 16, 8, 8, 4), 2),
                                     ((1, 8, 6, 6, 4), 4)])
def test_comm_bytes_estimate_matches_jax(shape, n):
    assert tprop.comm_bytes_estimate(shape, n) == jprop.comm_bytes_estimate(shape, n)


def test_partition_specs_match_jax():
    """Every parameter of the tiny UNet and VAE: JAX's spec on the flax
    kernel, its axes moved to torch's layout, equals the port's on the
    torch key (``to_out.0`` row-parallel over dim 1, convs over dim 0, norms,
    biases and the class embedding replicated)."""
    jm = JUNet(JUNetConfig(**TINY_UNET))
    s, lr, ctx = (np.zeros(sh, np.float32) for sh in ((1, 2, 8, 8, 4), (1, 2, 8, 8, 3),
                                                        (1, 3, 16)))
    trees = [jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), s, 0, lr, ctx, 0))["params"],
             jax.eval_shape(lambda: JVae(JVaeConfig(**VAES["vae"])).init(
                 jax.random.PRNGKey(0), np.zeros((1, 1, 16, 16, 3), np.float32)))["params"]]
    tmods = [UNetVideoModel(UNetVideoConfig(**TINY_UNET)), AutoencoderKLVideo(VaeConfig(
        **VAES["vae"]))]
    kinds = set()
    for tree, tm in zip(trees, tmods):
        tstate = tm.state_dict()
        for path, v in flatten_tree(tree).items():
            spec = tuple(jmesh.param_partition_spec(path, np.zeros(v.shape)))
            key = torch_key(path)
            assert key in tstate, key
            got = param_partition_spec(key, tstate[key])
            if not spec or all(a is None for a in spec):
                assert got == (), (key, got)
                continue
            nd = len(v.shape)
            want = [None] * nd
            for a, name in enumerate(spec):
                if name is not None:
                    want[flax_axis_to_torch(a, nd)] = name
            assert got == tuple(want), (key, spec, got)
            kinds.add((nd, got.index("model")))
    assert {(2, 0), (2, 1)} <= kinds and any(nd >= 4 for nd, _ in kinds), kinds


def test_builders_raise_without_a_process_group(setup):
    _, _, runner = port_modules(setup)
    with pytest.raises(RuntimeError, match="process group"):
        build_sharded_flows(runner)
    with pytest.raises(RuntimeError, match="process group"):
        build_sharded_decode(port_modules(setup)[0], None, 7)
    pipe = load_pipeline(setup["bundle"], device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ShardedVideoUpscalePipeline(pipe.m, device="cpu")


@pytest.mark.parametrize("t", [12, 18, 24])
def test_one_chunk_plan_matches_jax(t):
    """One chunk (world size 1, as on one card): the serial plan with no
    exchange, bit for bit with JAX's one-chunk path and the reference loop."""
    x = ranks.rand(40 + t, 1, t, 2, 2, 3)
    got = ttemporal.windowed_apply_local(ranks.window_fn, x, 1)
    want = jtemporal.windowed_apply_local(lambda w: w * 2.0 + w[:, :1], jnp.asarray(x.numpy()),
                                          "time", 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  ttemporal.reference_windowed_apply(ranks.window_fn, x).numpy())


# ----------------------------------------------------------- on the ranks

def test_every_rank_returns_the_same(world):
    n, outs = world
    for other in outs[1:]:
        for key, value in outs[0].items():
            if key == "window_caches":  # each rank's own windows
                continue
            if torch.is_tensor(value):
                assert torch.equal(other[key], value), key
            else:
                assert other[key] == value, key


def test_sharded_windowed_apply_matches_jax(world):
    n, outs = world
    x = ranks.inputs(n)["window_x"]
    mesh = jax_mesh(n, "time")
    want = jtemporal.sharded_windowed_apply(lambda w: w * 2.0 + w[:, :1], mesh)(
        jax.device_put(jnp.asarray(x.numpy()), NamedSharding(mesh, P(None, "time"))))
    np.testing.assert_array_equal(outs[0]["window"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(outs[0]["window"].numpy(),
                                  ttemporal.reference_windowed_apply(ranks.window_fn, x).numpy())
    count = ttemporal.local_window_count(x.shape[1] // n, n)
    for out in outs:  # every window's cache moved once, on its own rank
        np.testing.assert_array_equal(out["window_caches"].numpy(),
                                      10.0 * np.arange(count) + 1)


@pytest.mark.parametrize("case", ["prop", "prop_bilinear"])
def test_distributed_propagation(world, case):
    n, outs = world
    xs, ff, fb = ranks.inputs(n)[case]
    kw = {} if case == "prop" else dict(interpolation="bilinear", fuse_scale=0.3, alpha1=0.01,
                                        alpha2=0.5)
    got = outs[0][case]
    assert torch.equal(got, propagate_latents(xs, ff, fb, **kw))
    mesh = jax_mesh(n, "time")
    fn = shard_map(functools.partial(jprop.distributed_propagate_latents, axis="time",
                                     n_chunks=n, **kw),
                   mesh=mesh, in_specs=(P(None, "time"), P(), P()), out_specs=P(None, "time"),
                   check_rep=False)
    want = jax.jit(fn)(*(jnp.asarray(a.numpy()) for a in (xs, ff, fb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sharded_decode(world, setup):
    n, outs = world
    vae, video, _ = port_modules(setup)
    x = ranks.inputs(n)
    jvae, jparams = setup["jvae"]
    for t, z in x["decode_z"].items():
        got = outs[0][f"decode_{t}"]
        assert got.shape == (1, t, 16, 16, 3)
        assert torch.equal(got, serial_decode(vae, z))
        jfn = jdecode.build_sharded_decode(jvae, jax_mesh(n, "win"), t)
        want = np.asarray(jfn(jparams, jnp.asarray(z.numpy()), jnp.zeros((1, t, 4, 4, 3))))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())
    z, img = x["decode_video"]
    assert torch.equal(outs[0]["decode_video"], serial_decode(video, z, img, w_lr=0.7))


def test_sharded_flows(world, setup):
    n, outs = world
    _, _, runner = port_modules(setup)
    for key, frames in ranks.inputs(n)["flow_frames"].items():
        got = outs[0][f"flows_{key}"]
        with torch.no_grad():
            serial = torch.stack(compute_bidirectional_flows(runner, frames))
        assert got.shape == serial.shape == (2, 1, key[0] - 1, key[1], key[2], 2)
        np.testing.assert_allclose(got.numpy(), serial.numpy(),
                                   atol=1e-5 * serial.abs().max().item())
        want = np.stack(jflow.build_sharded_flows(setup["jraft"], jax_mesh(n, "win"))(
            jnp.asarray(frames.numpy())))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def single(setup):
    """The single-device pipeline from the same bundle (the UNet in float32,
    as on the ranks)."""
    return load_pipeline(setup["bundle"], dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("case", ["call", "call_prop", "call_pab"])
def test_sharded_pipeline_matches_single_device(world, single, case):
    n, outs = world
    c = ranks.inputs(n)["call"]
    kw = dict(num_inference_steps=ranks.STEPS, guidance_scale=6.0, noise_level=120,
              latents=c["latents"], lr_noise=c["lr_noise"])
    if case == "call_prop":
        want = single("a cat", c["image"], c["flows"], propagation_steps=[1], **kw)
        assert outs[0]["call_steps"] == [1]
    elif case == "call_pab":
        single.pab = PABConfig(**ranks.PAB)
        try:
            want = single("a cat", c["image"], **kw)
        finally:
            single.pab = None
    else:
        want = single("a cat", c["image"], **kw)
    got = outs[0][case]
    assert got.shape == want.shape == (1, 10, 32, 32, 3)
    assert rel_l2(got, want) <= PIPE_TOL


def test_cli_takes_the_sharded_flows(world, single, setup):
    n, outs = world
    _, _, runner = port_modules(setup)
    want = cli.upscale_clip(single, runner, ranks.inputs(n)["cli_frames"], ranks.cli_args(),
                            caption="a cat ")
    assert outs[0]["cli"].shape == want.shape == (3, 256, 256, 3)
    assert rel_l2(outs[0]["cli"], want) <= PIPE_TOL


@pytest.mark.parametrize("case", ["time", "time_prop", "time_pab"])
def test_time_sharded_denoise_matches_single_device(world, single, case):
    n, outs = world
    tm = ranks.inputs(n)["time"]
    if case == "time_pab":
        single.pab = PABConfig(**ranks.PAB)
    try:
        want = single.denoise(tm["lat"], tm["img"], tm["embeds"], torch.full((1,), 120),
                              *tm["flows"], num_inference_steps=2, guidance_scale=6.0,
                              propagation_steps=frozenset({1} if case == "time_prop" else ()))
    finally:
        single.pab = None
    got = outs[0][case]
    assert got.shape == want.shape == (1, 12 * n, 8, 8, 4)
    assert rel_l2(got, want) <= PIPE_TOL


def test_shard_params_placements(world):
    n, outs = world
    out = outs[0]
    assert out["full_equal"]
    unet = UNetVideoModel(UNetVideoConfig(**TINY_UNET))
    for key, value in unet.state_dict().items():
        spec = param_partition_spec(key, value)
        dim = spec.index("model") if "model" in spec else None
        model = f"S({dim})" if dim is not None and value.shape[dim] % 2 == 0 else "R"
        assert out["placements"][key] == ["R", model], key
    assert any(p[1].startswith("S") for p in out["placements"].values())
    assert out["shard_video"] == ("(Shard(dim=1), Replicate())", (1, 24, 8, 8, 4))
