"""The PyTorch port's RAFT against the JAX package's, on the CPU, in float32:
the correlation pyramid, the window lookup (with the reference's offset
quirk), the convex upsampling, each encoder and update block, both variants
end to end, the weight transfer both ways (JAX tree → port, and a port state
dict saved with DataParallel's ``module.`` prefix read by both ``load_raft``),
and the clip-sliced bidirectional flows at T = 14 and on a frame size that is
no multiple of 8. Inputs and parameters are made by numpy from a seed
(:func:`seeded`).

Tolerances: 1e-5 absolute for the correlation and lookup (values of order 1),
1e-4 of the largest output for each block, and 2e-4 of the largest flow for
whole RAFT runs (float32 convolutions summed in another order, carried through
the recurrent refinement; flows reach ~100 pixels with these weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.models import raft as jraft
from upscale_a_video_tpu_torch.models import raft as traft
from upscale_a_video_tpu_torch.weights import flatten_tree, raft_state_dict

torch.set_num_threads(1)


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def seeded(module, *args, seed, scale=0.05):
    """A parameter tree of ``module``'s shapes (``jax.eval_shape``: no
    initialiser runs) drawn by numpy: each conv kernel uniform within
    ±1/√fan_in (PyTorch's default), norm scales 1 + N(0, scale²), BatchNorm
    variances 0.5 + |N(0, scale²)|, every other leaf N(0, scale²)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_tree(shapes).items():
        if k[-1] == "kernel":
            bound = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
            continue
        noise = (scale * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = {"scale": 1 + noise, "var": 0.5 + np.abs(noise)}.get(k[-1], noise)
    return out


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def frames_pair(rng, b, h, w):
    i1 = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    i2 = np.roll(i1, 2, axis=2) + 0.05 * rng.standard_normal(i1.shape).astype(np.float32)
    return i1, i2


# ------------------------------------------------------------- correlation

def test_corr_pyramid():
    rng = np.random.default_rng(0)
    f1, f2 = (rng.standard_normal((2, 16, 12, 8)).astype(np.float32) for _ in range(2))
    want = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = traft.build_corr_pyramid(nchw(f1), nchw(f2))
    assert [tuple(g.shape) for g in got] == [(384, 1, 16, 12), (384, 1, 8, 6), (384, 1, 4, 3),
                                             (384, 1, 2, 1)]
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(wnt)[..., 0], atol=1e-5)


@pytest.mark.parametrize("radius", [4, 3])
def test_lookup_corr_keeps_the_offset_quirk(radius):
    """Coordinates past the borders included; the (2r+1)² samples in the
    JAX package's channel order (window row offset added to x)."""
    rng = np.random.default_rng(radius)
    f1, f2 = (rng.standard_normal((1, 16, 12, 8)).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-2, 18, (1, 16, 12, 2)).astype(np.float32)
    pyr = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    want = np.asarray(jraft.lookup_corr(pyr, jnp.asarray(coords), radius))
    got = traft.lookup_corr(traft.build_corr_pyramid(nchw(f1), nchw(f2)), nchw(coords), radius)
    assert got.shape == (1, 4 * (2 * radius + 1) ** 2, 16, 12)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)
    # the quirk, at integer coordinates (exact taps): level-0 sample
    # i·(2r+1) + j of a pixel at (x, y) is the correlation at (x + i - r, y + j - r)
    n = 2 * radius + 1
    corr0 = traft.build_corr_pyramid(nchw(f1), nchw(f2))[0][0, 0].numpy()  # pixel (0, 0)
    x, y = 5, 6
    at = traft.lookup_corr(traft.build_corr_pyramid(nchw(f1), nchw(f2)),
                           torch.tensor([x, y], dtype=torch.float32).reshape(1, 2, 1, 1)
                           .expand(1, 2, 16, 12).contiguous(), radius)[0, :n * n, 0, 0].numpy()
    for i in range(n):
        for j in range(n):
            xi, yj = x + i - radius, y + j - radius
            inside = 0 <= xi < 12 and 0 <= yj < 16
            assert at[i * n + j] == pytest.approx(corr0[yj, xi] if inside else 0.0, abs=1e-6)


def test_upsample_flow():
    rng = np.random.default_rng(1)
    flow = rng.standard_normal((2, 4, 5, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 4, 5, 576)).astype(np.float32)
    want = np.asarray(jraft.RAFT().upsample_flow(jnp.asarray(flow), jnp.asarray(mask)))
    got = traft.RAFT.upsample_flow(nchw(flow), nchw(mask))
    assert got.shape == (2, 2, 32, 40)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


# ------------------------------------------------------------------ blocks

ENCODERS = [(jraft.BasicEncoder, traft.BasicEncoder, 256, "instance"),
            (jraft.BasicEncoder, traft.BasicEncoder, 256, "batch"),
            (jraft.BasicEncoder, traft.BasicEncoder, 256, "group"),
            (jraft.SmallEncoder, traft.SmallEncoder, 128, "instance"),
            (jraft.SmallEncoder, traft.SmallEncoder, 160, "none")]


@pytest.mark.parametrize("jcls,tcls,out,norm", ENCODERS,
                         ids=["basic-instance", "basic-batch", "basic-group", "small-instance",
                              "small-none"])
def test_encoder(jcls, tcls, out, norm):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    jm = jcls(output_dim=out, norm_fn=norm)
    flat = seeded(jm, x, seed=3)
    tm = tcls(out, norm).eval()
    tm.load_state_dict(raft_state_dict(flat), strict=True)
    want = np.asarray(jm.apply({"params": unflatten(flat)}, x))
    with torch.no_grad():
        got = tm(nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (2, 5, 6, out)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("small", [False, True], ids=["basic", "small"])
def test_update_block(small):
    """Motion encoder, GRU, flow head (and the full block's 0.25 · mask)."""
    rng = np.random.default_rng(4)
    hdim, cdim, radius = (96, 64, 3) if small else (128, 128, 4)
    b, h, w = 2, 5, 6
    net = np.tanh(rng.standard_normal((b, h, w, hdim))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((b, h, w, cdim)), 0).astype(np.float32)
    corr = rng.standard_normal((b, h, w, 4 * (2 * radius + 1) ** 2)).astype(np.float32)
    flow = rng.uniform(-3, 3, (b, h, w, 2)).astype(np.float32)
    jm = jraft.SmallUpdateBlock(hdim) if small else jraft.BasicUpdateBlock(hdim)
    flat = seeded(jm, net, inp, corr, flow, seed=5)
    tm = (traft.SmallUpdateBlock if small else traft.BasicUpdateBlock)(hdim, cdim, 4, radius)
    tm.load_state_dict(raft_state_dict(flat), strict=True)
    jnet, jmask, jdelta = jm.apply({"params": unflatten(flat)}, net, inp, corr, flow)
    with torch.no_grad():
        tnet, tmask, tdelta = tm(nchw(net), nchw(inp), nchw(corr), nchw(flow))
    for got, want in ((tnet, jnet), (tdelta, jdelta)) + (() if small else ((tmask, jmask),)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                                   atol=1e-4 * np.abs(want).max())
    assert (tmask is None) == small
    with torch.no_grad():
        assert tm(nchw(net), nchw(inp), nchw(corr), nchw(flow), with_mask=False)[1] is None


# ------------------------------------------------------------------- RAFT

@pytest.fixture(scope="module", params=[False, True], ids=["raft-things", "raft-small"])
def raft_pair(request):
    """Seeded JAX RAFT parameters, and the port RAFT loaded with them (the
    flax tree → port transfer)."""
    small = request.param
    jm = jraft.RAFT(small=small)
    d = np.zeros((1, 64, 64, 3), np.float32)
    flat = seeded(jm, d, d, 1, seed=6)
    tm = traft.RAFT(small=small).eval()
    tm.load_state_dict(raft_state_dict(flat), strict=True)
    return jm, {"params": unflatten(flat)}, tm


def test_raft_end_to_end(raft_pair):
    """Two 64×80 pairs, 3 iterations."""
    jm, params, tm = raft_pair
    i1, i2 = frames_pair(np.random.default_rng(7), 2, 64, 80)
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply(p, a, b, 3))(params, i1, i2))
    got = tm(torch.from_numpy(i1), torch.from_numpy(i2), 3).numpy()
    assert got.shape == (2, 64, 80, 2)
    assert np.abs(want).max() > 1
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_bidirectional_flows_clip_slicing(raft_pair):
    """T = 14 at width ≤ 640: clips of frames [0, 12) and [11, 14), 13 flows
    each way, equal to the JAX package's slicing."""
    jm, params, tm = raft_pair
    rng = np.random.default_rng(8)
    base = rng.uniform(-1, 1, (1, 64, 72, 3)).astype(np.float32)
    frames = np.stack([np.roll(base, k, axis=2) for k in range(14)], axis=1)
    want = jraft.compute_bidirectional_flows(jraft.RaftRunner(jm, params, iters=1),
                                             jnp.asarray(frames))
    got = traft.compute_bidirectional_flows(traft.RaftRunner(tm, iters=1),
                                            torch.from_numpy(frames))
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert g.shape == wnt.shape == (1, 13, 64, 72, 2)
        np.testing.assert_allclose(g.numpy(), wnt, atol=2e-4 * np.abs(wnt).max())
    assert traft.clip_length(640) == 12 and traft.clip_length(720) == 8
    assert traft.clip_length(1280) == 4 and traft.clip_length(1281) == 2


def test_bidirectional_flows_on_a_frame_not_a_multiple_of_8(raft_pair):
    """60×76 frames: resized to 64×80 for RAFT, flows resized back with x
    scaled by 76/80 and y by 60/64."""
    jm, params, tm = raft_pair
    rng = np.random.default_rng(9)
    frames = rng.uniform(-1, 1, (1, 3, 60, 76, 3)).astype(np.float32)
    want = jraft.compute_bidirectional_flows(jraft.RaftRunner(jm, params, iters=2),
                                             jnp.asarray(frames))
    got = traft.compute_bidirectional_flows(traft.RaftRunner(tm, iters=2),
                                            torch.from_numpy(frames))
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert g.shape == (1, 2, 60, 76, 2)
        np.testing.assert_allclose(g.numpy(), wnt, atol=2e-4 * np.abs(wnt).max())


def test_resize_flow_scales_each_axis():
    rng = np.random.default_rng(10)
    flow = rng.standard_normal((1, 8, 10, 2)).astype(np.float32)
    want = np.asarray(jraft.resize_flow(jnp.asarray(flow), 6, 15))
    got = traft.resize_flow(torch.from_numpy(flow), 6, 15)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_checkpoint_read_by_both_loaders(tmp_path):
    """A port RAFT (seeded initialisers, BatchNorm statistics set) saved as
    ``raft-things.pth`` with the ``module.`` prefix: the JAX package's
    ``load_raft`` (through its converter) and the port's (``strict=True``)
    give the same flows."""
    src = traft.load_raft(None, iters=2, device="cpu", seed=3).model
    gen = torch.Generator().manual_seed(4)
    for m in src.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
            m.num_batches_tracked.fill_(7)
    path = tmp_path / "raft-things.pth"
    torch.save({f"module.{k}": v for k, v in src.state_dict().items()}, path)

    port = traft.load_raft(str(path), iters=2, device="cpu")
    for (k, a), b in zip(src.state_dict().items(), port.model.state_dict().values()):
        assert torch.equal(a, b), k
    jax_runner = jraft.load_raft(str(path), iters=2)
    i1, i2 = frames_pair(np.random.default_rng(11), 1, 64, 64)
    want = np.asarray(jax_runner._flow_fn()(jnp.asarray(i1), jnp.asarray(i2)))
    got = port(torch.from_numpy(i1), torch.from_numpy(i2)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max() + 1e-5)


def test_load_raft_random_init_is_seeded():
    a = traft.load_raft(None, device="cpu", seed=0).model.state_dict()
    b = traft.load_raft(None, device="cpu", seed=0).model.state_dict()
    c = traft.load_raft(None, device="cpu", seed=1).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])
    assert torch.equal(a["cnet.norm1.running_var"], torch.ones(64))
