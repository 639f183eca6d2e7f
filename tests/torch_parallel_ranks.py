"""The ranks of ``tests/test_torch_parallel.py``: one process per rank on a
gloo group (``torch.multiprocessing``, ``spawn``), every case of the port's
``parallel`` package run in one spawn, each rank's results saved for the
test process to compare. Imports torch and the port only (a spawned rank
does not load JAX).

The inputs are made from seeds by :func:`inputs`, in the ranks and in the
test process alike; the weights come from files the test process writes
(``setup.pt``: the tiny VAEs and RAFT as state dicts, the tiny bundle's
directory).
"""

import os
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 120.0  # seconds a spawn may take before its ranks are killed
STEPS = 3
PAB = dict(start_step=0, cross_range=2, spatial_range=2, temporal_range=2)


def rand(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


def inputs(world: int) -> dict:
    """Every case's tensors, from seeds."""
    t_time = 12 * world  # the temporal plan: 12 frames a rank
    return dict(
        window_x=rand(1, 1, t_time, 2, 2, 3),
        prop=(rand(2, 1, 8, 6, 6, 4), rand(3, 1, 7, 12, 12, 2, scale=3.0),
              rand(4, 1, 7, 12, 12, 2, scale=3.0)),
        prop_bilinear=(rand(5, 2, 8, 6, 6, 4), rand(6, 2, 7, 12, 12, 2, scale=2.0),
                       rand(7, 2, 7, 12, 12, 2, scale=2.0)),
        decode_z={t: rand(8 + t, 1, t, 4, 4, 4) for t in (7, 2)},
        decode_video=(rand(10, 1, 7, 4, 4, 4), rand(11, 1, 7, 4, 4, 3).clamp(-1, 1)),
        flow_frames={(t, h, w): rand(12 + t, 1, t, h, w, 3).clamp(-1, 1)
                     for t, h, w in ((5, 64, 64), (4, 64, 64), (4, 60, 76))},
        call=dict(image=rand(20, 1, 10, 8, 8, 3).clamp(-1, 1), latents=rand(21, 1, 10, 8, 8, 4),
                  lr_noise=rand(22, 1, 10, 8, 8, 3),
                  flows=(rand(23, 1, 9, 8, 8, 2), rand(24, 1, 9, 8, 8, 2))),
        cli_frames=rand(25, 3, 64, 64, 3).clamp(-1, 1).numpy(),
        time=dict(lat=rand(30, 1, t_time, 8, 8, 4), img=rand(31, 1, t_time, 8, 8, 3),
                  embeds=rand(32, 2, 77, 16), flows=(rand(33, 1, t_time - 1, 8, 8, 2),
                                                     rand(34, 1, t_time - 1, 8, 8, 2))),
    )


def window_fn(w):
    """Exact arithmetic (a doubling and one add), so the plans compare bit
    for bit across frameworks."""
    return w * 2.0 + w[:, :1]


def cli_args():
    """The CLI options ``cli.upscale_clip`` reads: 2 steps, propagation at 1."""
    return types.SimpleNamespace(
        max_size=0, inference_steps=2, guidance_scale=6.0, noise_level=120, n_prompt="",
        propagation_steps=[1], w_lr=1.0, a_prompt="best quality", perform_tile=False,
        tile_size=256, tile_batch=1, seed=5, color_fix="None")


def run_cases(rank: int, world: int, setup: dict) -> dict:
    from upscale_a_video_tpu_torch import cli
    from upscale_a_video_tpu_torch.config import VaeConfig
    from upscale_a_video_tpu_torch.models import AutoencoderKLVideo
    from upscale_a_video_tpu_torch.models.raft import RAFT, RaftRunner
    from upscale_a_video_tpu_torch.parallel import (ShardedVideoUpscalePipeline,
                                                    build_sharded_decode, build_sharded_denoise,
                                                    build_sharded_flows,
                                                    distributed_propagate_latents, make_mesh,
                                                    shard_params, shard_video,
                                                    sharded_windowed_apply)
    from upscale_a_video_tpu_torch.parallel.mesh import all_gather, axis_group
    from upscale_a_video_tpu_torch.parallel.temporal import (local_window_count,
                                                             windowed_apply_local)
    from upscale_a_video_tpu_torch.pipeline import PABConfig, load_pipeline

    x = inputs(world)
    out = {}
    group, n, r = axis_group()

    # temporal chunks: the halo and spill exchange, and per-window caches
    out["window"] = sharded_windowed_apply(window_fn)(x["window_x"])
    t_local = x["window_x"].shape[1] // n
    caches = [torch.full((1,), 10.0 * k) for k in range(local_window_count(t_local, n))]
    _, new = windowed_apply_local(lambda w, c: (window_fn(w), c + 1), x["window_x"][
        :, r * t_local:(r + 1) * t_local], n, caches=caches, group=group, rank=r)
    out["window_caches"] = torch.cat(new)

    # propagation: this rank's chunk, then the chunks gathered
    for name, kw in (("prop", {}), ("prop_bilinear", dict(interpolation="bilinear",
                                                          fuse_scale=0.3, alpha1=0.01,
                                                          alpha2=0.5))):
        xs, ff, fb = x[name]
        l = xs.shape[1] // n
        local = distributed_propagate_latents(xs[:, r * l:(r + 1) * l], ff, fb, n, group, r,
                                              **kw)
        out[name] = all_gather(local, n, group).movedim(0, 1).flatten(1, 2)

    # decode: the tiny 3D VAE at 7 frames (two chunks and a tail) and 2
    # (the tail alone), the conditioned video VAE at 7
    for key, video in (("vae", False), ("vae_video", True)):
        cfg = VaeConfig(**setup[key + "_config"])
        vae = AutoencoderKLVideo(cfg).eval()
        vae.load_state_dict(setup[key], strict=True)
        if video:
            z, img = x["decode_video"]
            out["decode_video"] = build_sharded_decode(vae, None, 7, w_lr=0.7)(z, img)
        else:
            for t, z in x["decode_z"].items():
                out[f"decode_{t}"] = build_sharded_decode(vae, None, t)(z)

    # RAFT's flows, rows split over the ranks
    raft = RAFT(small=True).eval()
    raft.load_state_dict(setup["raft"], strict=True)
    runner = RaftRunner(raft, iters=2)
    flows = build_sharded_flows(runner)
    for key, frames in x["flow_frames"].items():
        out[f"flows_{key}"] = torch.stack(flows(frames))

    # the pipeline over the ranks (window items), as a user calls it
    c = x["call"]
    pipe = ShardedVideoUpscalePipeline(load_pipeline(setup["bundle"], dtype=torch.float32,
                                                     device="cpu").m,
                                       device="cpu")
    kw = dict(num_inference_steps=STEPS, guidance_scale=6.0, noise_level=120,
              latents=c["latents"], lr_noise=c["lr_noise"])
    out["call"] = pipe("a cat", c["image"], **kw)
    out["call_prop"] = pipe("a cat", c["image"], c["flows"], propagation_steps=[1], **kw)
    out["call_steps"] = list(pipe.propagated_steps)
    pipe.pab = PABConfig(**PAB)
    out["call_pab"] = pipe("a cat", c["image"], **kw)
    pipe.pab = None
    out["cli"] = cli.upscale_clip(pipe, runner, x["cli_frames"], cli_args(), caption="a cat ")

    # the frame axis split over the ranks (temporal chunks), with
    # propagation at step 1 and under PAB
    tm = x["time"]
    unet, sched = pipe.m.unet, pipe.m.scheduler
    level = torch.full((2,), 120)
    img = torch.cat([tm["img"]] * 2)
    for name, pab, prop in (("time", None, ()), ("time_prop", None, (1,)),
                            ("time_pab", PABConfig(**PAB), ())):
        run = build_sharded_denoise(unet, sched, None, 2, 6.0, propagation_steps=prop, pab=pab)
        out[name] = run(tm["lat"], img, tm["embeds"], level, *tm["flows"])

    # placements: a (world/2 x 2) mesh, the UNet's parameters
    mesh = make_mesh(model=2, device_type="cpu")
    sharded = shard_params(unet, mesh)
    out["placements"] = {k: [str(p) for p in v.placements] for k, v in sharded.items()}
    state = unet.state_dict()
    out["full_equal"] = all(torch.equal(v.full_tensor(), state[k]) for k, v in sharded.items())
    video = shard_video(tm["lat"], mesh, axis="data")
    out["shard_video"] = (str(video.placements), tuple(video.to_local().shape))
    return out


def rank_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    try:
        setup = torch.load(os.path.join(workdir, "setup.pt"), weights_only=False)
        out = run_cases(rank, world, setup)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, workdir: str, timeout: float = JOIN_TIMEOUT) -> list:
    """Run :func:`rank_main` on ``world`` ranks and return each rank's
    results. The join waits ``timeout`` seconds at most: then every rank is
    killed and the call raises, so a collective that never returns cannot
    hang the test run."""
    ctx = mp.start_processes(rank_main, args=(world, workdir), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
