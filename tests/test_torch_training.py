"""The port's training (``upscale_a_video_tpu_torch/training``) against the
JAX package's on the CPU, float32, tiny configs:

- the temporal mask: the port's trainable names are JAX's masked paths
  through the key conversion;
- the UNet step: with JAX's draws (t, eps, lvl, lr_noise of
  ``train_unet.py:58-64``) replayed through ``diffusion_loss``'s ``noise``
  seam, the loss and the temporal gradients of one step, and the parameters
  after one and two steps of AdamW (lr 1e-4, weight decay 1e-2), against
  ``jax.value_and_grad`` and JAX's ``make_train_step``; frozen parameters
  unchanged; remat (``use_remat``) gives the same gradients;
- the VAE GAN losses for both optimizer indices against JAX (a conditioned
  tiny video VAE and a PatchDiscriminator converted by
  ``weights.discriminator_state_dict``); the discriminator step leaves the
  VAE without gradient;
- the schedules against JAX's.

Tolerances: the loss within 1e-4 relative, gradients within 1e-3 of the
largest gradient (float32 sums of the same products in another order
through a backward pass); parameters within 5e-2 x lr (the first Adam
steps move each weight by about lr, so this holds the direction of every
update); the VAE losses within 1e-4 relative; the schedules within 1e-6 relative
or 1e-7 of the base lr (JAX's float32 near the cosine's end).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upscale_a_video_tpu.config import UNetVideoConfig as JUNetConfig
from upscale_a_video_tpu.config import VaeConfig as JVaeConfig
from upscale_a_video_tpu.models import AutoencoderKLVideo as JVae
from upscale_a_video_tpu.models import UNetVideoModel as JUNet
from upscale_a_video_tpu.sampling import DDIMScheduler as JDDIM
from upscale_a_video_tpu.sampling import DDIMSchedulerConfig as JDDIMConfig
from upscale_a_video_tpu.sampling import DDPMScheduler as JDDPM
from upscale_a_video_tpu.training import lr_schedules as jsched
from upscale_a_video_tpu.training import train_unet as jtrain
from upscale_a_video_tpu.training import train_vae as jvae
from upscale_a_video_tpu_torch.config import UNetVideoConfig, VaeConfig
from upscale_a_video_tpu_torch.models import AutoencoderKLVideo, UNetVideoModel
from upscale_a_video_tpu_torch.sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler
from upscale_a_video_tpu_torch.training import lr_schedules
from upscale_a_video_tpu_torch.training.train_unet import (diffusion_loss, init_optimizer,
                                                           make_train_step, temporal_param_mask)
from upscale_a_video_tpu_torch.training.train_vae import PatchDiscriminator, vae_training_losses
from upscale_a_video_tpu_torch.weights import (discriminator_state_dict, flatten_tree,
                                               to_state_dict, torch_key)

torch.set_num_threads(1)

TINY_UNET = dict(block_out_channels=(8, 16, 16, 32), attention_head_dim=4, norm_num_groups=4,
                 cross_attention_dim=16)
TINY_VAE_VIDEO = dict(block_out_channels=(8, 16, 16), norm_num_groups=4, condition_channels=8,
                      up_block_types=("UpDecoderBlock3D_plus",) * 3, condition_img=True,
                      use_temporal_block=True)
LR = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
PARAM_ATOL = 5e-2 * LR


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + rand(rng, *np.shape(v), scale=0.1)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}


def port_value(flat_path, value):
    """A JAX leaf in the port's layout (the converter's transposes)."""
    return to_state_dict({flat_path: value})[torch_key(flat_path)].numpy()


def jax_draws(key, latents, low_res, max_noise_level=350):
    """JAX diffusion_loss's draws for ``key`` (train_unet.py:58-64)."""
    b = latents.shape[0]
    k_t, k_eps, k_lvl, k_lr = jax.random.split(key, 4)
    return {"t": jax.random.randint(k_t, (b,), 0, 1000),
            "eps": jax.random.normal(k_eps, latents.shape, latents.dtype),
            "lvl": jax.random.randint(k_lvl, (b,), 0, max_noise_level),
            "lr_noise": jax.random.normal(k_lr, low_res.shape, low_res.dtype)}


def torch_draws(d):
    return {k: torch.from_numpy(np.array(v)).long() if k in ("t", "lvl")
            else T(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def unet_case():
    rng = np.random.default_rng(0)
    batch = {"latents": rand(rng, 1, 2, 8, 8, 4), "low_res": rand(rng, 1, 2, 8, 8, 3),
             "text_embeds": rand(rng, 1, 3, 16)}
    jm = JUNet(JUNetConfig(**TINY_UNET))
    params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), batch["latents"], 0,
                                     batch["low_res"], batch["text_embeds"], 0))()
    flat = perturbed(params["params"], 1)
    jsch = JDDIM(JDDIMConfig(beta_schedule="scaled_linear"))
    jlrs = JDDPM()
    jparams = {"params": unflatten(flat)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, k: jtrain.diffusion_loss(jm, p, jbatch, k, jsch, jlrs)))
    step = jtrain.make_train_step(jm, jsch, jlrs, donate=False)
    opt_state = jtrain.init_optimizer(jparams)
    # the two programs compile in parallel (XLA compiles outside the GIL)
    with ThreadPoolExecutor(2) as pool:
        loss_grad, step = pool.map(lambda lowered: lowered.compile(), [
            loss_grad.lower(jparams, keys[0]),
            step.lower(jparams, opt_state, jbatch, keys[0])])
    loss0, grads0 = loss_grad(jparams, keys[0])
    p1, opt_state, l1 = step(jparams, opt_state, jbatch, keys[0])
    p2, _, l2 = step(p1, opt_state, jbatch, keys[1])
    want = dict(loss0=float(loss0), grads=flatten_tree(jax.tree.map(np.asarray, grads0["params"])),
                losses=(float(l1), float(l2)),
                params=[flatten_tree(jax.tree.map(np.asarray, p["params"])) for p in (p1, p2)],
                mask=flatten_tree(jtrain.temporal_param_mask(jparams)["params"]))
    draws = [torch_draws(jax_draws(k, jbatch["latents"], jbatch["low_res"])) for k in keys]
    return flat, {k: T(v) for k, v in batch.items()}, draws, want


def port_unet(flat, use_remat=False):
    tm = UNetVideoModel(UNetVideoConfig(**TINY_UNET), use_remat=use_remat)
    tm.load_state_dict(to_state_dict(flat), strict=True)
    return tm


def schedulers():
    return DDIMScheduler(DDIMSchedulerConfig(beta_schedule="scaled_linear")), DDPMScheduler()


def test_temporal_mask_matches_jax(unet_case):
    flat, _, _, want = unet_case
    jax_trained = {torch_key(p) for p, on in want["mask"].items() if on}
    mask = temporal_param_mask(port_unet(flat))
    assert {n for n, on in mask.items() if on} == jax_trained
    assert any("down_temp_blocks" in n for n in jax_trained)
    assert any("attn_temporal" in n for n in jax_trained)
    assert not mask["conv_in.weight"]


def temporal_grads(tm):
    return {n: p.grad.numpy() for n, p in tm.named_parameters() if p.grad is not None}


def test_loss_and_gradients_match_jax(unet_case):
    flat, batch, draws, want = unet_case
    tm = port_unet(flat)
    init_optimizer(tm)
    loss = diffusion_loss(tm, batch, *schedulers(), noise=draws[0])
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss0"], rtol=LOSS_RTOL)
    got = temporal_grads(tm)
    ref = {torch_key(p): port_value(p, g) for p, g in want["grads"].items()
           if want["mask"][p]}
    assert set(got) == set(ref)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in ref.items():
        np.testing.assert_allclose(got[name], g, atol=GRAD_TOL * scale, err_msg=name)


def test_two_steps_match_jax_and_freeze(unet_case):
    flat, batch, draws, want = unet_case
    tm = port_unet(flat)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state = init_optimizer(tm)
    step = make_train_step(tm, *schedulers(), state)
    for i in range(2):
        loss = step(batch, noise=draws[i])
        np.testing.assert_allclose(loss.item(), want["losses"][i], rtol=LOSS_RTOL)
        now = dict(tm.named_parameters())
        for path, value in want["params"][i].items():
            name = torch_key(path)
            if want["mask"][path]:
                np.testing.assert_allclose(now[name].detach().numpy(), port_value(path, value),
                                           atol=PARAM_ATOL, rtol=0, err_msg=f"step {i}: {name}")
            else:
                assert torch.equal(now[name], before[name]), name
    moved = [n for n, p in tm.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(temporal_param_mask(tm)[n] for n in moved)


def test_remat_gives_the_same_gradients(unet_case):
    flat, batch, draws, _ = unet_case
    grads = []
    for remat in (False, True):
        tm = port_unet(flat, use_remat=remat)
        init_optimizer(tm)
        diffusion_loss(tm, batch, *schedulers(), noise=draws[0]).backward()
        grads.append(temporal_grads(tm))
    assert set(grads[0]) == set(grads[1])
    for name in grads[0]:  # the same operations recomputed: equal values
        np.testing.assert_allclose(grads[1][name], grads[0][name], rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def test_loss_draws_from_a_generator(unet_case):
    flat, batch, _, _ = unet_case
    tm = port_unet(flat)
    run = lambda seed: diffusion_loss(tm, batch, *schedulers(),
                                      generator=torch.Generator().manual_seed(seed)).item()
    with torch.no_grad():
        assert run(3) == run(3) != run(4)


@pytest.fixture(scope="module")
def vae_case():
    rng = np.random.default_rng(7)
    inputs, latents = rand(rng, 1, 2, 4, 4, 3), rand(rng, 1, 2, 4, 4, 4, scale=0.1)
    gts = rand(rng, 1, 2, 16, 16, 3, scale=0.5)
    jm = JVae(JVaeConfig(**TINY_VAE_VIDEO))
    vflat = perturbed(jm.init(jax.random.PRNGKey(1), np.zeros((1, 2, 16, 16, 3), np.float32),
                              img=inputs)["params"], 5)
    disc = jvae.PatchDiscriminator(base_channels=8, num_layers=2)
    dflat = perturbed(disc.init(jax.random.PRNGKey(2), np.zeros((1, 16, 16, 3)))["params"], 6)
    want = [float(jvae.vae_training_losses(jm, {"params": unflatten(vflat)}, disc,
                                           {"params": unflatten(dflat)}, inputs, gts, latents,
                                           optimizer_idx=i)[0]) for i in (0, 1)]
    tv = AutoencoderKLVideo(VaeConfig(**TINY_VAE_VIDEO))
    tv.load_state_dict(to_state_dict(vflat), strict=True)
    td = PatchDiscriminator(base_channels=8, num_layers=2)
    td.load_state_dict(discriminator_state_dict(dflat), strict=True)
    return tv, td, (T(inputs), T(gts), T(latents)), want


@pytest.mark.parametrize("idx", [0, 1])
def test_vae_losses_match_jax(vae_case, idx):
    tv, td, (inputs, gts, latents), want = vae_case
    loss, recon = vae_training_losses(tv, td, inputs, gts, latents, optimizer_idx=idx)
    assert recon.shape == gts.shape
    np.testing.assert_allclose(loss.item(), want[idx], rtol=1e-4)


def test_discriminator_step_leaves_the_vae_alone(vae_case):
    tv, td, (inputs, gts, latents), _ = vae_case
    before = {n: p.detach().clone() for n, p in tv.named_parameters()}
    opt = torch.optim.Adam(td.parameters(), lr=1e-2)
    loss, _ = vae_training_losses(tv, td, inputs, gts, latents, optimizer_idx=1)
    loss.backward()
    assert all(p.grad is None for p in tv.parameters())
    assert any(p.grad is not None and p.grad.abs().sum() > 0 for p in td.parameters())
    opt.step()
    assert all(torch.equal(p, before[n]) for n, p in tv.named_parameters())
    # the generator step reaches the decoder
    tv.zero_grad()
    vae_training_losses(tv, td, inputs, gts, latents, optimizer_idx=0)[0].backward()
    assert tv.decoder.conv_out.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("name,kwargs", [("warmup", dict(warmup_steps=100)),
                                         ("warmup", dict(warmup_steps=0)),
                                         ("cosine", dict(decay_steps=100)),
                                         ("cosine", dict(decay_steps=100, eta_min=1e-5))])
def test_schedules_match_jax(name, kwargs):
    want = jsched.get_lr_schedule(name, 1e-3, **kwargs)
    got = lr_schedules.get_lr_schedule(name, 1e-3, **kwargs)
    for step in (0, 1, 50, 99, 100, 101, 500):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-10)


def test_schedule_drives_lambda_lr():
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1e-3)
    sched = lr_schedules.warmup_schedule(1e-3, warmup_steps=4)
    lam = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: sched(s) / 1e-3)
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lam.step()
    np.testing.assert_allclose(seen, [0.0, 2.5e-4, 5e-4, 7.5e-4, 1e-3, 1e-3])
    with pytest.raises(NotImplementedError):
        lr_schedules.get_lr_schedule("step", 1e-3)
