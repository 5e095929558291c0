"""The port's training path against the JAX package, on the CPU in f32.

* The scheduler's training side (add_noise, v_target, the two timestep
  branches) against the JAX scheduler and trainer formulas.
* One ``DiffusionTrainer`` loss and every parameter gradient against the
  JAX ``DiffusionTrainer._loss`` under ``jax.value_and_grad``, with the same
  draws (the JAX ones, from ``jax.random.split(rng)``) and the same random
  weights (through ``state_dict_from_flax``; the gradients go through it
  too, being the same tree); and ``train_step`` given the JAX gradients
  against one optax ``adamw`` update.  The UNet is tests/test_training.py's 2-stage
  micro config; latents of 16 x 8 give the first stage 128 tokens, so its
  spatial attention runs the port's differentiable kernel path
  (``FlashAttentionPacked``, plain versions on the CPU) against JAX autodiff
  through ``attention_reference``.
* The loss falls over repeated steps on one batch.
* ``train.main`` runs two steps of a tiny synthetic config on the CPU and
  saves the final state; on a one-rank ``--mesh`` its first step is the
  same.

Tolerances (f32 on both sides; only the order of sums in the convolutions,
matmuls and reductions differs):
  * loss: 1e-5 relative;
  * each gradient: 1e-4 of its own largest magnitude (the backward runs
    through the whole network, ~10x the depth of the forward's 1e-5
    single-layer bound) plus 1e-5 of the largest gradient of the model.
    The second term is for gradients that are zero in exact arithmetic and
    round-off in both versions: a bias followed by a group norm, which
    removes any per-channel constant (time_emb_proj, conv1.bias), gets
    ~1e-9 against a largest gradient of ~0.1;
  * parameters after the AdamW step, given the same gradients: 2^-22
    absolute (one or two f32 ulps of weights below 1) plus 1e-6 lr (the
    update computed in another order).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from unigeo_tpu.models.depthcrafter.scheduler import EulerDiscreteScheduler as JaxScheduler
from unigeo_tpu.models.depthcrafter.unet import UNetSpatioTemporal as JaxUNet
from unigeo_tpu.parallel.trainer import DiffusionTrainer as JaxTrainer
from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_
from unigeo_tpu_torch.models.depthcrafter.scheduler import (
    EulerDiscreteConfig,
    EulerDiscreteScheduler,
)
from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal, tiny_unet_config
from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer
from unigeo_tpu_torch.utils.weights import state_dict_from_flax, unet_flax_path

MICRO = dict(tiny_unet_config(), block_out_channels=(16, 24), num_attention_heads=(1, 1))
B, T, HL, WL = 2, 2, 16, 8
LR = 1e-3
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5
STEP_TOL = 2.0**-22 + 1e-6 * LR


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "latents": rng.standard_normal((B, T, HL, WL, 4)).astype(np.float32),
        "cond_latents": rng.standard_normal((B, T, HL, WL, 4)).astype(np.float32),
        "context": rng.standard_normal((B, T, 1, MICRO["cross_attention_dim"])).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --- scheduler ----------------------------------------------------------------


def test_scheduler_training_side_matches_jax():
    rng = np.random.default_rng(1)
    clean = rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(clean.shape).astype(np.float32)
    sigma = np.exp(0.7 + 1.6 * rng.standard_normal((3, 1, 1, 1, 1))).astype(np.float32)
    sj, st = JaxScheduler(), EulerDiscreteScheduler()
    tc, tn, ts = (torch.from_numpy(a) for a in (clean, noise, sigma))
    for ours, ref in (
        (st.add_noise(tc, tn, ts), sj.add_noise(clean, noise, sigma)),
        (st.v_target(tc, tn, ts), sj.v_target(jnp.asarray(clean), jnp.asarray(noise),
                                              jnp.asarray(sigma))),
        (st.scale_model_input(tc, ts), sj.scale_model_input(jnp.asarray(clean),
                                                            jnp.asarray(sigma))),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

    # both timestep branches of trainer.py:94-104, sigmas inside and outside
    # the train table (the discrete branch clamps at its ends)
    flat = np.concatenate([sigma[:, 0, 0, 0, 0], [1e-3, 200.0]]).astype(np.float32)
    cont = 0.25 * np.log(flat)
    disc = jnp.interp(jnp.log(jnp.asarray(flat)),
                      jnp.log(jnp.asarray(sj.train_sigmas, jnp.float32)),
                      jnp.arange(sj.config.num_train_timesteps, dtype=jnp.float32))
    ours_c = st.train_timesteps(torch.from_numpy(flat))
    ours_d = EulerDiscreteScheduler(EulerDiscreteConfig(timestep_type="discrete")) \
        .train_timesteps(torch.from_numpy(flat))
    np.testing.assert_allclose(ours_c.numpy(), cont, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours_d.numpy(), np.asarray(disc), rtol=1e-5, atol=1e-3)


# --- one step against JAX -----------------------------------------------------


def _random_params(shapes, seed=0):
    """Random weights for a flax parameter tree of ``shapes``: lecun-normal
    kernels, and biases, norm scales and mix factors drawn around their
    initial values so that none is zero (a zero bias would hide a transposed
    or misrouted one).  Drawn with numpy: no init program to compile."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            return (std * rng.standard_normal(shape)).astype(np.float32)
        base = {"scale": 1.0, "mix_factor": 0.5}.get(name, 0.0)
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_step():
    """The JAX loss, gradients and one optax step on the micro UNet, and the
    draws it used (all jitted: the eager value_and_grad takes minutes)."""
    unet = JaxUNet(**MICRO)
    ctx_dim = MICRO["cross_attention_dim"]
    shapes = jax.eval_shape(
        lambda key: unet.init(key, jnp.zeros((B * T, HL, WL, 8)), jnp.zeros((B,)),
                              jnp.zeros((B * T, 1, ctx_dim)), jnp.zeros((B, 3)), T),
        jax.random.PRNGKey(0),
    )["params"]
    params = _random_params(shapes)
    trainer = JaxTrainer(unet, mesh=None, learning_rate=LR)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    rng = jax.random.PRNGKey(7)
    r_sigma, r_noise = jax.random.split(rng)
    n = jax.random.normal(r_sigma, (B, 1, 1, 1, 1))
    noise = jax.random.normal(r_noise, batch["latents"].shape, jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(trainer._loss), static_argnums=3)(
        params, batch, rng, T)

    @jax.jit
    def adamw_step(params, grads):
        updates, _ = trainer.optimizer.update(grads, trainer.optimizer.init(params), params)
        return optax.apply_updates(params, updates)

    after = adamw_step(params, grads)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return dict(params=params, grads=to_np(grads), after=to_np(after),
                loss=float(loss), n=np.array(n), noise=np.array(noise))


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step()


def _port_trainer(params):
    unet = UNetSpatioTemporal(**MICRO)
    unet.load_state_dict(state_dict_from_flax(params, unet, unet_flax_path), strict=True)
    return DiffusionTrainer(unet, learning_rate=LR)


def test_trainer_loss_and_gradients_match_jax(jax_step):
    trainer = _port_trainer(jax_step["params"])
    loss = trainer.loss(_torch_batch(_batch()), torch.from_numpy(jax_step["n"]),
                        torch.from_numpy(jax_step["noise"]))
    assert abs(loss.item() - jax_step["loss"]) <= LOSS_TOL * abs(jax_step["loss"])
    loss.backward()
    ref = state_dict_from_flax(jax_step["grads"], trainer.unet, unet_flax_path)
    g_all = max(v.abs().max().item() for v in ref.values())
    worst = {}
    for name, p in trainer.unet.named_parameters():
        g_ref = ref[name]
        if not torch.any(g_ref):
            # to_q / to_k of the single-key cross-attentions: JAX gives them
            # zeros, the port computes neither projection
            assert p.grad is None, name
            continue
        limit = GRAD_TOL * g_ref.abs().max().item() + GRAD_FLOOR * g_all
        worst[name] = (p.grad - g_ref).abs().max().item() / limit
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    # the spatial attention (128 tokens) ran the differentiable kernel path
    # and its projections got gradients through it
    to_q = trainer.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q.weight
    assert torch.any(to_q.grad != 0)


def test_trainer_step_matches_optax(jax_step):
    """The port's train_step, its loss's gradients replaced by the JAX ones,
    against one optax adamw update: the same decay (also of the cross-
    attention projections that get no gradient), moments, bias corrections
    and eps."""
    trainer = _port_trainer(jax_step["params"])
    ref_grads = state_dict_from_flax(jax_step["grads"], trainer.unet, unet_flax_path)
    named = dict(trainer.unet.named_parameters())

    def surrogate(*_args, **_kw):  # its gradient is the JAX gradient
        return sum((named[k] * g).sum() for k, g in ref_grads.items() if torch.any(g))

    trainer.loss = surrogate
    trainer.train_step(_torch_batch(_batch()))
    ref = state_dict_from_flax(jax_step["after"], trainer.unet, unet_flax_path)
    before = state_dict_from_flax(jax_step["params"], trainer.unet, unet_flax_path)
    for name, p in named.items():
        assert (p.detach() - ref[name]).abs().max().item() <= STEP_TOL, name
        # every parameter moved, also those without a gradient (decay)
        assert not torch.equal(p.detach(), before[name]), name


def test_trainer_loss_falls_over_repeated_steps():
    torch.manual_seed(0)
    unet = init_random_(UNetSpatioTemporal(**MICRO), torch.Generator().manual_seed(0))
    trainer = DiffusionTrainer(unet, learning_rate=1e-3)
    batch = _torch_batch(_batch(3))
    rng = np.random.default_rng(4)
    draws = [(torch.from_numpy(rng.standard_normal((B, 1, 1, 1, 1)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((B, T, HL, WL, 4)).astype(np.float32)))
             for _ in range(3)]
    losses = [float(trainer.train_step(batch, *d)) for d in draws]
    assert all(np.isfinite(losses)) and trainer.step == 3
    # the draws vary the loss from step to step; the first draw again must
    # give a lower loss than it did at step 0
    assert float(trainer.train_step(batch, *draws[0])) < losses[0]


def test_train_main_runs_on_the_cpu(tmp_path):
    from unigeo_tpu_torch import train

    # 128 x 128 frames: 256 latent tokens at the first stage (the kernel
    # path) and 4 at the last (a single-token attention would give to_q no
    # gradient in exact arithmetic)
    config = dict(
        dataset="SyntheticBoxDataset", root=None, h=128, w=128, clip_length=2,
        clip_overlap=0, split="test", model_name="DepthCrafter",
        dataset_params=dict(render_size=[128, 128], num_scenes=1, frames_per_scene=4),
    )
    out = train.main(["--device", "cpu", "--tiny", "--steps", "2",
                      "--log-dir", str(tmp_path), "--ckpt-dir", str(tmp_path / "ckpts")],
                     config=config)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert (tmp_path / "events.jsonl").exists()
    unet = out["trainer"].unet
    to_q = [p for n, p in unet.named_parameters()
            if n.endswith("transformer_blocks.0.attn1.to_q.weight")]
    assert to_q and all(torch.any(p.grad != 0) for p in to_q)
    # VAE and CLIP stay frozen
    pipe = out["pipe"]
    assert not any(p.requires_grad for m in (pipe.vae, pipe.clip) for p in m.parameters())
    # the final state is saved (fewer steps than --ckpt-every); a one-rank
    # mesh is accepted and its step is the one-device step
    assert out["checkpoints"] == [str(tmp_path / "ckpts" / "state-iter-000000002")]
    meshed = train.main(["--device", "cpu", "--tiny", "--steps", "1", "--mesh", "1,1,1",
                         "--ckpt-every", "0", "--log-dir", str(tmp_path / "mesh")],
                        config=config)
    assert meshed["mesh"] is not None and meshed["losses"] == out["losses"][:1]
