"""The port's ``DisparityTrainer`` (VideoDepthAnything) and
``FlowMatchingTrainer`` (Aether's DiT), and their batch builders, against
the JAX package's, on the CPU in f32.

* Each trainer's loss and every parameter gradient against the JAX
  trainer's ``_loss`` under ``jax.value_and_grad``, the same weights carried
  over by ``utils/weights.py`` (the gradients through it too), the same
  batch from a numpy seed and, for the flow trainer, the JAX draws (the
  logit-normal's normal and eps from ``jax.random.split(rng)``).  Sizes put
  the attentions on the port's differentiable kernel path (plain versions
  on the CPU): VDA at 128 x 256 (128 tokens a frame), the DiT over 2 latent
  frames of 16 x 32 at patch 2 (256 tokens).  The DiT's all-equal leaves
  (adaLN-zero's zero modulations and output projection, biases, norm
  scales) are perturbed on both sides, or most gradients would vanish.
  Then ``train_step`` given the JAX gradients against one optax ``adamw``
  update with the JAX trainer's optimizer.
* VideoDepthAnything's ReLUs (the DPT head's and the output's): a unit
  whose pre-activation lies within round-off of 0 can be gated on in one
  package and off in the other, and then its whole contribution moves a
  gradient (measured: 0.34% of the gradient's norm, elementwise up to 225x
  the limit below, with the loss equal to the last bit).  So the disparity
  trainer's gradients are held elementwise with every ReLU of both
  packages a softplus (then within 6e-6 of JAX's), and as it is norm-wise,
  all parameters together, within 1e-2.
* The disparity loss's per-frame alignment: its gradient through
  ``metrics/alignment.py::lstsq_scale_shift`` (the mean-centred closed
  form) is held against JAX's, not only its value.
* ``build_batch_disparity`` and ``build_batch_aether`` against the JAX
  builders of ``train.py`` on a synthetic clip (the same weights).
* The JAX package's own trainer tests, mirrored: the losses fall over
  repeated steps; an affine image of the GT disparity gives loss 0; the
  last raymap of an Aether batch recovers the clip's last GT pose.

Tolerances: the loss 1e-5 relative; each gradient 1e-4 of its own largest
magnitude plus 1e-5 of the model's largest gradient; the AdamW step 2^-22
plus 1e-6 lr (``tests/test_torch_trainers.py``'s); the batches 1e-5
relative (host arrays in f32: equal up to the f64 raymaps' last bit), the
Aether latents 1e-4 relative (the VAE encode, ``tests/test_torch_aether.py``'s
bound); the recovered pose 1e-4 absolute.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_trainers import LOSS_TOL, LR, hold_gradients, hold_optax_step, jax_step
from unigeo_tpu_torch.utils.weights import aether_state_dicts, pointmap_state_dict

B, T, H, W = 2, 3, 128, 256
# Aether: the tiny VAE and DiT; latents of 2 x 16 x 32 (256 DiT tokens)
NET = dict(width=32, depth=2, num_heads=2, patch=2, mlp_ratio=2)
VAE = dict(base_width=8, mults=(1, 1, 2), temporal_down=(False, True, False), z_channels=4)
ZC, TARGET = 4, 10
TL, HL, WL = 2, 16, 32
# VDA's gradients with its ReLUs, norm-wise (see the module docstring)
RELU_NORM_TOL = 1e-2


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def disparity_batch(seed=0, b=B, t=T, h=H, w=W):
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.uniform(size=(b, t, h, w, 3)).astype(np.float32),
        "gt_disp": rng.uniform(0.2, 2.0, size=(b, t, h, w)).astype(np.float32),
        "mask": (rng.uniform(size=(b, t, h, w)) > 0.2).astype(np.float32),
    }


def flow_batch(seed=2, b=B):
    rng = np.random.default_rng(seed)
    return {"target_latents": rng.standard_normal((b, TL, HL, WL, TARGET)).astype(np.float32),
            "cond_latents": rng.standard_normal((b, TL, HL, WL, ZC)).astype(np.float32)}


def perturbed(params, seed):
    """Every all-equal leaf (std 0) replaced by N(0, 0.2) draws."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf) if float(np.std(leaf)) > 0
        else rng.normal(0, 0.2, np.shape(leaf)).astype(np.float32),
        jax.device_get(params))


# --- the disparity trainer -----------------------------------------------------


@contextlib.contextmanager
def smooth_relu(on: bool):
    """Every ReLU of both packages' VDA (the DPT head's and the output's) a
    softplus while on."""
    if not on:
        yield
        return
    import flax.linen as fnn
    import torch.nn.functional as F

    saved = fnn.relu, F.relu, torch.relu
    fnn.relu = jax.nn.softplus
    F.relu = lambda x, inplace=False: F.softplus(x)
    torch.relu = F.softplus
    try:
        yield
    finally:
        fnn.relu, F.relu, torch.relu = saved


@functools.lru_cache(maxsize=None)
def jax_disparity(smooth=False):
    from unigeo_tpu.models.vda import VDANetwork, tiny_vda_config
    from unigeo_tpu.parallel.trainer import DisparityTrainer

    net = VDANetwork(**tiny_vda_config())
    params = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3))))
    with smooth_relu(smooth):
        loss, grads, after = jax_step(DisparityTrainer(net, mesh=None, learning_rate=LR), params,
                                      disparity_batch())
    return dict(params=params, loss=loss, grads=grads, after=after)


def port_disparity(smooth=False):
    from unigeo_tpu_torch.models.vda import VDANetwork, tiny_vda_config
    from unigeo_tpu_torch.parallel.trainer import DisparityTrainer

    ref = jax_disparity(smooth)
    net = VDANetwork(**tiny_vda_config())
    net.load_state_dict(pointmap_state_dict(ref["params"], net))
    return DisparityTrainer(net, learning_rate=LR), net, ref


# --- the flow trainer ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_flow():
    from unigeo_tpu.models.aether import AetherDiT
    from unigeo_tpu.parallel.trainer import FlowMatchingTrainer

    dit = AetherDiT(out_channels=TARGET, **NET)
    params = perturbed(jax.jit(dit.init)(jax.random.PRNGKey(2), jnp.zeros((TL, HL, WL, ZC + TARGET)),
                                         jnp.float32(1.0)), 4)
    rng = jax.random.PRNGKey(7)
    r_t, r_noise = jax.random.split(rng)
    draws = (np.array(jax.random.normal(r_t, (B,))),
             np.array(jax.random.normal(r_noise, (B, TL, HL, WL, TARGET), jnp.float32)))
    loss, grads, after = jax_step(FlowMatchingTrainer(dit, mesh=None, learning_rate=LR), params,
                                  flow_batch(), rng)
    return dict(params=params, loss=loss, grads=grads, after=after, draws=draws)


def port_flow():
    from unigeo_tpu_torch.models.aether import AetherDiT
    from unigeo_tpu_torch.parallel.trainer import FlowMatchingTrainer

    ref = jax_flow()
    dit = AetherDiT(ZC + TARGET, TARGET, **NET)
    dit.load_state_dict(aether_state_dicts(None, ref["params"], dit))
    return FlowMatchingTrainer(dit, learning_rate=LR), dit, ref


PORTS = {
    "disparity_smooth": (functools.partial(port_disparity, True), lambda ref: (),
                         lambda tree, m: pointmap_state_dict(tree, m), disparity_batch),
    "disparity": (port_disparity, lambda ref: (), lambda tree, m: pointmap_state_dict(tree, m),
                  disparity_batch),
    "flow": (port_flow, lambda ref: tuple(torch.from_numpy(d) for d in ref["draws"]),
             lambda tree, m: aether_state_dicts(None, tree, m), flow_batch),
}


@pytest.mark.parametrize("kind", ["disparity_smooth", "flow"])
def test_trainer_loss_and_gradients_match_jax(kind):
    build, draws, bridge, batch = PORTS[kind]
    trainer, module, ref = build()
    with smooth_relu(kind == "disparity_smooth"):
        loss = trainer.loss(batch(), *draws(ref))
        assert abs(loss.item() - ref["loss"]) <= LOSS_TOL * abs(ref["loss"]), (loss.item(),
                                                                               ref["loss"])
        loss.backward()
    hold_gradients(module.named_parameters(), bridge(ref["grads"], module))


def test_disparity_gradients_with_relu_gates_match_jax_normwise():
    """VDA as it is: the loss within LOSS_TOL, the gradients norm-wise (all
    parameters together) within RELU_NORM_TOL of JAX's."""
    trainer, module, ref = port_disparity()
    loss = trainer.loss(disparity_batch())
    assert abs(loss.item() - ref["loss"]) <= LOSS_TOL * abs(ref["loss"]), (loss.item(), ref["loss"])
    loss.backward()
    g_ref = pointmap_state_dict(ref["grads"], module)
    err = sum(((p.grad - g_ref[n]) ** 2).sum() for n, p in module.named_parameters()) ** 0.5
    norm = sum((g ** 2).sum() for g in g_ref.values()) ** 0.5
    assert (err / norm).item() <= RELU_NORM_TOL, (err / norm).item()


@pytest.mark.parametrize("kind", sorted(PORTS))
def test_trainer_step_matches_optax(kind):
    build, _, bridge, _ = PORTS[kind]
    trainer, module, ref = build()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    hold_optax_step(trainer, module, bridge(ref["grads"], module), ref["after"], before,
                    lambda tree: bridge(tree, module))


def test_disparity_alignment_gradient_matches_jax():
    """One clip's loss from a given prediction: value and gradient with
    respect to the prediction, through the per-frame least-squares fit."""
    from unigeo_tpu.parallel.trainer import DisparityTrainer as J
    from unigeo_tpu_torch.parallel.trainer import DisparityTrainer

    b = disparity_batch(3, b=1, t=4, h=8, w=8)
    pred = np.random.default_rng(4).uniform(0.5, 3.0, size=(4, 8, 8)).astype(np.float32)

    class Given:  # a network whose output is the argument
        def apply(self, p, f):
            return p

    ref, g_ref = jax.value_and_grad(
        lambda p: J(Given(), None)._loss(p, jax.tree.map(jnp.asarray, b)))(jnp.asarray(pred))
    trainer = DisparityTrainer(torch.nn.Linear(1, 1))
    tp = torch.from_numpy(pred).requires_grad_()
    ours = trainer.clip_loss(tp, torch.from_numpy(b["gt_disp"][0]), torch.from_numpy(b["mask"][0]))
    assert abs(ours.item() - float(ref)) <= 1e-6 * abs(float(ref))
    ours.backward()
    g_ref = np.asarray(g_ref)
    assert np.abs(tp.grad.numpy() - g_ref).max() <= 1e-5 * np.abs(g_ref).max()


# --- the JAX package's trainer tests, mirrored --------------------------------


def test_disparity_loss_falls_and_is_affine_invariant():
    from unigeo_tpu_torch.models.pointmap.adapter import build_network
    from unigeo_tpu_torch.models.vda import VDANetwork, tiny_vda_config
    from unigeo_tpu_torch.parallel.trainer import DisparityTrainer

    net = build_network(VDANetwork, tiny_vda_config(), torch.device("cpu")).requires_grad_(True)
    trainer = DisparityTrainer(net, learning_rate=3e-4)
    batch = disparity_batch(4, b=2, t=3, h=32, w=32)
    batch["mask"][:] = 1.0
    losses = [float(trainer.train_step(batch)) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    # the alignment absorbs any (s, b) applied to the prediction
    g, m = (torch.from_numpy(batch[k][0]) for k in ("gt_disp", "mask"))
    assert trainer.clip_loss(3.0 * g + 1.0, g, m).item() < 1e-5


def test_flow_loss_falls_over_repeated_steps():
    from unigeo_tpu_torch.models.aether import tiny_aether
    from unigeo_tpu_torch.parallel.trainer import FlowMatchingTrainer

    model = tiny_aether(device="cpu")
    trainer = FlowMatchingTrainer(model.network.dit.requires_grad_(True), learning_rate=1e-3)
    batch = flow_batch(2)
    batch = {k: v[:, :, :4, :4] for k, v in batch.items()}
    rng = np.random.default_rng(5)
    draws = [(torch.from_numpy(rng.standard_normal(2).astype(np.float32)),
              torch.from_numpy(rng.standard_normal(batch["target_latents"].shape)
                               .astype(np.float32))) for _ in range(3)]
    losses = [float(trainer.train_step(batch, *d)) for d in draws]
    assert all(np.isfinite(losses)) and trainer.step == 3
    # the first draw again gives a lower loss than at step 0
    assert float(trainer.train_step(batch, *draws[0])) < losses[0]


# --- the batch builders --------------------------------------------------------


def synthetic_clip(t=5, size=64):
    from unigeo_tpu.data.synthetic import SyntheticBoxDataset

    return SyntheticBoxDataset(clip_length=t, clip_overlap=0, num_scenes=1, frames_per_scene=t,
                               render_size=(size, size))[0]


def test_build_batch_disparity_matches_jax():
    from train import build_batch_disparity as jax_build
    from unigeo_tpu_torch.train import build_batch_disparity

    samples = [synthetic_clip(3), synthetic_clip(3)]
    ref, ours = jax_build(samples), build_batch_disparity(samples)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], ref[k]), k


@functools.lru_cache(maxsize=None)
def aether_pair(size=64, frames=5):
    """The JAX tiny Aether and the port's with its weights."""
    from unigeo_tpu.models.aether import tiny_aether as jax_tiny
    from unigeo_tpu_torch.models.aether import tiny_aether

    jmodel = jax_tiny(height=size, width=size, frames=frames)
    model = tiny_aether(device="cpu")
    model.network.load_state_dict(
        aether_state_dicts(jax.device_get(jmodel.vae_params), jax.device_get(jmodel.dit_params),
                           model))
    return jmodel, model


def test_build_batch_aether_matches_jax_and_recovers_the_last_pose():
    """The JAX package's batch-contract test on the port, and the batch
    against JAX's (5 frames at ct 2: a pad of one)."""
    from train import build_batch_aether as jax_build
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.models.aether import pose_from_raymap
    from unigeo_tpu_torch.train import build_batch_aether

    jmodel, model = aether_pair()
    data = synthetic_clip(5)
    batch = build_batch_aether([data], model)
    ct, cs = model.network.ct, model.network.cs
    tl = (5 + (-5) % ct) // ct
    assert batch["cond_latents"].shape == (1, tl, 64 // cs, 64 // cs, ZC)
    assert batch["target_latents"].shape == (1, tl, 64 // cs, 64 // cs, TARGET)
    ref = jax_build([data], jmodel)
    for k in ref:
        assert rel_dev(batch[k].numpy(), ref[k]) < 1e-4, k
    raymaps = batch["target_latents"][0, ..., ZC:].numpy()
    assert rel_dev(raymaps, ref["target_latents"][0, ..., ZC:]) < 1e-5
    # the last raymap encodes the clip's last GT pose (its key time is t - 1)
    intr_lat = np.diag([1.0 / cs, 1.0 / cs, 1.0]) @ np.asarray(data["intrinsics"][0])
    rec = pose_from_raymap(raymaps[-1], intr_lat)
    np.testing.assert_allclose(rec, prepare_gt_label(data)["gt_poses"][-1], atol=1e-4)
