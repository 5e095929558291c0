"""The port's pointmap trainers (``PointmapTrainer`` for Spann3R and Cut3R,
``Dust3RTrainer``) and their losses against the JAX package's, on the CPU
in f32.

* ``normalize_by_avg_dis``, ``pointmap_regression_loss`` (with and without
  confidences, ``normalize`` on and off) and ``pose_loss`` against the JAX
  functions, values and gradients.
* Each trainer's loss and every parameter gradient against the JAX
  trainer's ``_loss`` under ``jax.value_and_grad``, the same weights carried
  over by ``utils/weights.py::pointmap_state_dict`` (the gradients through
  it too, being the same tree) and the same batch (two clips of three
  128 x 256 frames from a numpy seed: 128 tokens at patch 16, so every
  attention runs the port's differentiable kernel path, plain versions on
  the CPU; a mask with holes; random GT rotations for Cut3R's pose loss);
  then ``train_step`` given the JAX gradients against one optax ``adamw``
  update with the JAX trainer's optimizer (its weight decay, 5e-2, is the
  family's default).
* The JAX package's own trainer tests, mirrored: the loss falls over
  repeated steps on one batch; a perfect prediction gives loss 0.

Tolerances (f32 on both sides; sums in another order, and the port's masked
means summed in f64):
  * the loss functions: 1e-6 relative (values), gradients 1e-5 of their
    largest magnitude;
  * a trainer's loss: 1e-5 relative;
  * each gradient: 1e-4 of its own largest magnitude plus 1e-5 of the
    model's largest gradient (the bounds of ``tests/test_torch_training.py``;
    the backward runs through the whole network and its recurrence);
  * parameters after the AdamW step, given the same gradients: 2^-22
    absolute plus 1e-6 lr.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from unigeo_tpu_torch.utils.weights import pointmap_state_dict

B, T, H, W = 2, 3, 128, 256
LR = 1e-3
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5
STEP_TOL = 2.0**-22 + 1e-6 * LR
FN_TOL = 1e-6


def random_rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q * np.linalg.det(q)[:, None, None]


def pointmap_batch(seed=0, b=B, t=T, h=H, w=W):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (b, t, 1, 1))
    poses[..., :3, :3] = random_rotations(rng, b * t).reshape(b, t, 3, 3)
    poses[..., :3, 3] = rng.standard_normal((b, t, 3))
    return {
        "frames": rng.uniform(size=(b, t, h, w, 3)).astype(np.float32),
        "gt_world_pts": (rng.standard_normal((b, t, h, w, 3)) + [0, 0, 2.0]).astype(np.float32),
        "mask": (rng.uniform(size=(b, t, h, w)) > 0.2).astype(np.float32),
        "gt_poses": poses.astype(np.float32),
    }


def jax_step(trainer, params, batch, *extra):
    """(loss, gradients, parameters after one optax step) of a JAX trainer,
    all as numpy (jitted: an eager value_and_grad takes minutes)."""
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(trainer._loss))(params, jb, *extra)

    @jax.jit
    def adamw_step(p, g):
        updates, _ = trainer.optimizer.update(g, trainer.optimizer.init(p), p)
        return optax.apply_updates(p, updates)

    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return float(loss), to_np(grads), to_np(adamw_step(params, grads))


def hold_gradients(named, ref):
    """Every parameter's gradient against the reference state dict ``ref``
    (a parameter the loss does not reach has no .grad; JAX gives it zeros)."""
    g_all = max(v.abs().max().item() for v in ref.values())
    worst = {}
    for name, p in named:
        g_ref = ref[name]
        if p.grad is None:
            assert not torch.any(g_ref), name
            continue
        limit = GRAD_TOL * g_ref.abs().max().item() + GRAD_FLOOR * g_all
        worst[name] = (p.grad - g_ref).abs().max().item() / limit
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:5]


def hold_optax_step(trainer, module, ref_grads, ref_after, before, bridge):
    """``train_step`` with the JAX gradients (a surrogate loss) against the
    optax step: the same decay, moments, bias corrections and eps."""
    named = dict(module.named_parameters())

    def surrogate(*_args, **_kw):  # its gradient is the JAX gradient
        return sum((named[k] * g).sum() for k, g in ref_grads.items() if torch.any(g))

    trainer.loss = surrogate
    trainer.train_step({})
    ref = bridge(ref_after)
    for name, p in named.items():
        assert (p.detach() - ref[name]).abs().max().item() <= STEP_TOL, name
        # a gradient or the decay moves every parameter that is not 0 and
        # has none (Cut3R's self head, which the loss does not read)
        if torch.any(before[name] != 0) or torch.any(ref_grads[name] != 0):
            assert not torch.equal(p.detach(), before[name]), name


# --- the loss functions --------------------------------------------------------


@pytest.mark.parametrize("conf,normalize", [(False, True), (True, True), (True, False)])
def test_pointmap_regression_loss_matches_jax(conf, normalize):
    from unigeo_tpu.models.pointmap.losses import pointmap_regression_loss as jloss
    from unigeo_tpu_torch.models.pointmap.losses import pointmap_regression_loss

    rng = np.random.default_rng(3)
    pred = rng.standard_normal((2, 3, 8, 8, 3)).astype(np.float32)
    gt = (rng.standard_normal((2, 3, 8, 8, 3)) + 1.0).astype(np.float32)
    valid = (rng.uniform(size=(2, 3, 8, 8)) > 0.3).astype(np.float32)
    cf = (1.0 + np.exp(rng.standard_normal((2, 3, 8, 8)))).astype(np.float32) if conf else None
    fn = lambda p, c: jloss(p, jnp.asarray(gt), jnp.asarray(valid), c, 0.2, normalize)
    ref, (g_p, g_c) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(pred), None if cf is None else jnp.asarray(cf))
    tp = torch.from_numpy(pred).requires_grad_()
    tc = None if cf is None else torch.from_numpy(cf).requires_grad_()
    ours = pointmap_regression_loss(tp, torch.from_numpy(gt), torch.from_numpy(valid), tc, 0.2,
                                    normalize)
    assert abs(ours.item() - float(ref)) <= FN_TOL * abs(float(ref))
    ours.backward()
    for t, g in ((tp, g_p), (tc, g_c)):
        if t is not None:
            g = np.asarray(g)
            assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_normalize_by_avg_dis_and_pose_loss_match_jax():
    from unigeo_tpu.models.pointmap.losses import normalize_by_avg_dis as jnorm, pose_loss as jpose
    from unigeo_tpu_torch.models.pointmap.losses import normalize_by_avg_dis, pose_loss

    rng = np.random.default_rng(4)
    pts = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    valid = (rng.uniform(size=(3, 8, 8)) > 0.3).astype(np.float32)
    ref_pts, ref_f = jnorm(jnp.asarray(pts), jnp.asarray(valid))
    ours_pts, ours_f = normalize_by_avg_dis(torch.from_numpy(pts), torch.from_numpy(valid))
    assert abs(ours_f.item() - float(ref_f)) <= FN_TOL * float(ref_f)
    assert np.abs(ours_pts.numpy() - np.asarray(ref_pts)).max() <= FN_TOL * np.abs(ref_pts).max()

    poses = pointmap_batch(5, b=1, t=6, h=2, w=2)["gt_poses"][0]
    enc = rng.standard_normal((6, 7)).astype(np.float32)
    enc[:3, 3:] *= -1.0  # some quaternions on the other sheet of the cover
    ref, g = jax.value_and_grad(lambda e: jpose(e, jnp.asarray(poses)))(jnp.asarray(enc))
    te = torch.from_numpy(enc).requires_grad_()
    ours = pose_loss(te, torch.from_numpy(poses))
    assert abs(ours.item() - float(ref)) <= FN_TOL * abs(float(ref))
    ours.backward()
    assert np.abs(te.grad.numpy() - np.asarray(g)).max() <= 1e-5 * np.abs(np.asarray(g)).max()


def test_pointmap_loss_perfect_prediction_zero():
    from unigeo_tpu_torch.models.pointmap.losses import pointmap_regression_loss

    pts = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32))
    valid = torch.ones((2, 8, 8))
    assert pointmap_regression_loss(pts, pts, valid, None).item() < 1e-6
    # with confidence 1 everywhere the log term vanishes
    assert pointmap_regression_loss(pts, pts, valid, torch.ones((2, 8, 8))).item() < 1e-5


# --- the trainers against JAX ----------------------------------------------------

FAMILIES = ("Spann3R", "Cut3R", "Dust3R")


def family(name):
    """(JAX network class, its tiny config, JAX trainer class, port network
    class, port trainer class)."""
    from unigeo_tpu.parallel import trainer as jt
    from unigeo_tpu_torch.parallel import trainer as pt

    if name == "Spann3R":
        from unigeo_tpu.models.pointmap.spann3r import Spann3RNetwork as J, tiny_spann3r_config
        from unigeo_tpu_torch.models.pointmap.spann3r import Spann3RNetwork as P
        return J, tiny_spann3r_config(), jt.PointmapTrainer, P, pt.PointmapTrainer
    if name == "Cut3R":
        from unigeo_tpu.models.pointmap.cut3r import Cut3RNetwork as J, tiny_cut3r_config
        from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork as P
        return J, tiny_cut3r_config(), jt.PointmapTrainer, P, pt.PointmapTrainer
    from unigeo_tpu.models.pointmap.dust3r import Dust3RNetwork as J, tiny_dust3r_config
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork as P
    return J, tiny_dust3r_config(), jt.Dust3RTrainer, P, pt.Dust3RTrainer


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """The JAX network's params (init at seed 0), and its trainer's loss,
    gradients and one optax step on pointmap_batch()."""
    jnet_cls, cfg, jtrainer_cls, _, _ = family(name)
    jnet = jnet_cls(**cfg)
    if name == "Dust3R":  # the pair signature
        zero = jnp.zeros((1, H, W, 3))
        params = jax.jit(jnet.init)(jax.random.PRNGKey(0), zero, zero)
    else:
        params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)))
    params = jax.device_get(params)
    loss, grads, after = jax_step(jtrainer_cls(jnet, mesh=None, learning_rate=LR), params,
                                  pointmap_batch())
    return dict(params=params, loss=loss, grads=grads, after=after)


def port_trainer(name):
    _, cfg, _, net_cls, trainer_cls = family(name)
    ref = jax_reference(name)
    net = net_cls(**cfg)
    net.load_state_dict(pointmap_state_dict(ref["params"], net))
    return trainer_cls(net, learning_rate=LR), net, ref


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_loss_and_gradients_match_jax(name):
    trainer, net, ref = port_trainer(name)
    loss = trainer.loss(pointmap_batch())
    assert abs(loss.item() - ref["loss"]) <= LOSS_TOL * abs(ref["loss"]), (loss.item(), ref["loss"])
    loss.backward()
    hold_gradients(net.named_parameters(), pointmap_state_dict(ref["grads"], net))
    if name == "Cut3R":  # the pose head trains through the pose loss
        assert all(p.grad is not None and torch.any(p.grad != 0)
                   for p in net.head_pose.parameters())


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_step_matches_optax(name):
    trainer, net, ref = port_trainer(name)
    bridge = lambda tree: pointmap_state_dict(tree, net)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    hold_optax_step(trainer, net, bridge(ref["grads"]), ref["after"], before, bridge)


def test_trainer_defaults_match_jax():
    from unigeo_tpu.parallel import trainer as jt
    from unigeo_tpu_torch.parallel import trainer as pt

    net = torch.nn.Linear(2, 2)
    for jcls, pcls, wd in ((jt.PointmapTrainer, pt.PointmapTrainer, 5e-2),
                           (jt.Dust3RTrainer, pt.Dust3RTrainer, 5e-2),
                           (jt.DisparityTrainer, pt.DisparityTrainer, 1e-2),
                           (jt.FlowMatchingTrainer, pt.FlowMatchingTrainer, 1e-2),
                           (jt.DiffusionTrainer, pt.DiffusionTrainer, 1e-2)):
        ours = pcls(net)
        group = ours.optimizer.param_groups[0]
        assert group["weight_decay"] == wd and group["betas"] == (0.9, 0.999), pcls
        assert group["eps"] == 1e-8, pcls
        j = jcls(None, None)
        for key in ("conf_alpha", "pose_weight", "temporal_weight"):
            if hasattr(j, key):
                assert getattr(ours, key) == getattr(j, key), (pcls, key)


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_loss_falls_over_repeated_steps(name):
    """The JAX package's tests/test_training.py, on the port: four steps on
    one batch (32 x 32 frames), the loss falls."""
    from unigeo_tpu_torch.models.pointmap.adapter import build_network

    _, cfg, _, net_cls, trainer_cls = family(name)
    net = build_network(net_cls, cfg, torch.device("cpu"), seed=0).requires_grad_(True)
    trainer = trainer_cls(net, learning_rate=3e-4)
    batch = pointmap_batch(1, b=2, t=3, h=32, w=32)
    batch["mask"][:] = 1.0
    losses = [float(trainer.train_step(batch)) for _ in range(4)]
    assert all(np.isfinite(losses)) and trainer.step == 4
    assert losses[-1] < losses[0], losses
