"""The port's trainers on a dp / sp / tp mesh over gloo ranks on the CPU
(``unigeo_tpu_torch/parallel/trainer.py`` on ``parallel/comm.py``'s
differentiable collectives and ``parallel/sharding.py::parallelize``),
against the port's one-process step, the JAX package's
``DiffusionTrainer._loss`` and formulas, at the tiny f32 configs.

Weights: the JAX package's parameter trees (the micro UNet's
``_random_params`` of ``tests/test_torch_training.py``; for the DiT, Cut3R,
Dust3R and VDA the JAX init's tree from ``jax.eval_shape`` with the same
numpy draws), carried over by ``utils/weights.py``.  Two launches of
``parallel/launch.py::run_ranks`` (``tests/torch_parallel_train_ranks.py``
holds the rank functions), each once per module:

  * 2 ranks: every differentiable collective's forward and backward against
    its formula; ``gather_params(parallelize(m))`` bitwise ``m.state_dict()``
    at tp 2 (UNet, DiT, Cut3R, VDA); one step of every family on dp 2 (the
    diffusion family also on sp 2; it, the flow, Dust3R and disparity
    families on tp 2) against the one-process step;
    four planted faults; ``train.main --mesh`` for one name of each family,
    a tp 2 checkpoint, and its refusals; ``ShardedClipExecutor`` on (1, 1, 2)
    (the tiny pipeline's weights from the port's seeded init: the executor
    is held against the port's serial path);
  * 4 ranks: the collectives, the placement at tp 4, the diffusion step on
    (1, 2, 2).

Bounds (``tests/test_torch_training.py``'s; f32 on both sides, sums in
another order):

  * loss: 1e-5 relative;
  * each gradient: 1e-4 of its own largest magnitude plus 1e-5 of the
    model's largest gradient (JAX's gradients for the diffusion family, the
    one-process step's for every family);
  * the parameters after AdamW against the one-process optimizer given the
    mesh's gradients: 2^-22 absolute plus 1e-6 lr;
  * the collectives: 1e-12 (f64, sums of a few terms);
  * a checkpoint written on a tp 2 mesh against the one-process run's: the
    AdamW bound plus lr times the difference of AdamW's first-step
    directions g / (|g| + eps) of the two runs' gradients (a gradient that
    is 0 in exact arithmetic is round-off in both runs, and AdamW's first
    step scales it to a size of its own); the gradients within the gradient
    bound;
  * the tp executor against the serial ``run_window_staged``: 1e-3 of the
    largest magnitude (``tests/test_torch_parallel_ranks.py``'s dp bound
    against JAX).

Planted faults, each of which must miss its loss or gradient bound by 10x
or more (measured, loss / gradients: the sp gather's backward sliced, the
tp form, 0x / 2.27e3x; the tp gather's backward summed, the sp form,
0.009x / 1.43e6x; a row-parallel bias added before the reduce 38.6x /
2.62e3x; ``PointmapTrainer`` averaging its ranks' local losses 7.28x /
64.5x).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu_torch.parallel.launch import run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

import torch_parallel_train_ranks as ranks  # noqa: E402
from test_torch_training import (  # noqa: E402
    GRAD_FLOOR,
    GRAD_TOL,
    LOSS_TOL,
    MICRO,
    STEP_TOL,
    _batch,
    _jax_step,
    _random_params,
)

LR = ranks.LR
LAUNCH_TIMEOUT = 240
COLL_TOL = 1e-12
EXECUTOR_TOL = 1e-3
FAULT_FACTOR = 10.0
FLOW = dict(net=dict(width=32, depth=2, num_heads=2, patch=2, mlp_ratio=2), zc=4, target=10)
H = W = 64
CLI_CONFIG = dict(dataset="SyntheticBoxDataset", root=None, h=H, w=W, clip_length=2,
                  clip_overlap=0, split="test", model_name="DepthCrafter",
                  dataset_params=dict(render_size=[H, W], num_scenes=1, frames_per_scene=4))
# one name of each family: (name, mesh, extra flags)
CLI_NAMES = [("DepthCrafter", "1,2,1", []), ("Aether", "2,1,1", ["--batch-size", "2"]),
             ("Cut3R", "2,1,1", ["--batch-size", "2"]), ("Dust3R", "1,1,2", []),
             ("VideoDepthAnything", "2,1,1", ["--batch-size", "2"])]
# the checkpoint's run: Cut3R on tp 2 (its attention, MLPs and pose head
# paired, its DPT-free heads generic)
CKPT_RUN = ("Cut3R", "1,1,2")
CLI_REFUSALS = {"frames": ("1,2,1", {"clip_length": 3}, []),
                "batch": ("2,1,1", {}, ["--batch-size", "3"]),
                "mesh": ("2,2,1", {}, [])}
CLI_REFUSED = {"frames": "3 frames (T) do not split over sp = 2",
               "batch": "--batch-size: 3 clips (B) do not split over dp = 2",
               "mesh": "mesh shape (2, 2, 1) != 2 devices"}
DP, SP, TP, SPTP = (2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2)
TWO_STEPS = [(f, DP, None) for f in ("diffusion", "flow", "pointmap", "dust3r", "disparity")] + [
    ("diffusion", SP, None)] + [(f, TP, None) for f in ("diffusion", "flow", "dust3r",
                                                         "disparity")] + [
    ("diffusion", SP, "sp_gather_sliced"), ("diffusion", TP, "tp_gather_summed"),
    ("diffusion", TP, "bias_before_reduce"), ("pointmap", DP, "pointmap_local_losses")]
FOUR_STEPS = [("diffusion", SPTP, None)]


def jax_tree_params(net, *example):
    """Parameters for the JAX network ``net`` of the shapes its init gives
    ``example`` (traced by ``jax.eval_shape``, nothing compiled), drawn
    with numpy as ``_random_params`` draws them."""
    shapes = jax.eval_shape(lambda key: net.init(key, *example), jax.random.PRNGKey(0))
    return _random_params(shapes["params"], seed=3)


def np_sd(sd):
    return {k: np.asarray(v.detach().numpy() if torch.is_tensor(v) else v) for k, v in sd.items()}


def pointmap_batch(b=2, t=3, h=32, w=32, seed=5):
    from test_torch_trainers import pointmap_batch as make

    return make(seed, b=b, t=t, h=h, w=w)


@pytest.fixture(scope="module")
def jax_micro():
    return _jax_step()


@pytest.fixture(scope="module")
def job(jax_micro):
    from unigeo_tpu.models.aether import AetherDiT as JDiT
    from unigeo_tpu.models.pointmap.cut3r import Cut3RNetwork as JCut3R
    from unigeo_tpu.models.pointmap.dust3r import Dust3RNetwork as JDust3R
    from unigeo_tpu.models.vda import VDANetwork as JVDA
    from unigeo_tpu.models.pointmap.cut3r import tiny_cut3r_config
    from unigeo_tpu.models.pointmap.dust3r import tiny_dust3r_config
    from unigeo_tpu.models.vda import tiny_vda_config
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal
    from unigeo_tpu_torch.utils.weights import (
        aether_state_dicts,
        pointmap_state_dict,
        state_dict_from_flax,
        unet_flax_path,
    )

    net_cfg, zc, target = FLOW["net"], FLOW["zc"], FLOW["target"]
    job = dict(micro=MICRO, flow_cfg=FLOW)
    job["unet"] = np_sd(state_dict_from_flax(jax_micro["params"], UNetSpatioTemporal(**MICRO),
                                             unet_flax_path))
    dit_params = jax_tree_params(JDiT(out_channels=target, **net_cfg),
                                 jnp.zeros((2, 16, 32, zc + target)), jnp.float32(1.0))
    job["dit"] = np_sd(aether_state_dicts(None, dit_params, _port_dit()))
    frames = jnp.zeros((2, 32, 32, 3))
    trees = {"Cut3R": jax_tree_params(JCut3R(**tiny_cut3r_config()), frames),
             "Dust3R": jax_tree_params(JDust3R(**tiny_dust3r_config()), frames[:1], frames[:1]),
             "VDA": jax_tree_params(JVDA(**tiny_vda_config()), frames)}
    job["nets"] = {name: np_sd(pointmap_state_dict(tree, _port_network(name)))
                   for name, tree in trees.items()}
    rng = np.random.default_rng(6)
    pm = pointmap_batch()
    job["batches"] = {
        "diffusion": _batch(), "pointmap": pm, "dust3r": pm,
        "flow": {"target_latents": rng.standard_normal((2, 2, 16, 32, target)).astype(np.float32),
                 "cond_latents": rng.standard_normal((2, 2, 16, 32, zc)).astype(np.float32)},
        "disparity": {"frames": pm["frames"],
                      "gt_disp": rng.uniform(0.2, 2.0, size=(2, 3, 32, 32)).astype(np.float32),
                      "mask": pm["mask"]},
    }
    job["draws"] = {"diffusion": (jax_micro["n"], jax_micro["noise"]),
                    "flow": (rng.standard_normal((2,)).astype(np.float32),
                             rng.standard_normal((2, 2, 16, 32, target)).astype(np.float32))}
    clip_rng = np.random.default_rng(7)
    job["tp_clips"] = dict(frames=clip_rng.uniform(size=(2, 2, H, W, 3)).astype(np.float32),
                           noise=clip_rng.normal(size=(2, 2, H // 8, W // 8, 4)).astype(np.float32),
                           aug=clip_rng.normal(size=(2, 2, H, W, 3)).astype(np.float32))
    job.update(cli_config=CLI_CONFIG, cli_names=CLI_NAMES, cli_refusals=CLI_REFUSALS,
               ckpt_run=CKPT_RUN, tp_executor_mesh=TP)
    return job


def _port_dit():
    from unigeo_tpu_torch.models.aether import AetherDiT

    return AetherDiT(FLOW["zc"] + FLOW["target"], FLOW["target"], **FLOW["net"])


def _port_network(name):
    from unigeo_tpu_torch.models import vda
    from unigeo_tpu_torch.models.pointmap import cut3r, dust3r

    cls, cfg = {"Cut3R": (cut3r.Cut3RNetwork, cut3r.tiny_cut3r_config),
                "Dust3R": (dust3r.Dust3RNetwork, dust3r.tiny_dust3r_config),
                "VDA": (vda.VDANetwork, vda.tiny_vda_config)}[name]
    return cls(**cfg())


@pytest.fixture(scope="module")
def two(job, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("train_ranks2"))
    return run_ranks("torch_parallel_train_ranks:two_ranks", 2,
                     dict(job, steps=TWO_STEPS, workdir=work), work, python_path=[TESTS],
                     threads=1, timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def four(job, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("train_ranks4"))
    small = {k: job[k] for k in ("micro", "flow_cfg", "unet", "dit", "nets", "batches",
                                 "draws")}
    return run_ranks("torch_parallel_train_ranks:four_ranks", 4,
                     dict(small, steps=FOUR_STEPS, workdir=work), work, python_path=[TESTS],
                     threads=1, timeout=LAUNCH_TIMEOUT)


def launch(request, n):
    return request.getfixturevalue({2: "two", 4: "four"}[n])


# --- the collectives ----------------------------------------------------------------


def expected(name, n, r):
    """(forward, input gradient) of collective ``name`` on rank r of n, from
    every rank's x and upstream gradient."""
    shape = (2, 3, 4 * n) if name == "ScatterToGroup" else ranks.COLL_SHAPE
    xs = [ranks.coll_draw(1, j, shape) for j in range(n)]
    g = lambda j, s: ranks.coll_draw(2, j, s)
    if name == "GatherFrames":
        return (np.concatenate(xs, 1),
                sum(g(j, (2, 3 * n, 4)) for j in range(n))[:, 3 * r:3 * r + 3])
    if name == "Halo":
        z = np.zeros((2, 1, 4))
        y = np.concatenate([xs[r - 1][:, -1:] if r else z, xs[r],
                            xs[r + 1][:, :1] if r + 1 < n else z], 1)
        grad = g(r, (2, 5, 4))[:, 1:4].copy()
        if r:
            grad[:, :1] += g(r - 1, (2, 5, 4))[:, 4:5]
        if r + 1 < n:
            grad[:, -1:] += g(r + 1, (2, 5, 4))[:, :1]
        return y, grad
    if name == "FromFirst":
        total = sum(g(j, shape) for j in range(n))
        return xs[0], total if r == 0 else np.zeros(shape)
    if name == "Stacked":
        return np.stack(xs), sum(g(j, (n, *shape)) for j in range(n))[r]
    if name == "CopyToGroup":
        return xs[r], sum(g(j, shape) for j in range(n))
    if name == "ReduceFromGroup":
        return sum(xs), g(r, shape)
    if name == "GatherFromGroup":
        return np.concatenate(xs, -1), g(r, (2, 3, 4 * n))[..., 4 * r:4 * r + 4]
    if name == "ScatterToGroup":
        return xs[r][..., 4 * r:4 * r + 4], np.concatenate([g(j, (2, 3, 4)) for j in range(n)], -1)
    return sum(xs), sum(g(j, shape) for j in range(n))  # AllReduceSum


COLLECTIVES = ["GatherFrames", "Halo", "FromFirst", "Stacked", "CopyToGroup", "ReduceFromGroup",
               "GatherFromGroup", "ScatterToGroup", "AllReduceSum"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_forward_and_backward_match_their_formulas(request, name, n):
    for r, res in enumerate(launch(request, n)):
        y, grad = res["collectives"][name]
        y_ref, grad_ref = expected(name, n, r)
        assert y.shape == y_ref.shape and np.abs(y - y_ref).max() <= COLL_TOL, (name, r)
        assert grad.shape == grad_ref.shape and np.abs(grad - grad_ref).max() <= COLL_TOL, \
            (name, r)


# --- placement ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("module", ["unet", "dit", "cut3r", "vda"])
def test_gather_params_of_parallelize_is_the_state_dict_bitwise(request, module, n):
    for res in launch(request, n):
        assert res["placement"][module] == dict(keys=True, bitwise=True, shrunk=True), module


# --- one step on a mesh -------------------------------------------------------------


def hold_step(res, ref_grads=None, ref_loss=None):
    """The mesh step's loss, gradients and AdamW update against the
    one-process step's (or the given references); the worst gradient's
    error over its limit."""
    ref_loss = res["ref_loss"] if ref_loss is None else ref_loss
    assert abs(res["loss"] - ref_loss) <= LOSS_TOL * abs(ref_loss), (res["loss"], ref_loss)
    return grad_ratio(res["grads"], res["ref_grads"] if ref_grads is None else ref_grads)


def grad_ratio(grads, ref, norm=False):
    """The worst leaf's error over its limit: elementwise, or with ``norm``
    the L2 norms of the error and of the leaf in place of the largest
    magnitudes."""
    size = (lambda a: np.linalg.norm(a.ravel())) if norm else (lambda a: np.abs(a).max())
    g_all = max(size(v) for v in ref.values())
    return max((size(grads[k] - ref[k]) / (GRAD_TOL * size(ref[k]) + GRAD_FLOOR * g_all), k)
               for k in ref)


MESH_STEPS = [(f, s) for f, s, fault in TWO_STEPS if fault is None] + [("diffusion", SPTP)]


@pytest.mark.parametrize("family,shape", MESH_STEPS)
def test_mesh_step_matches_the_one_process_step(request, family, shape):
    results = launch(request, int(np.prod(shape)) if shape == SPTP else 2)
    res = results[0][(family, shape, None)]
    assert len({r[(family, shape, None)]["loss"] for r in results}) == 1  # every rank's
    worst = hold_step(res)
    assert worst[0] <= 1.0, worst
    for k, after in res["after"].items():
        assert np.abs(after - res["ref_after"][k]).max() <= STEP_TOL, k


@pytest.mark.parametrize("shape", [DP, SP, TP, SPTP])
def test_diffusion_mesh_step_matches_jax(request, jax_micro, shape):
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal
    from unigeo_tpu_torch.utils.weights import state_dict_from_flax, unet_flax_path

    res = launch(request, 4 if shape == SPTP else 2)[0][("diffusion", shape, None)]
    ref = np_sd(state_dict_from_flax(jax_micro["grads"], UNetSpatioTemporal(**MICRO),
                                     unet_flax_path))
    worst = hold_step(res, ref, jax_micro["loss"])
    assert worst[0] <= 1.0, worst


FAULTS = {"sp_gather_sliced": ("diffusion", SP), "tp_gather_summed": ("diffusion", TP),
          "bias_before_reduce": ("diffusion", TP), "pointmap_local_losses": ("pointmap", DP)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_misses_the_bound(two, fault):
    family, shape = FAULTS[fault]
    res = two[0][(family, shape, fault)]
    loss_miss = abs(res["loss"] - res["ref_loss"]) / (LOSS_TOL * abs(res["ref_loss"]))
    grad_miss = grad_ratio(res["grads"], res["ref_grads"])[0]
    print(f"{fault}: loss {loss_miss:.3g}x, gradients {grad_miss:.3g}x its bound")
    assert max(loss_miss, grad_miss) >= FAULT_FACTOR, (loss_miss, grad_miss)


# --- the CLI ------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, _, _ in CLI_NAMES])
def test_train_cli_runs_on_a_mesh(two, name):
    runs = [r[f"cli_{name}"] for r in two]
    assert all(r["refused"] is None for r in runs), runs
    losses = [r["losses"] for r in runs]
    assert len(losses[0]) == 1 and np.isfinite(losses[0]).all() and losses[0] == losses[1]


@pytest.mark.parametrize("label", list(CLI_REFUSALS))
def test_train_cli_refuses_a_mesh_that_does_not_fit(two, label):
    for r in two:
        assert CLI_REFUSED[label] in r[f"refused_{label}"], r[f"refused_{label}"]


def test_tp_checkpoint_loads_and_equals_the_one_process_run(two, tmp_path):
    from unigeo_tpu_torch import train
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3R, tiny_cut3r_config
    from unigeo_tpu_torch.utils.checkpoint import load_params

    name, _ = CKPT_RUN
    tp_run = [r["cli_ckpt"] for r in two]
    assert tp_run[1]["checkpoints"] == [] and len(tp_run[0]["checkpoints"]) == 1
    one = train.main(["--device", "cpu", "--tiny", "--model", name, "--steps", "1",
                      "--ckpt-dir", str(tmp_path / "one"), "--ckpt-every", "1", "--lr", str(LR),
                      "--log-dir", str(tmp_path)], config=dict(CLI_CONFIG))
    assert abs(tp_run[0]["losses"][0] - one["losses"][0]) <= LOSS_TOL * abs(one["losses"][0])
    one_grads = np_sd({k: p.grad for k, p in one["network"].named_parameters()})
    grads = tp_run[0]["grads"]
    worst = grad_ratio(grads, one_grads)
    assert worst[0] <= 1.0, worst
    ours = load_params(tp_run[0]["checkpoints"][0])
    ref = load_params(one["checkpoints"][0])
    assert list(ours) == list(ref)
    direction = lambda g: g / (np.abs(g) + 1e-8)
    for k, v in ours.items():
        bound = STEP_TOL + LR * np.abs(direction(grads[k]) - direction(one_grads[k])) * (1 + 1e-6)
        assert np.all(np.abs(v.numpy() - ref[k].numpy()) <= bound), k
    # the one-device eval adapter loads it
    model = Cut3R(network_config=tiny_cut3r_config(), checkpoint_path=tp_run[0]["checkpoints"][0],
                  device="cpu")
    for k, v in model.network.state_dict().items():
        assert torch.equal(v, ours[k]), k


def test_tp_executor_matches_the_serial_path(two):
    for r in two:
        ref = r["tp_executor_serial"]
        assert np.abs(r["tp_executor"] - ref).max() <= EXECUTOR_TOL * np.abs(ref).max()
    assert np.array_equal(two[0]["tp_executor"], two[1]["tp_executor"])
