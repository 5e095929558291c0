"""Rank functions of the port's multi-process training tests
(``tests/test_torch_parallel_train_ranks.py``), run by
``unigeo_tpu_torch/parallel/launch.py::run_ranks`` as gloo ranks on the CPU.
Each builds the tiny f32 modules from the state dicts in its job (weights
from the JAX package's parameter trees, carried over by the test through
``utils/weights.py``), runs the mesh steps and, in the same rank, the
one-process step on the whole batch, and returns numpy arrays; the test
holds them against each other and against the JAX package.  Not a test
module itself.
"""

import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

LR = 1e-3
# the collectives' inputs: every rank's x and upstream gradient g are drawn
# from (seed, rank), so the test can recompute every rank's
COLL_SHAPE = (2, 3, 4)


def coll_draw(seed, rank, shape):
    return np.random.default_rng(1000 * seed + rank).standard_normal(shape).astype(np.float64)


def _collectives():
    """Each differentiable collective's forward and the gradient its
    backward gives this rank's input, for the upstream gradient
    ``coll_draw(2, rank, out.shape)``."""
    from unigeo_tpu_torch.parallel import comm

    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    shard = comm.FrameShard(group)
    cases = {
        "GatherFrames": lambda x: comm.GatherFrames.apply(x, group, 1),
        "Halo": lambda x: comm.Halo.apply(x, shard, 1, 1),
        "FromFirst": lambda x: comm.FromFirst.apply(x, shard),
        "Stacked": lambda x: comm.Stacked.apply(x, group),
        "CopyToGroup": lambda x: comm.CopyToGroup.apply(x, group),
        "ReduceFromGroup": lambda x: comm.ReduceFromGroup.apply(x, group),
        "GatherFromGroup": lambda x: comm.GatherFromGroup.apply(x, group, -1),
        "ScatterToGroup": lambda x: comm.ScatterToGroup.apply(x, group, -1),
        "AllReduceSum": lambda x: comm.AllReduceSum.apply(x, group),
    }
    out = {}
    for name, fn in cases.items():
        shape = (2, 3, 4 * world) if name == "ScatterToGroup" else COLL_SHAPE
        x = torch.from_numpy(coll_draw(1, rank, shape)).requires_grad_()
        y = fn(x)
        y.backward(torch.from_numpy(coll_draw(2, rank, tuple(y.shape))))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


# --- modules ---------------------------------------------------------------------


def unet(job):
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal

    m = UNetSpatioTemporal(**job["micro"])
    m.load_state_dict({k: torch.from_numpy(v) for k, v in job["unet"].items()})
    return m


def dit(job):
    from unigeo_tpu_torch.models.aether import AetherDiT

    cfg = job["flow_cfg"]
    m = AetherDiT(cfg["zc"] + cfg["target"], cfg["target"], **cfg["net"])
    m.load_state_dict({k: torch.from_numpy(v) for k, v in job["dit"].items()})
    return m


def network(job, name):
    from unigeo_tpu_torch.models import vda
    from unigeo_tpu_torch.models.pointmap import cut3r, dust3r

    cls, cfg = {"Cut3R": (cut3r.Cut3RNetwork, cut3r.tiny_cut3r_config),
                "Dust3R": (dust3r.Dust3RNetwork, dust3r.tiny_dust3r_config),
                "VDA": (vda.VDANetwork, vda.tiny_vda_config)}[name]
    m = cls(**cfg())
    m.load_state_dict({k: torch.from_numpy(v) for k, v in job["nets"][name].items()})
    return m


def trainer_of(job, family, mesh=None):
    from unigeo_tpu_torch.parallel import trainer as pt

    if family == "diffusion":
        return pt.DiffusionTrainer(unet(job), learning_rate=LR, mesh=mesh)
    if family == "flow":
        return pt.FlowMatchingTrainer(dit(job), learning_rate=LR, mesh=mesh)
    if family == "pointmap":
        return pt.PointmapTrainer(network(job, "Cut3R"), learning_rate=LR, mesh=mesh)
    if family == "dust3r":
        return pt.Dust3RTrainer(network(job, "Dust3R"), learning_rate=LR, mesh=mesh)
    return pt.DisparityTrainer(network(job, "VDA"), learning_rate=LR, mesh=mesh)


def np_state(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


# --- one step on a mesh against the one-process step ---------------------------------


def mesh_step(job, family, shape, fault=None):
    """One step of ``family`` on a ``shape`` mesh and the one-process step on
    the whole batch with the same draws: both losses, both gradients (the
    mesh's all-reduced and gathered), and both parameters after AdamW, the
    one-process trainer given the mesh's gradients."""
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.sharding import gather_params

    batch = {k: torch.from_numpy(v) for k, v in job["batches"][family].items()}
    draws = [torch.from_numpy(d) for d in job["draws"].get(family, ())]
    ref = trainer_of(job, family)
    ref_loss = ref.backward(batch, *draws)
    ref_grads = {k: p.grad.clone() for k, p in ref.module.named_parameters()}

    tr = trainer_of(job, family, make_mesh(dist.get_world_size(), shape, device="cpu"))
    if fault == "pointmap_local_losses":
        tr.place.group["dp"] = None
    with planted(fault):
        loss = tr.backward(tr.local_batch(batch), *draws)
    named = dict(tr.module.named_parameters())
    grads = gather_params(tr.module, values={k: p.grad for k, p in named.items()})
    tr.optimizer.step()
    after = gather_params(tr.module, values=dict(tr.module.named_parameters()))
    for k, p in ref.module.named_parameters():
        p.grad = grads[k].clone()
    ref.optimizer.step()
    out = {"loss": float(loss), "ref_loss": float(ref_loss)}
    if dist.get_rank() == 0:
        out.update(grads=np_state(grads), ref_grads=np_state(ref_grads), after=np_state(after),
                   ref_after=np_state(dict(ref.module.named_parameters())))
    return out


@contextlib.contextmanager
def planted(fault):
    """A planted fault of the tests' docstring, while in the block."""
    from unigeo_tpu_torch.models import layers
    from unigeo_tpu_torch.parallel import comm

    saved = []

    def swap(owner, name, value):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    if fault == "sp_gather_sliced":  # the tp form's backward on the frames
        def sliced(ctx, g):
            n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
            return g.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n), None, None
        swap(comm.GatherFrames, "backward", staticmethod(sliced))
    elif fault == "tp_gather_summed":  # the sp form's backward on the features
        swap(comm.GatherFromGroup, "backward", staticmethod(
            lambda ctx, g: (comm.reduce_scatter(g, ctx.group, ctx.dim), None, None)))
    elif fault == "bias_before_reduce":
        def row_from_local(self, x):
            spec = self._checked_spec()
            return layers.reduce_from_group(super(layers.TensorParallel, self).forward(x),
                                            spec.group)
        swap(layers.TensorParallel, "row_from_local", row_from_local)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def _placement_round_trip(job):
    """gather_params(parallelize(m)) against m.state_dict(), bitwise, at this
    world's tp."""
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.sharding import gather_params, parallelize

    n = dist.get_world_size()
    mesh = make_mesh(n, (1, 1, n), device="cpu")
    out = {}
    for name, build in (("unet", lambda: unet(job)), ("dit", lambda: dit(job)),
                        ("cut3r", lambda: network(job, "Cut3R")),
                        ("vda", lambda: network(job, "VDA"))):
        m = build()
        whole = {k: v.clone() for k, v in m.state_dict().items()}
        local_bytes = sum(p.numel() for p in parallelize(m, mesh).parameters())
        back = gather_params(m)
        out[name] = dict(keys=list(back) == list(whole),
                         bitwise=all(torch.equal(back[k], whole[k]) for k in whole),
                         shrunk=local_bytes < sum(v.numel() for v in whole.values()))
    return out


# --- the CLI on a mesh -------------------------------------------------------------


def _cli(job, name, mesh, extra=(), config=None):
    """train.main on this world's mesh; (the losses, the message of a
    refusal, what it returned) with stderr captured."""
    from unigeo_tpu_torch import train

    rank = dist.get_rank()
    argv = ["--device", "cpu", "--tiny", "--model", name, "--steps", "1", "--mesh", mesh,
            "--log-dir", os.path.join(job["workdir"], f"log_{name}_{rank}"), *extra]
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            out = train.main(argv, config=dict(job["cli_config"], **(config or {})))
    except SystemExit as e:
        return None, f"{e.code} {err.getvalue()}", None
    return out["losses"], None, out


def _cli_runs(job):
    from unigeo_tpu_torch.parallel.sharding import gather_params

    out = {}
    for name, mesh, extra in job["cli_names"]:
        losses, refused, _ = _cli(job, name, mesh, ["--ckpt-every", "0", *extra])
        out[f"cli_{name}"] = dict(losses=losses, refused=refused)
    ckpt = os.path.join(job["workdir"], "ckpt_tp")
    name, mesh = job["ckpt_run"]
    losses, refused, run = _cli(job, name, mesh,
                                ["--ckpt-dir", ckpt, "--ckpt-every", "1", "--lr", str(LR)])
    net = run["network"]
    grads = gather_params(net, values={k: p.grad for k, p in net.named_parameters()})
    out["cli_ckpt"] = dict(losses=losses, refused=refused, checkpoints=run["checkpoints"],
                           grads=np_state(grads) if dist.get_rank() == 0 else None)
    for label, (mesh, config, extra) in job["cli_refusals"].items():
        out[f"refused_{label}"] = _cli(job, "DepthCrafter", mesh, ["--ckpt-every", "0", *extra],
                                       config)[1]
    return out


def _tp_executor(job):
    """``ShardedClipExecutor`` on a (1, 1, world) mesh against the serial
    ``run_window_staged`` of each clip."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.parallel.executor import ShardedClipExecutor
    from unigeo_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size()
    pipe = tiny_pipeline(device="cpu", dtype=torch.float32)
    pipe.init_random(torch.Generator().manual_seed(0))
    clips = {k: torch.from_numpy(v) for k, v in job["tp_clips"].items()}
    with torch.no_grad():
        serial = torch.stack([(pipe.run_window_staged(clips["frames"][i], clips["noise"][i], 2,
                                                      aug_noise=clips["aug"][i]) + 1.0) / 2.0
                              for i in range(clips["frames"].shape[0])])
        ex = ShardedClipExecutor(pipe, make_mesh(n, job["tp_executor_mesh"], device="cpu"),
                                 num_inference_steps=2)
        tp = ex(clips["frames"], noise=clips["noise"], aug_noise=clips["aug"])
    return {"tp_executor": tp.numpy(), "tp_executor_serial": serial.numpy()}


def _timed(seconds, name, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    seconds[name] = time.perf_counter() - t0
    return result


def four_ranks(job):
    """The collectives, the placement and the mesh steps of ``job``; each
    part's seconds."""
    seconds = {}
    out = {"rank": dist.get_rank(), "seconds": seconds,
           "collectives": _timed(seconds, "collectives", _collectives),
           "placement": _timed(seconds, "placement", _placement_round_trip, job)}
    for family, shape, fault in job["steps"]:
        out[(family, shape, fault)] = _timed(seconds, (family, shape, fault), mesh_step, job,
                                             family, shape, fault)
    return out


def two_ranks(job):
    """``four_ranks``' parts, then the CLI and the tp executor."""
    out = four_ranks(job)
    out.update(_timed(out["seconds"], "cli", _cli_runs, job))
    out.update(_timed(out["seconds"], "tp_executor", _tp_executor, job))
    return out
