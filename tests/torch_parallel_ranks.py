"""Rank functions of the port's multi-process tests (``tests/test_torch_parallel_ranks.py``),
run by ``unigeo_tpu_torch/parallel/launch.py::run_ranks`` as gloo ranks on the
CPU.  Each builds the tiny f32 models from the state dicts in its job (the
JAX package's weights, carried over by the test), runs the parallel paths
and their serial counterparts, and returns numpy arrays; the test holds them
against each other and against the JAX package.  Not a test module itself.
"""

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist


def _pipeline(job):
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline

    pipe = tiny_pipeline(device="cpu", dtype=torch.float32)
    pipe.load_state_dicts(*job["pipeline"])
    return pipe


def _aether(job):
    from unigeo_tpu_torch.models.aether import AetherNetwork

    net = AetherNetwork(vae_config=job["aether_vae"], network_config=job["aether_net"])
    net.load_state_dict(job["aether"])
    return net.eval()


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _sp_denoise(pipe, job, mesh):
    """The sp denoise at 1 and 2 steps, the unsplit loop, and two planted
    faults at 1 step: the temporal convs without the neighbours' frames
    (zeros in their place) and the group norms on this rank's frames only."""
    from unigeo_tpu_torch.models import layers
    from unigeo_tpu_torch.parallel.comm import FrameShard
    from unigeo_tpu_torch.parallel.context import denoise_context_parallel

    cond, ctx, noise = (t_(job["sp"][k]) for k in ("cond", "ctx", "noise"))
    out = {}
    with torch.no_grad():
        for steps in (1, 2):
            out[f"sp_{steps}"] = denoise_context_parallel(pipe, cond, ctx, noise, steps,
                                                          mesh).numpy()
            out[f"serial_{steps}"] = pipe._denoise_loop(cond[None], ctx[None], noise[None],
                                                        steps)[0].numpy()
        alone = FrameShard()
        real_halo, real_gn = FrameShard.halo, layers.sharded_group_norm
        FrameShard.halo = lambda self, x, dim, width: real_halo(alone, x, dim, width)
        try:
            out["fault_no_halo"] = denoise_context_parallel(pipe, cond, ctx, noise, 1,
                                                            mesh).numpy()
        finally:
            FrameShard.halo = real_halo
        layers.sharded_group_norm = lambda x, g, w, b, eps, shard: real_gn(x, g, w, b, eps, alone)
        try:
            out["fault_local_norm"] = denoise_context_parallel(pipe, cond, ctx, noise, 1,
                                                               mesh).numpy()
        finally:
            layers.sharded_group_norm = real_gn
    return out


def _sp_flow(job, mesh):
    from unigeo_tpu_torch.parallel.context import flow_sample_context_parallel

    net = _aether(job)
    cond, noise = t_(job["flow"]["cond"]), t_(job["flow"]["noise"])
    with torch.no_grad():
        return {"flow_sp": flow_sample_context_parallel(net, cond, noise, 2, mesh).numpy(),
                "flow_serial": net.sample(cond, noise, 2).numpy()}


def _eval(job):
    """The eval CLI on the identity config twice (the second run resumes
    from each rank's file), each rank into its own directory."""
    from unigeo_tpu_torch import eval as eval_cli

    out_dir = os.path.join(job["eval_dir"], f"rank{dist.get_rank()}")
    argv = ["--config", job["eval_config"], "--output", out_dir, "--device", "cpu"]
    runs = []
    for _ in range(2):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            eval_cli.main(argv)
        runs.append(text.getvalue().count("processing seq"))
    return {"eval_processed": runs, "eval_files": sorted(os.listdir(out_dir)),
            "eval_dir": out_dir}


def two_ranks(job):
    """dp (the executor with padding, StableNormal), sp (the UNet denoise with
    its planted faults, Aether's flow sampler), the rows gather, the pp
    executor's refusal and the eval over both ranks."""
    from unigeo_tpu_torch.models.stablenormal import StableNormal
    from unigeo_tpu_torch.parallel.executor import ShardedClipExecutor
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.multihost import (
        is_primary,
        process_allgather_rows,
        shard_indices,
    )
    from unigeo_tpu_torch.parallel.staged import PipelinedStageExecutor

    rank = dist.get_rank()
    pipe = _pipeline(job)
    out = {"rank": rank, "primary": is_primary(), "indices": shard_indices(5)}
    out["rows"] = process_allgather_rows([{"seq_name": f"seq{rank}", "Abs Rel": rank + 0.5}])

    dp_mesh = make_mesh(2, shape=(2, 1, 1), device="cpu")
    dp = job["dp"]
    with torch.no_grad():
        ex = ShardedClipExecutor(pipe, dp_mesh, num_inference_steps=2)
        out["dp_batch_size"] = ex.batch_size
        out["dp"] = ex(dp["frames"], noise=dp["noise"], aug_noise=dp["aug"]).numpy()
        # the serial path, each rank its share of the clips
        out["serial"] = {i: ((pipe.run_window_staged(t_(dp["frames"][i]), t_(dp["noise"][i]), 2,
                                                     aug_noise=t_(dp["aug"][i])) + 1.0) / 2.0
                             ).numpy()
                         for i in range(len(dp["frames"])) if i % 2 == rank}
        sn = StableNormal(pipeline=pipe, num_inference_steps=2, mesh=dp_mesh)
        frames = t_(job["sn"]["frames"])
        noise, aug = t_(job["sn"]["noise"]), t_(job["sn"]["aug"])
        out["sn_batch_size"] = sn.eval_batch_size
        out["sn_dp"] = sn._run_frames_dp(frames, noise, aug).numpy()
        out["sn_single"] = sn._run_frames_single(frames, noise, aug).numpy()

    sp_mesh = make_mesh(2, shape=(1, 2, 1), device="cpu")
    out.update(_sp_denoise(pipe, job, sp_mesh))
    out.update(_sp_flow(job, sp_mesh))
    try:
        PipelinedStageExecutor(pipe, num_frames=4)
    except ValueError as e:
        out["pp_refusal"] = str(e)
    out.update(_eval(job))
    return out


def four_ranks(job):
    """pp (encode on rank 0, decode on rank 1, the frames split over ranks 2
    and 3), Aether's flow sampler over sp = 4, and the dp executor on a
    (2, 1, 2) mesh (tp 2 in each dp rank) beside each clip's serial path."""
    from unigeo_tpu_torch.parallel.executor import ShardedClipExecutor
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.staged import PipelinedStageExecutor

    out = {"rank": dist.get_rank()}
    out.update(_sp_flow(job, make_mesh(4, shape=(1, 4, 1), device="cpu")))
    pipe = _pipeline(job)
    pp = job["pp"]
    with torch.no_grad():
        ex = PipelinedStageExecutor(pipe, num_frames=pp["frames"].shape[1],
                                    num_inference_steps=2)
        out["pp_denoise_ranks"] = ex.denoise_ranks
        out["pp"] = ex(pp["frames"], noise=pp["noise"], aug_noise=pp["aug"]).numpy()
        pipe = _pipeline(job)  # the pp executor kept only its ranks' stages
        out["tp_serial"] = np.stack([((pipe.run_window_staged(
            t_(pp["frames"][i]), t_(pp["noise"][i]), 2, aug_noise=t_(pp["aug"][i])) + 1.0) / 2.0
        ).numpy() for i in range(len(pp["frames"]))])
        # parallelize places the pipeline's modules in place: last
        tp = ShardedClipExecutor(pipe, make_mesh(4, shape=(2, 1, 2), device="cpu"),
                                 num_inference_steps=2)
        out["tp"] = tp(pp["frames"], noise=pp["noise"], aug_noise=pp["aug"]).numpy()
    return out
