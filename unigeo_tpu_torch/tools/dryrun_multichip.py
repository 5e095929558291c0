"""Dry run of the port's parallel executors on the CPU: the counterpart of
the JAX package's ``__graft_entry__.py::dryrun_multichip``.

    python -m unigeo_tpu_torch.tools.dryrun_multichip --nproc 4

spawns N gloo ranks on the CPU (``parallel/launch.py``) that build the tiny
f32 DepthCrafter pipeline and a tiny Aether network from one seed and check,
each against the serial path in the same rank, printing each max |delta|:

  * dp: ``ShardedClipExecutor`` over a (N, 1, 1) mesh on N + 1 clips (the
    last step padded) against ``run_window_staged`` per clip;
  * sp: ``denoise_context_parallel`` over a (1, N, 1) mesh on 2N frames
    against the unsplit denoise loop, and ``flow_sample_context_parallel``
    over N latent frames against ``AetherNetwork.sample``;
  * pp (N >= 3): ``PipelinedStageExecutor`` on two clips of 4 frames;
  * training, on ``mesh.py::_factor(N)``'s mesh (dp 2 x sp 2 x tp 2 at N =
    8, the JAX dry run's): one ``DiffusionTrainer`` step (the tiny UNet, B =
    dp clips of 2 sp frames) and one ``FlowMatchingTrainer`` step (the tiny
    DiT, B = dp clips), each against the one-process step on the same batch
    and draws in the same rank: each loss, its relative difference and the
    largest gradient difference relative to the largest gradient (the
    counterpart of ``__graft_entry__.py::dryrun_multichip``'s training and
    ``_dryrun_flow_matching``).

Then, in this process, the SVD-XT tp accounting of ``__graft_entry__.py::
_check_svdxt_tp_divisibility``: the full UNet built on the meta device,
every weight a rule targets sharded evenly at tp = 2, 4 and 8 (none falls
back to replication), and the sharded share of its bytes.  Exits non-zero
if a check fails.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List, Optional

import torch

H = W = 64
STEPS = 2
# relative to the serial output's largest magnitude: dp is the serial
# computation; sp and pp reorder the temporal statistics' f32 sums; the flow
# sampler absolute, as tests/test_aether.py holds JAX's
BOUNDS = {"dp": 1e-6, "sp": 4e-4, "pp": 2e-3, "flow": 2e-4}
# the training steps against the one-process step (f32 sums in another
# order): the loss relative, the gradients relative to the largest one
TRAIN_BOUNDS = {"loss": 1e-5, "grad": 1e-4}
SVD_XT_UNET = dict(block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
                   num_attention_heads=(5, 10, 20, 20), cross_attention_dim=1024,
                   addition_time_embed_dim=256, head_dim=64)


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def rank_main(job):
    """One rank's checks -> {name: (max |delta|, bound)}."""
    import torch.distributed as dist

    from unigeo_tpu_torch.models.aether import AetherNetwork, tiny_aether_configs
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_, tiny_pipeline
    from unigeo_tpu_torch.parallel.context import (
        denoise_context_parallel,
        flow_sample_context_parallel,
    )
    from unigeo_tpu_torch.parallel.executor import ShardedClipExecutor
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.staged import PipelinedStageExecutor

    n = dist.get_world_size()
    pipe = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(job["seed"]))
    g = torch.Generator().manual_seed(job["seed"] + 1)
    rnd = lambda *s: torch.randn(s, generator=g)
    out = {}
    with torch.no_grad():
        b, t = n + 1, 2
        frames = torch.rand((b, t, H, W, 3), generator=g)
        noise, aug = rnd(b, t, H // 8, W // 8, 4), rnd(b, t, H, W, 3)
        dp = ShardedClipExecutor(pipe, make_mesh(n, (n, 1, 1), device="cpu"), STEPS)(
            frames, noise=noise, aug_noise=aug)
        serial = torch.stack([(pipe.run_window_staged(frames[i], noise[i], STEPS, aug[i]) + 1.0)
                              / 2.0 for i in range(b)])
        out["dp ShardedClipExecutor"] = (_rel(dp, serial), BOUNDS["dp"])

        sp_mesh = make_mesh(n, (1, n, 1), device="cpu")
        t = 2 * n
        cond, ctx = pipe._encode_stage(torch.rand((t, 3, H, W), generator=g))
        x0 = rnd(t, 4, H // 8, W // 8)
        sp = denoise_context_parallel(pipe, cond, ctx, x0, STEPS, sp_mesh)
        ref = pipe._denoise_loop(cond[None], ctx[None], x0[None], STEPS)[0]
        out["sp denoise_context_parallel"] = (_rel(sp, ref), BOUNDS["sp"])

        net_cfg, vae_cfg = tiny_aether_configs()
        net = init_random_(AetherNetwork(vae_cfg, net_cfg), g).eval()
        lat = rnd(n, net.z_channels, 8, 8)
        eps = rnd(n, net.target_channels, 8, 8)
        flow = flow_sample_context_parallel(net, lat, eps, STEPS, sp_mesh)
        out["sp flow_sample_context_parallel"] = (
            float((flow - net.sample(lat, eps, STEPS)).abs().max()), BOUNDS["flow"])

        if n >= 3:
            clips = torch.rand((2, 4, H, W, 3), generator=g)
            noise, aug = rnd(2, 4, H // 8, W // 8, 4), rnd(2, 4, H, W, 3)
            serial = torch.stack([(pipe.run_window_staged(clips[i], noise[i], STEPS, aug[i])
                                   + 1.0) / 2.0 for i in range(2)])
            pp = PipelinedStageExecutor(pipe, num_frames=4, num_inference_steps=STEPS)
            got = pp(clips, noise=noise, aug_noise=aug)
            out[f"pp PipelinedStageExecutor (denoise ranks {pp.denoise_ranks})"] = (
                _rel(got, serial), BOUNDS["pp"])
    out.update(train_steps(job["seed"]))
    return out


def train_steps(seed: int):
    """One DiffusionTrainer and one FlowMatchingTrainer step on _factor(N)'s
    mesh against the one-process step -> {name: (difference, bound)}."""
    import copy

    import torch.distributed as dist

    from unigeo_tpu_torch.models.aether import AetherDiT, tiny_aether_configs
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal, tiny_unet_config
    from unigeo_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from unigeo_tpu_torch.parallel.sharding import gather_params
    from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer, FlowMatchingTrainer

    n = dist.get_world_size()
    shape = mesh_shape(n)
    dp, sp, _ = shape
    g = torch.Generator().manual_seed(seed + 2)
    rnd = lambda *s: torch.randn(s, generator=g)
    unet_cfg = tiny_unet_config()
    b, t = dp, 2 * sp
    diffusion = ({"latents": rnd(b, t, 16, 16, 4), "cond_latents": rnd(b, t, 16, 16, 4),
                  "context": rnd(b, t, 1, unet_cfg["cross_attention_dim"])},
                 (rnd(b, 1, 1, 1, 1), rnd(b, t, 16, 16, 4)))
    net_cfg, _ = tiny_aether_configs()
    flow = ({"target_latents": rnd(b, 2, 8, 8, 10), "cond_latents": rnd(b, 2, 8, 8, 4)},
            (rnd(b), rnd(b, 2, 8, 8, 10)))
    runs = (("DiffusionTrainer", DiffusionTrainer,
             init_random_(UNetSpatioTemporal(**unet_cfg), g), diffusion),
            ("FlowMatchingTrainer", FlowMatchingTrainer,
             init_random_(AetherDiT(14, 10, **net_cfg), g), flow))
    out = {}
    for name, cls, module, (batch, draws) in runs:
        ref = cls(copy.deepcopy(module), learning_rate=1e-4)
        ref_loss = float(ref.backward(batch, *draws))
        ref_grads = {k: p.grad for k, p in ref.module.named_parameters()}
        trainer = cls(module, learning_rate=1e-4, mesh=make_mesh(n, shape, device="cpu"))
        loss = float(trainer.backward(trainer.local_batch(batch), *draws))
        grads = gather_params(module, values={k: p.grad for k, p in module.named_parameters()})
        g_all = max(float(v.abs().max()) for v in ref_grads.values())
        grad_dev = max(float((grads[k] - v).abs().max()) for k, v in ref_grads.items()) / g_all
        label = f"train {name} on dp,sp,tp {shape}: loss {loss:.6f} (one process {ref_loss:.6f})"
        out[f"{label}, relative loss difference"] = (abs(loss - ref_loss) / abs(ref_loss),
                                                     TRAIN_BOUNDS["loss"])
        out[f"{label}, largest gradient difference over the largest gradient"] = (
            grad_dev, TRAIN_BOUNDS["grad"])
    return out


def svdxt_tp_accounting(tp_sizes=(2, 4, 8)) -> List[str]:
    """Lines of the SVD-XT UNet's tp accounting; raises if a targeted weight
    falls back to replication or under 80% of the bytes are sharded."""
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal
    from unigeo_tpu_torch.parallel import sharding

    with torch.device("meta"):
        unet = UNetSpatioTemporal(**SVD_XT_UNET).to(torch.bfloat16)
    owners = dict(unet.named_modules())
    targeted = []
    for key, p in unet.named_parameters():
        mod = owners[key.rsplit(".", 1)[0]]
        if key.endswith(".weight") and isinstance(mod, sharding._SHARDABLE):
            if sharding.param_spec(key, tuple(p.shape), 1) is not None:
                targeted.append(key)
    lines, counts = [], set()
    for tp in tp_sizes:
        specs = sharding.param_specs(unet, tp)
        fell_back = [k for k in targeted if specs[k] is None]
        if fell_back:
            raise AssertionError(f"tp={tp}: {len(fell_back)} targeted weights fell back to "
                                 f"replication, e.g. {fell_back[:3]}")
        shard_b, total_b = sharding.sharded_bytes_fraction(unet, tp)
        n_sharded = sum(d is not None for d in specs.values())
        counts.add(n_sharded)
        if shard_b / total_b < 0.8:
            raise AssertionError(f"tp={tp}: only {100 * shard_b / total_b:.1f}% of the bytes")
        lines.append(f"SVD-XT UNet tp={tp}: {n_sharded}/{len(specs)} leaves sharded evenly, "
                     f"sharded bytes {shard_b / 1e6:.0f}/{total_b / 1e6:.0f} MB (bf16) "
                     f"({100 * shard_b / total_b:.1f}%)")
    if len(counts) != 1:
        raise AssertionError(f"the sharded leaf count varies with tp: {sorted(counts)}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.nproc < 2:
        ap.error("--nproc must be at least 2")

    from unigeo_tpu_torch.parallel.launch import run_ranks

    ok = True
    with tempfile.TemporaryDirectory() as work:
        results = run_ranks("unigeo_tpu_torch.tools.dryrun_multichip:rank_main", args.nproc,
                            {"seed": args.seed}, work, threads=1)
    print(f"{args.nproc} gloo ranks on the CPU, tiny f32 configs, {STEPS} steps")
    for name, (err, bound) in results[0].items():
        same = all(r[name] == results[0][name] for r in results)
        good = err <= bound and same
        ok &= good
        what = "" if name.startswith("train ") else " max |delta|"
        print(f"{name}:{what} {err:.3e} (bound {bound:.0e}; every rank the same "
              f"{same}) {'ok' if good else 'FAILED'}")
    for line in svdxt_tp_accounting():
        print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
