"""Config-driven training CLI of the port, counterpart of ``train.py``.

    python -m unigeo_tpu_torch.train --config configs/<experiment>.yaml \
        [--model NAME] [--steps 100] [--batch-size 1] [--lr 1e-4] \
        [--ckpt-dir ./ckpts] [--ckpt-every 50] [--tiny] [--device cuda]
    torchrun --nproc-per-node N -m unigeo_tpu_torch.train --config ... \
        [--mesh dp,sp,tp]

Every family of the JAX trainer, selected by the config's model (or
``--model``), on one device or on a device mesh (``parallel/trainer.py``):

  * DepthCrafter, UniGeoCam / UniGeo, StableNormal, ChronoDepth,
    DepthAnyVideo: EDM fine-tuning of the SVD UNet on VAE-encoded clips
    (``DiffusionTrainer``; the VAE and CLIP frozen; direct-depth targets
    for ChronoDepth and DepthAnyVideo, inverse depth for the others); the
    pipeline at the config's ``unet_config`` / ``vae_config`` /
    ``clip_config``, bf16 (f32 under ``--tiny``).
  * Spann3R, Cut3R: confidence-weighted world-pointmap regression, plus
    the pose loss for Cut3R's pose head (``PointmapTrainer``); Dust3R in
    pair mode (``Dust3RTrainer``); the config's ``network_config``, f32.
  * VideoDepthAnything: scale-shift-invariant disparity with temporal
    gradient matching (``DisparityTrainer``), f32.
  * Aether: rectified flow of the DiT on [depth latents | raymaps] with the
    VAE frozen (``FlowMatchingTrainer``).

Each step builds its batch from the config's dataset (``build_batch_*``),
runs the loss, its backward (through the flash-attention kernels on the
card: the forward with logsumexp, then dq and dk/dv) and one AdamW update.
Weights are random, made on the device from seed 0.  Checkpoints rotate
under ``--ckpt-dir`` (``utils/checkpoint.py::TrainStateSaver``, the newest 3
kept) every ``--ckpt-every`` steps, and the final state is saved; each is
the layout the family's eval adapter loads through ``checkpoint_path``.
``--ckpt-every 0`` saves nothing.  It runs on the card unless ``--device
cpu`` is given.

Over several processes (torchrun's environment, ``parallel/multihost.py``)
each rank runs on ``cuda:{LOCAL_RANK % device_count}`` (or the CPU under
``--device cpu``) on a mesh of the world's size: ``--mesh dp,sp,tp``, or
``mesh.py::_factor``'s shape without it.  ``--batch-size`` is the whole
batch and must divide by dp; each rank builds only its dp block of the
clips and, in the diffusion family under sp, encodes only its block of
each clip's frames (T must divide by sp; the depth target's clip-wide
min-max is still taken over the whole clip).  Only rank 0 logs and writes
checkpoints, each the whole state (``sharding.gather_params``) in the
layout the one-device eval adapter loads.  One process with no ``--mesh``
is the one-device path.

``main(argv, config=dict)`` takes the experiment config as a dict instead of
``--config``, so a caller needs neither a YAML file nor the ``yaml`` package.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

DIFFUSION_MODELS = ("DepthCrafter", "UniGeoCam", "UniGeo", "StableNormal", "ChronoDepth",
                    "DepthAnyVideo")
# ChronoDepth and DepthAnyVideo decode depth itself ((x + 1) / 2)
DIRECT_DEPTH_MODELS = ("ChronoDepth", "DepthAnyVideo")
POINTMAP_MODELS = ("Spann3R", "Cut3R", "Dust3R")


def frames_of(data) -> np.ndarray:
    """data["images"] [T, 3, H, W] 0..255 -> [T, H, W, 3] f32 in 0..1."""
    return np.moveaxis(data["images"], 1, -1).astype(np.float32) / 255.0


def build_batch_pointmap(samples) -> Dict[str, np.ndarray]:
    """Clips -> the pointmap trainers' batch (host arrays): frames, GT
    world points, mask and c2w poses."""
    from unigeo_tpu_torch.data.collate import collate_clips
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    batch = []
    for data in samples:
        gt = prepare_gt_label(data)
        batch.append({
            "frames": frames_of(data),
            "gt_world_pts": gt["gt_world_pts"].astype(np.float32),
            "mask": gt["gt_masks"].astype(np.float32),
            "gt_poses": gt["gt_poses"].astype(np.float32),
        })
    return collate_clips(batch)


def build_batch_disparity(samples) -> Dict[str, np.ndarray]:
    """Clips -> the disparity trainer's batch (host arrays): GT disparity =
    1 / depth on valid pixels (the loss's affine alignment makes its scale
    irrelevant)."""
    from unigeo_tpu_torch.data.collate import collate_clips
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    batch = []
    for data in samples:
        gt = prepare_gt_label(data)
        d = np.asarray(gt["gt_depths"], np.float32)
        m = np.asarray(gt["gt_masks"], np.float32)
        batch.append({
            "frames": frames_of(data),
            "gt_disp": np.where(m > 0, 1.0 / np.maximum(d, 1e-3), 0.0).astype(np.float32),
            "mask": m,
        })
    return collate_clips(batch)


def _normalized_depth_target(gt, direct_depth: bool) -> np.ndarray:
    """GT depth -> clip-min-max-normalised [0, 1] target on valid pixels:
    inverse depth (the representation DepthCrafter's postprocess inverts) or,
    with ``direct_depth``, depth itself.  Invalid pixels drive neither the
    normalisation nor the target (mid-range fill)."""
    d = np.asarray(gt["gt_depths"], np.float32)
    rep = d if direct_depth else 1.0 / np.maximum(d, 1e-3)
    m = np.asarray(gt["gt_masks"], bool)
    valid = rep[m]
    lo = float(valid.min()) if valid.size else 0.0
    hi = float(valid.max()) if valid.size else 1.0
    return np.where(m, (rep - lo) / max(hi - lo, 1e-8), 0.5)


def _target_frames(data, direct_depth: bool) -> np.ndarray:
    """The depth target in [-1, 1] tiled to 3 channels, [T, 3, H, W] f32."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    x = _normalized_depth_target(prepare_gt_label(data), direct_depth)
    return np.repeat((x * 2.0 - 1.0)[:, None], 3, axis=1).astype(np.float32)


@torch.no_grad()
def build_batch_diffusion(samples, pipe, direct_depth: bool = False,
                          place=None) -> Dict[str, torch.Tensor]:
    """Clips -> an EDM training batch on the pipeline's device, f32, in the
    JAX package's layout: latents and cond_latents [B, T, h, w, 4], context
    [B, T, 1, C].  Target latents encode the GT depth target into the
    scaled (0.18215) latent space in f32 (``pipe.encode_target``: the JAX
    trainer encodes its f32 target through the bf16 VAE, which flax computes
    in f32); the conditioning is the unscaled RGB latent and the CLIP
    context of ``_encode_stage``, in the pipeline dtype.  With a trainer's
    ``place`` (``parallel/trainer.py::MeshPlace``) only its sp block of each
    clip's frames is encoded (every encode is per frame), the target
    normalised over the whole clip first."""
    dev = pipe.device
    block = (lambda x: x) if place is None else (lambda x: place.block(x, "sp", 0))
    lats, conds, ctxs = [], [], []
    for data in samples:
        rgb = block(torch.from_numpy(np.asarray(data["images"], np.float32)))  # [T,3,H,W]
        cond, ctx = pipe._encode_stage((rgb / 255.0).to(dev), None)
        target = block(torch.from_numpy(_target_frames(data, direct_depth)))
        lat = pipe.encode_target(target.contiguous().to(dev))
        lats.append(lat.permute(0, 2, 3, 1).float())
        conds.append(cond.permute(0, 2, 3, 1).float())
        ctxs.append(ctx.float())
    return {
        "latents": torch.stack(lats),
        "cond_latents": torch.stack(conds),
        "context": torch.stack(ctxs),
    }


@torch.no_grad()
def build_batch_aether(samples, model) -> Dict[str, torch.Tensor]:
    """Clips -> the rectified-flow batch on the model's device, f32, in the
    JAX package's layout [B, T', h, w, C]: cond_latents the causal VAE's
    RGB latents; target_latents [depth latents | GT raymaps], the depth
    clip-min-max normalised to [-1, 1] and encoded by the same VAE, the
    raymaps built from the GT poses at the latent keyframe times (the clip
    left-padded to a multiple of ct with copies of frame 0, as the adapter
    pads it)."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.models.aether import latent_key_times, raymap_from_pose

    net = model.network
    ct, cs = net.ct, net.cs
    dtype = model.compute_dtype or torch.float32

    def encode(x):  # [T, 3, H, W] in [-1, 1], left-padded -> [T', h, w, z] f32
        t = torch.from_numpy(x).to(model.device)
        pad = (-t.shape[0]) % ct
        if pad:
            t = torch.cat([t[:1].expand(pad, *t.shape[1:]), t])
        return net.encode(t.to(dtype)).permute(0, 2, 3, 1).float()

    conds, tgts = [], []
    for data in samples:
        t = data["images"].shape[0]
        cond = encode(np.asarray(data["images"], np.float32) / 255.0 * 2.0 - 1.0)
        dep_lat = encode(_target_frames(data, direct_depth=True))
        tl, hl, wl = cond.shape[:3]
        intr_lat = np.diag([1.0 / cs, 1.0 / cs, 1.0]) @ np.asarray(data["intrinsics"][0])
        poses = prepare_gt_label(data)["gt_poses"]
        rays = np.stack([raymap_from_pose(poses[int(k)], intr_lat, hl, wl)
                         for k in latent_key_times(tl, ct, (-t) % ct, t)]).astype(np.float32)
        tgts.append(torch.cat([dep_lat, torch.from_numpy(rays).to(model.device)], dim=-1))
        conds.append(cond)
    return {"target_latents": torch.stack(tgts), "cond_latents": torch.stack(conds)}


def run_training_loop(trainer, make_batch, dataset, args, writer, saver=None,
                      export_params: Optional[Callable[[], Any]] = None,
                      on_step: Optional[Callable[[int, float, float], None]] = None,
                      clips: Optional[range] = None):
    """The one driver every family shares: streams batches, runs and times
    the steps, logs the loss, saves ``export_params()`` through ``saver``
    every ``args.ckpt_every`` steps and after the last.  ``clips``: the
    positions of the batch's ``args.batch_size`` clips this rank builds (its
    dp block; all by default).  On a rank without a ``saver``,
    ``export_params`` is still called at each save (its gathers are
    collective) and nothing is written; only the primary rank prints.  A
    step's time ends when its loss is read back, so when the device has
    finished the update.
    ``on_step(step, loss, seconds)`` is called after each step; with it the
    loop also waits for each batch's device work (such as the VAE encodes)
    before it starts the step's clock, so that a caller who reads the times
    gets the batch's and the step's apart.  Without it nothing waits, and a
    batch's time is the host's.  Returns the losses, the step and batch
    seconds and the checkpoints written."""
    from unigeo_tpu_torch.parallel.multihost import is_primary
    from unigeo_tpu_torch.utils.writers import TimeWriter

    timer = TimeWriter(writer, "step_time")
    batch_timer = TimeWriter(writer, "batch_time")
    timed = on_step is not None and trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if timed else (lambda: None)
    losses, seconds, batch_seconds, saved = [], [], [], []
    every = args.ckpt_every if export_params is not None else 0
    clips = range(args.batch_size) if clips is None else clips
    idx = 0
    for step in range(args.steps):
        with batch_timer:
            samples = [dataset[(idx + i) % len(dataset)] for i in clips]
            batch = make_batch(samples)
            sync()
        idx += args.batch_size
        batch_seconds.append(batch_timer.last)
        with timer:
            loss = float(trainer.train_step(batch))
        losses.append(loss)
        seconds.append(timer.last)
        writer.put_scalar("loss", loss, step)
        if step % 10 == 0 and is_primary():
            print(f"step {step}: loss {loss:.4f} ({timer.avg:.2f}s/step)", flush=True)
        if on_step is not None:
            on_step(step, loss, timer.last)
        if every and (step + 1) % every == 0:
            state = export_params()
            if saver is not None:
                saved.append(saver.save(state, step + 1))
    if every and args.steps % every != 0:  # the final state, not saved yet
        state = export_params()
        if saver is not None:
            saved.append(saver.save(state, args.steps))
    return {"losses": losses, "step_seconds": seconds, "batch_seconds": batch_seconds,
            "checkpoints": saved}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train a model of the PyTorch port (every family of train.py), "
        "from random weights, on one device or (under torchrun) on a dp/sp/tp mesh.")
    parser.add_argument("--config", default=None, help="experiment YAML")
    parser.add_argument("--model", default=None, help="override the config's model")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--ckpt-dir", default="./ckpts")
    parser.add_argument("--ckpt-every", type=int, default=50,
                        help="steps between checkpoints (0: save none)")
    parser.add_argument("--log-dir", default="./train_logs")
    parser.add_argument("--tiny", action="store_true", help="tiny model configs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--mesh", default=None,
        help="dp,sp,tp: the mesh's shape over the processes (its product the world "
        "size; default: mesh.py's _factor of the world size)")
    return parser


def parse_mesh(text: str):
    """"dp,sp,tp" -> (dp, sp, tp), each a positive integer."""
    parts = text.split(",")
    try:
        shape = tuple(int(p) for p in parts)
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: expected dp,sp,tp, three positive integers")
    return shape


def _pointmap_family(name, cfg_net, tiny: bool, device, lr, mesh=None):
    """(trainer, batch builder, export, the trained network) of a pointmap
    model or VideoDepthAnything: the network from ``cfg_net`` (or the tiny
    config) in f32 with random weights from seed 0."""
    from unigeo_tpu_torch.models.pointmap.adapter import build_network
    from unigeo_tpu_torch.parallel.trainer import (
        DisparityTrainer,
        Dust3RTrainer,
        PointmapTrainer,
    )

    if name == "Cut3R":
        from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork as cls, tiny_cut3r_config
        tiny_cfg, trainer_cls = tiny_cut3r_config, PointmapTrainer
    elif name == "Dust3R":
        from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork as cls, tiny_dust3r_config
        tiny_cfg, trainer_cls = tiny_dust3r_config, Dust3RTrainer
    elif name == "Spann3R":
        from unigeo_tpu_torch.models.pointmap.spann3r import (
            Spann3RNetwork as cls,
            tiny_spann3r_config,
        )
        tiny_cfg, trainer_cls = tiny_spann3r_config, PointmapTrainer
    else:
        from unigeo_tpu_torch.models.vda import VDANetwork as cls, tiny_vda_config
        tiny_cfg, trainer_cls = tiny_vda_config, DisparityTrainer
    from unigeo_tpu_torch.parallel.sharding import gather_params

    net = build_network(cls, tiny_cfg() if tiny else cfg_net, device, seed=0)
    trainer = trainer_cls(net.requires_grad_(True), learning_rate=lr, mesh=mesh)
    make_batch = build_batch_disparity if trainer_cls is DisparityTrainer else build_batch_pointmap
    # the whole network in RandomInitAdapter.checkpoint_of's layout
    return trainer, make_batch, lambda: gather_params(net), dict(network=net)


def main(argv=None, config: Optional[Dict[str, Any]] = None,
         on_step: Optional[Callable[[int, float, float], None]] = None) -> Dict[str, Any]:
    """Parse ``argv``, build the dataset, the model and its family's trainer,
    and train.  ``config``: the experiment config as a dict (instead of
    ``--config``).  Returns the trainer, the dataset, the losses, the step
    seconds, the checkpoints written and the trained model: ``pipe``
    (diffusion), ``model`` (the Aether adapter) or ``network``."""
    parser = _parser()
    args = parser.parse_args(argv)

    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from unigeo_tpu_torch.parallel.multihost import (
        initialize_distributed,
        is_primary,
        rank_device,
    )
    from unigeo_tpu_torch.parallel.multihost import world as world_of
    from unigeo_tpu_torch.parallel.sharding import gather_params
    from unigeo_tpu_torch.registry import get_dataset_cls
    from unigeo_tpu_torch.utils.checkpoint import TrainStateSaver
    from unigeo_tpu_torch.utils.writers import EventWriter

    shape = None
    if args.mesh is not None:
        try:
            shape = parse_mesh(args.mesh)
        except ValueError as e:
            parser.error(str(e))
    if args.ckpt_every < 0:
        parser.error("--ckpt-every must be >= 0")
    if config is None:
        if args.config is None:
            parser.error("--config is required when no config dict is given")
        cfg = EvalConfig.from_yaml(args.config)
    else:
        cfg = EvalConfig.from_dict(config)
    if args.model:
        cfg = EvalConfig.from_dict(dict(cfg.raw, model_name=args.model))
    name = cfg.model_name
    if name not in DIFFUSION_MODELS + POINTMAP_MODELS + ("VideoDepthAnything", "Aether"):
        raise SystemExit(
            f"the training driver trains the pointmap models (Spann3R, Cut3R, Dust3R), the "
            f"diffusion models ({', '.join(DIFFUSION_MODELS)}), the flow-matching Aether and "
            f"the feed-forward VideoDepthAnything; got model {name!r}")

    device = resolve_device(args.device)
    mesh = None
    if shape is not None or (initialize_distributed(device=device.type)
                             and world_of()[0] > 1):
        world = world_of()[0]
        try:
            mesh = make_mesh(world, mesh_shape(world, shape), device=device.type)
        except ValueError as e:
            parser.error(f"--mesh: {e}")
        device = rank_device(device)
    dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    mp = dict(cfg.model_params or {})
    if name in DIFFUSION_MODELS:
        from unigeo_tpu_torch.models.depthcrafter.pipeline import (
            DepthCrafterPipeline,
            tiny_pipeline,
        )
        from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer

        if args.tiny:
            pipe = tiny_pipeline(device=device)
        else:
            # the config's architecture, so that the checkpoint loads into
            # the eval model built from the same config
            pipe = DepthCrafterPipeline(unet_config=mp.get("unet_config"),
                                        vae_config=mp.get("vae_config"),
                                        clip_config=mp.get("clip_config"), device=device)
        pipe.init_random(torch.Generator(device=device).manual_seed(0))
        # the UNet takes gradients; the VAE and CLIP stay frozen
        trainer = DiffusionTrainer(pipe.unet.requires_grad_(True), learning_rate=args.lr,
                                   mesh=mesh)
        direct = name in DIRECT_DEPTH_MODELS
        try:
            trainer.place.span(cfg.dataset_kwargs["clip_length"], "sp")
        except ValueError as e:
            parser.error(f"the clips: {e}")
        make_batch = lambda samples: build_batch_diffusion(samples, pipe, direct_depth=direct,
                                                           place=trainer.place)
        export = lambda: dict(pipe.checkpoint(), unet=gather_params(pipe.unet))
        extra = dict(pipe=pipe)
    elif name == "Aether":
        from unigeo_tpu_torch.models.aether import Aether, tiny_aether
        from unigeo_tpu_torch.parallel.trainer import FlowMatchingTrainer

        model = tiny_aether(device=device) if args.tiny else Aether(**dict(mp, device=device))
        trainer = FlowMatchingTrainer(model.network.dit.requires_grad_(True),
                                      learning_rate=args.lr, mesh=mesh)
        make_batch = lambda samples: build_batch_aether(samples, model)
        # the trained DiT beside the frozen VAE that made its targets
        export = lambda: dict(Aether.checkpoint_of(model.network),
                              dit=gather_params(model.network.dit))
        extra = dict(model=model)
    else:
        trainer, make_batch, export, extra = _pointmap_family(
            name, mp.get("network_config") or {}, args.tiny, device, args.lr, mesh)

    try:
        clips = trainer.place.span(args.batch_size, "dp")
    except ValueError as e:
        parser.error(f"--batch-size: {e}")
    primary = is_primary()
    writer = EventWriter(args.log_dir) if primary else None
    saver = TrainStateSaver(args.ckpt_dir) if args.ckpt_every and primary else None
    result = run_training_loop(trainer, make_batch, dataset, args,
                               writer if primary else _NoWriter(), saver,
                               export if args.ckpt_every else None, on_step=on_step,
                               clips=clips)
    if primary:
        where = (f"checkpoints in {args.ckpt_dir}" if saver
                 else "no checkpoint (--ckpt-every 0)")
        grid = "" if mesh is None else f" on a dp,sp,tp mesh of {tuple(mesh.mesh.shape)}"
        print(f"done: {name}{grid}, {args.steps} steps, final loss "
              f"{result['losses'][-1]:.4f}; {where}", flush=True)
    return dict(result, trainer=trainer, dataset=dataset, mesh=mesh, **extra)


class _NoWriter:
    """The event writer of a rank that logs nothing (all but rank 0)."""

    def put_scalar(self, name, value, step) -> None:
        pass


if __name__ == "__main__":
    main()
