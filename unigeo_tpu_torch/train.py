"""Config-driven training CLI of the port: the DepthCrafter UNet.

    python -m unigeo_tpu_torch.train --config configs/<experiment>.yaml \
        [--steps 100] [--batch-size 1] [--lr 1e-4] [--tiny] [--device cuda]

Port of ``train.py``'s DepthCrafter branch: EDM diffusion fine-tuning of the
UNet (``parallel/trainer.py::DiffusionTrainer``) on VAE-encoded clips of the
config's dataset, with VAE and CLIP frozen.  Each step builds its batch
(``build_batch_diffusion``: conditioning latents and CLIP context of the
frames, target latents of the clip-normalised inverse GT depth), then runs
the loss, its backward (through the flash-attention backward kernels on the
card) and one AdamW update.

The weights are random, drawn on the device from a fixed seed (no published
checkpoint is in the repository).  It runs on the card unless ``--device cpu`` is
given.  The other trainer families of ``train.py`` (pointmap, flow
matching, disparity) and the other diffusion models are not ported yet
(ROADMAP queue 1 item 10), nor are checkpoint IO (queue 1 item 9) and the
device mesh (queue 1 item 11): ``--ckpt-dir`` and ``--mesh`` are refused.

``main(argv, config=dict)`` takes the experiment config as a dict instead of
``--config``, so a caller needs neither a YAML file nor the ``yaml`` package.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

TRAINER_ROADMAP = "ROADMAP.md queue 1 item 10"
CHECKPOINT_ROADMAP = "ROADMAP.md queue 1 item 9"
PARALLEL_ROADMAP = "ROADMAP.md queue 1 item 11"


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


@torch.no_grad()
def build_batch_diffusion(samples, pipe, direct_depth: bool = False) -> Dict[str, torch.Tensor]:
    """Clips -> an EDM training batch on the pipeline's device, f32, in the
    JAX package's layout: latents and cond_latents [B, T, h, w, 4], context
    [B, T, 1, C].  Target latents encode the GT depth target in [-1, 1],
    tiled to 3 channels, into the scaled (0.18215) latent space; the
    conditioning is the unscaled RGB latent and the CLIP context of
    ``_encode_stage``."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    dev = pipe.device
    lats, conds, ctxs = [], [], []
    for data in samples:
        frames = np.asarray(data["images"], np.float32) / np.float32(255.0)  # [T,3,H,W]
        x = _normalized_depth_target(prepare_gt_label(data), direct_depth)
        x3 = np.repeat((x * 2.0 - 1.0)[:, None], 3, axis=1).astype(np.float32)  # [T,3,H,W]
        cond, ctx = pipe._encode_stage(torch.from_numpy(frames).to(dev), None)
        lat = pipe.vae.encode_scaled(torch.from_numpy(x3).to(dev).to(pipe.dtype))
        lats.append(lat.permute(0, 2, 3, 1).float())
        conds.append(cond.permute(0, 2, 3, 1).float())
        ctxs.append(ctx.float())
    return {
        "latents": torch.stack(lats),
        "cond_latents": torch.stack(conds),
        "context": torch.stack(ctxs),
    }


def run_training_loop(trainer, make_batch, dataset, args, writer,
                      on_step: Optional[Callable[[int, float, float], None]] = None):
    """Streams batches, runs and times the steps (the loss is read back, so a
    step's time ends when the device has finished it) and logs the loss.
    ``on_step(step, loss, seconds)`` is called after each step.  Returns the
    losses and step seconds."""
    from unigeo_tpu_torch.utils.writers import TimeWriter

    timer = TimeWriter(writer, "step_time")
    losses, seconds = [], []
    idx = 0
    for step in range(args.steps):
        samples = [dataset[(idx + i) % len(dataset)] for i in range(args.batch_size)]
        idx += args.batch_size
        batch = make_batch(samples)
        with timer:
            loss = float(trainer.train_step(batch))
        losses.append(loss)
        seconds.append(timer.last)
        writer.put_scalar("loss", loss, step)
        if step % 10 == 0:
            print(f"step {step}: loss {loss:.4f} ({timer.avg:.2f}s/step)", flush=True)
        if on_step is not None:
            on_step(step, loss, timer.last)
    return {"losses": losses, "step_seconds": seconds}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train the DepthCrafter UNet of the PyTorch port "
        "(EDM v-prediction, AdamW), from random weights.")
    parser.add_argument("--config", default=None, help="experiment YAML")
    parser.add_argument("--model", default=None, help="override the config's model")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument(
        "--ckpt-dir", default=None,
        help=f"not available yet: checkpoint IO waits for {CHECKPOINT_ROADMAP}; "
        "the port saves nothing and refuses this option")
    parser.add_argument("--log-dir", default="./train_logs")
    parser.add_argument("--tiny", action="store_true", help="tiny model configs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--mesh", default=None,
        help=f"not available yet: the trainer runs on one device; the mesh and its "
        f"sharding wait for {PARALLEL_ROADMAP}")
    return parser


def main(argv=None, config: Optional[Dict[str, Any]] = None,
         on_step: Optional[Callable[[int, float, float], None]] = None) -> Dict[str, Any]:
    """Parse ``argv``, build the dataset, the pipeline and the trainer, and
    train.  ``config``: the experiment config as a dict (instead of
    ``--config``).  Returns the trainer, the pipeline, the dataset, the
    losses and the step seconds."""
    parser = _parser()
    args = parser.parse_args(argv)

    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline, tiny_pipeline
    from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer
    from unigeo_tpu_torch.registry import get_dataset_cls
    from unigeo_tpu_torch.utils.writers import EventWriter

    if args.ckpt_dir is not None:
        parser.error(f"--ckpt-dir: checkpoint IO is not ported yet ({CHECKPOINT_ROADMAP})")
    if args.mesh is not None:
        parser.error(f"--mesh: the trainer runs on one device ({PARALLEL_ROADMAP})")
    if config is None:
        if args.config is None:
            parser.error("--config is required when no config dict is given")
        cfg = EvalConfig.from_yaml(args.config)
    else:
        cfg = EvalConfig.from_dict(config)
    if args.model:
        cfg = EvalConfig.from_dict(dict(cfg.raw, model_name=args.model))
    if cfg.model_name != "DepthCrafter":
        raise SystemExit(
            f"the port's training driver has the DepthCrafter trainer only; "
            f"{cfg.model_name!r} waits for {TRAINER_ROADMAP}")

    device = resolve_device(args.device)
    dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    if args.tiny:
        pipe = tiny_pipeline(device=device)
    else:
        mp = dict(cfg.model_params or {})
        pipe = DepthCrafterPipeline(
            unet_config=mp.get("unet_config"),
            vae_config=mp.get("vae_config"),
            clip_config=mp.get("clip_config"),
            device=device,
        )
    pipe.init_random(torch.Generator(device=device).manual_seed(0))
    # the trainer's UNet takes gradients; VAE and CLIP stay frozen (the
    # pipeline builds all three with requires_grad off)
    trainer = DiffusionTrainer(pipe.unet.requires_grad_(True), learning_rate=args.lr)
    writer = EventWriter(args.log_dir)
    result = run_training_loop(
        trainer, lambda samples: build_batch_diffusion(samples, pipe), dataset, args,
        writer, on_step=on_step,
    )
    print(f"done: {args.steps} steps, final loss {result['losses'][-1]:.4f}", flush=True)
    return dict(result, trainer=trainer, pipe=pipe, dataset=dataset)


if __name__ == "__main__":
    main()
