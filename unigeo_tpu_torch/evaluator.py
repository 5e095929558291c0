"""The evaluator, port of ``unigeo_tpu/evaluator.py``: dataset -> model ->
GT -> metrics -> CSV.

Config-driven: the dataset and the model come from the registries (the
model's ``**model_params`` from the config), each ``eval_*`` section turns
one metric family on, and the per-sequence rows stream into
``<save_dir>/metrics.csv`` after every clip (``metrics/manager.py``).

As in the JAX package:
  * resumable: sequences already in the CSV are skipped;
  * ``max_clips``, ``strict`` (the clip-sample contract checked on every
    clip) and ``verbose``;
  * per-clip seconds and frames/s (``utils/profiling.py::ClipTimer``);
  * async metrics: clip i is scored on one worker thread while clip i+1's
    forward runs; the queue holds at most two clips, a worker's error is
    raised before the next forward, and the pool is shut down on every exit;
  * ``num_workers`` > 0: clips are decoded ahead on that many host threads
    (``data/prefetch.py``), in order;
  * ``data_parallel`` resolved as there: auto is on for a model with
    ``forward_batch`` that asks for a batch (``eval_batch_size`` > 1, on one
    GPU DepthCrafter's ``clips_per_step``), and an explicit request for a
    model without ``forward_batch`` raises.  Batched clips are handed to
    ``forward_batch`` ``eval_batch_size`` at a time (the last batch may be
    short), timed as one block of all their frames, and recorded in order.

The four metric families: depth, normals, point clouds (``eval_pcd``, on
``device``: the card unless the caller asks for the CPU) and camera poses
(``eval_camera``, numpy f64 on the host); with ``vis_pcd`` each clip's
aligned clouds go to ``<save_dir>/pcd_<seq>/{pred,gt}.ply``.

Not ported yet, and raising with their ROADMAP item instead of running
something else: runs over several processes (queue 1 item 11) and
``debug_nans`` (item 12).
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from unigeo_tpu_torch.config import EvalConfig
from unigeo_tpu_torch.data.sample import prepare_gt_label, validate_sample
from unigeo_tpu_torch.metrics.camera import camera_pose_evaluation
from unigeo_tpu_torch.metrics.depth import depth_evaluation
from unigeo_tpu_torch.metrics.manager import MetricsManager
from unigeo_tpu_torch.metrics.normal import normal_evaluation
from unigeo_tpu_torch.metrics.pointcloud import pcd_evaluation
from unigeo_tpu_torch.registry import get_dataset_cls, get_model_cls
from unigeo_tpu_torch.utils.profiling import ClipTimer


def _refuse_unported(debug_nans: bool) -> None:
    if debug_nans:
        raise NotImplementedError("debug_nans is not ported yet (ROADMAP queue 1 item 12)")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "an eval over several processes is not ported yet (ROADMAP queue 1 item 11)")


def evaluate_clip(cfg: EvalConfig, output: Dict[str, Any], gt_label: Dict[str, Any],
                  device="cuda") -> Dict[str, Any]:
    """Score one clip's predictions against its GT labels; the point-cloud
    metrics run on ``device``, and their clouds come back under
    ``_pcd_clouds`` ((points, colours) of pred and gt)."""
    metric: Dict[str, Any] = {}
    if cfg.eval_depth:
        res, *_ = depth_evaluation(
            output["pred_depths"], gt_label["gt_depths"], custom_mask=gt_label["gt_masks"],
            alignment=cfg.depth_alignment, max_depth=cfg.max_depth,
        )
        metric.update(res)
    if cfg.eval_normal:
        metric.update(normal_evaluation(output["pred_normals"], gt_label["gt_normals"],
                                        custom_mask=gt_label["gt_masks"]))
    if cfg.eval_pcd:
        pcd_res = pcd_evaluation(output["pred_world_pts"], gt_label["gt_world_pts"],
                                 gt_label["gt_masks"], rgbs=gt_label["gt_rgbs"],
                                 downsample_num=cfg.pcd_downsample_num, device=device)
        metric["_pcd_clouds"] = (pcd_res.pop("pred_pcd"), pcd_res.pop("gt_pcd"))
        pcd_res.pop("alignment")
        metric.update(pcd_res)
    if cfg.eval_camera:
        ate, rpe_trans, rpe_rot = camera_pose_evaluation(output["pred_poses"],
                                                         gt_label["gt_poses"])
        metric.update({"ATE": ate, "RPE trans": rpe_trans, "RPE rot": rpe_rot})
    return metric


def run_evaluation(
    cfg: EvalConfig,
    save_dir: str = "./debug_output",
    resume: bool = True,
    max_clips: Optional[int] = None,
    dataset=None,
    model=None,
    verbose: bool = True,
    strict: bool = False,
    debug_nans: bool = False,
    num_workers: int = 0,
    data_parallel: Optional[bool] = None,
    async_metrics: bool = True,
    timer: Optional[ClipTimer] = None,
    device="cuda",
) -> MetricsManager:
    """The full eval loop; returns the manager holding every row.

    dataset / model: instances to use instead of the config's (the config's
    ``model_params`` build the model otherwise).
    num_workers: host threads that decode clips ahead (0: on the main thread).
    data_parallel: None = auto (on when the model has ``forward_batch`` and
        ``eval_batch_size`` > 1); True for a model without ``forward_batch``
        raises.
    async_metrics: score on one worker thread (default); off scores on the
        main thread (clean stack traces).
    timer: the ``ClipTimer`` that times each forward (a new one by default);
        give one with a ``jsonl_path`` to keep each clip's seconds and frames/s.
    device: where the point-cloud metrics run (the card by default, and a
        missing card is an error; "cpu" when asked for).
    """
    _refuse_unported(debug_nans)
    os.makedirs(save_dir, exist_ok=True)
    save_path = os.path.join(save_dir, "metrics.csv")
    if dataset is None:
        dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    if model is None:
        model = get_model_cls(cfg.model_name)(**cfg.model_params)

    manager = (MetricsManager.from_csv(save_path, cfg.metric_names) if resume
               else MetricsManager(cfg.metric_names))
    timer = ClipTimer() if timer is None else timer
    n = len(dataset) if max_clips is None else min(max_clips, len(dataset))
    if num_workers > 0:
        from unigeo_tpu_torch.data.prefetch import PrefetchLoader

        stream = enumerate(PrefetchLoader(dataset, num_workers=num_workers, indices=range(n)))
    else:
        stream = ((i, dataset[i]) for i in range(n))

    if data_parallel is None:
        data_parallel = (hasattr(model, "forward_batch")
                         and getattr(model, "eval_batch_size", 1) > 1)
    if data_parallel and not hasattr(model, "forward_batch"):
        raise ValueError(
            f"data_parallel requested but {type(model).__name__} has no forward_batch")
    batch_size = max(1, getattr(model, "eval_batch_size", 1)) if data_parallel else 1

    def _record(seq: str, data, output) -> None:
        gt_label = prepare_gt_label(data)
        metric = {"seq_name": seq}
        metric.update(evaluate_clip(cfg, output, gt_label, device=device))
        clouds = metric.pop("_pcd_clouds", None)
        if cfg.vis_pcd and clouds is not None:
            from unigeo_tpu_torch.utils.vis import save_point_cloud

            pcd_dir = os.path.join(save_dir, f"pcd_{seq}")
            save_point_cloud(*clouds[0], os.path.join(pcd_dir, "pred.ply"))
            save_point_cloud(*clouds[1], os.path.join(pcd_dir, "gt.ply"))
        if cfg.vis_depth:
            from unigeo_tpu_torch.utils.vis import save_depth_normal_maps

            save_depth_normal_maps(output.get("pred_depths"), output.get("pred_normals"),
                                   os.path.join(save_dir, f"depth_{seq}"),
                                   rgbs=gt_label["gt_rgbs"])
        manager.update_metrics(metric)
        manager.export_to_csv(save_path)
        if verbose:
            shown = {k: round(v, 5) for k, v in metric.items()
                     if isinstance(v, (int, float)) and k in cfg.metric_names}
            print(f"  {shown}  [{timer.summary()}]")

    # one worker scores clip i while the main thread runs clip i+1's forward;
    # the bounded deque caps the outputs held, result() re-raises a worker's
    # error on the main thread
    record_pool = ThreadPoolExecutor(1, thread_name_prefix="metrics") if async_metrics else None
    record_q: collections.deque = collections.deque()

    def _submit_record(seq, data, output) -> None:
        if record_pool is None:
            _record(seq, data, output)
            return
        while len(record_q) >= 2:
            record_q.popleft().result()
        record_q.append(record_pool.submit(_record, seq, data, output))

    def _check_worker() -> None:
        """A finished worker's failure, raised before the next forward."""
        while record_q and record_q[0].done():
            record_q.popleft().result()

    pending = []  # [(seq, data)] waiting to fill a batch

    def _flush() -> None:
        if not pending:
            return
        with timer.clip(num_frames=sum(len(d["images"]) for _, d in pending)):
            outputs = model.forward_batch([d for _, d in pending])
        for (seq, data), output in zip(pending, outputs):
            _submit_record(seq, data, output)
        pending.clear()

    try:
        for data_idx, data in stream:
            _check_worker()
            seq = f"{data_idx:03d}_{data['scene_name']}"
            if resume and manager.has_sequence(seq):
                continue
            if strict:
                validate_sample(data)
            if verbose:
                print(f"processing seq: {seq}")
            if batch_size > 1:
                pending.append((seq, data))
                if len(pending) >= batch_size:
                    _flush()
                continue
            with timer.clip(num_frames=len(data["images"])):
                output = model.forward(data)
            _submit_record(seq, data, output)
        _flush()
        while record_q:
            record_q.popleft().result()
    finally:
        # every exit: cancel queued records and wait out a running one, so no
        # thread outlives this call
        if record_pool is not None:
            record_pool.shutdown(wait=True, cancel_futures=True)
    return manager
