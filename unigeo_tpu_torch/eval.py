"""The port's eval CLI, the counterpart of the repository's ``eval.py``.

    python -m unigeo_tpu_torch.eval --config CONFIG [--output DIR]
        [--max-clips N] [--no-resume] [--strict] [--device cuda|cpu] ...

CONFIG is a YAML file (read with PyYAML, imported only then).
The model and the point-cloud metrics run on ``--device`` (default
``cuda``; a missing card is an error, the CPU only when asked for); the
model is built here from the config's ``model_params`` with that device.
``--validate-root`` checks the dataset's layout on disk (files, depth scale,
poses, intrinsics, one sample), prints the report and exits 0 if nothing
failed, 1 otherwise; ``--num-workers N`` decodes clips ahead on N threads;
``--clip-times FILE`` appends one JSON line per timed clip (a batch of
clips through ``forward_batch`` is one line).
The reader that decodes the stock image files (``native``, the C++ clip
reader built with g++ on first use, or ``pil``) is printed once.
``--debug-nans`` raises with its ROADMAP item (not ported yet).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from unigeo_tpu_torch.config import EvalConfig
from unigeo_tpu_torch.evaluator import run_evaluation
from unigeo_tpu_torch.registry import get_model_cls
from unigeo_tpu_torch.utils.profiling import ClipTimer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True, help="experiment YAML path")
    parser.add_argument("--output", default="./debug_output", help="results dir")
    parser.add_argument("--max-clips", type=int, default=None)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--strict", action="store_true",
                        help="validate the clip-sample contract per clip")
    parser.add_argument("--debug-nans", action="store_true")
    parser.add_argument("--num-workers", type=int, default=0,
                        help="prefetch clips with this many threads")
    parser.add_argument("--data-parallel", dest="data_parallel", action="store_true",
                        default=None, help="batch clips through the model's forward_batch")
    parser.add_argument("--no-data-parallel", dest="data_parallel", action="store_false",
                        help="force the serial clip loop")
    parser.add_argument("--no-async-metrics", dest="async_metrics", action="store_false",
                        default=True, help="score clips on the main thread (debugging)")
    parser.add_argument("--validate-root", action="store_true",
                        help="preflight the dataset layout and exit")
    parser.add_argument("--clip-times", default=None, metavar="JSONL",
                        help="append each clip's seconds and frames/s to this JSON-lines file")
    parser.add_argument("--device", default="cuda", help="the model's and the point-cloud metrics' device (cuda or cpu)")
    return parser.parse_args(argv)


def validate_root_main(cfg: EvalConfig) -> int:
    """Print the preflight report of the config's dataset; 0 if it passed."""
    from unigeo_tpu_torch.data.preflight import format_report, validate_root
    from unigeo_tpu_torch.registry import get_dataset_cls

    try:
        dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    except Exception as e:
        print(f"preflight: {cfg.dataset} — FAILED\n  ✗ construct: {type(e).__name__}: {e}")
        return 1
    result = validate_root(dataset)
    print(format_report(result))
    return 0 if result["ok"] else 1


def main(argv: Optional[List[str]] = None):
    from unigeo_tpu_torch import native

    args = parse_args(argv)
    cfg = EvalConfig.from_yaml(args.config)
    reason = f" (the native reader did not build: {native.build_error})" if native.build_error else ""
    print(f"clip reader: {native.reader_name()}{reason}", flush=True)
    if args.validate_root:
        sys.exit(validate_root_main(cfg))
    model = get_model_cls(cfg.model_name)(**{**cfg.model_params, "device": args.device})
    manager = run_evaluation(
        cfg,
        save_dir=args.output,
        resume=not args.no_resume,
        max_clips=args.max_clips,
        model=model,
        strict=args.strict,
        debug_nans=args.debug_nans,
        num_workers=args.num_workers,
        data_parallel=args.data_parallel,
        async_metrics=args.async_metrics,
        timer=ClipTimer(jsonl_path=args.clip_times),
        device=args.device,
    )
    print("Averages:")
    for name, value in manager.calculate_averages().items():
        print(f"  {name}: {value:.5f}")
    return manager


if __name__ == "__main__":
    main()
