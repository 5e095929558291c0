"""The port's eval CLI, the counterpart of the repository's ``eval.py``.

    python -m unigeo_tpu_torch.eval --config CONFIG [--output DIR]
        [--max-clips N] [--no-resume] [--strict] [--device cuda|cpu] ...

CONFIG is a YAML file (read with PyYAML, imported only then).
The model and the point-cloud metrics run on ``--device`` (default
``cuda``; a missing card is an error, the CPU only when asked for); the
model is built here from the config's ``model_params`` with that device.
Flags the port does not support yet
(``--num-workers`` > 0, ``--debug-nans``, ``--validate-root``) raise with
their ROADMAP item.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from unigeo_tpu_torch.config import EvalConfig
from unigeo_tpu_torch.evaluator import run_evaluation
from unigeo_tpu_torch.registry import get_model_cls


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
    parser.add_argument("--device", default="cuda", help="the model's and the point-cloud metrics' device (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    if args.validate_root:
        raise NotImplementedError("--validate-root: the dataset preflight is not ported yet "
                                  "(ROADMAP queue 1 item 4)")
    cfg = EvalConfig.from_yaml(args.config)
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
        device=args.device,
    )
    print("Averages:")
    for name, value in manager.calculate_averages().items():
        print(f"  {name}: {value:.5f}")
    return manager


if __name__ == "__main__":
    main()
