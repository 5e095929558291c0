"""Run one function on N ranks, each a process of this machine.

    results = run_ranks("package.module:function", n, job, workdir)

starts ``python -m unigeo_tpu_torch.parallel.launch`` n times with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``);
each rank joins the default process group through a ``FileStore`` in
``workdir`` (no port is picked), calls ``function(job)`` and pickles what it
returns; ``run_ranks`` returns those results in rank order.  The backend is
``multihost.backend_for(device)``'s: gloo on the CPU and for ranks that
share a card.  A rank that fails or outlives ``timeout`` stops every rank,
and the error names it with the end of its output.  The multi-process tests,
``tools/dryrun_multichip.py`` and ``chip_smoke.py`` drive the parallel
executors this way.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from typing import Any, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(target: str, world_size: int, job: Any, workdir: str, device: str = "cpu",
              timeout: float = 600.0, threads: Optional[int] = None,
              python_path: Sequence[str] = ()) -> List[Any]:
    """``target`` ("module:function") on ``world_size`` ranks -> each rank's
    return value, in rank order.

    threads: torch's CPU threads a rank (``OMP_NUM_THREADS``); python_path:
    directories the ranks import from besides the repository."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join([REPO, *python_path, base.get("PYTHONPATH", "")])
    if threads:
        base["OMP_NUM_THREADS"] = str(threads)
    procs, logs = [], []
    for rank in range(world_size):
        rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(world_size))
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "unigeo_tpu_torch.parallel.launch", target, workdir, device],
            env=rank_env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    failed, deadline = None, time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks outlived {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        culprit = int(failed.split()[1]) if failed.startswith("rank") else 0
        with open(os.path.join(workdir, f"rank{culprit}.log")) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{target} on {world_size} ranks: {failed}\n{tail}")
    results = []
    for rank in range(world_size):
        with open(os.path.join(workdir, f"result.rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _main(target: str, workdir: str, device: str) -> int:
    import torch
    import torch.distributed as dist

    from unigeo_tpu_torch.parallel.multihost import initialize_distributed

    if "OMP_NUM_THREADS" in os.environ:
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    initialize_distributed(init_method="file://" + os.path.join(workdir, "store"),
                           world_size=world_size, rank=rank, device=device)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    result = fn(job)
    with open(os.path.join(workdir, f"result.rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(*sys.argv[1:4]))
