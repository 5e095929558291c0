"""The port's parallel executors over several gloo ranks on the CPU
(``unigeo_tpu_torch/parallel/``), against the port's serial paths and the
JAX package's executors, on the tiny f32 models with the JAX weights
(``utils/weights.py``) and the same numpy-seeded noise on both sides.

Two launches of ``parallel/launch.py::run_ranks`` (ranks rendezvous through
a ``FileStore`` in ``tmp_path``; ``tests/torch_parallel_ranks.py`` holds the
rank functions), each once per module:

  * 2 ranks: ``ShardedClipExecutor`` over dp = 2 on B = 3 clips (the last
    step padded), ``StableNormal._run_frames_dp``, ``denoise_context_parallel``
    over sp = 2 at T = 8 with two planted faults, ``flow_sample_context_
    parallel`` over sp = 2, the rows gather, the pp executor's refusal, and
    the eval CLI on ``configs/identity_synthetic.yaml`` twice (resumed);
  * 4 ranks: ``PipelinedStageExecutor`` (encode, decode, the frames over
    ranks 2 and 3) on B = 2 clips of T = 4, the flow sampler over sp = 4, and
    the dp executor on a (2, 1, 2) mesh (tp 2 inside each dp rank).

The JAX references run in this process on conftest's 8 virtual CPU devices.
Tolerances (relative to the reference's largest magnitude unless said):

  * dp: each clip bitwise the port's serial ``run_window_staged`` (the
    executor runs one clip a rank through ``run_clips_staged``, whose B = 1
    clip is the serial one's computation); against JAX's executor on a
    2-device mesh, and on (2, 1, 2) with tp 2 against JAX's on the same
    mesh over ``shard_params``, 1e-3 (``tests/test_torch_windows.py``'s bound for a
    window: five steps from sigma_max = 700 carry the f32 differences);
  * StableNormal over dp against its one-device path: 2e-4 (the encoder
    and the denoise run one frame a call instead of N, which reorders f32
    sums; measured 2.9e-5);
  * sp UNet denoise against the unsplit loop: 2e-4 at 1 step and 4e-4 at 2
    (measured 4.8e-5 at both; ``tests/test_training.py`` holds JAX's at
    2e-3 / 3e-3), against JAX's ``denoise_context_parallel`` and its unsplit
    stage 2e-3 / 3e-3; each planted fault (the temporal convs without the
    neighbours' frames; the temporal group norms on one rank's frames) must
    miss the 1-step bound by 10x or more (measured 845x and 250x);
  * Aether's flow sampler over sp = 2 and 4 against the port's ``sample``
    and JAX's ``_sample`` / ``flow_sample_context_parallel``: 2e-4 absolute
    (``tests/test_aether.py``'s bound; the port's split bitwise its serial
    sampler at sp = 2 here);
  * pp against the port's serial path and JAX's ``PipelinedStageExecutor``
    (sp = 4 there): 2e-3 (``tests/test_staged_pipeline.py``'s bound);
    measured 9.9e-5 against the serial path on 4 ranks (the dry run);
  * the eval: the merged ``metrics.csv`` against one process's within 1e-6
    relative (the same clips, the same code, one rank's threads).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu_torch.parallel.launch import run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
IDENTITY = os.path.join(ROOT, "configs", "identity_synthetic.yaml")
H = W = 64
LAUNCH_TIMEOUT = 240


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def clips(seed, b, t):
    rng = np.random.default_rng(seed)
    return dict(frames=rng.uniform(size=(b, t, H, W, 3)).astype(np.float32),
                noise=rng.normal(size=(b, t, H // 8, W // 8, 4)).astype(np.float32),
                aug=rng.normal(size=(b, t, H, W, 3)).astype(np.float32))


def aether_parts():
    from test_torch_aether import NET, TARGET, VAE, jax_params, port_network

    return NET, VAE, TARGET, jax_params()[1], port_network()


def flow_inputs(target, z):
    rng = np.random.default_rng(6)
    return dict(cond=rng.normal(size=(4, 8, 8, z)).astype(np.float32),
                noise=rng.normal(size=(4, 8, 8, target)).astype(np.float32))


def nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1))


def jax_aether(net_cfg, target):
    from unigeo_tpu.models.aether import Aether as JAether, AetherDiT as JDiT

    model = JAether.__new__(JAether)
    model.dit = JDiT(out_channels=target, **net_cfg)
    model._sample = jax.jit(model._flow_sample, static_argnames=("steps",))
    return model


@pytest.fixture(scope="module")
def job(shared_tiny_pipeline, tmp_path_factory):
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

    jp = shared_tiny_pipeline
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    net_cfg, vae_cfg, target, _, net = aether_parts()
    sp_frames = np.random.default_rng(0).uniform(size=(8, H, W, 3)).astype(np.float32)
    cond, ctx = jp._encode_stage(jp.params, jnp.asarray(sp_frames))
    sp_noise = np.random.default_rng(1).normal(size=(8, H // 8, W // 8, 4)).astype(np.float32)
    sn = clips(4, 1, 3)
    return dict(
        pipeline=pipeline_state_dicts(jp.params, pp),
        aether=net.state_dict(), aether_net=net_cfg, aether_vae=vae_cfg,
        dp=clips(2, 3, 2),
        sn=dict(frames=sn["frames"][0], noise=sn["noise"][0, :1], aug=sn["aug"][0, :1]),
        sp=dict(frames=sp_frames, cond=nchw(cond), ctx=np.asarray(ctx, np.float32),
                noise=nchw(sp_noise), cond_nhwc=np.asarray(cond), noise_nhwc=sp_noise),
        flow=flow_inputs(target, vae_cfg["z_channels"]),
        pp=clips(3, 2, 4),
        eval_config=IDENTITY,
        eval_dir=str(tmp_path_factory.mktemp("parallel_eval")),
    )


@pytest.fixture(scope="module")
def two(job, tmp_path_factory):
    flow = job["flow"]
    ranks_job = dict(job, flow=dict(cond=nchw(flow["cond"]), noise=nchw(flow["noise"])))
    return run_ranks("torch_parallel_ranks:two_ranks", 2, ranks_job,
                     str(tmp_path_factory.mktemp("ranks2")), python_path=[TESTS], threads=1,
                     timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def four(job, tmp_path_factory):
    flow = job["flow"]
    ranks_job = dict(job, flow=dict(cond=nchw(flow["cond"]), noise=nchw(flow["noise"])))
    del ranks_job["dp"], ranks_job["sp"], ranks_job["sn"]
    return run_ranks("torch_parallel_ranks:four_ranks", 4, ranks_job,
                     str(tmp_path_factory.mktemp("ranks4")), python_path=[TESTS], threads=1,
                     timeout=LAUNCH_TIMEOUT)


# --- dp --------------------------------------------------------------------------


def test_dp_executor_every_rank_gets_every_clip(two):
    assert [r["dp_batch_size"] for r in two] == [2, 2]
    assert two[0]["dp"].shape == (3, 2, H, W, 3)
    assert np.array_equal(two[0]["dp"], two[1]["dp"])


def test_dp_executor_equals_the_serial_path(two):
    for r in two:
        for i, serial in r["serial"].items():
            assert np.array_equal(r["dp"][i], serial), i


def test_dp_executor_matches_jax(two, job, shared_tiny_pipeline):
    from unigeo_tpu.parallel.executor import ShardedClipExecutor
    from unigeo_tpu.parallel.mesh import make_mesh

    dp = job["dp"]
    ex = ShardedClipExecutor(shared_tiny_pipeline, make_mesh(2, shape=(2, 1, 1)),
                             num_inference_steps=2)
    ref = ex(dp["frames"], noise=dp["noise"], aug_noise=dp["aug"])
    assert rel_dev(two[0]["dp"], ref) < 1e-3


def test_stablenormal_dp_matches_one_device(two):
    assert [r["sn_batch_size"] for r in two] == [2, 2]
    for r in two:
        assert r["sn_dp"].shape == (3, H, W, 3)
        assert rel_dev(r["sn_dp"], r["sn_single"]) < 2e-4


# --- sp --------------------------------------------------------------------------

SP_BOUNDS = {1: 2e-4, 2: 4e-4}
JAX_SP_BOUNDS = {1: 2e-3, 2: 3e-3}


@pytest.mark.parametrize("steps", [1, 2])
def test_sp_denoise_matches_the_unsplit_loop(two, steps):
    assert np.array_equal(two[0][f"sp_{steps}"], two[1][f"sp_{steps}"])
    assert rel_dev(two[0][f"sp_{steps}"], two[0][f"serial_{steps}"]) < SP_BOUNDS[steps]


@pytest.mark.parametrize("steps", [1, 2])
def test_sp_denoise_matches_jax(two, job, shared_tiny_pipeline, steps):
    from unigeo_tpu.parallel.context import denoise_context_parallel
    from unigeo_tpu.parallel.mesh import make_mesh

    jp, sp = shared_tiny_pipeline, job["sp"]
    args = (jnp.asarray(sp["cond_nhwc"]), jnp.asarray(sp["ctx"]), jnp.asarray(sp["noise_nhwc"]))
    ref = np.asarray(jp._denoise_stage(jp.params, *args, steps))
    jax_sp = np.asarray(denoise_context_parallel(jp, jp.params, *args, steps,
                                                 make_mesh(2, shape=(1, 2, 1))))
    ours = np.moveaxis(two[0][f"sp_{steps}"], 1, -1)
    assert rel_dev(ours, ref) < JAX_SP_BOUNDS[steps]
    assert rel_dev(ours, jax_sp) < JAX_SP_BOUNDS[steps]


@pytest.mark.parametrize("fault", ["fault_no_halo", "fault_local_norm"])
def test_sp_planted_faults_miss_the_bound(two, fault):
    assert rel_dev(two[0][fault], two[0]["serial_1"]) > 10 * SP_BOUNDS[1]


def test_flow_sample_sp2_matches_serial_and_jax(two, job):
    net_cfg, _, target, dit_params, _ = aether_parts()
    _check_flow(two, job, net_cfg, target, dit_params, 2)


def test_flow_sample_sp4_matches_serial_and_jax(four, job):
    net_cfg, _, target, dit_params, _ = aether_parts()
    _check_flow(four, job, net_cfg, target, dit_params, 4)


def _check_flow(results, job, net_cfg, target, dit_params, sp):
    from unigeo_tpu.parallel.context import flow_sample_context_parallel
    from unigeo_tpu.parallel.mesh import make_mesh

    model = jax_aether(net_cfg, target)
    cond, noise = jnp.asarray(job["flow"]["cond"]), jnp.asarray(job["flow"]["noise"])
    ref = np.asarray(model._sample(dit_params, cond, noise, steps=2))
    jax_sp = np.asarray(flow_sample_context_parallel(model, dit_params, cond, noise, 2,
                                                     make_mesh(sp, shape=(1, sp, 1))))
    for r in results:
        ours = np.moveaxis(r["flow_sp"], 1, -1)
        assert np.abs(r["flow_sp"] - r["flow_serial"]).max() < 2e-4
        assert np.abs(ours - ref).max() < 2e-4
        assert np.abs(ours - jax_sp).max() < 2e-4


# --- pp --------------------------------------------------------------------------


def test_pp_matches_serial_and_jax(four, job, shared_tiny_pipeline):
    from unigeo_tpu.parallel.staged import PipelinedStageExecutor
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

    pp = job["pp"]
    assert [r["pp_denoise_ranks"] for r in four] == [[2, 3]] * 4
    for r in four[1:]:
        assert np.array_equal(r["pp"], four[0]["pp"])
    port = tiny_pipeline(device="cpu", dtype=torch.float32)
    port.load_state_dicts(*pipeline_state_dicts(shared_tiny_pipeline.params, port))
    with torch.no_grad():
        serial = np.stack([((port.run_window_staged(
            torch.from_numpy(pp["frames"][i]), torch.from_numpy(pp["noise"][i]), 2,
            aug_noise=torch.from_numpy(pp["aug"][i])) + 1.0) / 2.0).numpy() for i in range(2)])
    assert rel_dev(four[0]["pp"], serial) < 2e-3
    ref = PipelinedStageExecutor(shared_tiny_pipeline, num_frames=4, num_inference_steps=2)(
        pp["frames"], noise=pp["noise"], aug_noise=pp["aug"])
    assert rel_dev(four[0]["pp"], ref) < 2e-3


def test_pp_refuses_two_ranks(two):
    for r in two:
        assert r["pp_refusal"] == "pipeline parallelism needs >= 3 devices"


def test_dp_executor_refuses_tp(four):
    """Under its earlier name (it pinned the refusal of tp > 1 before the
    tp execution was ported): the dp executor now runs a (2, 1, 2) mesh,
    every rank the whole batch, each clip within the dp bound against JAX
    (1e-3) of the port's serial path; tp sums its row-parallel products in
    another order, so not bitwise."""
    for r in four:
        assert r["tp"].shape == r["tp_serial"].shape == (2, 4, H, W, 3)
        assert rel_dev(r["tp"], r["tp_serial"]) < 1e-3
        assert np.array_equal(r["tp"], four[0]["tp"])


def test_tp_executor_matches_jax(four, job, shared_tiny_pipeline):
    """The dp executor on a (2, 1, 2) mesh against JAX's executor on the same
    mesh, its parameters placed by ``shard_params`` (tp 2 over conftest's
    virtual devices), within the dp bound against JAX."""
    from unigeo_tpu.parallel.executor import ShardedClipExecutor
    from unigeo_tpu.parallel.mesh import make_mesh

    pp = job["pp"]
    ex = ShardedClipExecutor(shared_tiny_pipeline, make_mesh(4, shape=(2, 1, 2)),
                             num_inference_steps=2)
    ref = ex(pp["frames"], noise=pp["noise"], aug_noise=pp["aug"])
    assert rel_dev(four[0]["tp"], ref) < 1e-3


# --- processes -------------------------------------------------------------------


def test_rows_gather_and_round_robin(two):
    assert [r["primary"] for r in two] == [True, False]
    assert sorted(two[0]["indices"] + two[1]["indices"]) == [0, 1, 2, 3, 4]
    for r in two:
        assert [row["seq_name"] for row in r["rows"]] == ["seq0", "seq1"]
        assert r["rows"][1]["Abs Rel"] == 1.5


def read_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_eval_over_two_ranks_matches_one_process(two, tmp_path):
    from unigeo_tpu_torch import eval as eval_cli

    eval_cli.main(["--config", IDENTITY, "--output", str(tmp_path), "--device", "cpu"])
    single = read_rows(tmp_path / "metrics.csv")
    merged = read_rows(os.path.join(two[0]["eval_dir"], "metrics.csv"))
    assert merged[0] == single[0] and [r[0] for r in merged] == [r[0] for r in single]
    ours = np.array([[float(v) for v in r[1:]] for r in merged[1:]])
    ref = np.array([[float(v) for v in r[1:]] for r in single[1:]])
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_eval_ranks_resume_and_only_rank0_merges(two):
    assert [r["eval_processed"] for r in two] == [[3, 0], [3, 0]]
    assert two[0]["eval_files"] == ["metrics.csv", "metrics.rank0.csv"]
    assert two[1]["eval_files"] == ["metrics.rank1.csv"]
