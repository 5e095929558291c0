"""The port's ``parallel/`` in one process: the mesh shapes, the
single-process fallbacks of ``multihost``, the tp rules against the JAX
package's, the frame-split layers with one rank, the layout repair of
``run_window_staged`` and the dry-run tool.  The multi-process runs are
``tests/test_torch_parallel_ranks.py``.

Tolerances: the tp rules exactly (the same leaves sharded on the same dim,
the same bytes); one rank's frame-split denoise (the halo of zeros, the
group norm from gathered moments) against the plain loop 2e-4 relative, the
bound of the two-rank split in ``tests/test_torch_parallel_ranks.py`` (the
group statistics' f32 sums in another order, carried through the loop from
sigma_max = 700; measured 3.7e-5); the layout repair bitwise.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_SIZES = (2, 4, 8)


# --- mesh and processes ------------------------------------------------------------


def test_factor_matches_jax():
    from unigeo_tpu.parallel.mesh import _factor as jax_factor
    from unigeo_tpu_torch.parallel.mesh import _factor, mesh_shape

    for n in range(1, 17):
        assert _factor(n) == jax_factor(n), n
        assert mesh_shape(n) == jax_factor(n), n


def test_mesh_shapes_match_jax():
    from unigeo_tpu.parallel.mesh import make_mesh as jax_mesh
    from unigeo_tpu_torch.parallel.mesh import mesh_shape

    for n in range(1, len(jax.devices()) + 1):
        assert mesh_shape(n) == jax_mesh(n).devices.shape, n
    assert mesh_shape(8, (1, 8, 1)) == jax_mesh(8, shape=(1, 8, 1)).devices.shape
    with pytest.raises(ValueError, match="mesh shape"):
        mesh_shape(8, (2, 2, 1))


def _no_dist_env():
    names = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT")
    return {k: os.environ.pop(k) for k in names if k in os.environ}


def test_single_process_fallbacks():
    import torch.distributed as dist

    from unigeo_tpu_torch.parallel.multihost import (
        initialize_distributed,
        is_primary,
        process_allgather_rows,
        shard_indices,
    )

    saved = _no_dist_env()
    try:
        assert not dist.is_initialized()
        assert initialize_distributed() is False
        assert not dist.is_initialized()
    finally:
        os.environ.update(saved)
    assert is_primary()
    assert shard_indices(5) == [0, 1, 2, 3, 4]
    rows = [{"seq_name": "a", "x": 1.0}]
    assert process_allgather_rows(rows) == rows


def test_one_process_mesh_and_placements():
    import torch.distributed as dist

    from unigeo_tpu_torch.parallel.mesh import axis_size, data_sharding, make_mesh, replicated
    from unigeo_tpu_torch.parallel.multihost import make_hybrid_mesh

    saved = _no_dist_env()
    try:
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.mesh_dim_names) == ("dp", "sp", "tp")
        assert [axis_size(mesh, a) for a in ("dp", "sp", "tp")] == [1, 1, 1]
        assert dist.get_backend() == "gloo"
        assert tuple(make_hybrid_mesh(device="cpu").mesh.shape) == (1, 1, 1)
        assert replicated(mesh).replicated
        placed = data_sharding(mesh, ("dp",))
        assert (placed.index, placed.size) == (0, 1)
    finally:
        dist.destroy_process_group()
        os.environ.update(saved)


def test_backend_rule():
    from unigeo_tpu_torch.parallel.multihost import backend_for

    assert backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        return
    n = torch.cuda.device_count()
    assert backend_for("cuda", local_world_size=n) == "nccl"
    assert backend_for("cuda", local_world_size=n + 1) == "gloo"


def test_largest_divisor():
    from unigeo_tpu_torch.parallel.staged import _largest_divisor_leq

    assert _largest_divisor_leq(25, 6) == 5
    assert _largest_divisor_leq(4, 6) == 4
    assert _largest_divisor_leq(7, 3) == 1
    assert _largest_divisor_leq(24, 6) == 6


# --- the tp rules -----------------------------------------------------------------


class _Key:
    def __init__(self, name):
        self.key = name


def _spec(key, shape, tp_size=2):
    from unigeo_tpu_torch.parallel.sharding import param_spec

    return param_spec(key, shape, tp_size)


def test_rules_on_port_paths():
    # attention and MLP: out features (torch dim 0), then in features (dim 1)
    assert _spec("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                 (64, 64)) == 0
    assert _spec("mid_block.attentions.0.transformer_blocks.0.attn1.to_out.0.weight",
                 (64, 64)) == 1
    assert _spec("up_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj.weight",
                 (512, 64)) == 0
    assert _spec("up_blocks.1.attentions.0.transformer_blocks.0.ff.net.2.weight",
                 (64, 256)) == 1
    assert _spec("vision_model.encoder.layers.3.self_attn.q_proj.weight", (64, 64)) == 0
    assert _spec("vision_model.encoder.layers.3.mlp.fc2.weight", (64, 256)) == 1
    # resblock convs: conv1 out channels, conv2 in channels (3x3 and (3,1,1))
    assert _spec("down_blocks.0.resnets.0.spatial_res_block.conv1.weight", (128, 64, 3, 3)) == 0
    assert _spec("down_blocks.0.resnets.0.spatial_res_block.conv2.weight",
                 (128, 128, 3, 3)) == 1
    assert _spec("down_blocks.0.resnets.0.temporal_res_block.conv1.weight",
                 (128, 64, 3, 1, 1)) == 0
    # shortcut, down- and upsamplers, the timestep pair
    assert _spec("up_blocks.0.resnets.0.spatial_res_block.conv_shortcut.weight",
                 (128, 256, 1, 1)) == 0
    assert _spec("down_blocks.0.downsamplers.0.conv.weight", (64, 64, 3, 3)) == 0
    assert _spec("decoder.up_blocks.1.upsamplers.0.conv.weight", (64, 64, 3, 3)) == 0
    assert _spec("time_embedding.linear_1.weight", (128, 32)) == 0
    assert _spec("time_embedding.linear_2.weight", (128, 128)) == 1
    # replicated: norms, biases, proj_in / proj_out, the position table
    assert _spec("down_blocks.0.resnets.0.spatial_res_block.norm1.weight", (64,)) is None
    assert _spec("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.bias",
                 (64,)) is None
    assert _spec("down_blocks.0.attentions.0.proj_in.weight", (64, 64)) is None
    assert _spec("vision_model.embeddings.position_embedding.weight", (257, 64)) is None
    # a dim that does not divide tp replicates
    assert _spec("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                 (66, 64), tp_size=4) is None
    assert _spec("down_blocks.0.resnets.0.spatial_res_block.conv2.weight",
                 (64, 66, 3, 3), tp_size=4) is None


def test_embedding_weight_is_never_sharded():
    from unigeo_tpu_torch.parallel.sharding import param_spec

    emb = torch.nn.Embedding(8, 64)
    assert param_spec("x.to_q.weight", (8, 64), 2, emb) is None
    assert param_spec("x.to_q.weight", (8, 64), 2, torch.nn.Linear(64, 8)) == 0


@pytest.fixture(scope="module")
def tiny_trees(shared_tiny_pipeline):
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline

    return shared_tiny_pipeline.params, tiny_pipeline(device="cpu", dtype=torch.float32)


def _flat(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("tp", TP_SIZES)
def test_rules_match_jax_per_leaf(tiny_trees, tp):
    """Each port parameter and its flax leaf (the weight bridge's key map):
    the same decision, on the same dim once the layouts are mapped (flax's
    last dim is torch's dim 0, flax's second-to-last torch's dim 1)."""
    from unigeo_tpu.parallel.sharding import param_spec as jax_spec
    from unigeo_tpu_torch.parallel.sharding import param_specs
    from unigeo_tpu_torch.utils import weights

    jparams, port = tiny_trees
    paths = {"unet": weights.unet_flax_path, "vae": weights.vae_flax_path,
             "clip": weights.clip_flax_path}
    n_sharded = 0
    for name, module in zip(("unet", "vae", "clip"), port.modules()):
        for key, dim in param_specs(module, tp).items():
            found = paths[name](key)
            path = found[0] if isinstance(found[0], tuple) else found
            leaf = _flat(jparams[name], path)
            spec = jax_spec(tuple(_Key(k) for k in path), leaf, tp_size=tp)
            jdim = next((i for i, a in enumerate(spec) if a == "tp"), None)
            expect = None if jdim is None else {leaf.ndim - 1: 0, leaf.ndim - 2: 1}[jdim]
            assert dim == expect, (name, key, dim, spec)
            n_sharded += dim is not None
    assert n_sharded > 0


def test_sharded_bytes_match_jax(tiny_trees):
    from unigeo_tpu.parallel.sharding import sharded_bytes_fraction as jax_fraction
    from unigeo_tpu_torch.parallel.sharding import sharded_bytes_fraction

    jparams, port = tiny_trees
    for tp in TP_SIZES:
        ours = [sharded_bytes_fraction(m, tp) for m in port.modules()]
        assert (sum(s for s, _ in ours), sum(t for _, t in ours)) == jax_fraction(jparams, tp_size=tp)


def test_shard_params_one_rank_is_whole(tiny_trees):
    import torch.distributed as dist

    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.sharding import shard_params

    saved = _no_dist_env()
    try:
        mesh = make_mesh(device="cpu")
        shards = shard_params(tiny_trees[1].unet, mesh)
        assert all(shards[k] is p for k, p in tiny_trees[1].unet.named_parameters())
    finally:
        dist.destroy_process_group()
        os.environ.update(saved)


# --- the frame-split layers with one rank ------------------------------------------


def test_one_rank_frame_split_matches_the_plain_loop():
    """frames_sharded with a one-rank shard takes the split code paths (the
    temporal convs padded by the halo, the group norms from gathered
    moments, the gathered keys) with every frame local."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.models.layers import frames_sharded
    from unigeo_tpu_torch.parallel.comm import FrameShard

    pipe = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    cond = torch.randn(1, 4, 4, 8, 8, generator=g)
    ctx = torch.randn(1, 4, 1, pipe.unet.cross_attention_dim, generator=g)
    noise = torch.randn(1, 4, 4, 8, 8, generator=g)
    with torch.no_grad():
        ref = pipe._denoise_loop(cond, ctx, noise, 1)
        with frames_sharded(FrameShard()):
            ours = pipe._denoise_loop(cond, ctx, noise, 1)
    assert ((ours - ref).abs().max() / ref.abs().max()) < 2e-4


def test_halo_pads_with_zeros_on_one_rank():
    from unigeo_tpu_torch.parallel.comm import FrameShard, split_frames

    x = torch.arange(6.0).reshape(1, 3, 2)
    out = FrameShard().halo(x, dim=1, width=1)
    assert out.shape == (1, 5, 2) and out[:, 0].eq(0).all() and out[:, -1].eq(0).all()
    assert torch.equal(out[:, 1:4], x)
    with pytest.raises(ValueError, match="halo"):
        FrameShard().halo(x, dim=1, width=4)
    assert torch.equal(split_frames(x, FrameShard(), dim=1), x)


# --- run_window_staged does not depend on its inputs' strides ----------------------


def test_run_window_staged_ignores_input_layout():
    """A dense NHWC clip and the same clip as a view of a dense NCHW tensor
    give the same bits, and the one-clip batch of run_clips_staged equals
    both.  (Before the inputs were copied to dense NCHW, the dense NHWC clip
    reached the VAE encoder as a channels-last tensor, which its convolutions
    and group norms compute in another order: 9.5e-5 apart here, 0.12 on the
    card at SVD-XT width in bf16.)"""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline

    pipe = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    dense = torch.from_numpy(rng.uniform(size=(4, 64, 64, 3)).astype(np.float32))
    view = dense.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    noise = torch.from_numpy(rng.normal(size=(4, 8, 8, 4)).astype(np.float32))
    aug = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    aug_view = aug.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with torch.no_grad():
        a = pipe.run_window_staged(dense, noise, 2, aug_noise=aug)
        b = pipe.run_window_staged(view, noise, 2, aug_noise=aug_view)
        c = pipe.run_clips_staged(dense[None], noise[None], 2, aug_noise=aug[None])[0]
    assert torch.equal(a, b)
    assert torch.equal(a, c)


# --- the dry run ---------------------------------------------------------------------


def test_dryrun_multichip_on_three_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "unigeo_tpu_torch.tools.dryrun_multichip", "--nproc", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    for line in ("dp ShardedClipExecutor", "pp PipelinedStageExecutor", "sp denoise",
                 "sp flow", "train DiffusionTrainer on dp,sp,tp (3, 1, 1)",
                 "train FlowMatchingTrainer on dp,sp,tp (3, 1, 1)", "SVD-XT UNet tp=2",
                 "SVD-XT UNet tp=8"):
        assert line in text, (line, text)


# --- the modules stand alone ---------------------------------------------------------

PARALLEL_MODULES = [f"unigeo_tpu_torch/parallel/{m}.py" for m in (
    "comm", "context", "executor", "launch", "mesh", "multihost", "sharding", "staged")] + [
    "unigeo_tpu_torch/tools/dryrun_multichip.py"]


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_parallel_modules_are_checked(rel):
    """tests/test_torch_no_jax.py's walk finds each module (its import and
    source checks then cover it)."""
    from test_torch_no_jax import _port_files

    assert os.path.join(ROOT, rel) in _port_files()


def test_parallel_modules_import_no_jax():
    mods = [rel[:-3].replace("/", ".") for rel in PARALLEL_MODULES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'unigeo_tpu', 'yaml', 'PIL'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
