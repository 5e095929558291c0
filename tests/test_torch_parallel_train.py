"""The training side of the port's ``parallel/`` in one process, on the CPU:

  * every differentiable collective of ``parallel/comm.py`` against
    ``torch.autograd.gradcheck``'s finite differences (f64) on a one-rank
    gloo group, where each reduces to its formula's one-rank case (the
    2- and 4-rank formulas are held in
    ``tests/test_torch_parallel_train_ranks.py``);
  * ``sharding.shard_params`` gives GEGLU's projection as rank i's value
    block i followed by its gate block i, so the rank's local GEGLU output
    is block i of the whole one (the equal blocks of the earlier
    ``shard_params`` gave rank 0 value rows only: ``test_geglu_shards_pair_
    each_value_with_its_gate`` fails on it);
  * a module placed by ``parallelize`` raises, naming its shard, when run
    outside ``tensor_parallel``, and refuses to be placed twice;
  * ``train.parse_mesh`` and the one-device trainer's ``local_batch``.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist


@pytest.fixture(scope="module")
def group():
    from unigeo_tpu_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        make_mesh(1, (1, 1, 1), device="cpu")
    assert dist.get_world_size() == 1
    return dist.group.WORLD


def _cases(group):
    from unigeo_tpu_torch.parallel import comm

    shard = comm.FrameShard(group)
    return {
        "GatherFrames": lambda x: comm.GatherFrames.apply(x, group, 1),
        "Halo": lambda x: comm.Halo.apply(x, shard, 1, 1),
        "FromFirst": lambda x: comm.FromFirst.apply(x, shard),
        "Stacked": lambda x: comm.Stacked.apply(x, group),
        "CopyToGroup": lambda x: comm.CopyToGroup.apply(x, group),
        "ReduceFromGroup": lambda x: comm.ReduceFromGroup.apply(x, group),
        "GatherFromGroup": lambda x: comm.GatherFromGroup.apply(x, group, -1),
        "ScatterToGroup": lambda x: comm.ScatterToGroup.apply(x, group, -1),
        "AllReduceSum": lambda x: comm.AllReduceSum.apply(x, group),
    }


# one rank: what each gives its input's gradient for an upstream gradient g
ONE_RANK_GRAD = {
    "Halo": lambda g: g[:, 1:-1],  # the halo frames are the clip's zero padding
    "Stacked": lambda g: g[0],
}


@pytest.mark.parametrize("name", ["GatherFrames", "Halo", "FromFirst", "Stacked", "CopyToGroup",
                                  "ReduceFromGroup", "GatherFromGroup", "ScatterToGroup",
                                  "AllReduceSum"])
def test_collective_backward_passes_gradcheck_on_one_rank(group, name):
    fn = _cases(group)[name]
    x = torch.randn(2, 3, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-9)
    y = fn(x)
    g = torch.randn(y.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    (grad,) = torch.autograd.grad(y, x, g)
    assert torch.equal(grad, ONE_RANK_GRAD.get(name, lambda t: t)(g))


def test_sums_run_in_f32_and_keep_the_dtype(group):
    from unigeo_tpu_torch.parallel.comm import all_reduce, all_reduce_mean_, reduce_scatter

    x = torch.randn(4, 3).to(torch.bfloat16)
    y = all_reduce(x, group)
    assert y.dtype == torch.bfloat16 and torch.equal(y, x)
    assert torch.equal(reduce_scatter(x, group, 0), x)
    a, b = torch.ones(3), torch.ones(2, dtype=torch.bfloat16)
    all_reduce_mean_([a, b], group)  # one rank: the mean is the tensor
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, torch.ones(2, dtype=torch.bfloat16))


class FakeMesh:
    """What the sharding functions read of a mesh whose tp dim has ``tp``
    ranks, seen from tp rank ``index`` (no process group behind it)."""

    mesh_dim_names = ("dp", "sp", "tp")

    def __init__(self, tp, index):
        self.tp, self.index = tp, index

    def size(self, i):
        return (1, 1, self.tp)[i]

    def __getitem__(self, name):
        return types.SimpleNamespace(get_local_rank=lambda: self.index)

    def get_group(self, name):
        return ("tp group", self.tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_geglu_shards_pair_each_value_with_its_gate(tp):
    """Rank i's GEGLU projection (``shard_params``' weight; the bias block of
    ``parallelize``, which shards a column-parallel layer's bias too) gives
    block i of the whole GEGLU output, the block net.2's shard takes."""
    import copy

    from unigeo_tpu_torch.models.layers import FeedForward, GEGLU
    from unigeo_tpu_torch.parallel.sharding import parallelize, shard_params

    torch.manual_seed(0)
    ff = FeedForward(8)
    with torch.no_grad():
        ff.net[0].proj.bias.normal_()
    x = torch.randn(5, 8)
    whole = ff.net[0](x)  # [5, 32]
    block = whole.shape[-1] // tp
    for i in range(tp):
        shards = shard_params(ff, FakeMesh(tp, i))
        placed = parallelize(copy.deepcopy(ff), FakeMesh(tp, i))
        w, b = shards["net.0.proj.weight"], placed.net[0].proj.bias
        assert w.shape == (2 * block, 8) and b.shape == (2 * block,)
        assert torch.equal(placed.net[0].proj.weight, w)
        local = GEGLU.gate(torch.nn.functional.linear(x, w, b))
        assert torch.allclose(local, whole[:, i * block:(i + 1) * block], atol=1e-6), i
        assert torch.equal(shards["net.2.weight"], ff.net[2].weight[:, i * block:(i + 1) * block])


def test_placed_module_refuses_to_run_outside_tensor_parallel():
    from unigeo_tpu_torch.models.layers import TensorParallel
    from unigeo_tpu_torch.parallel.sharding import parallelize

    mlp = torch.nn.Sequential()
    mlp.fc1 = torch.nn.Linear(8, 16)
    parallelize(mlp, FakeMesh(2, 1))
    assert isinstance(mlp.fc1, TensorParallel) and isinstance(mlp.fc1, torch.nn.Linear)
    assert mlp.fc1.weight.shape == (8, 8) and mlp.fc1.tp_spec.index == 1
    with pytest.raises(RuntimeError, match=r"weight \(8, 8\), a shard of 2"):
        mlp.fc1(torch.randn(2, 8))
    with pytest.raises(ValueError, match="placed on tp already"):
        parallelize(mlp, FakeMesh(2, 1))


def test_parse_mesh():
    from unigeo_tpu_torch.train import parse_mesh

    assert parse_mesh("2,1,4") == (2, 1, 4)
    for bad in ("2,2", "1,x,1", "0,1,1", "1,1,1,1"):
        with pytest.raises(ValueError, match="dp,sp,tp"):
            parse_mesh(bad)


def test_one_device_local_batch_is_the_batch():
    from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer

    trainer = DiffusionTrainer(torch.nn.Linear(2, 2))
    batch = {"latents": np.zeros((3, 5, 2, 2, 4), np.float32)}
    assert trainer.local_batch(batch)["latents"].shape == (3, 5, 2, 2, 4)
    assert trainer.place.grad_group is None and trainer.place.shard is None
