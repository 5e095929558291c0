"""The port's ``utils/vis.py``, ``utils/writers.py``, ``utils/profiling.py``
(the trace half) and ``utils/randparams.py`` against the JAX package's, on
the CPU: the numeric outputs equal the JAX package's numpy outputs, bit for
bit, on the same inputs (tensors accepted where the JAX side takes arrays);
the PLY reader reads what either package writes; the writers' JSON lines
carry the same names, steps and values; a trace holds the annotated range.
The two packages draw random weights from different generators, so
``random_state_dict_like`` is held to its contract (shapes, dtype, scale,
seed), not to JAX's values.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import json
import os

import numpy as np
import pytest
import torch

from unigeo_tpu.utils import vis as jvis
from unigeo_tpu.utils import writers as jwriters
from unigeo_tpu_torch.utils import vis
from unigeo_tpu_torch.utils import writers


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.random((3, 20, 24)).astype(np.float32),
            (rng.random((16, 12, 3)) * 255).astype(np.uint8),
            rng.random((18, 18)).astype(np.float32) * 3.0]


@pytest.mark.parametrize("colors", [False, True])
def test_point_cloud_round_trips_across_the_packages(tmp_path, colors):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.random((50, 3)).astype(np.float32) if colors else None
    vis.save_point_cloud(pts, cols, str(tmp_path / "port.ply"))
    jvis.save_point_cloud(pts, cols, str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    ours, ref = vis.load_point_cloud(str(tmp_path / "jax.ply")), \
        jvis.load_point_cloud(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(ours[0], ref[0])
    assert (ours[1] is None) == (ref[1] is None) == (not colors)
    if colors:
        np.testing.assert_array_equal(ours[1], ref[1])


@pytest.mark.parametrize("case", ["plain", "range", "mask_and_nan", "tensor"])
def test_vis_2d_array_matches_jax(case):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    a = rng.normal(size=(12, 10)).astype(np.float32)
    kw = {}
    if case == "range":
        kw = dict(vmin=-0.5, vmax=0.5, cmap="viridis")
    elif case == "mask_and_nan":
        a[0, 0], a[3, 4] = np.nan, np.inf
        kw = dict(mask=(rng.random((12, 10)) > 0.3))
    ref = jvis.vis_2d_array(a, **kw)
    ours = vis.vis_2d_array(torch.from_numpy(a) if case == "tensor" else a, **kw)
    assert ours.dtype == np.uint8 and np.array_equal(ours, ref)


@pytest.mark.parametrize("i", range(3))
def test_vis_image_matches_jax(images, i):
    ref = jvis.vis_image(images[i])
    assert np.array_equal(vis.vis_image(images[i]), ref)
    assert np.array_equal(vis.vis_image(torch.from_numpy(images[i])), ref)


def test_vis_image_takes_bf16_tensors():
    x = torch.rand(3, 8, 8).to(torch.bfloat16)
    assert np.array_equal(vis.vis_image(x), jvis.vis_image(x.float().numpy()))


def test_overlay_text_and_tile_images_match_jax(images):
    pytest.importorskip("PIL")
    assert np.array_equal(vis.overlay_text(images[0], "frame 0"),
                          jvis.overlay_text(images[0], "frame 0"))
    for kw in ({}, {"cols": 3, "labels": ["a", "b", "c"], "pad": 1, "pad_value": 9}):
        assert np.array_equal(vis.tile_images(images, **kw), jvis.tile_images(images, **kw))
    assert np.array_equal(vis.tile_images([]), jvis.tile_images([]))


def _lines(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]


def test_event_writer_matches_jax(tmp_path):
    ours, ref = writers.EventWriter(str(tmp_path / "p")), jwriters.EventWriter(str(tmp_path / "j"))
    for w in (ours, ref):
        w.put_scalar("loss", 0.5, 1)
        w.put_scalars({"lr": 1e-4, "grad_norm": 2.0}, 2)
        w.close()
    assert _lines(ours.jsonl_path) == _lines(ref.jsonl_path) == [
        {"step": 1, "name": "loss", "value": 0.5},
        {"step": 2, "name": "lr", "value": 1e-4},
        {"step": 2, "name": "grad_norm", "value": 2.0}]


def test_tensorboard_sink_only_when_asked(tmp_path):
    pytest.importorskip("tensorboard")
    plain = writers.EventWriter(str(tmp_path / "plain"))
    plain.put_scalar("x", 1.0, 0)
    plain.close()
    assert os.listdir(tmp_path / "plain") == ["events.jsonl"]
    tb = writers.EventWriter(str(tmp_path / "tb"), use_tensorboard=True)
    tb.put_scalars({"x": 1.0, "y": 2.0}, 3)
    tb.close()
    names = os.listdir(tmp_path / "tb")
    assert "events.jsonl" in names and any(n.startswith("events.out.tfevents") for n in names)


def test_trace_holds_the_annotated_range(tmp_path):
    from unigeo_tpu_torch.utils.profiling import start_trace, stop_trace, trace_annotation

    start_trace(str(tmp_path / "trace"))
    with pytest.raises(RuntimeError, match="running"):
        start_trace(str(tmp_path / "other"))
    with trace_annotation("unigeo_stage"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = stop_trace()
    assert path == str(tmp_path / "trace" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "unigeo_stage" for e in events)
    with pytest.raises(RuntimeError, match="no trace"):
        stop_trace()


def test_random_state_dict_like():
    from unigeo_tpu_torch.utils.randparams import random_state_dict_like

    module = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.BatchNorm1d(128))
    a = random_state_dict_like(module, seed=3)
    b = random_state_dict_like(module, seed=3)
    c = random_state_dict_like(module, seed=4, scale=1.0, dtype=torch.float32)
    ref = module.state_dict()
    assert list(a) == list(ref)
    for k, v in a.items():
        assert v.shape == ref[k].shape and torch.equal(v, b[k])
        if ref[k].is_floating_point():
            assert v.dtype == torch.bfloat16 and c[k].dtype == torch.float32
        else:  # num_batches_tracked, kept
            assert v.dtype == ref[k].dtype and torch.equal(v, ref[k])
    w = a["0.weight"].float()
    assert 0.015 < w.std().item() < 0.025 and abs(w.mean().item()) < 0.002
    assert 0.9 < c["0.weight"].std().item() < 1.1
    assert not torch.equal(a["0.weight"].float(), c["0.weight"] * 0.02)
    module.load_state_dict(a)  # strict
