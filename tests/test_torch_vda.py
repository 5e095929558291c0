"""The port's VideoDepthAnything (the network, the post-processing, the
adapter, the weight bridge, the eval CLI) against the JAX package's, on the
CPU in f32, the JAX weights carried over by
``utils/weights.py::pointmap_state_dict``.

Tolerances, relative to the reference's largest magnitude unless said:
  * VDANetwork's disparity: 1e-4 (four ViT blocks, four temporal blocks
    over the frame axis and the DPT head, a dozen convolutions and resizes
    deep), in three modes: the configs' tiny network (sin-cos, no class
    token); DINOv2's switches (qkv biases, a class token, the learned
    position table sliced top-left, the final norm on each hook) over five
    frames in head chunks of two (a chunk count that does not divide the
    clip); and patch 14 (the DPT's x16 output shrunk to the frame by the
    antialiased bilinear resize);
  * the post-processing (min-max, 1 / (x + 0.1), backprojection, plane-fit
    normals) on the same smooth disparity: depths 1e-6 (elementwise f32);
    normals by mean angle under 0.05 degree: the f32 plane fit's centred
    moments cancel, and the zero-padded corner boxes' fits are
    ill-conditioned (0.028 degree mean, 6 degrees at a corner, seen);
  * head chunks: the disparity of one chunk within 1e-5 of chunks of two
    (the same convolutions at another batch);
  * the adapter: depths 1e-4 (the network's bound through the min-max),
    normals by mean angle under 0.05 degree (as above);
  * the eval CLI on ``configs/vda_synthetic.yaml``: as it is (the port's own
    random weights), every column finite; with the JAX weights, every CSV
    column within ``tests/test_torch_eval.py``'s bounds of the JAX eval's
    (error metrics 2e-2 relative, threshold shares 3 pixels' share).

The JAX builds are shared: each mode's ``network.init`` and ``apply``
(jitted) are made once per module and handed to the JAX adapters through
their network's ``init``.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import functools
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from unigeo_tpu_torch.utils.weights import pointmap_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VDA_YAML = os.path.join(ROOT, "configs", "vda_synthetic.yaml")
H = W = 64
MAX_CLIPS = 2

TINY = dict(width=32, depth=4, num_heads=2, patch_size=16, temporal_heads=2)
# mode -> (network config, frames, frame side)
MODES = {
    "tiny": (TINY, 3, 64),
    "dinov2": (dict(TINY, qkv_bias=True, use_class_token=True, learned_pos_embed=True,
                    max_grid=6, hook_norm=True, head_chunk=2), 5, 64),
    "patch14": (dict(TINY, patch_size=14), 3, 56),
}


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def t_(a):
    return torch.from_numpy(np.array(a))


def mean_angle_deg(a, b):
    cos = np.clip((np.asarray(a, np.float64) * np.asarray(b, np.float64)).sum(-1), -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)).mean())


@functools.lru_cache(maxsize=None)
def jax_network(mode):
    """The mode's JAX network: (config, params, frames, disparity); built
    once per worker."""
    from unigeo_tpu.models.vda import VDANetwork as JNet

    cfg, t, side = MODES[mode]
    frames = jnp.asarray(np.random.default_rng(40).random((t, side, side, 3)).astype(np.float32))
    jnet = JNet(**cfg)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), frames))
    return cfg, params, np.asarray(frames), np.asarray(jax.jit(jnet.apply)(params, frames))


def port_network(mode):
    from unigeo_tpu_torch.models.vda import VDANetwork

    cfg, params, _, _ = jax_network(mode)
    net = VDANetwork(**cfg)
    net.load_state_dict(pointmap_state_dict(params, net))
    return net.eval()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vda_network_matches_jax(mode):
    _, _, frames, ref = jax_network(mode)
    with torch.no_grad():
        ours = port_network(mode)(t_(frames))
    assert ours.shape == frames.shape[:3] and (ours >= 0).all()
    assert rel_dev(ours.numpy(), ref) < 1e-4


def test_vda_head_chunks_change_nothing():
    """The head is frame-independent: one chunk of all five frames gives the
    disparity of chunks of two."""
    net = port_network("dinov2")
    frames = t_(jax_network("dinov2")[2])
    with torch.no_grad():
        chunked = net(frames)
        net.head_chunk = 8
        whole = net(frames)
    assert rel_dev(chunked.numpy(), whole.numpy()) < 1e-5


def test_vda_postprocess_matches_jax():
    from unigeo_tpu.models.vda import _postprocess as jpost
    from unigeo_tpu_torch.models.vda import postprocess

    # a smooth disparity (a random one's plane fits are ill-posed)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    disp = np.stack([1.0 + 0.5 * np.sin(uu / 9.0 + i) + 0.3 * np.cos(vv / 13.0) + 0.01 * uu
                     for i in range(3)]).astype(np.float32)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2 + 3], [0, 0, 1]], np.float32)
    intr = np.stack([k] * 3)
    depths, normals = postprocess(t_(disp), t_(intr))
    jd, jn = jpost(jnp.asarray(disp), jnp.asarray(intr))
    assert rel_dev(depths.numpy(), jd) < 1e-6
    assert mean_angle_deg(normals.numpy(), jn) < 0.05


def _clip(t=3, seed=42):
    rng = np.random.default_rng(seed)
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


def jax_adapter(monkeypatch, mode, **kw):
    from unigeo_tpu.models.vda import VDANetwork as JNet, VideoDepthAnything as JVDA

    cfg, params, _, _ = jax_network(mode)
    with monkeypatch.context() as m:
        m.setattr(JNet, "init", lambda self, *a, **k: params)
        return JVDA(**{"network_config": cfg, **kw})


def port_adapter(jmodel, **kw):
    from unigeo_tpu_torch.models.vda import VideoDepthAnything

    model = VideoDepthAnything(**{"device": "cpu", **kw})
    model.network.load_state_dict(pointmap_state_dict(jax.device_get(jmodel.params),
                                                      model.network))
    return model


def test_vda_adapter_matches_jax(monkeypatch):
    jmodel = jax_adapter(monkeypatch, "dinov2")
    data = _clip(5)
    monkeypatch.setenv("UNIGEO_COMPUTE_DTYPE", "bfloat16")  # ignored, as by the JAX adapter
    model = port_adapter(jmodel, network_config=MODES["dinov2"][0], compute_dtype="bfloat16",
                         transfer_dtype="float16")
    assert next(model.network.parameters()).dtype == torch.float32
    ref, ours = jmodel.forward(data), model.forward(data)
    assert sorted(ours) == sorted(ref) == ["pred_depths", "pred_normals"]
    for key, val in ours.items():
        assert val.dtype == np.float32 and val.shape == ref[key].shape and np.isfinite(val).all()
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-4
    assert mean_angle_deg(ours["pred_normals"], ref["pred_normals"]) < 0.05
    assert model.eval_batch_size == 1 and len(model.forward_batch([data, data])) == 2
    with pytest.raises(NotImplementedError, match="item 9"):
        port_adapter(jmodel, checkpoint_path="vda.pth")


def test_vda_weight_bridge_is_strict():
    from unigeo_tpu_torch.models.vda import VDANetwork

    cfg, params, _, _ = jax_network("dinov2")
    net = VDANetwork(**cfg)
    sd = pointmap_state_dict(params, net)
    p = params["params"]
    assert np.array_equal(sd["cls_token"].numpy(), p["cls_token"])
    assert np.array_equal(sd["pos_embed"].numpy(), p["pos_embed"])
    assert np.array_equal(sd["hook_norm.weight"].numpy(), p["hook_norm"]["scale"])
    assert np.array_equal(sd["temporal_3.attn.to_k.bias"].numpy(),
                          p["temporal_3"]["attn"]["to_k"]["bias"])
    assert np.array_equal(sd["head.head_4.weight"].numpy(),
                          np.transpose(p["head"]["head_4"]["kernel"], (3, 2, 0, 1)))

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        fn(tree["params"])
        return tree

    with pytest.raises(KeyError, match="no flax leaf"):
        pointmap_state_dict(edited(lambda q: q.pop("cls_token")), net)
    with pytest.raises(KeyError, match="left over"):
        pointmap_state_dict(edited(lambda q: q.update(temporal_4=q["temporal_0"])), net)
    with pytest.raises(ValueError, match="flax"):
        pointmap_state_dict(edited(lambda q: q.update(pos_embed=q["pos_embed"][:-1])), net)


def _cli(out, capsys):
    from unigeo_tpu_torch import eval as eval_cli

    manager = eval_cli.main(["--config", VDA_YAML, "--output", str(out), "--device", "cpu",
                             "--max-clips", str(MAX_CLIPS)])
    assert "Averages:" in capsys.readouterr().out
    return manager.rows()


def test_cli_runs_the_vda_config_as_it_is(tmp_path, capsys, monkeypatch):
    from unigeo_tpu_torch import eval as eval_cli

    built, get = [], eval_cli.get_model_cls
    monkeypatch.setattr(eval_cli, "get_model_cls",
                        lambda name: lambda **kw: built.append(get(name)(**kw)) or built[-1])
    rows = _cli(tmp_path, capsys)
    assert type(built[0]).__module__ == "unigeo_tpu_torch.models.vda"
    assert len(built[0].network.blocks.layers) == 4
    with open(VDA_YAML) as f:
        cfg = yaml.safe_load(f)
    names = [n for sec in ("eval_depth", "eval_normal") for n in cfg[sec]["metric_names"]]
    assert len(rows) == MAX_CLIPS
    assert all(np.isfinite(row[n]) for row in rows for n in names)


def test_cli_vda_rows_match_jax(tmp_path, capsys, monkeypatch):
    """configs/vda_synthetic.yaml through the port's CLI on the CPU, its model
    built from the config's model_params and given the JAX model's weights,
    against the JAX package's run_evaluation."""
    from unigeo_tpu.config import EvalConfig as JaxEvalConfig
    from unigeo_tpu.evaluator import run_evaluation as jax_run_evaluation
    from unigeo_tpu_torch import eval as eval_cli

    with open(VDA_YAML) as f:
        cfg = yaml.safe_load(f)
    assert cfg["model_params"]["network_config"] == MODES["tiny"][0]
    jmodel = jax_adapter(monkeypatch, "tiny", **cfg["model_params"])
    ref = jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"),
                             model=jmodel, max_clips=MAX_CLIPS, data_parallel=False,
                             verbose=False)

    def factory(**kw):
        assert kw["device"] == "cpu"
        return port_adapter(jmodel, **kw)

    monkeypatch.setattr(eval_cli, "get_model_cls", lambda name: factory)
    rows = _cli(tmp_path / "port", capsys)
    ref_rows = ref.rows()
    assert [r["seq_name"] for r in rows] == [r["seq_name"] for r in ref_rows]
    pixels = 3.0 / (2 * H * W)
    for row, want in zip(rows, ref_rows):
        assert row.keys() == want.keys() and {"Abs Rel", "normal mean"} <= set(row)
        for key, val in want.items():
            if key != "seq_name":
                tol = pixels if key.startswith(("delta", "angle")) else 2e-2 * abs(val)
                assert abs(row[key] - val) <= tol, (row["seq_name"], key, row[key], val)
