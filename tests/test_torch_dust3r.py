"""The port's Dust3R (entangled decoders, the network, the adapter, the
weight bridge, the eval CLI) against the JAX package's, on the CPU in f32,
the JAX weights carried over by ``utils/weights.py::pointmap_state_dict``.

Tolerances, relative to the reference's largest magnitude:
  * one entangled layer (two ViT blocks, each reading the other stream):
    1e-5 (f32 products summed in another order);
  * Dust3RNetwork's points and confidences: 1e-4 (two encoder blocks, two
    entangled layers and a linear or DPT head, the DPT a dozen convolutions
    and resizes deep), in sin-cos + linear and RoPE100 + qkv bias +
    context norm + DPT modes;
  * the adapter's world points and confidences: 1e-4 (the network's
    bound; frame 0's map is the mean of the pairs' view-1 maps);
  * the adapter's poses, on a scene with known cameras (a random network's
    pointmaps fit no camera, so their DLT is degenerate): the network's
    outputs taken from the scene in both packages, rotations within 1e-3
    degree and translations within 1e-3 of their norm of each other (the
    camera solver's bounds in ``tests/test_torch_pointmap.py``), and both
    within 0.5 degree and 0.02 of the true pose;
  * the eval CLI on ``configs/dust3r_synthetic.yaml``: as it is (the port's
    own random weights), every column finite; then with the network's
    outputs taken from a scene with known cameras in both packages (so the
    DLT is conditioned; the synthetic box's own GT is planar, where a DLT
    is degenerate), every CSV column
    within ``tests/test_torch_eval.py``'s bounds of the JAX eval's (error
    metrics 2e-2 relative, threshold shares 3 pixels' share, camera metrics
    2e-2 relative plus 1e-4).

The JAX builds are shared: each mode's ``network.init`` (jitted, so the
persistent compile cache serves later runs) is made once per module and
handed to the JAX adapters through their network's ``init``; the JAX
adapter's clip program runs eagerly (``_full_fn``, the function its
``forward`` jits), which costs less than its first compile.
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
DUST3R_YAML = os.path.join(ROOT, "configs", "dust3r_synthetic.yaml")
H = W = 64
MAX_CLIPS = 2

MODES = {
    "sincos_linear": {},
    "rope_dpt": dict(pos_embed="RoPE100", qkv_bias=True, norm_context=True, head_type="dpt"),
}


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def t_(a):
    return torch.from_numpy(np.array(a))


def rotation_deg(r1, r2):
    d = np.asarray(r1, np.float64) @ np.asarray(r2, np.float64).swapaxes(-1, -2)
    dist = np.linalg.norm(d - np.eye(3), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(dist / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def loaded(port_module, params):
    port_module.load_state_dict(pointmap_state_dict(jax.device_get(params), port_module))
    return port_module.eval()


def _frames(t, seed=20):
    return np.random.default_rng(seed).random((t, H, W, 3)).astype(np.float32)


def _clip(t=3, seed=21):
    rng = np.random.default_rng(seed)
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


@functools.lru_cache(maxsize=None)
def jax_network(mode):
    """The mode's JAX network over one-ref pairs of three frames: (config,
    params, frames, outputs); built once per worker."""
    from unigeo_tpu.models.pointmap.dust3r import Dust3RNetwork as JNet, tiny_dust3r_config

    cfg = dict(tiny_dust3r_config(), **MODES[mode])
    frames = _frames(3)
    jnet = JNet(**cfg)
    args = (jnp.asarray(frames[:1]), jnp.asarray(frames[1:]))
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), *args))
    return cfg, params, frames, jax.device_get(jax.jit(jnet.apply)(params, *args))


@pytest.fixture(scope="module", params=sorted(MODES))
def networks(request):
    """jax_network(mode) and the port's network with its weights."""
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork

    cfg, params, frames, ref = jax_network(request.param)
    return cfg, params, frames, ref, loaded(Dust3RNetwork(**cfg), params)


def jax_adapter(monkeypatch, mode, **kw):
    """The JAX Dust3R adapter on jax_network(mode)'s params (its network's
    init handed them)."""
    from unigeo_tpu.models.pointmap.dust3r import Dust3R as JDust3R, Dust3RNetwork as JNet

    cfg, params, _, _ = jax_network(mode)
    with monkeypatch.context() as m:
        m.setattr(JNet, "init", lambda self, *a, **k: params)
        return JDust3R(**{"network_config": cfg, **kw})


def test_entangled_layer_matches_jax():
    from unigeo_tpu.models.pointmap.dust3r import _EntangledStep as JStep
    from unigeo_tpu.ops.rope import grid_positions
    from unigeo_tpu_torch.models.pointmap.dust3r import EntangledStep

    rng = np.random.default_rng(22)
    x1, x2 = (rng.standard_normal((2, 16, 32)).astype(np.float32) for _ in range(2))
    pos = np.array(grid_positions(4, 4))[None]
    jstep = JStep(2, qkv_bias=True, rope_freq=100.0, norm_context=True)
    carry = (jnp.asarray(x1), jnp.asarray(x2))
    params = jax.jit(jstep.init)(jax.random.PRNGKey(1), carry, pos)
    (ref1, ref2), _ = jstep.apply(params, carry, pos)
    step = loaded(EntangledStep(32, 2, True, 100.0, True), params["params"])
    with torch.no_grad():
        y1, y2 = step(t_(x1), t_(x2), t_(pos))
    assert rel_dev(y1.numpy(), ref1) < 1e-5 and rel_dev(y2.numpy(), ref2) < 1e-5
    # each stream has its own weights: block 1 on stream 2's inputs is not block 2
    with torch.no_grad():
        z2, _ = step(t_(x2), t_(x1), t_(pos))
    assert rel_dev(z2.numpy(), ref2) > 1e-2


def test_dust3r_network_matches_jax(networks):
    """One reference frame against two: view 1's tokens broadcast over the pairs."""
    _, _, frames, ref, net = networks
    with torch.no_grad():
        ours = net(t_(frames[:1]), t_(frames[1:]))
    assert ours[0].shape == (2, H, W, 3) and ours[2].shape == (2, H, W)
    for o, r in zip(ours, ref):
        assert rel_dev(o.numpy(), r) < 1e-4
    # the two pairs' view-1 maps differ (each decoded against its own view 2)
    assert rel_dev(ours[0][0].numpy(), ours[0][1].numpy()) > 1e-3


def _scene(rng, nf=3, focal=50.0):
    """World pointmaps [nf, H, W, 3] seen by known cameras, frame 0's camera
    the world frame; the true extrinsics."""
    from scipy.spatial.transform import Rotation

    uu, vv = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pts, extr = [], []
    for i in range(nf):
        depth = 2.0 + rng.uniform(0, 0.5, size=(H, W))
        cam = np.stack([(uu - W / 2) * depth / focal, (vv - H / 2) * depth / focal, depth], -1)
        r = np.eye(3) if i == 0 else Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
        t = np.zeros(3) if i == 0 else rng.normal(0, 0.2, 3)
        ext = np.eye(4)
        ext[:3, :3], ext[:3, 3] = r, t
        pts.append(((cam.reshape(-1, 3) - t) @ r).reshape(H, W, 3))
        extr.append(ext)
    return np.stack(pts).astype(np.float32), np.stack(extr).astype(np.float32)


class _JaxSceneNet:
    def __init__(self, out):
        self.out = tuple(jnp.asarray(o) for o in out)

    def apply(self, params, img1, img2):
        return self.out


class _PortSceneNet(torch.nn.Module):
    def __init__(self, out):
        super().__init__()
        self.out = tuple(t_(o) for o in out)

    def forward(self, img1, img2):
        return self.out


def port_adapter(jmodel, **kw):
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3R

    model = Dust3R(**{"device": "cpu", **kw})
    return model.load_state_dict(pointmap_state_dict(jax.device_get(jmodel.params),
                                                     model.network))


def jax_forward(jmodel, data):
    """The JAX adapter's forward, its clip program run eagerly."""
    from unigeo_tpu.models.pointmap import adapter as jadapter

    raw = jadapter.raw_clip(data)
    if raw.shape[0] < 2:
        raw = np.concatenate([raw, raw])
    return jadapter.fetch_outputs(jmodel._full_fn(jmodel.params, raw))


def test_dust3r_adapter_matches_jax(monkeypatch):
    jmodel = jax_adapter(monkeypatch, "rope_dpt", init_height=H, init_width=W)
    model = port_adapter(jmodel, network_config=jax_network("rope_dpt")[0])
    data = _clip()
    ref, ours = jmodel.forward(data), model.forward(data)
    assert sorted(ours) == sorted(ref)
    for key, val in ours.items():
        assert val.dtype == np.float32 and val.shape == ref[key].shape and np.isfinite(val).all()
    assert rel_dev(ours["pred_world_pts"], ref["pred_world_pts"]) < 1e-4
    assert rel_dev(ours["pred_conf"], ref["pred_conf"]) < 1e-4
    assert model.eval_batch_size == 1
    # a one-frame clip is paired with itself, as a two-frame clip of it
    one = _clip(1)
    two = {"images": np.concatenate([one["images"]] * 2)}
    with torch.no_grad():
        assert torch.equal(model.forward_tensors(one)["pred_world_pts"],
                           model.forward_tensors(two)["pred_world_pts"])


def test_dust3r_adapter_poses_on_a_known_scene(monkeypatch):
    """The network's outputs taken from a scene with known cameras: the
    pairs' view-1 maps are frame 0's map with an offset of opposite signs
    (their mean is frame 0's), view 2's the other frames'."""
    jmodel = jax_adapter(monkeypatch, "rope_dpt", init_height=H, init_width=W)
    model = port_adapter(jmodel, network_config=jax_network("rope_dpt")[0])
    pts, extr = _scene(np.random.default_rng(23))
    off = np.full((1, H, W, 3), 0.01, np.float32)
    out = (np.concatenate([pts[:1] + off, pts[:1] - off]), pts[1:],
           np.full((2, H, W), 2.0, np.float32), np.full((2, H, W), 3.0, np.float32))
    jmodel.network, model.network = _JaxSceneNet(out), _PortSceneNet(out)
    data = _clip()
    ref = jax_forward(jmodel, data)
    ours = {k: v.numpy() for k, v in model.forward_tensors(data).items()}
    assert rel_dev(ours["pred_world_pts"], pts) < 1e-6
    assert np.array_equal(ours["pred_conf"][1:], np.full((2, H, W), 3.0, np.float32))
    c2w, jc2w = ours["pred_poses"], ref["pred_poses"]
    assert (rotation_deg(c2w[:, :3, :3], jc2w[:, :3, :3]) < 1e-3).all()
    t_dev = np.linalg.norm(c2w[1:, :3, 3] - jc2w[1:, :3, 3], axis=-1)
    assert (t_dev < 1e-3 * np.linalg.norm(jc2w[1:, :3, 3], axis=-1)).all()
    ext = np.linalg.inv(c2w.astype(np.float64))
    assert (rotation_deg(ext[:, :3, :3], extr[:, :3, :3]) < 0.5).all()
    assert (np.linalg.norm(ext[:, :3, 3] - extr[:, :3, 3], axis=-1) < 0.02).all()
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-3


def test_dust3r_weight_bridge_is_strict(networks):
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork

    cfg, params, _, _, net = networks
    sd = pointmap_state_dict(params, net)
    # layer i of both streams' stacked leaves
    layers = params["params"]["decoder"]["layers"]
    for i in range(cfg["dec_depth"]):
        for blk in ("block1", "block2"):
            assert np.array_equal(sd[f"decoder.layers.{i}.{blk}.cross_attn.to_k.weight"].numpy(),
                                  np.asarray(layers[blk]["cross_attn"]["to_k"]["kernel"][i]).T)
    assert not np.array_equal(layers["block1"]["attn"]["to_q"]["kernel"][0],
                              layers["block2"]["attn"]["to_q"]["kernel"][0])

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        fn(tree["params"]["decoder"])
        return tree

    fresh = Dust3RNetwork(**cfg)
    with pytest.raises(KeyError, match="no flax leaf"):
        pointmap_state_dict(edited(lambda p: p["norm2"].pop("scale")), fresh)
    with pytest.raises(KeyError, match="left over"):
        pointmap_state_dict(edited(lambda p: p["layers"].update(block3=p["layers"]["block1"])),
                            fresh)
    with pytest.raises(ValueError, match="flax"):
        pointmap_state_dict(edited(lambda p: p["decoder_embed"].update(bias=np.zeros(5))), fresh)


def _cli(out, capsys):
    from unigeo_tpu_torch import eval as eval_cli

    manager = eval_cli.main(["--config", DUST3R_YAML, "--output", str(out), "--device", "cpu",
                             "--max-clips", str(MAX_CLIPS)])
    assert "Averages:" in capsys.readouterr().out
    return manager.rows()


def test_cli_runs_the_dust3r_config_as_it_is(tmp_path, capsys, monkeypatch):
    from unigeo_tpu_torch import eval as eval_cli

    built, get = [], eval_cli.get_model_cls
    monkeypatch.setattr(eval_cli, "get_model_cls",
                        lambda name: lambda **kw: built.append(get(name)(**kw)) or built[-1])
    rows = _cli(tmp_path, capsys)
    net = built[0].network
    assert type(built[0]).__module__ == "unigeo_tpu_torch.models.pointmap.dust3r"
    assert len(net.encoder.blocks.layers) == 2 and net.decoder.decoder_embed.out_features == 48
    assert next(net.parameters()).dtype == torch.float32
    with open(DUST3R_YAML) as f:
        cfg = yaml.safe_load(f)
    names = [n for sec in ("eval_depth", "eval_normal", "eval_pcd", "eval_camera")
             for n in cfg[sec]["metric_names"]]
    assert len(rows) == MAX_CLIPS
    assert all(np.isfinite(row[n]) for row in rows for n in names)


def _scene_pairs(data):
    """The network's outputs from a scene with known cameras, one per clip:
    view 1 of every pair frame 0's map, view 2 the others', unit
    confidences.  (The synthetic clips' own GT is not used: a box's walls
    are planes, on which a DLT is degenerate.)"""
    t = len(data["images"])
    pts, _ = _scene(np.random.default_rng(100 + int(data["_index"])), nf=t)
    ones = np.ones((t - 1, H, W), np.float32)
    return np.repeat(pts[:1], t - 1, 0), pts[1:], ones, ones


class _OnScene:
    """An adapter whose network's outputs are each clip's _scene_pairs."""

    def __init__(self, model, scene_net):
        self.model, self.scene_net = model, scene_net

    def forward(self, data):
        self.model.network = self.scene_net(_scene_pairs(data))
        return self.model.forward(data)


def test_cli_dust3r_rows_match_jax(tmp_path, capsys, monkeypatch):
    """configs/dust3r_synthetic.yaml through the port's CLI on the CPU,
    its model built from the config's model_params, against the JAX
    package's run_evaluation; both networks' outputs taken from a scene
    with known cameras (_scene_pairs)."""
    from unigeo_tpu.config import EvalConfig as JaxEvalConfig
    from unigeo_tpu.evaluator import run_evaluation as jax_run_evaluation
    from unigeo_tpu_torch import eval as eval_cli

    with open(DUST3R_YAML) as f:
        cfg = yaml.safe_load(f)
    # the config's network is the sin-cos, linear-head tiny one
    assert cfg["model_params"]["network_config"] == jax_network("sincos_linear")[0]
    jmodel = jax_adapter(monkeypatch, "sincos_linear", **cfg["model_params"])
    jmodel.forward = lambda data: jax_forward(jmodel, data)
    ref = jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"),
                             model=_OnScene(jmodel, _JaxSceneNet), max_clips=MAX_CLIPS,
                             data_parallel=False, verbose=False)

    def factory(**kw):
        assert kw["device"] == "cpu"
        return _OnScene(port_adapter(jmodel, **kw), _PortSceneNet)

    monkeypatch.setattr(eval_cli, "get_model_cls", lambda name: factory)
    rows = _cli(tmp_path / "port", capsys)
    check_rows(rows, ref.rows(), {"Abs Rel", "normal mean", "acc", "ATE"})


def check_rows(rows, ref_rows, families):
    """Every column of every row within test_torch_eval.py's bounds."""
    assert [r["seq_name"] for r in rows] == [r["seq_name"] for r in ref_rows]
    assert len(rows) == MAX_CLIPS
    pixels = 3.0 / (2 * H * W)
    for row, ref in zip(rows, ref_rows):
        assert row.keys() == ref.keys() and families <= set(row), (row.keys(), families)
        for key, val in ref.items():
            if key == "seq_name":
                continue
            assert np.isfinite(row[key]), (row["seq_name"], key)
            if key.startswith("delta"):
                tol = pixels
            elif key in ("ATE", "RPE trans", "RPE rot"):
                tol = 2e-2 * abs(val) + 1e-4
            else:
                tol = 2e-2 * abs(val)
            assert abs(row[key] - val) <= tol, (row["seq_name"], key, row[key], val)
