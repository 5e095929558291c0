"""The port's Cut3R (the pose codec, the pose head, the recurrent step, the
network, the adapter, the weight bridge) against the JAX package's, on the
CPU in f32, the JAX weights carried over by
``utils/weights.py::pointmap_state_dict``.

Tolerances, relative to the reference's largest magnitude unless said:
  * the pose codec and the harmonic embedding: 1e-6 (elementwise f32 ops);
  * the pose head (a mean, two dense layers, tanh gelu, a normalised
    quaternion): 1e-5; and one recurrent step (the frame decoder reading
    the state with its keys unrotated, two state blocks reading the
    frame): 1e-5 (f32 products summed in another order);
  * Cut3RNetwork's points, confidences and pose encodings: 1e-4 (two
    encoder blocks, three frames through two decoder and two state blocks
    each, then a linear or DPT head), in sin-cos + linear and RoPE100 +
    qkv bias + context norm + DPT modes;
  * the adapter: world points, depths (the self-view z), confidences and
    the c2w decoded from the pose head 1e-4 (the network's bound), normals
    by mean angle under 0.05 degree (plane fits over the same points), the
    focal (Weiszfeld over frame 0's self-view points) 1e-4 relative.  No
    DLT is involved: the poses come from the pose head, compared directly.

The JAX builds are shared: each mode's ``network.init`` and ``apply``
(jitted) are made once per module and handed to the JAX adapter through
its network's ``init``.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu_torch.utils.weights import pointmap_state_dict

H = W = 64

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


def loaded(port_module, params):
    port_module.load_state_dict(pointmap_state_dict(jax.device_get(params), port_module))
    return port_module.eval()


def _frames(t, seed=30):
    return np.random.default_rng(seed).random((t, H, W, 3)).astype(np.float32)


def _clip(t=3, seed=31):
    rng = np.random.default_rng(seed)
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


# --- the pose codec and the pose head ---------------------------------------------


def test_pose_codec_matches_jax():
    from scipy.spatial.transform import Rotation

    from unigeo_tpu.models import posecodec as jpc
    from unigeo_tpu_torch.models import posecodec as pc

    rng = np.random.default_rng(32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    c2w[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 1.0, (5, 3))).as_matrix()
    c2w[:, :3, 3] = rng.normal(0, 1.0, (5, 3))
    enc = pc.camera_to_pose_encoding(t_(c2w))
    assert rel_dev(enc.numpy(), jpc.camera_to_pose_encoding(jnp.asarray(c2w))) < 1e-6
    back = pc.pose_encoding_to_camera(enc)
    assert back.dtype == torch.float32 and rel_dev(back.numpy(), c2w) < 1e-6
    raw = rng.normal(0, 1.0, (2, 3, 7)).astype(np.float32)  # unnormalised quaternions
    assert rel_dev(pc.pose_encoding_to_camera(t_(raw)).numpy(),
                   jpc.pose_encoding_to_camera(jnp.asarray(raw))) < 1e-6


@pytest.mark.parametrize("logspace,append,cov", [(True, True, False), (False, False, True)])
def test_harmonic_embedding_matches_jax(logspace, append, cov):
    from unigeo_tpu.models import posecodec as jpc
    from unigeo_tpu_torch.models import posecodec as pc

    rng = np.random.default_rng(33)
    x = rng.normal(0, 1.0, (4, 7)).astype(np.float32)
    dc = rng.uniform(0, 0.1, (4, 7)).astype(np.float32) if cov else None
    kw = dict(n_harmonic_functions=5, omega_0=0.5, logspace=logspace, append_input=append)
    ours = pc.harmonic_embedding(t_(x), diag_cov=None if dc is None else t_(dc), **kw)
    ref = jpc.harmonic_embedding(jnp.asarray(x), diag_cov=None if dc is None else jnp.asarray(dc),
                                 **kw)
    assert ours.shape[-1] == pc.harmonic_embedding_dim(7, 5, append) == ref.shape[-1]
    assert rel_dev(ours.numpy(), ref) < 1e-6
    assert rel_dev(pc.harmonic_frequencies(5, 0.5, logspace).numpy(),
                   jpc.harmonic_frequencies(5, 0.5, logspace)) < 1e-6
    emb, jemb = pc.PoseEmbedding(7, 4, append), jpc.PoseEmbedding(7, 4, append)
    assert emb.out_dim == jemb.out_dim
    assert rel_dev(emb(t_(x)).numpy(), jemb(jnp.asarray(x))) < 1e-6


def test_pose_head_matches_jax():
    """The tanh gelu of flax's nn.gelu: the erf form misses the bound."""
    from unigeo_tpu.models.pointmap.network import PoseHead as JHead
    from unigeo_tpu_torch.models.pointmap.network import PoseHead

    x = np.random.default_rng(34).standard_normal((3, 10, 48)).astype(np.float32) * 3.0
    jhead = JHead()
    params = jhead.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = jhead.apply(params, jnp.asarray(x))
    head = loaded(PoseHead(48), params["params"])
    with torch.no_grad():
        ours = head(t_(x))
        assert rel_dev(ours.numpy(), ref) < 1e-5
        assert np.allclose(np.linalg.norm(ours[:, 3:].numpy(), axis=-1), 1.0, atol=1e-6)
        erf = head.fc2(torch.nn.functional.gelu(head.fc1(t_(x).mean(1))))
    assert rel_dev(erf[:, :3].numpy(), np.asarray(ref)[:, :3]) > 1e-5


def test_recurrent_step_matches_jax():
    """RoPE mode: the frame's queries rotated, the state's keys not."""
    from unigeo_tpu.models.pointmap.cut3r import _RecurrentStep as JStep
    from unigeo_tpu.ops.rope import grid_positions
    from unigeo_tpu_torch.models.pointmap.cut3r import RecurrentStep

    rng = np.random.default_rng(35)
    state = rng.standard_normal((8, 32)).astype(np.float32)
    tok = rng.standard_normal((16, 40)).astype(np.float32)
    pos = np.array(grid_positions(4, 4))
    jstep = JStep(32, 2, 2, pos_embed="RoPE100", qkv_bias=True, norm_context=True)
    args = (jnp.asarray(state), jnp.asarray(tok), pos)
    params = jax.jit(jstep.init)(jax.random.PRNGKey(3), *args)
    ref_state, ref_dec = jax.jit(jstep.apply)(params, *args)
    step = loaded(RecurrentStep(40, 32, 2, 2, pos_embed="RoPE100", qkv_bias=True,
                                norm_context=True), params["params"])
    with torch.no_grad():
        new_state, dec = step(t_(state), t_(tok), t_(pos))
    assert rel_dev(dec.numpy(), ref_dec) < 1e-5
    assert rel_dev(new_state.numpy(), ref_state) < 1e-5


# --- the network, the adapter, the bridge --------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_network(mode):
    """The mode's JAX network over three frames: (config, params, frames,
    outputs); built once per worker."""
    from unigeo_tpu.models.pointmap.cut3r import Cut3RNetwork as JNet, tiny_cut3r_config

    cfg = dict(tiny_cut3r_config(), **MODES[mode])
    frames = jnp.asarray(_frames(3))
    jnet = JNet(**cfg)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), frames))
    return cfg, params, np.asarray(frames), jax.device_get(jax.jit(jnet.apply)(params, frames))


@pytest.fixture(scope="module", params=sorted(MODES))
def networks(request):
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork

    cfg, params, frames, ref = jax_network(request.param)
    return cfg, params, frames, ref, loaded(Cut3RNetwork(**cfg), params)


def test_cut3r_network_matches_jax(networks):
    _, _, frames, ref, net = networks
    with torch.no_grad():
        ours = net(t_(frames))
    assert sorted(ours) == sorted(ref)
    for key, val in ours.items():
        assert rel_dev(val.numpy(), ref[key]) < 1e-4, key
    assert ours["pose_enc"].shape == (3, 7) and ours["self_pts"].shape == (3, H, W, 3)


def test_cut3r_adapter_matches_jax(monkeypatch):
    from unigeo_tpu.models.pointmap.cut3r import Cut3R as JCut3R, Cut3RNetwork as JNet
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3R

    cfg, params, _, _ = jax_network("rope_dpt")
    with monkeypatch.context() as m:
        m.setattr(JNet, "init", lambda self, *a, **k: params)
        jmodel = JCut3R(network_config=cfg, init_height=H, init_width=W)
    model = Cut3R(network_config=cfg, device="cpu")
    model.load_state_dict(pointmap_state_dict(params, model.network))
    data = _clip()
    ref, ours = jmodel.forward(data), model.forward(data)
    assert sorted(ours) == sorted(ref)
    assert isinstance(ours["pred_focal"], float) and isinstance(ref["pred_focal"], float)
    assert abs(ours["pred_focal"] - ref["pred_focal"]) < 1e-4 * abs(ref["pred_focal"])
    for key in ("pred_world_pts", "pred_depths", "pred_poses", "pred_conf"):
        assert ours[key].dtype == np.float32 and np.isfinite(ours[key]).all()
        assert rel_dev(ours[key], ref[key]) < 1e-4, key
    cos = (ours["pred_normals"].astype(np.float64) * ref["pred_normals"]).sum(-1)
    assert np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).mean() < 0.05
    assert model.eval_batch_size == 1
    with pytest.raises(NotImplementedError, match="item 9"):
        Cut3R(checkpoint_path="cut3r.pth", device="cpu")


def test_cut3r_weight_bridge_is_strict(networks):
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork

    cfg, params, _, _, net = networks
    sd = pointmap_state_dict(params, net)
    # the recurrent step is broadcast over the frames, its decoder's blocks
    # stacked inside it; the state tokens and the pose head as they are
    p = params["params"]
    stacked = p["recurrent_step"]["decoder"]["blocks"]["layers"]["block"]
    for i in range(cfg["dec_depth"]):
        assert np.array_equal(
            sd[f"recurrent_step.decoder.blocks.layers.{i}.cross_attn.to_v.weight"].numpy(),
            np.asarray(stacked["cross_attn"]["to_v"]["kernel"][i]).T)
    assert np.array_equal(sd["state_tokens"].numpy(), p["state_tokens"])
    state_fc2 = p["recurrent_step"]["state_block_1"]["mlp"]["fc2"]["kernel"]
    assert np.array_equal(sd["recurrent_step.state_block_1.mlp.fc2.weight"].numpy(),
                          np.asarray(state_fc2).T)
    assert np.array_equal(sd["head_pose.fc1.weight"].numpy(),
                          np.asarray(p["head_pose"]["fc1"]["kernel"]).T)

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        fn(tree["params"])
        return tree

    fresh = Cut3RNetwork(**cfg)
    with pytest.raises(KeyError, match="no flax leaf"):
        pointmap_state_dict(edited(lambda q: q.pop("state_tokens")), fresh)
    with pytest.raises(KeyError, match="left over"):
        pointmap_state_dict(edited(lambda q: q["recurrent_step"].update(
            state_block_2=q["recurrent_step"]["state_block_0"])), fresh)
    with pytest.raises(ValueError, match="flax"):
        pointmap_state_dict(edited(lambda q: q["head_pose"]["fc2"].update(bias=np.zeros(6))),
                            fresh)
