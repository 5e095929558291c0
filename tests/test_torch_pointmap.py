"""The port's pointmap family (Spann3R and its parts) against the JAX
package's, on the CPU in f32, the JAX weights carried over by
``utils/weights.py::pointmap_state_dict``.

Tolerances, relative to the reference's largest magnitude unless said:
  * RoPE tables and rotation: 1e-6 (elementwise f32 ops);
  * one attention or ViT block, the patch embedding: 1e-5 (f32 products
    summed in another order);
  * the DPT head: 1e-4 (a dozen convolutions and resizes deep);
  * Spann3RNetwork's points: 1e-4 (two encoder and two decoder blocks per
    frame over three frames, then the head);
  * the camera solver: focal 1e-5 relative; poses held by rotation angle
    and translation, not elementwise, since the eigenvectors' signs and the
    sums' order differ between the solvers: 1e-3 degree and 1e-3 of the
    translation's norm on a synthetic scene (each solver lands about 1e-4
    degree and 4e-5 from the true pose in f32, 1.3e-4 of |t| apart seen),
    and both within the JAX package's own bounds of the true pose (0.5
    degree, 0.02);
  * the adapter's outputs: world points 1e-4 (the network's bound).  The
    depths and poses come from the DLT on the random network's pointmaps,
    which no camera explains: the fit is a compromise whose normal matrix
    has close smallest eigenvalues, so f32 rounding in either package moves
    the pose by up to 0.056 degree (measured on this clip).  Held at 0.25
    degree, translations and depths at 1e-2 relative, normals by mean angle
    under 0.5 degree; the conditioned scene above is where the solver is
    held tightly.

The JAX Spann3R network of each mode is built once per worker
(``jax_spann3r``) and shared by the network, adapter and bridge tests.
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


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def t_(a):
    return torch.from_numpy(np.array(a))


def rotation_deg(r1, r2):
    """The angle of r1 r2^T, from ||D - I||_F = 2 sqrt(2) sin(angle / 2) (exact
    for a rotation D, and not floored by f32 entries as arccos of the trace
    is: that reads ~0.03 degree for matrices equal to f32 round-off)."""
    d = np.asarray(r1, np.float64) @ np.asarray(r2, np.float64).swapaxes(-1, -2)
    dist = np.linalg.norm(d - np.eye(3), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(dist / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def mean_angle_deg(a, b):
    cos = np.clip((np.asarray(a, np.float64) * np.asarray(b, np.float64)).sum(-1), -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)).mean())


def loaded(port_module, params):
    port_module.load_state_dict(pointmap_state_dict(jax.device_get(params), port_module))
    return port_module.eval()


# --- RoPE, attention, blocks ----------------------------------------------------


def test_rope_matches_jax():
    from unigeo_tpu.ops import rope as jr
    from unigeo_tpu_torch.ops import rope as pr

    assert np.array_equal(pr.grid_positions(3, 5).numpy(), np.array(jr.grid_positions(3, 5)))
    pos = np.array(jr.grid_positions(3, 5))
    pos[2] = [-1, -1]  # a token without a grid slot stays unrotated
    for d in (16, 64):
        cos, sin = pr.rope_2d_cos_sin(d, t_(pos))
        jcos, jsin = jr.rope_2d_cos_sin(d, jnp.asarray(pos))
        assert rel_dev(cos.numpy(), jcos) < 1e-6 and rel_dev(sin.numpy(), jsin) < 1e-6
        assert (cos[2] == 1).all() and (sin[2] == 0).all()
        x = np.random.default_rng(d).standard_normal((2, 15, 3, d)).astype(np.float32)
        ours = pr.apply_rope_2d(t_(x), cos, sin)
        assert rel_dev(ours.numpy(), jr.apply_rope_2d(jnp.asarray(x), jcos, jsin)) < 1e-6
    cos, _ = pr.rope_2d_cos_sin(16, t_(pos), dtype=torch.bfloat16)
    assert cos.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple of 4"):
        pr.rope_2d_cos_sin(18, t_(pos))


@pytest.mark.parametrize("rope", [None, 100.0])
def test_masked_attention_matches_jax_and_gives_masked_keys_no_weight(rope):
    from unigeo_tpu.models.layers import Attention as JAttention
    from unigeo_tpu.ops.rope import grid_positions
    from unigeo_tpu_torch.models.layers import Attention

    rng = np.random.default_rng(3)
    c, s, sk = 32, 16, 24
    x = rng.standard_normal((2, s, c)).astype(np.float32)
    ctx = rng.standard_normal((2, sk, c)).astype(np.float32)
    mask = (np.arange(sk) < 18).astype(np.float32)
    pos = np.array(grid_positions(4, 4))
    ctx_pos = np.concatenate([pos, pos[:8]])
    jatt = JAttention(2, qkv_bias=True, rope_freq=rope)
    params = jatt.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx), pos=pos,
                       ctx_pos=ctx_pos, ctx_mask=mask)
    ref = jatt.apply(params, jnp.asarray(x), jnp.asarray(ctx), pos=pos, ctx_pos=ctx_pos,
                     ctx_mask=mask)
    att = loaded(Attention(c, 2, qkv_bias=True, rope_freq=rope), params["params"])
    kw = dict(pos=t_(pos), ctx_pos=t_(ctx_pos))
    with torch.no_grad():
        ours = att(t_(x), t_(ctx), ctx_mask=t_(mask), **kw)
        assert rel_dev(ours.numpy(), ref) < 1e-5
        # the masked keys' values change nothing, bit for bit
        other = ctx.copy()
        other[:, 18:] = 1e3 * rng.standard_normal((2, 6, c))
        assert torch.equal(att(t_(x), t_(other), ctx_mask=t_(mask), **kw), ours)
        # and a [B, Sk] mask is taken as well
        assert torch.equal(att(t_(x), t_(ctx), ctx_mask=t_(np.stack([mask, mask])), **kw), ours)


@pytest.mark.parametrize("cross,rope,mask", [(False, None, False), (True, None, False),
                                             (True, 100.0, True), (False, 100.0, False)])
def test_vit_block_matches_jax(cross, rope, mask):
    from unigeo_tpu.models.vit import ViTBlock as JBlock
    from unigeo_tpu.ops.rope import grid_positions
    from unigeo_tpu_torch.models.vit import ViTBlock

    rng = np.random.default_rng(4)
    c, s = 32, 16
    x = rng.standard_normal((1, s, c)).astype(np.float32)
    ctx = rng.standard_normal((1, 2 * s, c)).astype(np.float32) if cross else None
    pos = np.array(grid_positions(4, 4)) if rope else None
    ctx_pos = np.concatenate([pos, pos]) if rope and cross else None
    ctx_mask = (np.arange(2 * s) < s + 5).astype(np.float32) if mask else None
    jblock = JBlock(2, qkv_bias=True, rope_freq=rope, norm_context=cross)
    args = (jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), pos, ctx_pos, ctx_mask)
    params = jblock.init(jax.random.PRNGKey(1), *args)
    ref = jblock.apply(params, *args)
    block = loaded(ViTBlock(c, 2, qkv_bias=True, rope_freq=rope, norm_context=cross,
                            with_cross=cross), params["params"])
    tt = lambda a: None if a is None else t_(a)
    with torch.no_grad():
        ours = block(t_(x), tt(ctx), tt(pos), tt(ctx_pos), tt(ctx_mask))
    assert rel_dev(ours.numpy(), ref) < 1e-5


def test_patch_embed_and_sincos_match_jax():
    from unigeo_tpu.models.vit import PatchEmbed as JPatch, sincos_2d_pos_embed as jsincos
    from unigeo_tpu_torch.models.vit import PatchEmbed, sincos_2d_pos_embed

    assert rel_dev(sincos_2d_pos_embed(32, 3, 5).numpy(), jsincos(32, 3, 5)) < 1e-6
    x = np.random.default_rng(5).standard_normal((2, 48, 80, 3)).astype(np.float32)
    jp = JPatch(32, 16)
    params = jp.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref, grid = jp.apply(params, jnp.asarray(x))
    ours, ours_grid = loaded(PatchEmbed(32, 16), params["params"])(t_(x))
    assert ours_grid == grid == (3, 5)
    assert rel_dev(ours.detach().numpy(), ref) < 1e-5


# --- camera solver -------------------------------------------------------------


def _scene(rng, nf=3, h=24, w=32, focal=40.0, world_is_frame0=False):
    """World pointmaps seen by known cameras (tests/test_camera_solver.py's
    scene): depth 2-2.5, small random rotations and translations; with
    ``world_is_frame0`` frame 0's camera is the world frame, as a pointmap
    network predicts it."""
    from scipy.spatial.transform import Rotation

    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    depth = 2.0 + rng.uniform(0, 0.5, size=(nf, h, w))
    pts, extr = [], []
    for i in range(nf):
        cam = np.stack([(uu - k[0, 2]) * depth[i] / focal, (vv - k[1, 2]) * depth[i] / focal,
                        depth[i]], -1)
        r = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
        t = rng.normal(0, 0.2, 3)
        if world_is_frame0 and i == 0:
            r, t = np.eye(3), np.zeros(3)
        ext = np.eye(4)
        ext[:3, :3], ext[:3, 3] = r, t
        pts.append(((cam.reshape(-1, 3) - t) @ r).reshape(h, w, 3))
        extr.append(ext)
    return np.stack(pts).astype(np.float32), np.stack(extr).astype(np.float32), k


def test_camera_solver_matches_jax():
    from unigeo_tpu.models import camera_solver as jcs
    from unigeo_tpu_torch.models import camera_solver as pcs

    pts, extr, k = _scene(np.random.default_rng(6))
    cam0 = pts[0] @ extr[0, :3, :3].T + extr[0, :3, 3]
    f = pcs.estimate_focal_weiszfeld(t_(cam0)).item()
    assert abs(f - float(jcs.estimate_focal_weiszfeld(jnp.asarray(cam0)))) < 1e-5 * f
    assert abs(f - 40.0) < 0.02 * 40.0

    ours = pcs.solve_pnp_batch(t_(pts), t_(k)).numpy()
    ref = np.array(jcs.solve_pnp_batch(jnp.asarray(pts), jnp.asarray(k)))
    assert (rotation_deg(ours[:, :3, :3], ref[:, :3, :3]) < 1e-3).all()
    t_dev = np.linalg.norm(ours[:, :3, 3] - ref[:, :3, 3], axis=-1)
    assert (t_dev < 1e-3 * np.linalg.norm(ref[:, :3, 3], axis=-1)).all()
    assert (rotation_deg(ours[:, :3, :3], extr[:, :3, :3]) < 0.5).all()
    assert (np.linalg.norm(ours[:, :3, 3] - extr[:, :3, 3], axis=-1) < 0.02).all()
    assert np.allclose(ours[:, 3], [0, 0, 0, 1])

    # one frame's weighted DLT on its own
    pix = np.stack(np.meshgrid((np.arange(32) - 16) / 40.0, (np.arange(24) - 12) / 40.0,
                               indexing="xy"), -1).reshape(-1, 2).astype(np.float32)
    wgt = np.random.default_rng(7).uniform(0.5, 1.5, 24 * 32).astype(np.float32)
    r, t = pcs._dlt_pose(t_(pts[1].reshape(1, -1, 3)), t_(pix), t_(wgt[None]))
    jr, jt = jcs._dlt_pose(jnp.asarray(pts[1].reshape(-1, 3)), jnp.asarray(pix), jnp.asarray(wgt))
    assert rotation_deg(r[0].numpy(), np.array(jr)) < 1e-3
    assert np.linalg.norm(t[0].numpy() - np.array(jt)) < 1e-3 * np.linalg.norm(np.array(jt))

    # the whole recovery on a scene whose world is frame 0's camera
    pts, extr, k = _scene(np.random.default_rng(8), world_is_frame0=True)
    cam, ext, intr = pcs.solve_depth_and_camera_from_pointmaps(t_(pts))
    jcam, jext, jintr = jcs.solve_depth_and_camera_from_pointmaps(jnp.asarray(pts))
    assert rel_dev(intr.numpy(), jintr) < 1e-5 and abs(intr[0, 0, 0].item() - 40.0) < 0.8
    ext, jext = ext.numpy(), np.array(jext)
    assert (rotation_deg(ext[:, :3, :3], jext[:, :3, :3]) < 1e-3).all()
    t_dev = np.linalg.norm(ext[:, :3, 3] - jext[:, :3, 3], axis=-1)
    assert (t_dev[1:] < 1e-3 * np.linalg.norm(jext[1:, :3, 3], axis=-1)).all()
    assert rel_dev(cam.numpy(), jcam) < 1e-3


# --- DPT ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(4, 4), (3, 5)])
def test_dpt_head_matches_jax(grid):
    """An even and an odd token grid (the odd one resizes the deeper map to
    the skip's grid in every fusion block)."""
    from unigeo_tpu.models.pointmap.dpt import DPTHead as JDPT
    from unigeo_tpu_torch.models.pointmap.dpt import DPTHead

    dims, layer_dims = (24, 16, 16, 16), (8, 12, 16, 24)
    rng = np.random.default_rng(8)
    n = grid[0] * grid[1]
    hooks = [rng.standard_normal((2, n, d)).astype(np.float32) for d in dims]
    jdpt = JDPT(out_channels=4, feature_dim=16, layer_dims=layer_dims, head_dim=8)
    params = jdpt.init(jax.random.PRNGKey(3), [jnp.asarray(h) for h in hooks], grid)
    ref = jdpt.apply(params, [jnp.asarray(h) for h in hooks], grid)
    dpt = loaded(DPTHead(dims, 4, 16, layer_dims, 8), params["params"])
    with torch.no_grad():
        ours = dpt([t_(h) for h in hooks], grid)
    assert ours.shape == (2, 16 * grid[0], 16 * grid[1], 4)
    assert rel_dev(ours.numpy(), ref) < 1e-4
    # the transposed convs' kernels loaded without the spatial flip (same
    # shapes, no error) give other numbers
    sd = pointmap_state_dict(jax.device_get(params["params"]), dpt)
    for key in ("act_postprocess_0_resample.weight", "act_postprocess_1_resample.weight"):
        sd[key] = sd[key].flip(-1, -2)
    dpt.load_state_dict(sd)
    with torch.no_grad():
        assert rel_dev(dpt([t_(h) for h in hooks], grid).numpy(), ref) > 1e-2


def test_dpt_pointmap_head_resizes_a_non_16_patch_as_jax():
    from unigeo_tpu.models.pointmap.dpt import DPTPointmapHead as JHead
    from unigeo_tpu_torch.models.pointmap.dpt import DPTPointmapHead

    grid, dims = (3, 5), (24, 16, 16, 16)
    rng = np.random.default_rng(9)
    hooks = [rng.standard_normal((1, 15, d)).astype(np.float32) for d in dims]
    for patch in (14, 18):  # the x16 trunk shrunk (antialiased) and enlarged
        jhead = JHead(patch_size=patch, feature_dim=16, layer_dims=(8, 12, 16, 24))
        params = jhead.init(jax.random.PRNGKey(4), [jnp.asarray(h) for h in hooks], grid)
        ref_pts, ref_conf = jhead.apply(params, [jnp.asarray(h) for h in hooks], grid)
        head = loaded(DPTPointmapHead(dims, patch, 16, (8, 12, 16, 24)), params["params"])
        with torch.no_grad():
            pts, conf = head([t_(h) for h in hooks], grid)
        assert pts.shape == (1, 3 * patch, 5 * patch, 3)
        assert rel_dev(pts.numpy(), ref_pts) < 1e-4 and rel_dev(conf.numpy(), ref_conf) < 1e-4


# --- the network, the adapter, the bridge ----------------------------------------


def _frames(t, seed=10, h=H, w=W):
    return np.random.default_rng(seed).random((t, h, w, 3)).astype(np.float32)


MODES = {
    "sincos_linear": {},
    "rope_dpt": dict(pos_embed="RoPE100", qkv_bias=True, norm_context=True, head_type="dpt"),
}


@functools.lru_cache(maxsize=None)
def jax_spann3r(mode):
    """The mode's JAX Spann3RNetwork on three frames: (config, params,
    frames, points, confidence), its init and apply jitted (the persistent
    compile cache serves later runs) and built once per worker for every
    test that needs them."""
    from unigeo_tpu.models.pointmap.spann3r import Spann3RNetwork as JNet, tiny_spann3r_config

    cfg = dict(tiny_spann3r_config(), **MODES[mode])
    frames = jnp.asarray(_frames(3))
    jnet = JNet(**cfg)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), frames))
    ref_pts, ref_conf = jax.device_get(jax.jit(jnet.apply)(params, frames))
    return cfg, params, np.asarray(frames), ref_pts, ref_conf


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spann3r_network_matches_jax(mode):
    """Three frames through a two-slot ring: frame 2 overwrites frame 0's slot."""
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3RNetwork

    cfg, params, frames, ref_pts, ref_conf = jax_spann3r(mode)
    assert cfg["memory_frames"] == 2
    net = loaded(Spann3RNetwork(**cfg), params)
    with torch.no_grad():
        pts, conf = net(t_(frames))
    assert rel_dev(pts.numpy(), ref_pts) < 1e-4 and rel_dev(conf.numpy(), ref_conf) < 1e-4


def test_empty_ring_slots_take_no_attention():
    """Frame 0's output is the same whatever the ring's capacity."""
    from unigeo_tpu_torch.models.pointmap.adapter import init_network_
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3RNetwork

    cfg = dict(enc_width=32, enc_depth=1, enc_heads=2, dec_width=32, dec_depth=1, dec_heads=2)
    net2 = init_network_(Spann3RNetwork(memory_frames=2, **cfg), torch.Generator().manual_seed(0))
    net4 = Spann3RNetwork(memory_frames=4, **cfg)
    net4.load_state_dict(net2.state_dict())
    frames = t_(_frames(1, h=32, w=32))
    with torch.no_grad():
        assert torch.equal(net2(frames)[0], net4(frames)[0])


def _clip(t=3):
    rng = np.random.default_rng(11)
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


@pytest.fixture(scope="module")
def spann3r_pair():
    """The JAX adapter on jax_spann3r's params (its network's init handed
    them) and the port's with the same weights."""
    from unigeo_tpu.models.pointmap.spann3r import Spann3R as JSpann3R
    from unigeo_tpu.models.pointmap.spann3r import Spann3RNetwork as JNet
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R

    cfg, params, _, _, _ = jax_spann3r("rope_dpt")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JNet, "init", lambda self, *a, **k: params)
        jmodel = JSpann3R(network_config=cfg, init_height=H, init_width=W, init_frames=2)
    model = Spann3R(network_config=cfg, device="cpu")
    model.load_state_dict(pointmap_state_dict(jax.device_get(jmodel.params), model.network))
    return jmodel, model


def test_spann3r_adapter_matches_jax(spann3r_pair):
    jmodel, model = spann3r_pair
    data = _clip()
    ref, ours = jmodel.forward(data), model.forward(data)
    assert sorted(ours) == sorted(ref)
    for key, val in ours.items():
        assert val.dtype == np.float32 and val.shape == ref[key].shape and np.isfinite(val).all()
    assert rel_dev(ours["pred_world_pts"], ref["pred_world_pts"]) < 1e-4
    assert rel_dev(ours["pred_conf"], ref["pred_conf"]) < 1e-4
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-2
    assert (rotation_deg(ours["pred_poses"][:, :3, :3], ref["pred_poses"][:, :3, :3]) < 0.25).all()
    assert rel_dev(ours["pred_poses"][:, :3, 3], ref["pred_poses"][:, :3, 3]) < 1e-2
    assert mean_angle_deg(ours["pred_normals"], ref["pred_normals"]) < 0.5
    assert model.eval_batch_size == 1
    outs = model.forward_batch([data, data])
    assert len(outs) == 2 and np.array_equal(outs[1]["pred_depths"], ours["pred_depths"])


def test_spann3r_adapter_dtypes(spann3r_pair, monkeypatch, tmp_path):
    """bf16 compute (argument or UNIGEO_COMPUTE_DTYPE) keeps the geometry f32;
    an f16 transfer widens the bulky fields back to f32; unknown values
    raise; an f32 checkpoint loads at the compute dtype."""
    from unigeo_tpu_torch.models.pointmap import adapter
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R, tiny_spann3r_config

    _, model = spann3r_pair
    data = _clip(2)
    ref = model.forward(data)
    half = adapter.fetch_outputs(model.forward_tensors(data), torch.float16)
    assert all(v.dtype == np.float32 for v in half.values())
    assert np.array_equal(half["pred_depths"], ref["pred_depths"])
    assert rel_dev(half["pred_world_pts"], ref["pred_world_pts"]) < 1e-3  # f16's 2^-11
    monkeypatch.setenv("UNIGEO_COMPUTE_DTYPE", "bfloat16")
    bf = Spann3R(network_config=tiny_spann3r_config(), device="cpu")
    assert next(bf.network.parameters()).dtype == torch.bfloat16
    out = bf.forward_tensors(data)
    assert all(v.dtype == torch.float32 for v in out.values())
    monkeypatch.delenv("UNIGEO_COMPUTE_DTYPE")
    with pytest.raises(ValueError):
        adapter.resolve_compute_dtype("float16")
    with pytest.raises(ValueError):
        adapter.resolve_transfer_dtype("bfloat16")
    from unigeo_tpu_torch.utils.checkpoint import save_params

    save_params(model.network.state_dict(), str(tmp_path / "spann3r.ckpt"))
    bf = Spann3R(network_config=jax_spann3r("rope_dpt")[0],
                 checkpoint_path=str(tmp_path / "spann3r.ckpt"), compute_dtype="bfloat16",
                 device="cpu")
    ref = model.network.state_dict()
    assert all(torch.equal(v, ref[k].to(torch.bfloat16))
               for k, v in bf.network.state_dict().items())


def test_weight_bridge_is_strict():
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3RNetwork

    cfg, params, _, _, _ = jax_spann3r("rope_dpt")
    net = Spann3RNetwork(**cfg)
    sd = pointmap_state_dict(params, net)
    # layer i of a stacked leaf, the memory step's leaves unstacked
    stacked = params["params"]["memory_step"]["decoder"]["blocks"]["layers"]["block"]
    for i in range(2):
        assert np.array_equal(
            sd[f"memory_step.decoder.blocks.layers.{i}.attn.to_q.weight"].numpy(),
            np.asarray(stacked["attn"]["to_q"]["kernel"][i]).T)
    assert not np.array_equal(stacked["attn"]["to_q"]["kernel"][0],
                              stacked["attn"]["to_q"]["kernel"][1])

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        fn(tree["params"])
        return tree

    enc = lambda p: p["encoder"]
    with pytest.raises(KeyError, match="no flax leaf"):
        pointmap_state_dict(edited(lambda p: enc(p)["norm"].pop("scale")), net)
    with pytest.raises(KeyError, match="left over"):
        pointmap_state_dict(edited(lambda p: enc(p)["norm"].update(extra=np.zeros(3))), net)
    with pytest.raises(ValueError, match="flax"):
        pointmap_state_dict(edited(lambda p: enc(p)["norm"].update(scale=np.zeros(63))), net)
    # a deeper JAX stack than the port's (a third encoder layer stacked on
    # the two): its third layer is left over
    deeper = edited(lambda p: enc(p)["blocks"].update(layers=jax.tree_util.tree_map(
        lambda a: np.concatenate([a, a[:1]]), enc(p)["blocks"]["layers"])))
    with pytest.raises(KeyError, match="left over"):
        pointmap_state_dict(deeper, net)
