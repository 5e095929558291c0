"""The port's Aether (causal 3D VAE, adaLN-zero DiT, rectified-flow sampler,
raymap poses, the adapter, the weight bridge, the eval CLI) against the JAX
package's, on the CPU in f32, the JAX weights carried over by
``utils/weights.py::aether_state_dicts`` and the JAX noise passed in.

adaLN-zero makes a random DiT output exactly 0, so every parity test past
the VAE first gives each all-equal leaf (the modulations, the output
projection, biases, GroupNorm scales) live values, the same on both sides
(``perturbed``, as ``tests/test_aether_composed_oracle.py`` does).

Tolerances, relative to the reference's largest magnitude unless said:
  * ``CausalConv3d`` unstrided, at strides (1, 2, 2) and (2, 2, 2), and
    ``Upsample2xConv3d`` (one 2x2 kernel per output phase here) against
    JAX's conv fused with the nearest x2 upsample (an lhs-dilated conv) and
    against its conv of the upsampled input: 1e-5; ``CausalResBlock3d``
    with a skip: 1e-5;
  * GroupNorm per frame: a clip whose frames differ in scale by 10^4
    within 1e-5 (statistics pooled over the frames would be far off);
  * ``CausalVAE3D`` encode, and decode against JAX's fused and plain
    decoders: 1e-4;
    the port's encoder causal (a prefix encodes to the prefix): 1e-5;
  * ``DiTBlock``: 1e-5, also on tokens of variance 1e-6 (where flax's
    LayerNorm epsilon of 1e-6, not torch's 1e-5, shows); ``AetherDiT``:
    1e-4; the port's DiT at init: 0;
  * the flow sampler: with the true (constant) velocity, x0 within 1e-5
    absolute in 1 and 4 steps; with the tiny DiT and the JAX noise: 1e-4;
  * raymap helpers in f64: 1e-9 (absolute); ``interpolate_poses``: 1e-6
    absolute (its quaternions are f32 in both);
  * the adapter on 5 frames (ct 2: a pad of 1): depths, raymaps and world
    points (the JAX poses given to both) 1e-4, normals by mean angle under
    0.05 degree (the f32 plane fits round differently), and the host pose
    stage fed the JAX raymaps: poses 1e-6 absolute;
  * the eval CLI on ``configs/aether_synthetic.yaml``: as it is, every
    column of the four families finite; with the JAX weights and noise,
    the depth, normal and point-cloud columns within
    ``tests/test_torch_eval.py``'s bounds of the JAX eval's (errors 2e-2
    relative, shares 3 pixels' share), the camera columns finite only (the
    packages' random-weight poses are not compared).
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

from unigeo_tpu_torch.utils.weights import aether_state_dicts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AETHER_YAML = os.path.join(ROOT, "configs", "aether_synthetic.yaml")
MAX_CLIPS = 2
NET = dict(width=32, depth=2, num_heads=2, patch=2, mlp_ratio=2)
VAE = dict(base_width=8, mults=(1, 1, 2), temporal_down=(False, True, False), z_channels=4)
TARGET = VAE["z_channels"] + 6


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def nchw(a):
    """JAX [T, H, W, C] -> the port's [T, C, H, W]."""
    return t_(a).permute(0, 3, 1, 2)


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def mean_angle_deg(a, b):
    cos = np.clip((np.asarray(a, np.float64) * np.asarray(b, np.float64)).sum(-1), -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)).mean())


def perturbed(params, seed):
    """Every all-equal leaf (std 0) replaced by N(0, 0.2) draws."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf) if float(np.std(leaf)) > 0
        else rng.normal(0, 0.2, np.shape(leaf)).astype(np.float32),
        jax.device_get(params))


def jax_module(module, *inputs, seed=0):
    """(params with zero leaves perturbed, jitted apply) of a flax module."""
    params = perturbed(jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs), seed + 1)
    return params, jax.jit(module.apply)


def loaded(module, params, dit=None):
    vae, dit_p = (None, params) if dit else (params, None)
    module.load_state_dict(aether_state_dicts(vae, dit_p, module))
    return module.eval()


@functools.lru_cache(maxsize=None)
def jax_params():
    """The tiny configuration's JAX VAE and DiT params, zero leaves perturbed
    (built once per worker; aether_synthetic.yaml's model is the same)."""
    from unigeo_tpu.models.aether import AetherDiT, CausalVAE3D

    vae = CausalVAE3D(**VAE)
    vp = jax.jit(vae.init)(jax.random.PRNGKey(1), jnp.zeros((4, 32, 32, 3)))
    dit = AetherDiT(out_channels=TARGET, **NET)
    dp = jax.jit(dit.init)(jax.random.PRNGKey(2), jnp.zeros((2, 4, 4, VAE["z_channels"] + TARGET)),
                           jnp.float32(1.0))
    return perturbed(vp, 3), perturbed(dp, 4)


def port_network():
    from unigeo_tpu_torch.models.aether import AetherNetwork

    net = AetherNetwork(vae_config=VAE, network_config=NET)
    net.load_state_dict(aether_state_dicts(*jax_params(), net))
    return net.eval()


def jax_noise(seed, tl, h, w):
    """The JAX adapter's noise draw, in the port's [T', C, h, w]."""
    return nchw(jax.random.normal(jax.random.PRNGKey(seed), (tl, h, w, TARGET), jnp.float32))


# --- the VAE -------------------------------------------------------------------

CONV_CASES = {"plain": dict(kernel=(3, 3, 3)), "s122": dict(strides=(1, 2, 2)),
              "s222": dict(strides=(2, 2, 2)), "fused": dict(fuse_upsample2x=True),
              "k1": dict(kernel=(1, 1, 1))}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_causal_conv3d_matches_jax(case):
    """The "fused" case: the port's Upsample2xConv3d on the input against
    JAX's fused conv on it, and against JAX's plain conv on the input
    upsampled (the same parameters)."""
    from unigeo_tpu.models.aether import CausalConv3d as JConv
    from unigeo_tpu_torch.models.aether import CausalConv3d, Upsample2xConv3d

    kw = CONV_CASES[case]
    x = np.random.default_rng(5).standard_normal((5, 12, 10, 6)).astype(np.float32)
    params, apply = jax_module(JConv(7, **kw), jnp.asarray(x))
    ref = np.asarray(apply(params, jnp.asarray(x)))
    fused = case == "fused"
    conv = loaded(Upsample2xConv3d(6, 7) if fused else CausalConv3d(6, 7, **kw), params)
    with torch.no_grad():
        ours = nhwc(conv(nchw(x)))
    assert rel_dev(ours, ref) < 1e-5
    if fused:
        up = jnp.repeat(jnp.repeat(jnp.asarray(x), 2, axis=1), 2, axis=2)
        ref_plain = np.asarray(jax.jit(JConv(7).apply)(params, up))
        assert rel_dev(ours, ref_plain) < 1e-5


def test_res_block_with_skip_matches_jax():
    from unigeo_tpu.models.aether import CausalResBlock3d as JRes
    from unigeo_tpu_torch.models.aether import CausalResBlock3d

    x = np.random.default_rng(6).standard_normal((4, 8, 8, 8)).astype(np.float32)
    params, apply = jax_module(JRes(16), jnp.asarray(x))
    assert "skip" in params["params"]
    block = loaded(CausalResBlock3d(8, 16), params)
    with torch.no_grad():
        ours = nhwc(block(nchw(x)))
    assert rel_dev(ours, np.asarray(apply(params, jnp.asarray(x)))) < 1e-5


def test_group_norm_is_per_frame():
    """flax's GroupNorm on [T, H, W, C] takes T as the batch: the port's
    GroupNorm on [T, C, H, W] does too; statistics pooled over the frames
    (torch's GroupNorm on [1, C, T, H, W]) are far off on a clip whose
    frames differ in scale."""
    from unigeo_tpu.models.layers import GroupNorm as JGroupNorm
    from unigeo_tpu_torch.models.layers import GroupNorm

    x = np.random.default_rng(7).standard_normal((3, 6, 6, 24)).astype(np.float32)
    x *= np.array([1.0, 100.0, 0.01], np.float32)[:, None, None, None]
    params, apply = jax_module(JGroupNorm(), jnp.asarray(x))
    ref = np.asarray(apply(params, jnp.asarray(x)))
    norm = GroupNorm(24)
    inner = params["params"]["GroupNorm_0"]
    norm.load_state_dict({"weight": t_(inner["scale"]), "bias": t_(inner["bias"])})
    with torch.no_grad():
        ours = nhwc(norm(nchw(x)))
        pooled = norm(nchw(x).transpose(0, 1)[None])[0].transpose(0, 1)
    assert rel_dev(ours, ref) < 1e-5
    assert rel_dev(nhwc(pooled), ref) > 1e-1


def test_vae_matches_jax():
    """Encode, and decode against JAX's fused and plain decoders, on the
    tiny VAE (the port's one decoder, whatever ``fused_upsample`` says)."""
    from unigeo_tpu.models.aether import CausalVAE3D as JVAE
    from unigeo_tpu_torch.models.aether import CausalVAE3D

    vp = jax_params()[0]
    frames = np.random.default_rng(8).uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    jvae = JVAE(**VAE)
    z = jax.jit(lambda p, f: jvae.apply(p, f, method=JVAE.encode))(vp, jnp.asarray(frames))
    dec = jax.jit(lambda p, z: jvae.apply(p, z, method=JVAE.decode))(vp, z)
    jplain = JVAE(**VAE, fused_upsample=False)
    dec_plain = jax.jit(lambda p, z: jplain.apply(p, z, method=JVAE.decode))(vp, z)
    vae = loaded(CausalVAE3D(**VAE), vp)
    keyed = loaded(CausalVAE3D(**VAE, fused_upsample=False), vp)
    with torch.no_grad():
        ours_z = vae.encode(nchw(frames))
        ours_dec = vae.decode(nchw(z))
        assert torch.equal(keyed.decode(nchw(z)), ours_dec)
    assert ours_z.shape == (3, 4, 4, 4) and ours_dec.shape == (6, 3, 32, 32)
    assert rel_dev(nhwc(ours_z), z) < 1e-4
    assert rel_dev(nhwc(ours_dec), dec) < 1e-4
    assert rel_dev(nhwc(ours_dec), dec_plain) < 1e-4


def test_vae_encoder_is_causal():
    """A clip's prefix encodes to the prefix of its encoding, and a change to
    the last frame leaves the earlier latent frames as they were."""
    vae = port_network()
    frames = torch.from_numpy(np.random.default_rng(9).standard_normal((6, 3, 32, 32))
                              .astype(np.float32))
    with torch.no_grad():
        full = vae.encode(frames)
        prefix = vae.encode(frames[:4])  # ct = 2: two latent frames
        bumped = frames.clone()
        bumped[-1] += 10.0
        full2 = vae.encode(bumped)
    assert rel_dev(prefix, full[:2]) < 1e-5
    assert rel_dev(full2[:2], full[:2]) < 1e-5
    assert (full2[2:] - full[2:]).abs().max() > 1e-3


# --- the DiT -------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_dit_block_matches_jax(scale):
    """At unit scale, and on tokens of variance 1e-6, where the LayerNorms'
    epsilon (flax's 1e-6, not torch's 1e-5) sets the output."""
    from unigeo_tpu.models.aether import DiTBlock as JBlock
    from unigeo_tpu_torch.models.aether import DiTBlock

    rng = np.random.default_rng(10)
    x = (scale * rng.standard_normal((1, 40, 32))).astype(np.float32)
    cond = rng.standard_normal((1, 32)).astype(np.float32)
    params, apply = jax_module(JBlock(2, 2), jnp.asarray(x), jnp.asarray(cond))
    assert float(np.abs(params["params"]["adaLN_modulation"]["kernel"]).max()) > 0
    block = loaded(DiTBlock(32, 2, 2), params, dit=True)
    with torch.no_grad():
        ours = block(t_(x), t_(cond)).numpy()
    assert rel_dev(ours, np.asarray(apply(params, jnp.asarray(x), jnp.asarray(cond)))) < 1e-5


def test_dit_matches_jax():
    from unigeo_tpu.models.aether import AetherDiT as JDiT

    x = np.random.default_rng(11).standard_normal((3, 8, 6, VAE["z_channels"] + TARGET))
    x = x.astype(np.float32)
    ref = jax.jit(JDiT(out_channels=TARGET, **NET).apply)(jax_params()[1], jnp.asarray(x),
                                                          jnp.float32(0.7))
    dit = port_network().dit
    with torch.no_grad():
        ours = dit(nchw(x), torch.tensor(0.7))
    assert float(np.abs(ref).max()) > 1e-2
    assert rel_dev(nhwc(ours), ref) < 1e-4


def test_port_dit_is_zero_at_init():
    """adaLN-zero: the port's randomly initialised DiT outputs exactly 0."""
    from unigeo_tpu_torch.models.aether import tiny_aether

    dit = tiny_aether(device="cpu").network.dit
    assert float(dit.stack.blocks[0].attn.to_q.weight.abs().max()) > 0
    x = torch.randn(3, VAE["z_channels"] + TARGET, 8, 8)
    with torch.no_grad():
        out = dit(x, torch.tensor(0.7))
    assert out.shape == (3, TARGET, 8, 8)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("steps", [1, 4])
def test_flow_sampler_recovers_x0_with_the_true_velocity(steps):
    from unigeo_tpu_torch.models.aether import flow_sample

    gen = torch.Generator().manual_seed(12)
    x0, eps = torch.randn(2, 3, 4, 4, generator=gen), torch.randn(2, 3, 4, 4, generator=gen)
    out = flow_sample(lambda x, t: eps - x0, torch.zeros(2, 0, 4, 4), eps, steps)
    assert (out - x0).abs().max() < 1e-5


def test_flow_sampler_matches_jax():
    from unigeo_tpu.models.aether import AetherDiT as JDiT, Aether as JAether

    cond = np.random.default_rng(13).standard_normal((2, 4, 6, VAE["z_channels"]))
    cond = cond.astype(np.float32)
    jmodel = JAether.__new__(JAether)
    jmodel.dit = JDiT(out_channels=TARGET, **NET)
    noise = jax.random.normal(jax.random.PRNGKey(0), (2, 4, 6, TARGET), jnp.float32)
    ref = jax.jit(jmodel._flow_sample, static_argnames=("steps",))(
        jax_params()[1], jnp.asarray(cond), noise, steps=3)
    with torch.no_grad():
        ours = port_network().sample(nchw(cond), nchw(noise), 3)
    assert rel_dev(nhwc(ours), ref) < 1e-4


# --- raymaps and poses -----------------------------------------------------------


def _random_pose(seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    c2w = np.eye(4)
    c2w[:3, :3] = Rotation.from_quat(rng.randn(4)).as_matrix()
    c2w[:3, 3] = rng.randn(3)
    return c2w


def test_raymap_helpers_match_jax():
    from unigeo_tpu.models import aether as jax_aether
    from unigeo_tpu_torch.models import aether

    k = np.array([[50.0, 0, 16], [0, 52.0, 12.5], [0, 0, 1]])
    assert np.abs(aether.camera_rays(k, 24, 32) - jax_aether.camera_rays(k, 24, 32)).max() < 1e-9
    for seed in range(3):
        c2w = _random_pose(seed)
        rm = aether.raymap_from_pose(c2w, k, 24, 32)
        assert np.abs(rm - jax_aether.raymap_from_pose(c2w, k, 24, 32)).max() < 1e-9
        rec = aether.pose_from_raymap(rm, k)
        assert np.abs(rec - c2w).max() < 1e-9
        assert np.abs(rec - jax_aether.pose_from_raymap(rm, k)).max() < 1e-9
    for tl, ct, pad, t in [(3, 2, 1, 5), (4, 4, 0, 16), (2, 4, 3, 5)]:
        ours = aether.latent_key_times(tl, ct, pad, t)
        assert np.abs(ours - jax_aether.latent_key_times(tl, ct, pad, t)).max() < 1e-9
    keys = np.stack([np.eye(4), _random_pose(7), _random_pose(8)])
    times, queries = [0.0, 2.0, 5.0], np.arange(7) * 0.9
    ours = aether.interpolate_poses(keys, times, queries)
    assert np.abs(ours - jax_aether.interpolate_poses(keys, times, queries)).max() < 1e-6
    assert np.abs(ours[0] - keys[0]).max() < 1e-6
    assert np.abs(aether.interpolate_poses(keys[:1], [0.0], [0.0, 1.0]) - keys[0]).max() == 0


# --- the adapter -----------------------------------------------------------------


def _clip(t=5, h=32, w=32, seed=14):
    rng = np.random.RandomState(seed)
    k = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    return {"images": [rng.uniform(0, 255, (3, h, w)).astype(np.float32) for _ in range(t)],
            "intrinsics": [k] * t}


def jax_adapter(monkeypatch, **kw):
    """The JAX adapter with the shared perturbed params (its own init skipped)."""
    from unigeo_tpu.models.aether import Aether as JAether, AetherDiT, CausalVAE3D

    vp, dp = jax_params()
    with monkeypatch.context() as m:
        m.setattr(CausalVAE3D, "init", lambda self, *a, **k: vp)
        m.setattr(AetherDiT, "init", lambda self, *a, **k: dp)
        return JAether(**{"network_config": NET, "vae_config": VAE, **kw})


def port_adapter(**kw):
    from unigeo_tpu_torch.models.aether import Aether

    model = Aether(**{"network_config": NET, "vae_config": VAE, "device": "cpu", **kw})
    return model.load_state_dict(aether_state_dicts(*jax_params(), model.network))


def jax_host_poses(raymaps, intr, t, ct, cs):
    """The JAX adapter's host pose stage (aether.py:627-639) on ``raymaps``."""
    from unigeo_tpu.models.aether import interpolate_poses, latent_key_times, pose_from_raymap

    tl = raymaps.shape[0]
    intr_lat = np.diag([1.0 / cs, 1.0 / cs, 1.0]) @ intr
    keys = np.stack([pose_from_raymap(raymaps[i], intr_lat) for i in range(tl)])
    poses = interpolate_poses(keys, latent_key_times(tl, ct, (-t) % ct, t), np.arange(t))
    return np.linalg.inv(poses[0])[None] @ poses


def test_adapter_matches_jax(monkeypatch):
    from unigeo_tpu_torch.models import aether

    data = _clip()
    jmodel = jax_adapter(monkeypatch, num_steps=3, seed=5)
    raw = np.stack(data["images"])
    intr = np.stack(data["intrinsics"])
    depths, normals, raymaps, _ = jmodel._stage_main(jmodel.vae_params, jmodel.dit_params,
                                                     jnp.asarray(raw), jnp.asarray(intr))
    ref = jmodel.forward(data)
    assert np.abs(ref["pred_depths"] - np.asarray(depths)).max() == 0
    raymaps = np.asarray(raymaps)
    jposes = jax_host_poses(raymaps, intr[0], 5, 2, 8)
    assert np.abs(jposes.astype(np.float32) - ref["pred_poses"]).max() == 0

    model = port_adapter(num_steps=3, seed=5)
    # the host stage fed the JAX raymaps
    assert np.abs(aether.poses_from_raymaps(raymaps.astype(np.float64), intr[0], 5, 2, 8)
                  - jposes).max() < 1e-6
    # the device stages with the JAX noise, the JAX poses given to both
    monkeypatch.setattr(aether, "poses_from_raymaps", lambda *a: jposes)
    outs = model.forward_tensors(data, noise=jax_noise(5, 3, 4, 4))
    assert rel_dev(outs["raymaps"].numpy(), raymaps) < 1e-4
    assert rel_dev(outs["pred_depths"].numpy(), ref["pred_depths"]) < 1e-4
    assert rel_dev(outs["pred_world_pts"].numpy(), ref["pred_world_pts"]) < 1e-4
    assert mean_angle_deg(outs["pred_normals"].numpy(), ref["pred_normals"]) < 0.05
    assert np.abs(outs["pred_poses"].numpy() - ref["pred_poses"]).max() == 0


def test_adapter_contract_on_its_own_noise():
    """All four families, f32, finite, frame 0 the world, the world points
    of frame 0 its own backprojection; the noise drawn from ``seed``."""
    from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position

    model = port_adapter(num_steps=2, seed=3)
    data = _clip(t=6)
    out = model.forward(data)
    assert sorted(out) == ["pred_depths", "pred_normals", "pred_poses", "pred_world_pts"]
    shapes = {"pred_depths": (6, 32, 32), "pred_normals": (6, 32, 32, 3),
              "pred_poses": (6, 4, 4), "pred_world_pts": (6, 32, 32, 3)}
    for key, val in out.items():
        assert val.dtype == np.float32 and val.shape == shapes[key] and np.isfinite(val).all()
    assert np.abs(out["pred_poses"][0] - np.eye(4)).max() < 1e-5
    pts0 = backproject_to_cv_position(t_(out["pred_depths"][0]), t_(data["intrinsics"][0]))
    assert np.abs(out["pred_world_pts"][0] - pts0.numpy()).max() < 1e-4
    again = model.forward(data)
    assert all(np.array_equal(again[k], out[k]) for k in out)
    assert model.eval_batch_size == 1 and len(model.forward_batch([data, data])) == 2


def test_adapter_keys_device_and_dtypes(monkeypatch, tmp_path):
    from unigeo_tpu_torch.models.aether import Aether
    from unigeo_tpu_torch.registry import get_model_cls

    assert get_model_cls("Aether") is Aether
    kw = dict(network_config=NET, vae_config=VAE)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Aether(**kw)
    # a checkpoint in the {"vae", "dit"} layout loads, the DiT's zero init
    # skipped (its trained output projection kept)
    from unigeo_tpu_torch.utils.checkpoint import save_params

    src = Aether(**kw, seed=5, device="cpu")
    torch.nn.init.normal_(src.network.dit.final_proj.weight)
    save_params(Aether.checkpoint_of(src.network), str(tmp_path / "aether.ckpt"))
    loaded = Aether(**kw, checkpoint_path=str(tmp_path / "aether.ckpt"), device="cpu")
    ref = src.network.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in loaded.network.state_dict().items())
    model = Aether(**kw, compute_dtype="bfloat16", transfer_dtype="float16", init_height=64,
                   init_frames=4, model_dir="unused", device="cpu")
    assert {p.dtype for p in model.network.parameters()} == {torch.bfloat16}
    assert model.transfer_dtype == torch.float16 and model.num_steps == 4
    out = model.forward(_clip(t=4))
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in out.values())
    assert next(port_adapter().network.parameters()).dtype == torch.float32


def test_card_check_holds_every_output():
    """tools/aether_check.py's limits (the card against the CPU in the smoke
    and the card test) on its small Aether run on the CPU: a run against
    itself passes, and another draw of one-step depth noise stays within
    the normals' limit; one frame's normals flipped, every normal tilted by
    0.1 degree, or any other output moved by 1e-3 of its largest
    magnitude at one entry, fails."""
    from unigeo_tpu_torch.tools import aether_check

    _, model = aether_check.kernel_path_pair("cpu", 5)
    data, noise = aether_check.kernel_path_inputs(model, 18, 19)
    outs = model.forward_tensors(data, noise=noise)
    assert outs["pred_depths"].shape == (8, 128, 128)
    floor = aether_check.normals_floor_deg(data, outs)
    assert floor > 0
    check = lambda moved: aether_check.within_limits(aether_check.deviations(moved, outs, floor))
    same = aether_check.deviations(outs, outs, floor)
    assert aether_check.within_limits(same)
    assert same["pred_normals_mean_deg"] == 0 and max(same[k] for k in aether_check.REL_KEYS) == 0
    # another draw of one-step depth noise stays within the floor's limit
    other = aether_check.normals_floor_deg(data, outs, seed=1)
    assert other <= aether_check.NORMAL_FLOOR_FACTOR * floor
    flipped = dict(outs, pred_normals=outs["pred_normals"].clone())
    flipped["pred_normals"][3] *= -1
    assert aether_check.deviations(flipped, outs, floor)["pred_normals_mean_deg"] > 20
    assert not check(flipped)
    c, s_ = np.cos(np.radians(0.1)), np.sin(np.radians(0.1))
    tilt = torch.tensor([[1.0, 0, 0], [0, c, -s_], [0, s_, c]], dtype=torch.float32)
    tilted = dict(outs, pred_normals=outs["pred_normals"] @ tilt.T)
    assert not check(tilted)
    for key in aether_check.REL_KEYS:
        moved = dict(outs, **{key: outs[key].clone(memory_format=torch.contiguous_format)})
        moved[key].view(-1)[7] += 1e-3 * outs[key].abs().max()
        assert not check(moved), key


def test_aether_weight_bridge_is_strict():
    from unigeo_tpu_torch.models.aether import AetherNetwork

    vp, dp = jax_params()
    net = AetherNetwork(vae_config=VAE, network_config=NET)
    sd = aether_state_dicts(vp, dp, net)
    assert sd.keys() == net.state_dict().keys()
    v, d = vp["params"], dp["params"]
    assert np.array_equal(sd["encoder.stem.conv.weight"].numpy(),
                          np.transpose(v["encoder"]["stem"]["conv"]["kernel"], (4, 3, 0, 1, 2)))
    assert np.array_equal(sd["decoder.dec_up0.conv.bias"].numpy(),
                          v["decoder"]["dec_up0"]["conv"]["bias"])
    assert np.array_equal(sd["encoder.enc_res2.norm1.weight"].numpy(),
                          v["encoder"]["enc_res2"]["norm1"]["GroupNorm_0"]["scale"])
    assert np.array_equal(sd["encoder.enc_res2.skip.weight"].numpy(),
                          v["encoder"]["enc_res2"]["skip"]["kernel"].T)
    assert np.array_equal(sd["dit.patchify.weight"].numpy(),
                          np.transpose(d["patchify"]["kernel"], (3, 2, 0, 1)))
    stacked = d["stack"]["blocks"]["block"]
    assert np.array_equal(sd["dit.stack.blocks.1.adaLN_modulation.weight"].numpy(),
                          stacked["adaLN_modulation"]["kernel"][1].T)
    assert np.array_equal(sd["dit.stack.blocks.0.attn.to_out.0.bias"].numpy(),
                          stacked["attn"]["to_out"]["bias"][0])

    def edited(tree, fn):
        tree = jax.tree_util.tree_map(lambda a: a, tree)
        fn(tree["params"])
        return tree

    with pytest.raises(KeyError, match="left over"):
        aether_state_dicts(vp, edited(dp, lambda q: q.update(extra=q["t_embed1"])), net)
    with pytest.raises(KeyError, match="no flax leaf"):
        aether_state_dicts(edited(vp, lambda q: q["encoder"].pop("enc_out")), dp, net)
    with pytest.raises(ValueError, match="flax"):
        aether_state_dicts(vp, edited(dp, lambda q: q["t_embed2"].update(
            bias=q["t_embed2"]["bias"][:-1])), net)
    deeper = AetherNetwork(vae_config=VAE, network_config=dict(NET, depth=3))
    with pytest.raises(KeyError, match="no layer 2"):
        aether_state_dicts(vp, dp, deeper)


# --- the eval CLI -----------------------------------------------------------------


def _cli(out, capsys):
    from unigeo_tpu_torch import eval as eval_cli

    manager = eval_cli.main(["--config", AETHER_YAML, "--output", str(out), "--device", "cpu",
                             "--max-clips", str(MAX_CLIPS)])
    assert "Averages:" in capsys.readouterr().out
    return manager.rows()


def _metric_names(cfg, sections=("eval_depth", "eval_normal", "eval_pcd", "eval_camera")):
    return [n for sec in sections for n in cfg[sec]["metric_names"]]


def test_cli_runs_the_aether_config_as_it_is(tmp_path, capsys, monkeypatch):
    from unigeo_tpu_torch import eval as eval_cli

    built, get = [], eval_cli.get_model_cls
    monkeypatch.setattr(eval_cli, "get_model_cls",
                        lambda name: lambda **kw: built.append(get(name)(**kw)) or built[-1])
    rows = _cli(tmp_path, capsys)
    assert type(built[0]).__module__ == "unigeo_tpu_torch.models.aether"
    assert len(built[0].network.dit.stack.blocks) == 2 and built[0].num_steps == 2
    with open(AETHER_YAML) as f:
        cfg = yaml.safe_load(f)
    assert len(rows) == MAX_CLIPS
    assert all(np.isfinite(row[n]) for row in rows for n in _metric_names(cfg))


def test_cli_aether_rows_match_jax(tmp_path, capsys, monkeypatch):
    """configs/aether_synthetic.yaml through the port's CLI on the CPU, its
    model built from the config's model_params with the JAX weights and
    noise, against the JAX package's run_evaluation."""
    from unigeo_tpu.config import EvalConfig as JaxEvalConfig
    from unigeo_tpu.evaluator import run_evaluation as jax_run_evaluation
    from unigeo_tpu_torch import eval as eval_cli
    from unigeo_tpu_torch.models.aether import Aether

    with open(AETHER_YAML) as f:
        cfg = yaml.safe_load(f)
    mp = cfg["model_params"]
    assert mp["network_config"] == NET
    assert {k: tuple(v) if isinstance(v, list) else v for k, v in mp["vae_config"].items()} == VAE
    jmodel = jax_adapter(monkeypatch, **mp)
    ref = jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"),
                             model=jmodel, max_clips=MAX_CLIPS, data_parallel=False,
                             verbose=False)

    denoise = Aether.denoise

    def with_jax_noise(self, raw, noise=None):
        tl = -(-raw.shape[0] // self.network.ct)
        h, w = raw.shape[2] // self.network.cs, raw.shape[3] // self.network.cs
        return denoise(self, raw, jax_noise(self.seed, tl, h, w))

    monkeypatch.setattr(Aether, "denoise", with_jax_noise)

    def factory(**kw):
        assert kw["device"] == "cpu"
        return port_adapter(**kw)

    monkeypatch.setattr(eval_cli, "get_model_cls", lambda name: factory)
    rows = _cli(tmp_path / "port", capsys)
    ref_rows = ref.rows()
    assert [r["seq_name"] for r in rows] == [r["seq_name"] for r in ref_rows]
    camera = set(cfg["eval_camera"]["metric_names"])
    pixels = 3.0 / (2 * cfg["h"] * cfg["w"])
    for row, want in zip(rows, ref_rows):
        assert row.keys() == want.keys() and {"Abs Rel", "normal mean", "acc", "ATE"} <= set(row)
        for key, val in want.items():
            if key == "seq_name":
                continue
            if key in camera:
                assert np.isfinite(row[key]), (row["seq_name"], key)
                continue
            tol = pixels if key.startswith(("delta", "angle")) else 2e-2 * abs(val)
            assert abs(row[key] - val) <= tol, (row["seq_name"], key, row[key], val)
