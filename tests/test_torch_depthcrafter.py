"""The port's DepthCrafter slice against the JAX package, on the CPU in f32.

Both sides get the same weights (the JAX tiny pipeline's random params,
moved through the port's weight bridge) and the same inputs and noise, made
with numpy from a seed.  The JAX side runs on its CPU path (attention through
``attention_reference``); the port's attention runs its plain version there.

Tolerances (relative to the largest magnitude of the reference):
  * single layers: 1e-5 — one or two f32 ops deep, only the summation order
    of matmuls and convolutions differs;
  * whole modules (VAE encode/decode, CLIP, UNet): 1e-4 — tens of layers of
    f32 round-off;
  * the staged pipeline's decoded frames: 1e-3 — the Euler loop starts at
    700 * noise and carries the UNet's f32 differences through five steps;
  * depth from DepthCrafter.forward: 1e-2 — depth = 1/(x + 0.1) after a
    min-max over the clip has slope up to 100 near x = 0 (the same bound as
    tests/test_torch_parity.py's adapter test);
  * normals: mean angle between the two sides < 1 degree (plane fits over
    5x5 patches of those depths);
  * metrics: Abs Rel and delta < 1.25 within 1e-3, normal mean within 0.5
    degree.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu.models import layers as jl
from unigeo_tpu_torch.models import layers as tl
from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
from unigeo_tpu_torch.utils.weights import pipeline_state_dicts, to_torch_layout

T, H, W = 2, 64, 64


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.fixture(scope="module")
def pipes(shared_tiny_pipeline):
    """(JAX tiny pipeline 64x64x2, port tiny pipeline with the same weights)."""
    jp = shared_tiny_pipeline
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))
    return jp, pp


def _load(module, flax_params, path_of):
    """Load a standalone port layer from a flax param dict; ``path_of`` maps
    a port key to its flax path."""
    flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = np.asarray(v)

    walk(flax_params)
    sd = {}
    for key in module.state_dict():
        sd[key] = torch.from_numpy(np.array(to_torch_layout("m." + key, flat.pop(path_of(key)))))
    assert not flat, f"left over: {list(flat)}"
    module.load_state_dict(sd)
    return module.eval()


def _dense_path(key):
    parts = key.replace("to_out.0.", "to_out.").replace("net.0.proj", "net_0.proj")
    parts = parts.replace("net.2.", "net_2.").split(".")
    return tuple(parts[:-1] + ["kernel" if parts[-1] == "weight" else parts[-1]])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [16, 17, 320])
def test_sinusoidal_embedding(dim):
    ts = np.array([0.0, 1.0, 7.5, 25.0, -1.3], np.float32)
    ref = jl.sinusoidal_embedding(jnp.asarray(ts), dim)
    ours = tl.sinusoidal_embedding(torch.from_numpy(ts), dim)
    assert rel_dev(ours.numpy(), ref) < 1e-5


@pytest.mark.parametrize("channels,eps", [(48, 1e-6), (320, 1e-5), (20, 1e-5)])
def test_group_norm_with_divisor_fallback(channels, eps):
    x = np.random.default_rng(0).standard_normal((2, 6, 5, channels)).astype(np.float32)
    mod = jl.GroupNorm(epsilon=eps)
    params = mod.init(jax.random.PRNGKey(0), x)["params"]
    params = jax.tree.map(lambda a: a + 0.1 * jnp.arange(a.size).reshape(a.shape) / a.size, params)
    ref = mod.apply({"params": params}, x)
    ours = _load(tl.GroupNorm(channels, eps), params,
                 lambda k: ("GroupNorm_0", "scale" if k == "weight" else "bias"))
    assert ours.num_groups == tl.group_count(channels)
    assert rel_dev(nhwc(ours(nchw(x))), ref) < 1e-5


@pytest.mark.parametrize(
    "seq,ctx_len", [(130, None), (20, None), (40, 1), (40, 7)],
    ids=["kernel_path", "dense_path", "single_key_cross", "cross"],
)
def test_attention(seq, ctx_len):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, seq, 16)).astype(np.float32)
    ctx = None if ctx_len is None else rng.standard_normal((2, ctx_len, 12)).astype(np.float32)
    mod = jl.Attention(num_heads=2, head_dim=8, context_dim=12 if ctx is not None else None)
    params = mod.init(jax.random.PRNGKey(1), x, ctx)["params"]
    ref = mod.apply({"params": params}, x, ctx)
    port = _load(tl.Attention(16, 2, 8, context_dim=12 if ctx is not None else None),
                 params, _dense_path)
    with torch.no_grad():
        ours = port(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    assert rel_dev(ours.numpy(), ref) < 1e-5


def test_feed_forward_erf_gelu_in_f32():
    x = np.random.default_rng(2).standard_normal((3, 10, 24)).astype(np.float32)
    mod = jl.FeedForward()
    params = mod.init(jax.random.PRNGKey(2), x)["params"]
    ref = mod.apply({"params": params}, x)
    port = _load(tl.FeedForward(24), params, _dense_path)
    with torch.no_grad():
        assert rel_dev(port(torch.from_numpy(x)).numpy(), ref) < 1e-5


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(stride=2, padding=1), dict(kernel=1), dict(fuse_upsample2x=True)],
    ids=["same3x3", "stride2", "1x1", "fused_upsample2x"],
)
def test_conv2d(kwargs):
    x = np.random.default_rng(3).standard_normal((2, 6, 10, 5)).astype(np.float32)
    mod = jl.Conv2d(7, **kwargs)
    params = mod.init(jax.random.PRNGKey(3), x)["params"]
    params = jax.tree.map(lambda a: a + 0.01, params)  # nonzero bias
    ref = mod.apply({"params": params}, x)
    port = _load(tl.Conv2d(5, 7, **kwargs), params, lambda k: (
        "Conv_0", "kernel" if k == "weight" else "bias"))
    with torch.no_grad():
        assert rel_dev(nhwc(port(nchw(x))), ref) < 1e-5


def test_temporal_conv_and_alpha_blender():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 4, 6)).astype(np.float32)  # [B,T,H,W,C]
    mod = jl.TemporalConv(6)
    params = mod.init(jax.random.PRNGKey(4), x)["params"]
    ref = mod.apply({"params": params}, x)
    port = _load(tl.TemporalConv(6, 6), params,
                 lambda k: ("Conv_0", "kernel" if k == "weight" else "bias"))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))  # [B,C,T,H,W]
    with torch.no_grad():
        ours = np.moveaxis(port(xt).numpy(), 1, -1)
    assert rel_dev(ours, ref) < 1e-5

    a, b = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for switch in (False, True):
        blend = jl.AlphaBlender(merge_factor=0.3, switch=switch)
        bp = blend.init(jax.random.PRNGKey(0), a, b)["params"]
        port = tl.AlphaBlender(0.3, switch)
        with torch.no_grad():
            ours = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert rel_dev(ours, blend.apply({"params": bp}, a, b)) < 1e-6


def test_backproject_normals_and_fix_normal():
    from unigeo_tpu.ops.backproject import backproject_to_cv_position as j_bp
    from unigeo_tpu.ops.normals import fix_normal as j_fix
    from unigeo_tpu.ops.normals import surface_normals_from_points as j_normals
    from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
    from unigeo_tpu_torch.ops.normals import fix_normal, surface_normals_from_points

    rng = np.random.default_rng(12)
    # a smooth surface with a little noise, as a model's depth is (white
    # noise makes every 5x5 fit ill-conditioned in f32 on both sides)
    vv, uu = np.meshgrid(np.arange(20), np.arange(28), indexing="ij")
    depth = (2.0 + 0.3 * np.sin(uu / 5.0) + 0.2 * np.cos(vv / 7.0)
             + 1e-3 * rng.random((3, 20, 28))).astype(np.float32)
    k = np.array([[30.0, 0, 14.0], [0, 32.0, 10.0], [0, 0, 1]], np.float32)
    ks = np.stack([k, k * 1.1, k * 0.9]).astype(np.float32)
    ks[:, 2, 2] = 1.0
    ref_pts = jax.vmap(j_bp)(jnp.asarray(depth), jnp.asarray(ks))
    pts = backproject_to_cv_position(torch.from_numpy(depth), torch.from_numpy(ks))
    assert rel_dev(pts.numpy(), ref_pts) < 1e-6

    ref_n = np.asarray(j_normals(ref_pts))
    n = surface_normals_from_points(pts).numpy()
    # interior fits agree to f32 round-off; in the 2-pixel border the 5x5
    # window holds zero-padded points at the origin, the fit is ill-
    # conditioned, and the two sums' orders differ by up to ~5e-3 there
    # (both within 7e-3 of the same fit in f64)
    assert np.abs(n - ref_n)[:, 2:-2, 2:-2].max() < 2e-4
    assert np.abs(n - ref_n).max() < 1e-2
    assert np.degrees(np.arccos(np.clip((n * ref_n).sum(-1), -1, 1))).mean() < 1e-2

    normal = rng.standard_normal((3, 20, 28, 3)).astype(np.float32)
    ref_f = j_fix(jnp.asarray(normal), ref_pts)
    assert rel_dev(fix_normal(torch.from_numpy(normal), pts).numpy(), ref_f) < 1e-6


# ---------------------------------------------------------------------------
# scheduler and modules at the tiny configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 5, 25])
def test_scheduler_tables_match(steps):
    from unigeo_tpu.models.depthcrafter.scheduler import EulerDiscreteScheduler as JS
    from unigeo_tpu_torch.models.depthcrafter.scheduler import EulerDiscreteScheduler as PS

    js, ps = JS(), PS()
    np.testing.assert_array_equal(ps.inference_sigmas(steps), js.inference_sigmas(steps))
    sig = js.inference_sigmas(steps)[:-1]
    np.testing.assert_array_equal(ps.timesteps_for_sigmas(sig), js.timesteps_for_sigmas(sig))
    x = np.random.default_rng(5).standard_normal(8).astype(np.float32)
    v = np.random.default_rng(6).standard_normal(8).astype(np.float32)
    s, s_next = float(sig[0]), float(js.inference_sigmas(steps)[1])
    ref = js.euler_step(x, js.denoised_from_v(x, v, np.float32(s)), np.float32(s), np.float32(s_next))
    ours = ps.euler_step(torch.from_numpy(x), ps.denoised_from_v(torch.from_numpy(x),
                         torch.from_numpy(v), s), s, s_next)
    assert rel_dev(ours.numpy(), ref) < 1e-5


def test_vae_encode_decode(pipes):
    jp, pp = pipes
    rng = np.random.default_rng(7)
    frames = rng.uniform(-1, 1, (T, H, W, 3)).astype(np.float32)
    ref = jp.vae.apply({"params": jp.params["vae"]}, jnp.asarray(frames), method=jp.vae.encode)
    with torch.no_grad():
        ours = pp.vae.encode(nchw(frames))
    assert rel_dev(nhwc(ours), ref) < 1e-4

    lat = rng.standard_normal((T, H // 8, W // 8, 4)).astype(np.float32)
    ref = jp.vae.apply({"params": jp.params["vae"]}, jnp.asarray(lat), T, method=jp.vae.decode)
    with torch.no_grad():
        ours = pp.vae.decode(nchw(lat), T)
    assert rel_dev(nhwc(ours), ref) < 1e-4


@pytest.mark.parametrize("size", [(64, 64), (48, 80)], ids=["no_resize", "bicubic_resize"])
def test_clip_embedder(pipes, size):
    jp, pp = pipes
    frames = np.random.default_rng(8).random((T, *size, 3)).astype(np.float32)
    ref = jp.clip.apply({"params": jp.params["clip"]}, jnp.asarray(frames))
    with torch.no_grad():
        ours = pp.clip(nchw(frames))
    assert rel_dev(ours.numpy(), ref) < 1e-4


def test_unet(pipes):
    jp, pp = pipes
    rng = np.random.default_rng(9)
    sample = rng.standard_normal((T, H // 8, W // 8, 8)).astype(np.float32)
    ts = np.array([0.25 * math.log(30.0)], np.float32)
    ctx = rng.standard_normal((T, 1, 32)).astype(np.float32)
    added = np.array([[6.0, 127.0, 0.02]], np.float32)
    ref = jp.unet.apply({"params": jp.params["unet"]}, jnp.asarray(sample), jnp.asarray(ts),
                        jnp.asarray(ctx), jnp.asarray(added), T)
    with torch.no_grad():
        ours = pp.unet(nchw(sample), torch.from_numpy(ts), torch.from_numpy(ctx),
                       torch.from_numpy(added), T)
    assert rel_dev(nhwc(ours), ref) < 1e-4


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------


def test_run_window_staged(pipes):
    jp, pp = pipes
    rng = np.random.default_rng(10)
    frames = rng.random((T, H, W, 3)).astype(np.float32)
    noise = rng.standard_normal((T, H // 8, W // 8, 4)).astype(np.float32)
    aug = rng.standard_normal((T, H, W, 3)).astype(np.float32)
    ref = jp.run_window_staged(jp.params, jnp.asarray(frames), jnp.asarray(noise), 5,
                               aug_noise=jnp.asarray(aug))
    ours = pp.run_window_staged(torch.from_numpy(frames), torch.from_numpy(noise), 5,
                                aug_noise=torch.from_numpy(aug))
    assert rel_dev(ours.numpy(), ref) < 1e-3


def _tilted_plane_sample(rng):
    fx = fy = 50.0
    cx, cy = W / 2.0, H / 2.0
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    n = np.array([0.0, -0.4, -1.0]) / np.linalg.norm([0.0, -0.4, -1.0])
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)
    z = -3.0 / (rays @ n)
    gl = np.array([1.0, -1.0, -1.0])
    cam = ((rays * z[..., None]) * gl).transpose(2, 0, 1).astype(np.float32)
    nrm = np.broadcast_to((n * gl)[:, None, None], (3, H, W)).astype(np.float32)
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return {
        "images": rng.integers(0, 256, (T, 3, H, W)).astype(np.uint8),
        "intrinsics": np.stack([k] * T),
        "extrinsics": np.stack([np.eye(4, dtype=np.float32)] * T),
        "cam_coord": np.stack([cam] * T),
        "cam_normal": np.stack([nrm] * T),
        "world_coord": np.stack([cam] * T),
        "world_normal": np.stack([nrm] * T),
        "mask": np.ones((T, H, W), np.float32),
        "keyview_idx": 0,
        "scene_name": "tilted_plane",
    }


@pytest.fixture(scope="module")
def forwards(pipes):
    """(sample, JAX DepthCrafter.forward output, port output) on one clip,
    the port given the JAX adapter's own noise draws."""
    from unigeo_tpu.models.depthcrafter.model import DepthCrafter as JDC
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter as PDC

    jp, pp = pipes
    data = _tilted_plane_sample(np.random.default_rng(11))
    ref = JDC(pipeline=jp, num_inference_steps=5, seed=42).forward(data)
    noise, aug = jp.clip_noise(42, T, H, W)
    ours = PDC(pp, num_inference_steps=5, seed=42).forward(
        data, noise=torch.from_numpy(np.array(noise)), aug_noise=torch.from_numpy(np.array(aug))
    )
    return data, ref, ours


def test_forward_depths_and_normals(forwards):
    _, ref, ours = forwards
    assert ours["pred_depths"].shape == (T, H, W)
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-2
    a, b = ours["pred_normals"], np.asarray(ref["pred_normals"])
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, atol=1e-4)
    ang = np.degrees(np.arccos(np.clip((a * b).sum(-1), -1, 1)))
    assert ang.mean() < 1.0, ang.mean()


def test_forward_metrics(forwards):
    from unigeo_tpu.data.sample import prepare_gt_label as j_gt
    from unigeo_tpu.metrics.depth import depth_evaluation as j_depth
    from unigeo_tpu.metrics.normal import normal_evaluation as j_normal
    from unigeo_tpu_torch.data.sample import prepare_gt_label as p_gt
    from unigeo_tpu_torch.metrics.depth import depth_evaluation as p_depth
    from unigeo_tpu_torch.metrics.normal import normal_evaluation as p_normal

    data, ref, ours = forwards
    jg, pg = j_gt(data), p_gt(data)
    for key in jg:
        np.testing.assert_array_equal(pg[key], jg[key])
    jd, *_ = j_depth(ref["pred_depths"], jg["gt_depths"], custom_mask=jg["gt_masks"])
    pd, *_ = p_depth(ours["pred_depths"], pg["gt_depths"], custom_mask=pg["gt_masks"])
    jn = j_normal(ref["pred_normals"], jg["gt_normals"], custom_mask=jg["gt_masks"])
    pn = p_normal(ours["pred_normals"], pg["gt_normals"], custom_mask=pg["gt_masks"])
    assert abs(pd["Abs Rel"] - jd["Abs Rel"]) < 1e-3
    assert abs(pd["delta < 1.25"] - jd["delta < 1.25"]) < 1e-3
    assert abs(pn["normal mean"] - jn["normal mean"]) < 0.5
    assert pd["valid_pixels"] == jd["valid_pixels"]


def test_metrics_match_on_shared_predictions(forwards):
    """The same prediction scored by both packages: every key agrees."""
    from unigeo_tpu.metrics.depth import depth_evaluation as j_depth
    from unigeo_tpu.metrics.normal import normal_evaluation as j_normal
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.metrics.depth import depth_evaluation as p_depth
    from unigeo_tpu_torch.metrics.normal import normal_evaluation as p_normal

    data, ref, _ = forwards
    gt = prepare_gt_label(data)
    mask = gt["gt_masks"].copy()
    mask[:, :5] = False
    for align in ("lstsq", "metric"):
        jd, *_ = j_depth(ref["pred_depths"], gt["gt_depths"], custom_mask=mask, alignment=align)
        pd, *_ = p_depth(ref["pred_depths"], gt["gt_depths"], custom_mask=mask, alignment=align)
        for key, val in jd.items():
            assert abs(pd[key] - val) <= 1e-5 * max(1.0, abs(val)), (align, key, pd[key], val)
    jn = j_normal(ref["pred_normals"], gt["gt_normals"], custom_mask=mask)
    pn = p_normal(ref["pred_normals"], gt["gt_normals"], custom_mask=mask)
    # the angle-threshold shares count pixels, and a pixel within f32
    # round-off of a threshold may land on either side: allow two pixels
    two_pixels = 2 * 100.0 / mask.sum()
    for key, val in jn.items():
        tol = two_pixels if key.startswith("angle") else 1e-4 * max(1.0, abs(val))
        assert abs(pn[key] - val) <= tol, (key, pn[key], val)
