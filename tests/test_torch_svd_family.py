"""The SVD-family siblings of the port against the JAX package's, on the CPU
in f32 on the tiny pipeline (the JAX weights carried over by
``utils/weights.py``, the JAX ``jax.random`` draws passed in).

* Heun (``_denoise_loop`` with ``solver="heun"``): 2n - 1 UNet evaluations
  for n steps, the latents within 1e-3 of JAX relative to their largest
  magnitude (the bound ``tests/test_torch_windows.py`` holds a window's
  frames to: the loop starts at 700 * noise and carries the UNet's f32
  differences through every evaluation).
* ``_denoise_stage_known``: the same 1e-3 against JAX; the clamped frames
  equal ``known`` exactly (``torch.equal``); an all-zero mask is the Euler
  loop exactly (the clamp selects x unchanged, then the same operations).
* ``_decode_frames`` (num_frames = 1): 1e-4 against JAX, the whole-module
  bound of ``tests/test_torch_depthcrafter.py``.
* StableNormal's decoded frames within 1e-3 of JAX (the pipeline bound)
  and its normals' mean angle to JAX under 0.1 degree (unit vectors of
  x * 2 - 1, whose normalisation magnifies the frames' differences where
  the decoded triplet is near 0: 2.5e-3 absolute seen at one pixel);
  batched (one pass over the clip's N frames) against each frame alone
  through the port: 1e-3 (the batch changes only the products' row counts,
  so the order of sums).
* ChronoDepth (``chronodepth_synthetic.yaml``'s window 4, overlap 2, over 6
  frames: windows at 0 and 2, the second with 2 known frames) and
  DepthAnyVideo (6 frames, gap 4: key frames 0, 4 and the last, 5): depths
  within 1e-3 relative (depth is the decoded mean, no min-max) and normals'
  mean angle to JAX under 1 degree (plane fits over 5x5 patches).
* UniGeoCam without the geometry branch: depths within 1e-2 relative (the
  clip min-max and 1 / (x + 0.1) amplify the pipeline's differences, the
  bound of ``tests/test_torch_depthcrafter.py``) and normals' mean angle
  under 0.1 degree, as StableNormal's.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

H = W = 64
SEED = 42


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def mean_angle_deg(a, b):
    cos = np.clip((np.asarray(a, np.float64) * np.asarray(b, np.float64)).sum(-1), -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)).mean())


def port_of(jp, solver="euler"):
    """The port's tiny f32 pipeline on the CPU with ``jp``'s current weights."""
    pp = tiny_pipeline(device="cpu", dtype=torch.float32, solver=solver)
    return pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))


def t_(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return t_(a).permute(0, 3, 1, 2)


def _clip(t, seed):
    rng = np.random.default_rng(seed)
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


@pytest.fixture(scope="module")
def stage_inputs(shared_tiny_pipeline):
    """JAX-encoded cond / context and a noise draw for a 4-frame clip."""
    jp = shared_tiny_pipeline
    rng = jax.random.PRNGKey(0)
    frames = jax.random.uniform(rng, (4, H, W, 3))
    cond, ctx = jp._encode_stage(jp.params, frames, None)
    noise = jax.random.normal(jax.random.fold_in(rng, 1), (4, H // 8, W // 8, 4))
    return jp, cond, ctx, noise


def test_heun_matches_jax(stage_inputs):
    jp, cond, ctx, noise = stage_inputs
    jh = copy.copy(jp)
    jh.solver = "heun"
    ref = np.array(jh._denoise_stage(jh.params, cond, ctx, noise, 3))
    pp = port_of(jp, solver="heun")
    calls = []
    unet_forward = pp.unet.forward
    pp.unet.forward = lambda *a, **k: calls.append(1) or unet_forward(*a, **k)
    ours = pp._denoise_loop(nchw(cond)[None], t_(ctx)[None], nchw(noise)[None], 3)[0]
    assert len(calls) == 2 * 3 - 1
    assert rel_dev(ours.permute(0, 2, 3, 1).numpy(), ref) < 1e-3
    # and it is not the Euler loop
    euler = port_of(jp)._denoise_loop(nchw(cond)[None], t_(ctx)[None], nchw(noise)[None], 3)[0]
    assert rel_dev(ours.numpy(), euler.numpy()) > 1e-2


def test_denoise_stage_known_matches_jax_and_clamps_exactly(stage_inputs):
    jp, cond, ctx, noise = stage_inputs
    known = jax.random.normal(jax.random.PRNGKey(7), noise.shape)
    mask = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    ref = np.array(jp._denoise_stage_known(jp.params, cond, ctx, noise, known, mask, 3))
    pp = port_of(jp)
    args = (nchw(cond), t_(ctx), nchw(noise))
    ours = pp._denoise_stage_known(*args, nchw(known), t_(mask), 3)
    assert rel_dev(ours.permute(0, 2, 3, 1).numpy(), ref) < 1e-3
    assert torch.equal(ours[:2], nchw(known)[:2])
    assert not torch.allclose(ours[2:], nchw(known)[2:], atol=1e-3)
    # an all-zero mask is the Euler loop, exactly
    zero = pp._denoise_stage_known(*args, nchw(known), torch.zeros(4), 3)
    plain = pp._denoise_loop(*(a[None] for a in args), 3)[0]
    assert torch.equal(zero, plain)


def test_decode_frames_matches_jax(stage_inputs):
    jp, _, _, noise = stage_inputs
    latents = noise * 0.5
    ref = np.array(jp._decode_frames(jp.params, latents))
    pp = port_of(jp)
    ours = pp._decode_frames(nchw(latents)).permute(0, 2, 3, 1)
    assert rel_dev(ours.numpy(), ref) < 1e-4
    # frame i of the batch is frame i decoded alone
    alone = pp._decode_frames(nchw(latents)[2:3])
    assert rel_dev(alone.numpy(), ours.permute(0, 3, 1, 2)[2:3].numpy()) < 1e-5


@pytest.fixture(scope="module")
def stablenormal(shared_tiny_pipeline):
    from unigeo_tpu.models.stablenormal import StableNormal as JSN
    from unigeo_tpu_torch.models.stablenormal import StableNormal

    # the JAX adapter without its constructor, which would re-initialise the
    # shared pipeline's weights at its own seed
    jsn = JSN.__new__(JSN)
    jsn.pipeline, jsn.num_inference_steps, jsn.seed = shared_tiny_pipeline, 2, 7
    psn = StableNormal(num_inference_steps=2, pipeline=port_of(jsn.pipeline), seed=7)
    noise, aug = (t_(a) for a in jsn._frame_noise(H, W))
    return jsn, psn, noise, aug


def test_stablenormal_matches_jax_and_per_frame(stablenormal):
    jsn, psn, noise, aug = stablenormal
    data = _clip(3, 1)
    frames = np.moveaxis(data["images"], 1, -1).astype(np.float32) / 255.0
    decoded = psn._run_frames(torch.from_numpy(frames), noise, aug)
    ref_decoded = jsn._run_frames_single(frames)  # the JAX adapter on one device
    assert rel_dev(decoded.numpy(), ref_decoded) < 1e-3
    ref = jsn._finalize(ref_decoded)
    ours = psn.forward(data, noise=noise, aug_noise=aug)
    assert ours["pred_depths"].shape == (3, H, W) and not ours["pred_depths"].any()
    assert mean_angle_deg(ours["pred_normals"], ref["pred_normals"]) < 0.1
    np.testing.assert_allclose(np.linalg.norm(ours["pred_normals"], axis=-1), 1.0, atol=1e-5)
    for i in range(3):
        alone = psn._run_frames(torch.from_numpy(frames[i:i + 1]), noise, aug)
        assert rel_dev(alone.numpy(), decoded[i:i + 1].numpy()) < 1e-3


def test_stablenormal_forward_batch_concatenates_clips(stablenormal):
    _, psn, noise, aug = stablenormal
    datas = [_clip(2, 2), _clip(1, 3)]
    calls = []
    run = psn._run_frames
    psn._run_frames = lambda frames, *a: calls.append(len(frames)) or run(frames, *a)
    try:
        outs = psn.forward_batch(datas, noise=noise, aug_noise=aug)
    finally:
        del psn._run_frames
    assert calls == [3] and psn.eval_batch_size == 1
    for d, out in zip(datas, outs):
        alone = psn.forward(d, noise=noise, aug_noise=aug)
        assert mean_angle_deg(out["pred_normals"], alone["pred_normals"]) < 0.1


def test_chronodepth_matches_jax(shared_tiny_pipeline):
    from unigeo_tpu.models.chronodepth import ChronoDepth as JCD
    from unigeo_tpu_torch.models.chronodepth import ChronoDepth

    jp = shared_tiny_pipeline
    kw = dict(num_inference_steps=2, window_size=4, overlap=2, seed=SEED)
    data = _clip(6, 4)
    ref = JCD(_pipeline=jp, **kw).forward(data)
    rng = jax.random.PRNGKey(SEED)
    draws = [t_(jax.random.normal(jax.random.fold_in(rng, wi), (4, H // 8, W // 8, 4)))
             for wi in range(2)]
    model = ChronoDepth(_pipeline=port_of(jp), **kw)
    starts = []
    known = model.pipe._denoise_stage_known
    model.pipe._denoise_stage_known = lambda c, x, n, k, m, s: (
        starts.append(int(m.sum())) or known(c, x, n, k, m, s))
    ours = model.forward(data, window_noise=draws)
    assert starts == [0, 2]  # window 0 fresh, window 1 with frames 2 and 3 known
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-3
    assert mean_angle_deg(ours["pred_normals"], ref["pred_normals"]) < 1.0


def test_depthanyvideo_matches_jax(shared_tiny_pipeline):
    from unigeo_tpu.models.depthanyvideo import DepthAnyVideo as JDAV
    from unigeo_tpu_torch.models.depthanyvideo import DepthAnyVideo

    jp = shared_tiny_pipeline
    kw = dict(num_inference_steps=2, keyframe_gap=4, seed=SEED)
    data = _clip(6, 5)
    jmodel = JDAV(_pipeline=jp, **kw)
    assert list(jmodel.keyframe_indices(6)) == [0, 4, 5]  # the last is off the gap
    ref = jmodel.forward(data)
    rng = jax.random.PRNGKey(SEED)
    key_noise = t_(jax.random.normal(jax.random.fold_in(rng, 0), (3, H // 8, W // 8, 4)))
    clip_noise = t_(jax.random.normal(jax.random.fold_in(rng, 1), (6, H // 8, W // 8, 4)))
    model = DepthAnyVideo(_pipeline=port_of(jp), **kw)
    assert list(model.keyframe_indices(6)) == [0, 4, 5]
    ours = model.forward(data, key_noise=key_noise, clip_noise=clip_noise)
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-3
    assert mean_angle_deg(ours["pred_normals"], ref["pred_normals"]) < 1.0


def test_unigeo_cam_without_branch_matches_jax(shared_tiny_pipeline):
    from unigeo_tpu.models.unigeo_cam import UniGeoCam as JUG
    from unigeo_tpu_torch.models.unigeo_cam import UniGeoCam

    jp = shared_tiny_pipeline
    data = _clip(2, 6)
    ref = JUG(num_inference_steps=2, pipeline=jp, seed=SEED).forward(data)
    noise, aug = (t_(a) for a in jp.clip_noise(SEED, 2, H, W))
    ours = UniGeoCam(num_inference_steps=2, pipeline=port_of(jp), seed=SEED).forward(
        data, noise=noise, aug_noise=aug)
    assert sorted(ours) == ["pred_depths", "pred_normals"]
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-2
    assert mean_angle_deg(ours["pred_normals"], ref["pred_normals"]) < 0.1


def test_adapters_build_bf16_pipelines_and_share_a_given_one():
    """Without a pipeline each adapter builds one in bf16 on its device, with
    random weights from its seed; a given pipeline is used as it is; a
    checkpoint's weights load, at bf16, into the pipeline built; every name
    resolves."""
    from unigeo_tpu_torch.models.depthcrafter.unet import tiny_unet_config
    from unigeo_tpu_torch.models.depthcrafter.vae import tiny_vae_config
    from unigeo_tpu_torch.models.vit import tiny_clip_config
    from unigeo_tpu_torch.registry import get_model_cls

    unet = tiny_unet_config()
    cfgs = dict(unet_config=unet, vae_config=tiny_vae_config(),
                clip_config=dict(tiny_clip_config(), projection_dim=unet["cross_attention_dim"]),
                device="cpu")
    shared = tiny_pipeline(device="cpu")
    import os
    import tempfile

    from unigeo_tpu_torch.utils.checkpoint import save_params

    src = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(9))
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt = os.path.join(ckpt_dir.name, "svd.ckpt")
    save_params(src.checkpoint(), ckpt)
    for name, attr, given in (("StableNormal", "pipeline", "pipeline"),
                              ("ChronoDepth", "pipe", "_pipeline"),
                              ("DepthAnyVideo", "pipe", "_pipeline"),
                              ("UniGeoCam", "pipeline", "pipeline"),
                              ("UniGeo", "pipeline", "pipeline")):
        cls = get_model_cls(name)
        built = getattr(cls(**cfgs), attr)
        assert built.dtype == torch.bfloat16 and built.device.type == "cpu", name
        assert any(p.abs().max() > 0 for p in built.unet.parameters()), name
        assert getattr(cls(**{given: shared}), attr) is shared, name
        loaded = getattr(cls(checkpoint_path=ckpt, **cfgs), attr)
        assert loaded.dtype == torch.bfloat16, name
        ref = src.unet.state_dict()
        assert all(torch.equal(v, ref[k].to(torch.bfloat16))
                   for k, v in loaded.unet.state_dict().items()), name
    ckpt_dir.cleanup()
    assert get_model_cls("UniGeo") is get_model_cls("UniGeoCam")
