"""The training slice's host side against the JAX package's, on the CPU.

* ``data/augmentations.py`` and ``data/collate.py`` (the port's numpy
  copies): every augmentation on a synthetic clip, from the same
  ``np.random.Generator`` seed, gives the JAX package's output exactly;
  collate / uncollate / index_batched / seed_everything likewise.
* ``build_batch_pointmap`` against ``train.py``'s, exactly (host arrays).
* ``build_batch_diffusion`` on the tiny pipeline in f32 (the JAX weights
  carried over by ``utils/weights.py::pipeline_state_dicts``): target
  latents, conditioning latents and CLIP context within 1e-4 relative
  (``tests/test_torch_depthcrafter.py``'s bound for whole modules: tens of
  layers of f32 sums in another order; measured 3e-6 to 1.2e-5, the latter
  with one thread a worker), with DepthCrafter's inverse and ChronoDepth's
  direct depth.
* The trainer's target encode with bf16 parameters: JAX encodes its f32
  target through the bf16 VAE, which flax computes in f32 (the VAE sets no
  module dtype, so an f32 input promotes the bf16 weights); the port's
  ``encode_target`` upcasts the encoder's and quant_conv's weights and
  encodes in f32 too.  Its target latents are held within 1e-4 relative of
  JAX's (measured 3.2e-6), and the earlier path (the target cast to bf16
  and encoded by the bf16 modules) is shown to miss that bound by more than
  10x (measured 3.6e-2).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import copy

import numpy as np
import pytest
import torch

import jax

ENCODE_TOL = 1e-4


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def synthetic_clip(t=3, size=64, scene=0):
    from unigeo_tpu.data.synthetic import SyntheticBoxDataset

    return SyntheticBoxDataset(clip_length=t, clip_overlap=0, num_scenes=2, frames_per_scene=t,
                               render_size=(size, size))[scene]


# --- augmentations and collation ------------------------------------------------

AUGMENTATIONS = {
    "spatial": ("SpatialAugmentation", dict(size=(48, 56), p=1.0, stretch_p=1.0)),
    "spatial_center": ("SpatialAugmentation", dict(size=(48, 56), p=0.0)),
    "spatial_upscale": ("SpatialAugmentation", dict(size=(80, 72), p=0.0)),
    "color": ("ColorJitter", {}),
    "minmax": ("NormalizeImagesToMinMax", dict(min_val=-1.0, max_val=2.0)),
    "eraser": ("Eraser", dict(p=1.0, max_boxes=3, box_size=(5, 20))),
    "scale3d": ("Scale3DFixed", dict(scale=2.5)),
    "mask_depth": ("MaskDepth", dict(min_depth=0.5, max_depth=3.0)),
    "intrinsics": ("NormalizeIntrinsics", {}),
}


@pytest.mark.parametrize("case", sorted(AUGMENTATIONS))
def test_augmentation_matches_jax(case):
    from unigeo_tpu.data import augmentations as jaug
    from unigeo_tpu_torch.data import augmentations as paug

    name, kw = AUGMENTATIONS[case]
    sample = synthetic_clip()
    takes_rng = name in ("SpatialAugmentation", "ColorJitter", "Eraser")
    outs = []
    for mod in (jaug, paug):
        extra = dict(rng=np.random.default_rng(11)) if takes_rng else {}
        outs.append(getattr(mod, name)(**kw, **extra)(copy.deepcopy(sample)))
    ref, ours = outs
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), (case, k)
    if name == "SpatialAugmentation":
        assert ours["images"].shape[-2:] == kw["size"]


def test_collate_helpers_match_jax():
    from unigeo_tpu.data import collate as jc
    from unigeo_tpu_torch.data import collate as pc

    samples = [{"images": np.full((2, 3), i, np.float32), "scene": f"s{i}", "idx": i}
               for i in range(3)]
    ref, ours = jc.collate_clips(samples), pc.collate_clips(samples)
    assert sorted(ours) == sorted(ref)
    assert np.array_equal(ours["images"], ref["images"]) and ours["scene"] == ref["scene"]
    assert np.array_equal(ours["idx"], ref["idx"])
    back = pc.uncollate_clips(ours)
    assert [b["scene"] for b in back] == ["s0", "s1", "s2"]
    assert np.array_equal(back[2]["images"], samples[2]["images"])
    for idx in (1, [2, 0], np.array([0, 2])):
        a, b = jc.index_batched(ref, idx), pc.index_batched(ours, idx)
        assert np.array_equal(a["images"], b["images"]) and a["scene"] == b["scene"]
    assert pc.seed_everything(5).random() == jc.seed_everything(5).random()


# --- batch builders -------------------------------------------------------------


def test_build_batch_pointmap_matches_jax():
    from train import build_batch_pointmap as jax_build
    from unigeo_tpu_torch.train import build_batch_pointmap

    samples = [synthetic_clip(3, scene=0), synthetic_clip(3, scene=1)]
    ref, ours = jax_build(samples), build_batch_pointmap(samples)
    assert sorted(ours) == sorted(ref) == ["frames", "gt_poses", "gt_world_pts", "mask"]
    for k in ref:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], ref[k]), k


def port_pipeline(jax_pipe, dtype=torch.float32):
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

    pipe = tiny_pipeline(device="cpu", dtype=dtype)
    return pipe.load_state_dicts(*pipeline_state_dicts(jax.device_get(jax_pipe.params), pipe))


@pytest.mark.parametrize("direct_depth", [False, True], ids=["inverse", "direct"])
def test_build_batch_diffusion_matches_jax(shared_tiny_pipeline, direct_depth):
    from train import build_batch_diffusion as jax_build
    from unigeo_tpu_torch.train import build_batch_diffusion

    samples = [synthetic_clip(2)]
    ref = jax_build(samples, shared_tiny_pipeline, direct_depth=direct_depth)
    ours = build_batch_diffusion(samples, port_pipeline(shared_tiny_pipeline),
                                 direct_depth=direct_depth)
    for k in ("latents", "cond_latents", "context"):
        assert ours[k].dtype == torch.float32
        assert rel_dev(ours[k].numpy(), ref[k]) < ENCODE_TOL, k


def test_target_encode_in_f32_with_bf16_weights_matches_jax(shared_tiny_pipeline):
    import jax.numpy as jnp

    from train import build_batch_diffusion as jax_build
    from unigeo_tpu_torch.train import _target_frames, build_batch_diffusion

    jpipe = copy.copy(shared_tiny_pipeline)
    jpipe.dtype = jnp.bfloat16
    jpipe.params = jax.tree.map(lambda a: a, shared_tiny_pipeline.params)
    jpipe.cast_params_to_dtype()
    pipe = port_pipeline(shared_tiny_pipeline, torch.bfloat16)
    assert {p.dtype for p in pipe.vae.parameters()} == {torch.bfloat16}
    samples = [synthetic_clip(2)]
    ref = jax_build(samples, jpipe)["latents"]
    ours = build_batch_diffusion(samples, pipe)["latents"].numpy()
    assert rel_dev(ours, ref) < ENCODE_TOL
    # the earlier path: the target cast to bf16, encoded in bf16
    with torch.no_grad():
        x3 = torch.from_numpy(_target_frames(samples[0], False))
        cast = pipe.vae.encode_scaled(x3.to(torch.bfloat16)).permute(0, 2, 3, 1).float()
    assert rel_dev(cast.numpy()[None], ref) > 10 * ENCODE_TOL
