"""The port's weight bridge (flax tree -> upstream-named state dicts).

* Round trip: JAX tree -> port state dicts -> the JAX package's
  convert_svd_checkpoint -> flat JAX tree, equal to the flattened original,
  leaf for leaf and bit for bit.
* Strictness: a left-over flax leaf, a missing one, or a wrong shape raises.
* Key names: the port's state dicts carry the diffusers / transformers names
  that convert_svd's rules were written for.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import copy

import numpy as np
import pytest
import torch

import jax

from unigeo_tpu.utils.convert_svd import convert_svd_checkpoint
from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
from unigeo_tpu_torch.utils.weights import (
    clip_flax_path,
    pipeline_state_dicts,
    state_dict_from_flax,
    unet_flax_path,
    vae_flax_path,
)


@pytest.fixture(scope="module")
def bridged(shared_tiny_pipeline):
    params = jax.tree.map(np.asarray, shared_tiny_pipeline.params)
    port = tiny_pipeline(device="cpu", dtype=torch.float32)
    return params, port, pipeline_state_dicts(params, port)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_round_trip_through_convert_svd(bridged):
    params, _, (unet_sd, vae_sd, clip_sd) = bridged
    back = convert_svd_checkpoint(unet_sd, vae_sd, clip_sd)
    orig = _flat(params)
    assert set(back) == set(orig)
    for path, arr in orig.items():
        np.testing.assert_array_equal(back[path], arr, err_msg="/".join(path))


@pytest.mark.parametrize("component", ["unet", "vae", "clip"])
def test_state_dict_loads_strictly(bridged, component):
    _, port, sds = bridged
    sd = dict(zip(("unet", "vae", "clip"), sds))[component]
    module = getattr(port, component)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd, strict=True)


_PATH_FNS = {"unet": unet_flax_path, "vae": vae_flax_path, "clip": clip_flax_path}


@pytest.mark.parametrize("component", ["unet", "vae", "clip"])
def test_left_over_flax_leaf_raises(bridged, component):
    params, port, _ = bridged
    tree = copy.deepcopy(params[component])
    tree["stray_module"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="left over"):
        state_dict_from_flax(tree, getattr(port, component), _PATH_FNS[component])


@pytest.mark.parametrize("component", ["unet", "vae", "clip"])
def test_missing_flax_leaf_raises(bridged, component):
    params, port, _ = bridged
    tree = copy.deepcopy(params[component])
    first = next(iter(tree))
    del tree[first]
    with pytest.raises(KeyError, match="no flax leaf"):
        state_dict_from_flax(tree, getattr(port, component), _PATH_FNS[component])


def test_wrong_shape_raises(bridged):
    params, port, _ = bridged
    tree = copy.deepcopy(params["unet"])
    tree["conv_in"]["Conv_0"]["kernel"] = np.zeros((3, 3, 8, 5), np.float32)
    with pytest.raises(ValueError, match="conv_in.weight"):
        state_dict_from_flax(tree, port.unet, unet_flax_path)


def test_clip_stack_depth_must_match(bridged):
    """A scan-stacked leaf with more layers than the port has is left over."""
    params, port, _ = bridged
    tree = copy.deepcopy(params["clip"])
    block = tree["vision_model"]["blocks"]["layers"]["block"]
    block["norm1"]["scale"] = np.concatenate([block["norm1"]["scale"]] * 2)
    with pytest.raises(KeyError, match="left over"):
        state_dict_from_flax(tree, port.clip, clip_flax_path)


@pytest.mark.parametrize(
    "component,key",
    [
        ("unet", "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0.weight"),
        ("unet", "down_blocks.0.resnets.0.temporal_res_block.conv1.weight"),
        ("unet", "up_blocks.1.upsamplers.0.conv.weight"),
        ("unet", "mid_block.attentions.0.temporal_transformer_blocks.0.ff_in.net.0.proj.weight"),
        ("vae", "encoder.mid_block.attentions.0.to_q.weight"),
        ("vae", "decoder.time_conv_out.weight"),
        ("vae", "decoder.up_blocks.0.resnets.0.time_mixer.mix_factor"),
        ("clip", "vision_model.encoder.layers.1.self_attn.out_proj.weight"),
        ("clip", "vision_model.embeddings.position_embedding.weight"),
        ("clip", "visual_projection.weight"),
    ],
)
def test_upstream_key_names(bridged, component, key):
    _, port, _ = bridged
    assert key in getattr(port, component).state_dict()
