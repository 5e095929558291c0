"""The port's checkpoint converters for DUSt3R, VideoDepthAnything and Aether
(``unigeo_tpu_torch/utils/convert_{dust3r,vda,aether}.py`` through
``python -m unigeo_tpu_torch.tools.convert_checkpoint --family ...``)
against the JAX package's, on the CPU.

Random upstream state dicts at tiny widths, written as ``.safetensors``:
DUSt3R's key space as ``tests/test_convert_cli.py::_dust3r_keyspace``
enumerates it, and the CogVideoX / DINOv2 key spaces fabricated from the
JAX networks' own trees as ``tests/test_convert_aether_vda.py`` fabricates
them (LayerScale gammas, 6-chunk LayerNormZero projections, q / k norms and
an extra resnet the converters skip).  The port converter's checkpoint must
equal, bit for bit, the port's weight bridge (``utils/weights.py``) applied
to the JAX converter's tree (the JAX CLI's ``convert_*``, which grafts onto
the network's tree), load strictly through its adapter's
``checkpoint_path``, and an unknown or a missing key is refused, named.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convert_checkpoint as jax_cli  # noqa: E402

from test_convert_cli import TINY_DUST3R_CFG, _dust3r_keyspace  # noqa: E402
from unigeo_tpu_torch.tools import convert_checkpoint as port_cli  # noqa: E402
from unigeo_tpu_torch.utils.checkpoint import load_params  # noqa: E402

VDA_CFG = dict(width=16, depth=4, num_heads=2, patch_size=8, temporal_heads=2, qkv_bias=True,
               use_class_token=True, learned_pos_embed=True, max_grid=4, hook_norm=True)
AETHER_CFG = dict(vae_config=dict(base_width=8, mults=[1, 1, 2],
                                  temporal_down=[False, True, False], z_channels=4),
                  network_config=dict(width=16, depth=3, num_heads=2, patch=2, mlp_ratio=2))


def _save(sd, path):
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(path))
    return str(path)


def _random_tree(shapes, rng):
    """{path tuple: random f32 array} over the leaves of a flax shape tree,
    the "params" level dropped."""
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {tuple(str(getattr(k, "key", k)) for k in p if getattr(k, "key", k) != "params"):
            rng.normal(size=s.shape).astype(np.float32) for p, s in leaves}


def _equal_state_dicts(ours, ref):
    assert set(ours) == set(ref), (sorted(set(ours) ^ set(ref)))[:8]
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k


def _port(family, out, *args):
    argv = ["--family", family, "--out", str(out), *args]
    assert port_cli.main(argv) == 0
    return load_params(str(out))


# --- the upstream key spaces ------------------------------------------------------


def _vda_upstream(rng):
    """A VideoDepthAnything state dict whose conversion is the JAX tree of
    VDANetwork(**VDA_CFG) with random leaves (LayerScale gammas folded by
    the converters; a mask token they skip)."""
    from unigeo_tpu.models.vda import VDANetwork

    shapes = jax.eval_shape(lambda r: VDANetwork(**VDA_CFG).init(r, jnp.zeros((2, 32, 32, 3))),
                            jax.random.PRNGKey(0))
    by_mod = {}
    for p, arr in _random_tree(shapes, rng).items():
        by_mod.setdefault(p[0], {})[p[1:]] = arr
    sd = {"pretrained.cls_token": by_mod["cls_token"][()].reshape(1, 1, -1),
          "pretrained.pos_embed": by_mod["pos_embed"][()][None],
          "pretrained.mask_token": rng.normal(size=(1, 16)).astype(np.float32),
          "pretrained.norm.weight": by_mod["hook_norm"][("scale",)],
          "pretrained.norm.bias": by_mod["hook_norm"][("bias",)],
          "pretrained.patch_embed.proj.weight":
              np.transpose(by_mod["patch_embed"][("proj", "kernel")], (3, 2, 0, 1)),
          "pretrained.patch_embed.proj.bias": by_mod["patch_embed"][("proj", "bias")]}

    def block(prefix, leaves, with_ls):
        g1 = rng.uniform(0.5, 1.5, 16).astype(np.float32) if with_ls else None
        g2 = rng.uniform(0.5, 1.5, 16).astype(np.float32) if with_ls else None
        sd[f"{prefix}.attn.qkv.weight"] = np.concatenate(
            [leaves[("attn", f"to_{n}", "kernel")].T for n in "qkv"], axis=0)
        sd[f"{prefix}.attn.qkv.bias"] = np.concatenate(
            [leaves[("attn", f"to_{n}", "bias")] for n in "qkv"])
        for name, (mod, leaf), g in (("attn.proj", ("attn", "to_out"), g1),
                                     ("mlp.fc2", ("mlp", "fc2"), g2)):
            w, b = leaves[(mod, leaf, "kernel")], leaves[(mod, leaf, "bias")]
            if g is not None:
                sd[f"{prefix}.{'ls1' if mod == 'attn' else 'ls2'}.gamma"] = g
                w, b = w / g[None, :], b / g
            sd[f"{prefix}.{name}.weight"], sd[f"{prefix}.{name}.bias"] = w.T, b
        for n in ("norm1", "norm2"):
            sd[f"{prefix}.{n}.weight"] = leaves[(n, "scale")]
            sd[f"{prefix}.{n}.bias"] = leaves[(n, "bias")]
        sd[f"{prefix}.mlp.fc1.weight"] = leaves[("mlp", "fc1", "kernel")].T
        sd[f"{prefix}.mlp.fc1.bias"] = leaves[("mlp", "fc1", "bias")]

    for i in range(VDA_CFG["depth"]):
        block(f"pretrained.blocks.{i}",
              {p[2:]: a[i] for p, a in by_mod["blocks"].items()}, with_ls=True)
    for h in range(4):
        block(f"head.motion_modules.{h}", by_mod[f"temporal_{h}"], with_ls=False)
    conv = lambda a: np.transpose(a, (3, 2, 0, 1))
    names = {"head_0": "scratch.output_conv1", "head_2": "scratch.output_conv2.0",
             "head_4": "scratch.output_conv2.2"}
    for p, arr in by_mod["head"].items():
        mod, leaf = p[0], p[-1]
        tleaf = "weight" if leaf == "kernel" else "bias"
        if mod.startswith("act_postprocess_"):
            k = int(mod[len("act_postprocess_")])
            if mod.endswith("_proj"):
                name = f"head.projects.{k}.{tleaf}"
            else:
                name = f"head.resize_layers.{k}.{tleaf}"
                if k in (0, 1) and leaf == "kernel":  # ConvTranspose: flax's flip undone
                    sd[name] = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
                    continue
        elif mod.startswith("layer") or mod.startswith("refinenet"):
            name = ".".join(["head.scratch", mod, *p[1:-1], tleaf])
        else:
            name = f"head.{names[mod]}.{tleaf}"
        sd[name] = conv(arr) if leaf == "kernel" else arr
    return sd


def _aether_upstream(rng):
    """(DiT, VAE) CogVideoX-lineage state dicts whose conversion is the JAX
    trees of Aether at AETHER_CFG with random leaves (text-stream chunks and
    q / k norms and an extra resnet the converters skip)."""
    from unigeo_tpu.models.aether import AetherDiT, CausalVAE3D

    vae = CausalVAE3D(**AETHER_CFG["vae_config"])
    dit = AetherDiT(out_channels=vae.z_channels + 6, **AETHER_CFG["network_config"])
    key = jax.random.PRNGKey(0)
    vae_tree = _random_tree(jax.eval_shape(
        lambda r: vae.init(r, jnp.zeros((2 * vae.ct, 2 * vae.cs, 2 * vae.cs, 3))), key), rng)
    dit_tree = _random_tree(jax.eval_shape(
        lambda r: dit.init(r, jnp.zeros((2, 2, 2, 2 * vae.z_channels + 6)), jnp.float32(1.0)),
        key), rng)
    c = AETHER_CFG["network_config"]["width"]
    tw = lambda leaf, a: (a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1))) \
        if leaf == "kernel" else a
    tl = lambda leaf: "weight" if leaf in ("kernel", "scale") else "bias"
    dsd = {}
    top = {"patchify": "patch_embed.proj", "t_embed1": "time_embedding.linear_1",
           "t_embed2": "time_embedding.linear_2", "final_modulation": "norm_out.linear",
           "final_proj": "proj_out"}
    block = {("attn", "to_q"): "attn1.to_q", ("attn", "to_k"): "attn1.to_k",
             ("attn", "to_v"): "attn1.to_v", ("attn", "to_out"): "attn1.to_out.0",
             ("mlp", "fc1"): "ff.net.0.proj", ("mlp", "fc2"): "ff.net.2"}
    for p, arr in dit_tree.items():
        if p[0] in top:
            dsd[f"{top[p[0]]}.{tl(p[-1])}"] = tw(p[-1], arr)
            continue
        sub, leaf = p[3:-1], p[-1]
        for i in range(arr.shape[0]):
            a = tw(leaf, arr[i])
            if sub == ("adaLN_modulation",):
                junk = rng.normal(size=a[:3 * c].shape).astype(np.float32)
                dsd[f"transformer_blocks.{i}.norm1.linear.{tl(leaf)}"] = \
                    np.concatenate([a[:3 * c], junk])
                dsd[f"transformer_blocks.{i}.norm2.linear.{tl(leaf)}"] = \
                    np.concatenate([a[3 * c:], junk])
            else:
                dsd[f"transformer_blocks.{i}.{block[sub]}.{tl(leaf)}"] = a
    dsd["transformer_blocks.0.attn1.norm_q.weight"] = np.ones(8, np.float32)
    dsd["transformer_blocks.0.attn1.norm_k.weight"] = np.ones(8, np.float32)

    conv5 = lambda leaf, a: np.transpose(a, (4, 3, 0, 1, 2)) if leaf == "kernel" else a
    n = len(AETHER_CFG["vae_config"]["mults"])
    vsd = {}

    def res(prefix, sub, leaf, arr):
        if sub[0] in ("norm1", "norm2"):
            vsd[f"{prefix}.{sub[0]}.{tl(leaf)}"] = arr
        elif sub[0] == "skip":
            vsd[f"{prefix}.conv_shortcut.conv.{tl(leaf)}"] = (
                arr.T.reshape(arr.shape[1], arr.shape[0], 1, 1, 1) if leaf == "kernel" else arr)
        else:
            vsd[f"{prefix}.{sub[0]}.conv.{tl(leaf)}"] = conv5(leaf, arr)

    plain = {"stem": "encoder.conv_in.conv", "enc_out": "encoder.conv_out.conv",
             "dec_in": "decoder.conv_in.conv", "dec_out": "decoder.conv_out.conv",
             "enc_norm": "encoder.norm_out", "dec_norm": "decoder.norm_out"}
    for p, arr in vae_tree.items():
        side, mod, sub, leaf = p[0], p[1], p[2:-1], p[-1]
        sub = tuple(x for x in sub if x != "GroupNorm_0")
        if mod in plain:
            vsd[f"{plain[mod]}.{tl(leaf)}"] = conv5(leaf, arr)
        elif mod in ("enc_mid", "dec_mid"):
            res(f"{side}.mid_block.resnets.0", sub, leaf, arr)
        elif mod.startswith(("enc_res", "dec_res")):
            i = int(mod[7:])
            res(f"encoder.down_blocks.{i}.resnets.0" if side == "encoder"
                else f"decoder.up_blocks.{n - 1 - i}.resnets.0", sub, leaf, arr)
        else:  # enc_down{i} / dec_up{i}
            i = int(mod[len("enc_down"):] if mod.startswith("enc_down") else mod[len("dec_up"):])
            vsd[(f"encoder.down_blocks.{i}.downsamplers" if side == "encoder"
                 else f"decoder.up_blocks.{n - 1 - i}.upsamplers")
                + f".0.conv.conv.{tl(leaf)}"] = conv5(leaf, arr)
    vsd["encoder.down_blocks.0.resnets.1.conv1.conv.weight"] = \
        rng.normal(size=(8, 8, 3, 3, 3)).astype(np.float32)
    return dsd, vsd


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    root = tmp_path_factory.mktemp("upstream")
    rng = np.random.default_rng(0)
    dit, vae = _aether_upstream(rng)
    return {"dust3r": _save(_dust3r_keyspace(rng), root / "dust3r.safetensors"),
            "vda": _save(_vda_upstream(rng), root / "vda.safetensors"),
            "dit": _save(dit, root / "dit.safetensors"),
            "vae": _save(vae, root / "vae.safetensors")}


# --- against the JAX converters through the weight bridge ---------------------------


def test_dust3r_matches_the_bridged_jax_conversion(upstream, tmp_path):
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3R, Dust3RNetwork
    from unigeo_tpu_torch.utils.weights import pointmap_state_dict

    cfg = json.dumps(TINY_DUST3R_CFG)
    tree = jax_cli.convert_dust3r(argparse.Namespace(
        ckpt=upstream["dust3r"], network_config=cfg, allow_partial=False))
    ref = pointmap_state_dict(tree, Dust3RNetwork(**TINY_DUST3R_CFG))
    ours = _port("dust3r", tmp_path / "d.ckpt", "--ckpt", upstream["dust3r"],
                 "--network-config", cfg)
    _equal_state_dicts(ours, ref)
    model = Dust3R(network_config=TINY_DUST3R_CFG, checkpoint_path=str(tmp_path / "d.ckpt"),
                   device="cpu")
    _equal_state_dicts(model.network.state_dict(), ref)


def test_vda_matches_the_bridged_jax_conversion(upstream, tmp_path):
    from unigeo_tpu_torch.models.vda import VDANetwork, VideoDepthAnything
    from unigeo_tpu_torch.utils.weights import pointmap_state_dict

    from unigeo_tpu.models.vda import VDANetwork as JaxVDANetwork
    from unigeo_tpu.utils.checkpoint import graft_flat_params
    from unigeo_tpu.utils.convert_vda import convert_vda_checkpoint

    # the JAX CLI shapes its tree at 140 x 140, past this max_grid: the
    # library's conversion grafted onto the tree at 32 x 32, as
    # tests/test_convert_aether_vda.py does
    shapes = jax.eval_shape(lambda r: JaxVDANetwork(**VDA_CFG).init(
        r, jnp.zeros((2, 32, 32, 3))), jax.random.PRNGKey(0))
    target = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    tree, _, missed = graft_flat_params(
        target, convert_vda_checkpoint(jax_cli.load_state_dict(upstream["vda"])))
    assert not missed, missed[:8]
    ref = pointmap_state_dict(tree, VDANetwork(**VDA_CFG))
    cfg = json.dumps(VDA_CFG)
    ours = _port("vda", tmp_path / "v.ckpt", "--ckpt", upstream["vda"], "--network-config", cfg)
    _equal_state_dicts(ours, ref)
    model = VideoDepthAnything(network_config=VDA_CFG, checkpoint_path=str(tmp_path / "v.ckpt"),
                               device="cpu")
    _equal_state_dicts(model.network.state_dict(), ref)


def test_aether_matches_the_bridged_jax_conversion(upstream, tmp_path):
    from unigeo_tpu_torch.models.aether import Aether, AetherNetwork
    from unigeo_tpu_torch.utils.weights import aether_state_dicts

    cfg = json.dumps(AETHER_CFG)
    tree = jax_cli.convert_aether(argparse.Namespace(
        transformer=upstream["dit"], vae=upstream["vae"], network_config=cfg,
        allow_partial=False))
    ref = aether_state_dicts(tree["vae"], tree["dit"], AetherNetwork(**AETHER_CFG))
    ours = _port("aether", tmp_path / "a.ckpt", "--transformer", upstream["dit"],
                 "--vae", upstream["vae"], "--network-config", cfg)
    assert set(ours) == {"vae", "dit"}
    _equal_state_dicts(Aether.state_dict_of(ours), ref)
    model = Aether(checkpoint_path=str(tmp_path / "a.ckpt"), device="cpu", **AETHER_CFG)
    _equal_state_dicts(model.network.state_dict(), ref)


# --- refusals -------------------------------------------------------------------------


def _load(path):
    return port_cli.load_state_dict(path)


@pytest.mark.parametrize("family,fault", [
    ("dust3r", "unknown_block_key"), ("dust3r", "unknown_top_key"), ("dust3r", "missing"),
    ("vda", "unknown_top_key"), ("vda", "unknown_block_key"), ("vda", "missing"),
    ("aether", "unknown_top_key"), ("aether", "missing"),
])
def test_unknown_and_missing_keys_are_refused_and_named(upstream, family, fault):
    if family == "aether":
        sds = [_load(upstream["dit"]), _load(upstream["vae"])]
        convert = lambda: port_cli.convert_aether(*sds, AETHER_CFG)
        target, name = sds[1], {"unknown_top_key": "ema_shadow.weight",
                                "missing": "decoder.conv_out.conv.bias"}[fault]
    else:
        sds = [_load(upstream[family])]
        cfg = TINY_DUST3R_CFG if family == "dust3r" else VDA_CFG
        fn = port_cli.convert_dust3r if family == "dust3r" else port_cli.convert_vda
        convert = lambda: fn(*sds, cfg)
        target = sds[0]
        name = {("dust3r", "unknown_block_key"): "enc_blocks.0.attn.surprise.weight",
                ("dust3r", "unknown_top_key"): "ema_shadow.enc_norm.weight",
                ("dust3r", "missing"): "enc_norm.bias",
                ("vda", "unknown_top_key"): "ema_shadow.weight",
                ("vda", "unknown_block_key"): "pretrained.blocks.1.attn.surprise.weight",
                ("vda", "missing"): "pretrained.norm.bias"}[(family, fault)]
    if fault == "missing":
        del target[name]
        port_name = {"decoder.conv_out.conv.bias": "decoder.dec_out.conv.bias",
                     "enc_norm.bias": "encoder.norm.bias",
                     "pretrained.norm.bias": "hook_norm.bias"}[name]
        with pytest.raises(SystemExit, match=f"missing \\['{port_name}'\\]"):
            convert()
    else:
        target[name] = torch.zeros(4)
        with pytest.raises(SystemExit, match="refused.*" + name.replace(".", "\\.")):
            convert()


def test_svd_invocation_is_unchanged():
    """The SVD converter's flags as before: --unet --vae --clip --out, no
    --family (its round trip is in tests/test_torch_checkpoint.py)."""
    with pytest.raises(SystemExit):
        port_cli.main(["--out", "x", "--unet", "u"])  # svd needs all three
    with pytest.raises(SystemExit):
        port_cli.main(["--family", "dust3r", "--out", "x"])  # dust3r needs --ckpt
