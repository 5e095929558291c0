"""Checkpoint IO of the port (``utils/checkpoint.py``), the SVD converter
(``tools/convert_checkpoint.py``) and the full-width SVD-XT key space, on
the CPU.

* ``TrainStateSaver``: ``state-iter-{step:09d}`` names, the newest
  ``max_to_keep`` kept, ``list_steps`` / ``load_latest``; a save cut inside
  ``torch.save`` leaves no file that ``list_steps`` reads, and no temporary
  file either.
* ``load_strict`` names the missing and unexpected keys and the shapes that
  differ; an adapter given a checkpoint of another layout refuses it.
* The port's UNet, VAE and CLIP at SVD-XT width, built on the meta device,
  match ``unigeo_tpu/utils/svd_keyspace.py`` (the upstream diffusers and
  transformers key spaces, enumerated independently) key for key and shape
  for shape.
* The converter round-trips random state dicts of the tiny configuration
  (from ``.pt`` files, ``.safetensors`` files and a directory of shards)
  into a checkpoint that ``DepthCrafter(checkpoint_path=...)`` loads with
  every tensor equal; it refuses a missing, an extra and a reshaped key,
  naming it.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import json
import os

import pytest
import torch

from unigeo_tpu_torch.utils.checkpoint import (
    TrainStateSaver,
    load_params,
    load_strict,
    save_params,
)


def small_state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"net": {"w": torch.randn((3, 4), generator=g), "b": torch.zeros(4)}}


def test_saver_rotates_and_loads_the_latest(tmp_path):
    saver = TrainStateSaver(str(tmp_path / "ckpts"), max_to_keep=3)
    for step in (10, 20, 30, 40, 50):
        path = saver.save(small_state(step), step)
        assert os.path.basename(path) == f"state-iter-{step:09d}"
    assert saver.list_steps() == [30, 40, 50]
    assert sorted(os.listdir(saver.base_dir)) == [f"state-iter-{s:09d}" for s in (30, 40, 50)]
    params, step = saver.load_latest()
    assert step == 50 and torch.equal(params["net"]["w"], small_state(50)["net"]["w"])
    with pytest.raises(FileNotFoundError):
        TrainStateSaver(str(tmp_path / "empty")).load_latest()


def test_cut_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    saver = TrainStateSaver(str(tmp_path))
    saver.save(small_state(1), 1)
    real_save = torch.save

    def cut(obj, f, *a, **kw):  # writes part of the file, then dies
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise KeyboardInterrupt("cut")

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        saver.save(small_state(2), 2)
    monkeypatch.setattr(torch, "save", real_save)
    assert saver.list_steps() == [1] and os.listdir(tmp_path) == ["state-iter-000000001"]
    # an earlier checkpoint at the same name is replaced only by a whole one
    save_params(small_state(3), saver.path(1))
    assert torch.equal(load_params(saver.path(1))["net"]["w"], small_state(3)["net"]["w"])


def test_load_strict_names_what_differs():
    module = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.Linear(3, 1))
    sd = module.state_dict()
    load_strict(module, sd)
    bad = dict(sd, extra=torch.zeros(1))
    bad.pop("1.bias")
    bad["0.weight"] = torch.zeros(4, 2)
    with pytest.raises(KeyError) as exc:
        load_strict(module, bad, "ckpt.pt")
    msg = str(exc.value)
    assert "ckpt.pt" in msg and "1.bias" in msg and "extra" in msg and "0.weight" in msg


def test_adapters_refuse_a_checkpoint_of_another_layout(tmp_path):
    from unigeo_tpu_torch.models.aether import Aether, tiny_aether_configs
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R, tiny_spann3r_config

    path = str(tmp_path / "other")
    save_params({"vae": {}, "dit": {}}, path)
    with pytest.raises(KeyError, match="unet"):
        tiny_pipeline(device="cpu").load_checkpoint(path)
    with pytest.raises(KeyError, match="missing"):
        Spann3R(network_config=tiny_spann3r_config(), checkpoint_path=path, device="cpu")
    save_params({"unet": {}}, path)
    net, vae = tiny_aether_configs()
    with pytest.raises(KeyError, match="Aether loads"):
        Aether(network_config=net, vae_config=vae, checkpoint_path=path, device="cpu")


# --- the full SVD-XT key space -----------------------------------------------------


@pytest.mark.parametrize("component", ["unet", "vae", "clip"])
def test_svd_xt_modules_match_the_upstream_key_space(component):
    from unigeo_tpu.utils import svd_keyspace
    from unigeo_tpu_torch.tools.convert_checkpoint import COMPONENTS, port_modules

    keyspace = {"unet": svd_keyspace.unet_svd_xt_keyspace,
                "vae": svd_keyspace.vae_temporal_decoder_keyspace,
                "clip": svd_keyspace.clip_vit_h_keyspace}[component]()
    module = port_modules()[COMPONENTS.index(component)]
    ours = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert sorted(set(ours) ^ set(keyspace)) == []
    assert [k for k in ours if ours[k] != tuple(keyspace[k])] == []
    if component == "unet":  # the 1.52 B parameters of SVD-XT's UNet
        assert 1.4e9 < sum(v.numel() for v in module.parameters()) < 1.6e9


# --- the converter --------------------------------------------------------------------


def tiny_upstream(seed=0):
    """Random state dicts of the tiny SVD configuration, upstream names."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.models.depthcrafter.unet import tiny_unet_config
    from unigeo_tpu_torch.models.depthcrafter.vae import tiny_vae_config
    from unigeo_tpu_torch.models.vit import tiny_clip_config

    pipe = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(seed))
    unet = tiny_unet_config()
    cfg = {"unet_config": unet, "vae_config": tiny_vae_config(),
           "clip_config": dict(tiny_clip_config(), projection_dim=unet["cross_attention_dim"])}
    return pipe.checkpoint(), cfg


@pytest.mark.parametrize("fmt", ["pt", "safetensors", "shards"])
def test_converter_round_trips_random_state_dicts(tmp_path, fmt):
    from safetensors.torch import save_file

    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.tools import convert_checkpoint

    sds, cfg = tiny_upstream()
    args = []
    for name, sd in sds.items():
        sd = {k: v.contiguous() for k, v in sd.items()}
        if fmt == "pt":  # wrapped as a training script would save it
            path = str(tmp_path / f"{name}.pt")
            torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
        elif fmt == "safetensors":
            path = str(tmp_path / f"{name}.safetensors")
            save_file(sd, path)
        else:
            path = str(tmp_path / name)
            os.makedirs(path)
            keys = sorted(sd)
            for i, part in enumerate((keys[::2], keys[1::2])):
                save_file({k: sd[k] for k in part}, os.path.join(path, f"shard-{i}.safetensors"))
        args += [f"--{name}", path]
    if fmt == "safetensors":  # an older transformers' buffer, dropped
        clip = {k: v.contiguous() for k, v in sds["clip"].items()}
        clip["vision_model.embeddings.position_ids"] = torch.arange(5)[None]
        save_file(clip, str(tmp_path / "clip.safetensors"))
    out = str(tmp_path / "svd.ckpt")
    assert convert_checkpoint.main(
        args + ["--out", out, "--network-config", json.dumps(cfg)]) == 0
    model = DepthCrafter(checkpoint_path=out, device="cpu", **cfg)
    for name, module in zip(("unet", "vae", "clip"), model.pipeline.modules()):
        loaded = module.state_dict()
        assert all(torch.equal(loaded[k], v.to(loaded[k].dtype)) for k, v in sds[name].items())
    assert model.pipeline.dtype == torch.bfloat16


@pytest.mark.parametrize("fault", ["missing", "extra", "reshaped"])
def test_converter_refuses_a_partial_conversion(fault):
    from unigeo_tpu_torch.tools.convert_checkpoint import convert_svd

    sds, cfg = tiny_upstream()
    vae = dict(sds["vae"])
    key = sorted(vae)[3]
    if fault == "missing":
        vae.pop(key)
    elif fault == "extra":
        vae["encoder.renamed.weight"] = vae[key]
        key = "encoder.renamed.weight"
    else:
        vae[key] = torch.zeros(vae[key].numel() + 1)
    with pytest.raises(SystemExit, match=key.replace(".", r"\.")):
        convert_svd(sds["unet"], vae, sds["clip"], cfg)
