"""Train -> checkpoint -> eval, end to end on the CPU, for every model name
the JAX ``train.py`` trains: ``unigeo_tpu_torch.train.main`` with the tiny
configs, four steps, a checkpoint every step; the saver keeps the newest
three; the family's eval adapter built with ``checkpoint_path`` at the
latest one gives outputs equal (bitwise) to the same adapter running the
trained module in memory.  Then the trainer's refusal of a ``--mesh``
larger than the world of processes, naming the shape (one process here),
and of an unknown model, and the loop's device barrier, there only for a
caller that times the steps."""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest

from unigeo_tpu_torch import train

H = W = 64
CONFIG = dict(dataset="SyntheticBoxDataset", root=None, h=H, w=W, clip_length=3,
              clip_overlap=0, split="test", model_name="DepthCrafter",
              dataset_params=dict(render_size=[H, W], num_scenes=1, frames_per_scene=6))
STEPS = 4

# model name -> the keyword its adapter takes a pipeline by (SVD family)
PIPELINE_KEYWORD = {"DepthCrafter": "pipeline", "StableNormal": "pipeline",
                    "UniGeoCam": "pipeline", "UniGeo": "pipeline",
                    "ChronoDepth": "_pipeline", "DepthAnyVideo": "_pipeline"}
NAMES = ["Spann3R", "Cut3R", "Dust3R", "VideoDepthAnything", "Aether", *PIPELINE_KEYWORD]


def adapters(name, out, ckpt):
    """(the adapter loaded from ``ckpt``, the adapter running the trained
    module in memory, frozen as the adapters build theirs: with gradients
    on, the attention would take its differentiable path)."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.registry import get_model_cls

    cls = get_model_cls(name)
    if name in PIPELINE_KEYWORD:
        given = PIPELINE_KEYWORD[name]
        kw = dict(num_inference_steps=2)
        out["pipe"].unet.requires_grad_(False)
        return (cls(**kw, **{given: tiny_pipeline(device="cpu")}, checkpoint_path=ckpt),
                cls(**kw, **{given: out["pipe"]}))
    if name == "Aether":
        from unigeo_tpu_torch.models.aether import tiny_aether_configs

        net, vae = tiny_aether_configs()
        out["model"].network.requires_grad_(False)
        return (cls(network_config=net, vae_config=vae, num_steps=out["model"].num_steps,
                    checkpoint_path=ckpt, device="cpu"), out["model"])
    from unigeo_tpu_torch.models.pointmap import cut3r, dust3r, spann3r
    from unigeo_tpu_torch.models import vda

    cfg = {"Spann3R": spann3r.tiny_spann3r_config, "Cut3R": cut3r.tiny_cut3r_config,
           "Dust3R": dust3r.tiny_dust3r_config, "VideoDepthAnything": vda.tiny_vda_config}[name]()
    loaded = cls(network_config=cfg, checkpoint_path=ckpt, device="cpu")
    memory = cls(network_config=cfg, device="cpu")
    memory.network = out["network"].eval().requires_grad_(False)
    return loaded, memory


@pytest.mark.parametrize("name", NAMES)
def test_train_checkpoint_eval(tmp_path, name):
    ckpt_dir = tmp_path / "ckpts"
    out = train.main(["--device", "cpu", "--tiny", "--model", name, "--steps", str(STEPS),
                      "--ckpt-every", "1", "--ckpt-dir", str(ckpt_dir),
                      "--log-dir", str(tmp_path / "logs")], config=dict(CONFIG))
    assert len(out["losses"]) == STEPS and all(np.isfinite(out["losses"]))
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [
        f"state-iter-{s:09d}" for s in (2, 3, 4)]
    assert out["checkpoints"][-1] == str(ckpt_dir / f"state-iter-{STEPS:09d}")
    loaded, memory = adapters(name, out, out["checkpoints"][-1])
    data = out["dataset"][0]
    a, b = loaded.forward(data), memory.forward(data)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True), (name, k)


def test_final_state_is_saved_off_the_rotation(tmp_path):
    """Five steps at --ckpt-every 2: checkpoints at 2 and 4, and the final
    state at 5; --ckpt-every 0 saves none."""
    ckpt_dir = tmp_path / "ckpts"
    out = train.main(["--device", "cpu", "--tiny", "--model", "Dust3R", "--steps", "5",
                      "--ckpt-every", "2", "--ckpt-dir", str(ckpt_dir),
                      "--log-dir", str(tmp_path)], config=dict(CONFIG))
    assert [p.rsplit("-", 1)[1] for p in out["checkpoints"]] == ["000000002", "000000004",
                                                                  "000000005"]
    none_dir = tmp_path / "none"
    out = train.main(["--device", "cpu", "--tiny", "--model", "Dust3R", "--steps", "1",
                      "--ckpt-every", "0", "--ckpt-dir", str(none_dir),
                      "--log-dir", str(tmp_path)], config=dict(CONFIG))
    assert out["checkpoints"] == [] and not none_dir.exists()


def test_train_cli_refuses_the_mesh_and_unknown_models(capsys):
    """A mesh of two ranks over one process is refused by its shape (the
    mesh itself is accepted since the training side of ``parallel/``; the
    test once pinned its refusal)."""
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--tiny", "--mesh", "2,1,1"], config=dict(CONFIG))
    assert "mesh shape (2, 1, 1) != 1 devices" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="Identity"):
        train.main(["--device", "cpu", "--tiny", "--model", "Identity"], config=dict(CONFIG))


@pytest.mark.parametrize("with_on_step", [False, True])
def test_loop_waits_for_batches_only_for_a_timing_caller(monkeypatch, tmp_path, with_on_step):
    """``run_training_loop`` on a CUDA trainer calls no device barrier of its
    own in training; with ``on_step`` it waits once a step, after the batch
    and before the step's clock, and calls ``on_step(step, loss, seconds)``."""
    import argparse

    import torch

    from unigeo_tpu_torch.utils.writers import EventWriter

    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: events.append("sync"))

    class Trainer:  # a trainer whose parameters would live on the card
        device = torch.device("cuda")

        def train_step(self, batch):
            events.append("step")
            return torch.tensor(float(batch))

    def make_batch(samples):
        events.append("batch")
        return sum(samples)

    seen = []
    args = argparse.Namespace(steps=3, batch_size=2, ckpt_every=0)
    out = train.run_training_loop(
        Trainer(), make_batch, list(range(5)), args, EventWriter(str(tmp_path)),
        on_step=(lambda *a: seen.append(a)) if with_on_step else None)
    per_step = ["batch", "sync", "step"] if with_on_step else ["batch", "step"]
    assert events == per_step * 3
    assert out["losses"] == [1.0, 5.0, 4.0] and out["checkpoints"] == []
    assert len(out["step_seconds"]) == len(out["batch_seconds"]) == 3
    assert [s[:2] for s in seen] == ([(0, 1.0), (1, 5.0), (2, 4.0)] if with_on_step else [])
