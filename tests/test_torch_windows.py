"""The port's windowed crossfade and batched denoise against the JAX
package's, on the tiny f32 pipelines of ``tests/test_torch_depthcrafter.py``
(the same weights on both sides, the JAX noise draws passed in).

Tolerances: decoded frames at rel_dev < 1e-3 (largest deviation over the
largest reference magnitude), the bound ``test_run_window_staged`` holds one
window to: the Euler loop starts at 700 * noise and carries the UNet's f32
differences through five steps; the crossfade's blend is the JAX package's
(f64 ramp, rounded to f32) and adds none.  Depths from ``forward_batch``
within 1e-2 relative, the bound of ``test_forward_depths_and_normals``
(depth = 1/(x + 0.1) after the clip's min-max has slope up to 100).
The batched path against the port's own serial one: the same two bounds
(the batch changes only the order of the products' sums).  Port against
port (``clips_per_step`` 2 against 1): the CSV rows within
``tests/test_torch_eval.py``'s bounds, 2e-2 relative on the error metrics
and 3 pixels' share on the threshold shares.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu.models.depthcrafter.pipeline import aug_noise_rng
from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

H = W = 64
SEED = 42


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture(scope="module")
def pipes(shared_tiny_pipeline):
    jp = shared_tiny_pipeline
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))
    return jp, pp


def jax_window_draws(jp, seed, window, n_windows):
    """Each window's (noise, aug_noise) as the JAX ``__call__`` draws them:
    fold_in(rng, wi) and fold_in(aug_rng, wi)."""
    rng = jax.random.PRNGKey(seed)
    aug_rng = aug_noise_rng(rng)
    out = []
    for wi in range(n_windows):
        noise = jax.random.normal(jax.random.fold_in(rng, wi), (window, H // 8, W // 8, 4))
        aug = jax.random.normal(jax.random.fold_in(aug_rng, wi), (window, H, W, 3))
        out.append((torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(aug))))
    return out


# one window width, so the JAX side compiles one set of stages (T = 3), which
# the batched clips below share
@pytest.mark.parametrize("t,window,overlap,starts", [
    (7, 3, 1, [0, 2, 4]),  # range(0, 6, 2): three windows, 1-frame overlaps
    (6, 3, 1, [0, 2, 3]),  # range(0, 5, 2) = 0, 2, 4: the last re-covers from 3,
                           # a 2-frame overlap ramped by r = 0, 0.5
])
def test_windowed_call_matches_jax(pipes, t, window, overlap, starts):
    jp, pp = pipes
    frames = np.random.default_rng(t).random((t, H, W, 3)).astype(np.float32)
    ref = jp(frames, num_inference_steps=5, window_size=window, overlap=overlap, seed=SEED)
    draws = jax_window_draws(jp, SEED, window, len(starts))
    ours = pp(torch.from_numpy(frames), num_inference_steps=5, window_size=window,
              overlap=overlap, seed=SEED, window_noise=draws)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    assert rel_dev(ours.numpy(), ref) < 1e-3
    # the stitching, exactly, against the windows run one by one
    outs = [pp.run_window_staged(torch.from_numpy(frames[s:s + window]), n, 5, aug_noise=a)
            for s, (n, a) in zip(starts, draws)]
    acc = np.zeros((t, H, W, 3), np.float32)
    prev_end = 0
    for wi, (s, out) in enumerate(zip(starts, outs)):
        out = out.numpy()
        ov = prev_end - s
        if wi and ov > 0:
            r = np.linspace(0.0, 1.0, ov, endpoint=False).reshape(-1, 1, 1, 1)
            acc[s:s + ov] = (1.0 - r) * acc[s:s + ov] + r * out[:ov]
            acc[s + ov:s + window] = out[ov:]
        else:
            acc[s:s + window] = out
        prev_end = s + window
    assert np.array_equal(ours.numpy(), (acc + 1.0) / 2.0)


def test_window_shorter_than_its_overlap_raises_as_in_jax(pipes):
    jp, pp = pipes
    frames = np.zeros((5, H, W, 3), np.float32)
    with pytest.raises(ValueError) as ref:
        jp(frames, window_size=2, overlap=2)
    with pytest.raises(ValueError) as ours:
        pp(torch.from_numpy(frames), window_size=2, overlap=2)
    assert str(ours.value) == str(ref.value)


def test_window_draws_are_seeded_per_window(pipes):
    _, pp = pipes
    a = pp.draw_clip_noise(pp.window_generator(SEED, 0), 2, H, W)
    b = pp.draw_clip_noise(pp.window_generator(SEED, 0), 2, H, W)
    c = pp.draw_clip_noise(pp.window_generator(SEED, 1), 2, H, W)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def _clip(rng, t=3):
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


@pytest.fixture(scope="module")
def batched(pipes):
    """Two clips through JAX forward_batch / run_clips_staged and the port's,
    given the JAX adapter's draws (one draw broadcast over the batch)."""
    from unigeo_tpu.models.depthcrafter.model import DepthCrafter as JDC
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter as PDC

    jp, pp = pipes
    rng = np.random.default_rng(12)
    datas = [_clip(rng), _clip(rng)]
    jmodel, pmodel = JDC(pipeline=jp, seed=SEED), PDC(pp, seed=SEED, clips_per_step=2)
    noise, aug = (np.array(a) for a in jp.clip_noise(SEED, 3, H, W))
    frames = np.stack([np.moveaxis(d["images"], 1, -1).astype(np.float32) / 255.0 for d in datas])
    b_noise = np.broadcast_to(noise, (2, *noise.shape))
    b_aug = np.broadcast_to(aug, (2, *aug.shape))
    ref_dec = jp.run_clips_staged(jp.params, jnp.asarray(frames), jnp.asarray(b_noise), 5,
                                  aug_noise=jnp.asarray(b_aug))
    our_dec = pp.run_clips_staged(torch.from_numpy(frames), torch.from_numpy(b_noise.copy()), 5,
                                  aug_noise=torch.from_numpy(b_aug.copy()))
    ref = jmodel.forward_batch(datas)
    ours = pmodel.forward_batch(datas, noise=torch.from_numpy(noise),
                                aug_noise=torch.from_numpy(aug))
    serial = [pmodel.forward(d, noise=torch.from_numpy(noise), aug_noise=torch.from_numpy(aug))
              for d in datas]
    serial_dec = [pp.run_window_staged(torch.from_numpy(f), torch.from_numpy(noise), 5,
                                       aug_noise=torch.from_numpy(aug)).numpy() for f in frames]
    return dict(jmodel=jmodel, pmodel=pmodel, datas=datas, ref_dec=np.array(ref_dec),
                our_dec=our_dec.numpy(), serial_dec=serial_dec, ref=ref, ours=ours,
                serial=serial)


def test_run_clips_staged_matches_jax_and_the_serial_window(batched):
    """Against JAX and against the port's own serial window, both at the
    pipeline bound: the batch changes only the products' row counts (M
    doubles) and so the order of their sums, carried through the five steps
    from sigma_max as between the packages (8e-5 seen)."""
    assert batched["our_dec"].shape == (2, 3, H, W, 3)
    assert rel_dev(batched["our_dec"], batched["ref_dec"]) < 1e-3
    for ours, serial in zip(batched["our_dec"], batched["serial_dec"]):
        assert rel_dev(ours, serial) < 1e-3


def test_forward_batch_matches_jax_and_the_serial_forward(batched):
    assert batched["pmodel"].eval_batch_size == 2
    for ours, ref, serial in zip(batched["ours"], batched["ref"], batched["serial"]):
        # against JAX and against the port's serial forward at the depth
        # bound (the serial one: 1.8e-4 seen)
        assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-2
        assert rel_dev(ours["pred_depths"], serial["pred_depths"]) < 1e-2


def test_mixed_shapes_and_windowed_clips_take_the_serial_route(pipes):
    """Both packages fall back to ``forward`` per clip for clips of different
    shapes and for clips longer than the window."""
    from unigeo_tpu.models.depthcrafter.model import DepthCrafter as JDC
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter as PDC

    jp, pp = pipes
    rng = np.random.default_rng(13)
    cases = [([_clip(rng, 2), _clip(rng, 3)], {}),
             ([_clip(rng), _clip(rng)], {"window_size": 2, "overlap": 1})]
    for datas, kw in cases:
        for model in (JDC(pipeline=jp, seed=SEED, **kw), PDC(pp, seed=SEED, **kw)):
            calls = []
            model.forward = lambda data, _calls=calls: _calls.append(len(data["images"]))
            out = model.forward_batch(datas)
            assert calls == [len(d["images"]) for d in datas] and len(out) == 2, type(model)


def _csv_rows(pp, clips_per_step, tmp_path):
    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.evaluator import run_evaluation
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter

    cfg = {
        "dataset": "SyntheticBoxDataset", "root": None, "h": 64, "w": 64,
        "clip_length": 2, "clip_overlap": 0, "split": "test",
        "dataset_params": {"render_size": [64, 64], "num_scenes": 1, "frames_per_scene": 6},
        "model_name": "DepthCrafter",
        "model_params": {"num_inference_steps": 5, "clips_per_step": clips_per_step},
        "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25"], "depth_alignment": "lstsq"},
        "eval_normal": {"metric_names": ["normal mean", "angle < 11.25"]},
    }
    model = DepthCrafter(pipeline=pp, **cfg["model_params"])
    calls = []
    batch = model.forward_batch
    model.forward_batch = lambda datas: calls.append(len(datas)) or batch(datas)
    manager = run_evaluation(EvalConfig.from_dict(cfg), save_dir=str(tmp_path / str(clips_per_step)),
                             model=model, verbose=False, device="cpu")
    return manager.rows(), calls


def test_eval_with_clips_per_step_2_matches_1(pipes, tmp_path):
    _, pp = pipes
    serial, serial_calls = _csv_rows(pp, 1, tmp_path)
    rows, calls = _csv_rows(pp, 2, tmp_path)
    assert serial_calls == [] and calls == [2, 1]  # 3 clips: a pair, then one
    assert [r["seq_name"] for r in rows] == [r["seq_name"] for r in serial]
    pixels = 3.0 / (2 * 64 * 64)
    for row, ref in zip(rows, serial):
        for key, val in ref.items():
            if key == "seq_name":
                continue
            tol = pixels if key.startswith("delta") else (
                100.0 * pixels if key.startswith("angle") else 2e-2 * abs(val))
            assert abs(row[key] - val) <= tol, (key, row[key], val)
