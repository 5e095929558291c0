"""The port's serving layer (``unigeo_tpu_torch/serving.py``, ``serve.py``)
against the JAX package's, on the CPU.

* The npz wire format: the JAX package's ``encode_arrays`` decoded by the
  port's and the reverse, bit for bit.
* Every case of ``tests/test_serving.py`` on the port's ``IdentityModel``
  (micro-batching, error isolation, 400s, ``close``), plus tensors on the
  wire (bf16 as f32).
* One clip served by both packages' servers over localhost HTTP: equal
  ``pred_*``.
* A tiny f32 DepthCrafter pair served by both packages' servers, coalesced
  into one batch on each side, the port's ``forward_batch`` given the JAX
  adapter's draws (``pipeline.clip_noise``): depths within 1e-2 relative,
  the ``forward_batch`` parity bound of ``tests/test_torch_windows.py``.
* ``python -m unigeo_tpu_torch.serve --device cpu --port 0`` answers
  ``/healthz`` and ``/v1/predict`` (IdentityModel, a tiny DepthCrafter, a
  tiny Spann3R); without ``--device cpu`` on a machine with no card it
  exits non-zero.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch


from unigeo_tpu import serving as jserving
from unigeo_tpu.models.identity import IdentityModel as JIdentity
from unigeo_tpu_torch.models.identity import IdentityModel
from unigeo_tpu_torch.serving import (
    HTTPInferenceServer,
    InferenceServer,
    decode_arrays,
    encode_arrays,
    warmup_clip,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
SEED = 42


@pytest.fixture(scope="module")
def clip():
    return warmup_clip(num_frames=2, hw=(32, 32))


def _sendable(clip):
    """The unified sample minus non-array entries (what a client sends)."""
    return {k: v for k, v in clip.items() if isinstance(v, np.ndarray) or np.isscalar(v)}


def _post(port, payload, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=payload,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return decode_arrays(r.read())


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the wire, across the packages
# ---------------------------------------------------------------------------


def test_synthetic_clip_is_the_jax_packages(clip):
    ref = jserving.warmup_clip(num_frames=2, hw=(32, 32))
    assert set(ref) == set(clip)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert _equal(clip[k], v), k
        else:
            assert clip[k] == v, k


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_crosses_the_packages_bit_exact(clip, direction):
    arrays = {**_sendable(clip), "pred_scale": 2.5, "scene_name": "scene_01"}
    enc, dec = ((jserving.encode_arrays, decode_arrays) if direction == "jax_to_port"
                else (encode_arrays, jserving.decode_arrays))
    back = dec(enc(arrays))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        if isinstance(v, np.ndarray) and v.ndim:
            assert _equal(back[k], v), k
        else:
            assert back[k] == (v.item() if isinstance(v, np.ndarray) else v), k


# ---------------------------------------------------------------------------
# tests/test_serving.py's cases on the port
# ---------------------------------------------------------------------------


def test_wire_roundtrip(clip):
    back = decode_arrays(encode_arrays(_sendable(clip)))
    assert back["keyview_idx"] == clip["keyview_idx"]  # 0-d -> scalar
    np.testing.assert_array_equal(back["images"], clip["images"])
    np.testing.assert_array_equal(back["extrinsics"], clip["extrinsics"])


def test_core_predict_and_stats(clip):
    srv = InferenceServer(IdentityModel(), max_batch=2)
    try:
        out = srv.predict(clip)
        assert out["pred_depths"].shape == clip["mask"].shape
        np.testing.assert_allclose(out["pred_depths"], -clip["cam_coord"][:, 2], atol=1e-5)
        s = srv.stats()
        assert s["served"] == 1 and s["latency_p50_s"] >= 0
    finally:
        srv.close()


def test_core_batching(clip):
    """Concurrent requests coalesce (mean_batch > 1) and all succeed."""

    class SlowIdentity(IdentityModel):
        def forward(self, data):
            time.sleep(0.05)  # hold the dispatch thread so requests pile up
            return super().forward(data)

        def forward_batch(self, datas):
            return [self.forward(d) for d in datas]

    srv = InferenceServer(SlowIdentity(), max_batch=4, batch_window_ms=50.0)
    try:
        results = [None] * 6

        def hit(i):
            results[i] = srv.predict(dict(clip))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(r is not None and "pred_depths" in r for r in results)
        assert srv.stats()["served"] == 6
        assert srv.stats()["mean_batch"] > 1.0
    finally:
        srv.close()


def test_batch_failure_is_shared_by_its_callers(clip):
    """A batch through forward_batch fails every caller of it (one batched
    run served them all), and the server serves on."""

    class FailingBatch(IdentityModel):
        def forward_batch(self, datas):
            raise ValueError("batch boom")

    srv = InferenceServer(FailingBatch(), max_batch=2, batch_window_ms=2000.0)
    try:
        errors = []

        def hit():
            try:
                srv.predict(dict(clip))
            except RuntimeError as exc:
                errors.append(str(exc))

        threads = [threading.Thread(target=hit) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert errors == ["ValueError: batch boom"] * 2
        assert "pred_depths" in srv.predict(dict(clip))  # alone: forward
    finally:
        srv.close()


def test_core_error_isolation(clip):
    """A model exception fails that request but the server keeps serving."""

    class Flaky(IdentityModel):
        def __init__(self):
            super().__init__()
            self.n = 0

        def forward(self, data):
            self.n += 1
            if self.n == 1:
                raise ValueError("boom")
            return super().forward(data)

    srv = InferenceServer(Flaky(), max_batch=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            srv.predict(dict(clip))
        assert "pred_depths" in srv.predict(dict(clip))
    finally:
        srv.close()


def test_dispatch_thread_runs_under_inference_mode(clip):
    """Grad mode is thread-local: the dispatch thread sets inference mode
    itself, whatever the caller's thread has."""
    seen = []

    class Probe(IdentityModel):
        def forward(self, data):
            seen.append((torch.is_inference_mode_enabled(), torch.is_grad_enabled()))
            return super().forward(data)

    srv = InferenceServer(Probe(), max_batch=1)
    try:
        with torch.enable_grad():
            srv.predict(dict(clip))
    finally:
        srv.close()
    assert seen == [(True, False)]


@pytest.fixture(scope="module")
def http_server():
    srv = HTTPInferenceServer(IdentityModel(), host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.shutdown()


def test_http_health_and_stats(http_server):
    assert _get(http_server.port, "/healthz") == {"status": "ok", "model": "IdentityModel"}
    assert "served" in _get(http_server.port, "/stats")


def test_http_predict(http_server, clip):
    preds = _post(http_server.port, encode_arrays(_sendable(clip)), timeout=30)
    assert set(preds) >= {"pred_depths", "pred_normals", "pred_poses"}
    np.testing.assert_allclose(preds["pred_depths"], -clip["cam_coord"][:, 2], atol=1e-5)


def test_http_bad_request(http_server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(http_server.port, b"not an npz", timeout=10)
    assert ei.value.code == 400
    assert _get(http_server.port, "/healthz")["status"] == "ok"


def test_per_clip_error_isolation(clip):
    """On the one-by-one path a bad co-batched request does not fail the
    valid ones."""

    class NoBatch(IdentityModel):
        forward_batch = None  # the one-by-one path

        def forward(self, data):
            time.sleep(0.05)
            if "poison" in data:
                raise ValueError("bad payload")
            return super().forward(data)

    srv = InferenceServer(NoBatch(), max_batch=4, batch_window_ms=80.0)
    try:
        results = {}

        def hit(i, payload):
            try:
                results[i] = srv.predict(payload)
            except RuntimeError as exc:
                results[i] = exc

        bad = dict(clip)
        bad["poison"] = np.zeros(1)
        threads = [threading.Thread(target=hit, args=(i, p))
                   for i, p in enumerate([dict(clip), bad, dict(clip)])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert isinstance(results[1], RuntimeError)
        assert "pred_depths" in results[0] and "pred_depths" in results[2]
    finally:
        srv.close()


def test_close_fails_queued_requests(clip):
    """close() fails queued requests at once, and refuses later ones."""

    class Slow(IdentityModel):
        def forward(self, data):
            time.sleep(0.5)
            return super().forward(data)

    srv = InferenceServer(Slow(), max_batch=1)
    errs = []

    def hit():
        try:
            srv.predict(dict(clip), timeout=30.0)
        except (RuntimeError, TimeoutError) as exc:
            errs.append(exc)

    threads = [threading.Thread(target=hit) for _ in range(3)]
    t0 = time.time()
    for t in threads:
        t.start()
    time.sleep(0.1)
    srv.close()
    for t in threads:
        t.join(timeout=10)
    assert time.time() - t0 < 8.0  # nobody waited out a long timeout
    with pytest.raises(RuntimeError):
        srv.predict(dict(clip))


def test_encode_arrays_keeps_tensors():
    """Tensor predictions are not dropped: bf16 (which numpy lacks) comes
    back as f32 of the same values, other dtypes as they are."""
    x = torch.linspace(-3, 3, 32).reshape(2, 4, 4)
    payload = encode_arrays({
        "pred_depths": x.to(torch.bfloat16),
        "pred_normals": x,
        "pred_ids": torch.arange(3),
        "pred_scale": 2.5,
        "scene_name": "scene_01",  # unicode arrays round-trip pickle-free
        "skip_me": {"not": "encodable"},  # object dtype: dropped
    })
    back = decode_arrays(payload)
    assert back["pred_depths"].dtype == np.float32
    assert np.array_equal(back["pred_depths"], x.to(torch.bfloat16).float().numpy())
    assert _equal(back["pred_normals"], x.numpy())
    assert _equal(back["pred_ids"], np.arange(3))
    assert back["pred_scale"] == 2.5 and back["scene_name"] == "scene_01"
    assert "skip_me" not in back


# ---------------------------------------------------------------------------
# the two packages' servers on the same requests
# ---------------------------------------------------------------------------


def _serve_concurrently(srv, payloads):
    """POST every payload at once; the decoded responses in order."""
    out = [None] * len(payloads)

    def hit(i):
        out[i] = _post(srv.port, payloads[i], timeout=600)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def test_identity_served_by_both_packages_agrees(clip):
    payload = encode_arrays(_sendable(clip))
    servers = (jserving.HTTPInferenceServer(JIdentity(), host="127.0.0.1", port=0),
               HTTPInferenceServer(IdentityModel(), host="127.0.0.1", port=0))
    for s in servers:
        s.start()
    try:
        ref, ours = (_post(s.port, payload) for s in servers)
    finally:
        for s in servers:
            s.shutdown()
    assert set(ours) == set(ref) >= {"pred_depths", "pred_normals", "pred_poses",
                                     "pred_world_pts"}
    for k in ref:
        assert _equal(ours[k], ref[k]), k


def _dc_clip(rng, t=3):
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def test_depthcrafter_pair_served_by_both_packages(shared_tiny_pipeline):
    """Two clips POSTed at once coalesce into one batch on each side (a
    2-second window, max_batch 2), the port's forward_batch given the JAX
    adapter's draws: depths within the forward_batch parity bound."""
    from unigeo_tpu.models.depthcrafter.model import DepthCrafter as JDC
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter as PDC
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

    jp = shared_tiny_pipeline
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))
    noise, aug = (torch.from_numpy(np.array(a)) for a in jp.clip_noise(SEED, 3, H, W))

    class GivenDraws(PDC):
        """The port's adapter with the JAX adapter's draws."""

        def forward_batch(self, datas):
            return super().forward_batch(datas, noise=noise, aug_noise=aug)

    rng = np.random.default_rng(14)
    payloads = [encode_arrays(_dc_clip(rng)), encode_arrays(_dc_clip(rng))]
    servers = (jserving.HTTPInferenceServer(JDC(pipeline=jp, seed=SEED), host="127.0.0.1",
                                            port=0, max_batch=2, batch_window_ms=2000.0),
               HTTPInferenceServer(GivenDraws(pp, seed=SEED), host="127.0.0.1", port=0,
                                   max_batch=2, batch_window_ms=2000.0))
    for s in servers:
        s.start()
    try:
        ref, ours = (_serve_concurrently(s, payloads) for s in servers)
        stats = [_get(s.port, "/stats") for s in servers]
    finally:
        for s in servers:
            s.shutdown()
    for st in stats:
        assert st["served"] == 2 and st["mean_batch"] == 2.0, st
    for o, r in zip(ours, ref):
        assert set(o) == set(r) == {"pred_depths", "pred_normals"}
        assert rel_dev(o["pred_depths"], r["pred_depths"]) < 1e-2
    assert rel_dev(ours[0]["pred_depths"], ours[1]["pred_depths"]) > 1e-3  # two clips


# ---------------------------------------------------------------------------
# python -m unigeo_tpu_torch.serve
# ---------------------------------------------------------------------------


def _start_cli(argv, timeout=120):
    """The CLI in a subprocess; (process, port) once it prints its port."""
    proc = subprocess.Popen([sys.executable, "-m", "unigeo_tpu_torch.serve", *argv],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines, found = [], []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                found.append(int(line.split("http://")[1].split()[0].rsplit(":", 1)[1]))
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    if not found:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError("".join(lines))
    return proc, found[0]


def _cli_params(model):
    """--params for the CLI: tiny networks of the port's own tiny configs."""
    if model == "DepthCrafter":
        from unigeo_tpu_torch.models.depthcrafter.unet import tiny_unet_config
        from unigeo_tpu_torch.models.depthcrafter.vae import tiny_vae_config
        from unigeo_tpu_torch.models.vit import tiny_clip_config

        return json.dumps(dict(unet_config=tiny_unet_config(), vae_config=tiny_vae_config(),
                               clip_config=tiny_clip_config(), num_inference_steps=2))
    if model == "Spann3R":
        from unigeo_tpu_torch.models.pointmap.spann3r import tiny_spann3r_config

        return json.dumps(dict(network_config=tiny_spann3r_config()))
    return "{}"


@pytest.mark.parametrize("model", ["IdentityModel", "DepthCrafter", "Spann3R"])
def test_serve_cli_on_the_cpu(model):
    frames = 2
    argv = ["--model", model, "--params", _cli_params(model), "--device", "cpu",
            "--host", "127.0.0.1", "--port", "0", "--warmup-frames", str(frames),
            "--warmup-hw", "64", "64"]
    proc, port = _start_cli(argv)
    try:
        assert _get(port, "/healthz") == {"status": "ok", "model": model}
        clip = _sendable(warmup_clip(num_frames=frames, hw=(64, 64)))
        preds = _post(port, encode_arrays(clip), timeout=300)
        assert "pred_depths" in preds
        assert preds["pred_depths"].shape[0] == frames
        assert np.isfinite(preds["pred_depths"]).all()
        assert _get(port, "/stats")["served"] == 1
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_serve_cli_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "-m", "unigeo_tpu_torch.serve", "--model",
                          "IdentityModel", "--port", "0", "--host", "127.0.0.1"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
