"""Find the first operation whose output for a clip depends on the clip's
slot in a batch of DepthCrafter clips.

``pipeline.run_clips_staged`` denoises B clips in one loop: every UNet
product sees B times the rows of one clip.  This runs two distinct clips
in both orders, [A, B] and [B, A], with the same noise (as
``DepthCrafter.forward_batch`` broadcasts it) and compares clip A's part
of everything the UNet computes:

* ``steps``: A's latents after every Euler step, bitwise;
* ``modules``: inside every UNet evaluation, every submodule's inputs and
  output (forward pre-hooks and hooks, in the order they fire), as two
  int64 fingerprints of the tensor's bits: the sum of the bit patterns and
  their sum weighted by (index mod 65521) + 1.  A tensor whose leading
  dimension is even is split in halves, A's half being the first in [A, B]
  and the second in [B, A]; one whose whole bits agree in both orders (a
  tensor that does not carry the batch) counts as agreeing.  The first
  module whose inputs agree and whose output does not holds the first op
  that depends on the slot (if it is not a leaf, an op of its own forward
  between its children);
* ``ops``: single operations at the UNet's shapes on one [A; B] batch and
  its [B; A] reorder, A's rows compared bitwise: the products of
  ``nn.Linear`` (cuBLAS), cuDNN's convolutions, ``GroupNorm``,
  ``LayerNorm``, the packed flash kernel, the temporal attention's plain
  path; and the repairs of a product that depends on the slot (per clip,
  and batched over clips with the clip as the batch index), each also held
  against one clip's own call (the serial forward's op);
* ``outputs``: A's decoded clip in both orders, against each other and
  against ``run_window_staged`` on A alone;
* ``serial``: clip A in ``run_clips_staged([A, B])`` against
  ``run_window_staged(A)``: the encode stage's outputs, A's latents after
  every Euler step and the decoded clip, bitwise; and, where they first
  differ, the first module of the encoder or the UNet whose inputs agree
  and whose output does not (the serial run's whole tensors against A's
  half of the batched run's).  ``serial_channels_last`` does the same with
  the serial clip handed to the stages as a channels-last view of the tool's
  dense NHWC clip (no copy), as ``run_window_staged`` handed such a clip to
  its encoder before it copied its inputs to dense NCHW;
* ``unet_ms`` (on the card): one UNet evaluation over the two clips with
  its convolutions per clip (``layers.clipwise``, the default) and over the
  whole batch, in turns, by CUDA events.

Each is run twice: with the UNet's convolutions per clip (``bisect``, the
default) and over the whole batch (``bisect_batched_convs``, the UNet
before ``clipwise``).

Under cuDNN's deterministic algorithms, as ``chip_smoke.py``'s serving
phase runs.  On the card at SVD-XT width in bf16 (random weights from a
seed, 25 x 384 x 512 clips, 5 Euler steps):

    python -m unigeo_tpu_torch.tools.order_bisect [--out FILE]

``--tiny --device cpu`` runs the tiny f32 pipeline at 4 x 64 x 64 on the
CPU (the control flow only).  It prints one JSON object (the card's name
with it) and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SVD_XT_UNET = dict(block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
                   num_attention_heads=(5, 10, 20, 20), cross_attention_dim=1024,
                   addition_time_embed_dim=256, head_dim=64)
SVD_XT_CLIP = dict(width=1280, depth=32, num_heads=16, patch_size=14,
                   projection_dim=1024, image_size=224)
FP_MOD = 65521


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of x's bit patterns (plain, and weighted by position)."""
    x = x.detach().contiguous().reshape(-1)
    if x.dtype.is_floating_point:
        x = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])
    v = x.to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % FP_MOD + 1
    return torch.stack([v.sum(), (v * w).sum()])


def tensor_prints(x: torch.Tensor) -> torch.Tensor:
    """[3, 2]: the whole tensor's fingerprint and its two halves' along the
    leading dimension (zeros where it is odd)."""
    whole = fingerprint(x)
    if x.dim() and x.shape[0] % 2 == 0:
        n = x.shape[0] // 2
        return torch.stack([whole, fingerprint(x[:n]), fingerprint(x[n:])])
    return torch.stack([whole, torch.zeros_like(whole), torch.zeros_like(whole)])


class Recorder:
    """Forward pre-hooks and hooks on every submodule of ``root``: one
    entry (call, name, "in" / "out", shapes, prints) per firing."""

    def __init__(self, root: torch.nn.Module, root_name: str = "unet"):
        self.entries: List[Dict[str, Any]] = []
        self.prints: List[torch.Tensor] = []
        self.call = -1
        self.handles = []
        self.types = {}
        for name, mod in root.named_modules():
            name = f"{root_name}.{name}" if name else root_name
            self.types[name] = type(mod).__name__
            self.handles.append(mod.register_forward_pre_hook(self._pre(name, mod is root)))
            self.handles.append(mod.register_forward_hook(self._post(name)))

    def _add(self, name, kind, tensors):
        tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
        if not tensors:
            return
        self.entries.append(dict(call=self.call, name=name, type=self.types[name], kind=kind,
                                 shapes=[list(t.shape) for t in tensors],
                                 dtypes=[str(t.dtype).replace("torch.", "") for t in tensors]))
        self.prints.append(torch.stack([tensor_prints(t) for t in tensors]))

    def _pre(self, name, is_root):
        def hook(mod, args):
            if is_root:
                self.call += 1
            self._add(name, "in", args)
        return hook

    def _post(self, name):
        def hook(mod, args, out):
            self._add(name, "out", out if isinstance(out, (tuple, list)) else [out])
        return hook

    def close(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def host_prints(self):
        return [p.cpu().numpy() for p in self.prints]


def agree(p_ab: np.ndarray, p_ba: np.ndarray) -> bool:
    """A's part of each tensor of one entry agrees in both orders: the
    whole bits (a tensor that does not carry the batch), or A's half (the
    first in [A, B], the second in [B, A])."""
    for t_ab, t_ba in zip(p_ab, p_ba):
        if np.array_equal(t_ab[0], t_ba[0]):
            continue
        if not (t_ab[1].any() or t_ab[2].any()) or not np.array_equal(t_ab[1], t_ba[2]):
            return False
    return True


@contextlib.contextmanager
def deterministic_cudnn():
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_clips(t, h, w, seed):
    """Two distinct clips [t, h, w, 3] in [0, 1]: smooth random fields."""
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(2):
        low = rng.random((t, 3, h // 16, w // 16)).astype(np.float32)
        up = F.interpolate(torch.from_numpy(low), size=(h, w), mode="bilinear",
                           align_corners=False)
        clips.append(up.permute(0, 2, 3, 1).contiguous())
    return clips


def run_order(pipe, clips, order, noise, steps, dev):
    """Clips in ``order`` through run_clips_staged, recording the UNet's
    submodules and the latents after every Euler step."""
    rec = Recorder(pipe.unet)
    step_prints = []
    euler = pipe.scheduler.euler_step
    def recorded_euler(x, *args):
        out = euler(x, *args)
        step_prints.append(tensor_prints(out))
        return out

    pipe.scheduler.euler_step = recorded_euler
    try:
        frames = torch.stack([clips[i] for i in order])
        out = pipe.run_clips_staged(frames, noise.expand(2, *noise.shape), steps)
        sync(dev)
    finally:
        del pipe.scheduler.euler_step  # the class's method again
        rec.close()
    return out, rec.entries, rec.host_prints(), [p.cpu().numpy() for p in step_prints]


def bisect(pipe, clips, noise, steps, dev):
    out_ab, ent_ab, pr_ab, st_ab = run_order(pipe, clips, (0, 1), noise, steps, dev)
    out_ba, ent_ba, pr_ba, st_ba = run_order(pipe, clips, (1, 0), noise, steps, dev)
    if [(e["call"], e["name"], e["kind"]) for e in ent_ab] != \
            [(e["call"], e["name"], e["kind"]) for e in ent_ba]:
        raise AssertionError("the two orders fired different hooks")
    steps_agree = [agree(a[None], b[None]) for a, b in zip(st_ab, st_ba)]
    first_out, first_entries, n_diff = None, [], 0
    last_in: Dict[str, bool] = {}
    for e, a, b in zip(ent_ab, pr_ab, pr_ba):
        same = agree(a, b)
        if e["kind"] == "in":
            last_in[e["name"]] = same
            continue
        if same:
            continue
        n_diff += 1
        row = dict(e, inputs_agree=last_in.get(e["name"]))
        if len(first_entries) < 12:
            first_entries.append(row)
        if first_out is None and row["inputs_agree"]:
            first_out = row
    a_ab, a_ba = out_ab[0], out_ba[1]
    serial = pipe.run_window_staged(clips[0], noise, steps)
    sync(dev)
    diff = lambda x, y: float((x.float() - y.float()).abs().max())
    return dict(
        steps_agree=steps_agree,
        first_step_differing=next((i for i, s in enumerate(steps_agree) if not s), None),
        module_outputs_recorded=sum(e["kind"] == "out" for e in ent_ab),
        module_outputs_differing=n_diff,
        first_op=first_out,
        first_differing_outputs=first_entries,
        outputs=dict(a_bitwise_across_orders=bool(torch.equal(a_ab, a_ba)),
                     a_max_abs_across_orders=diff(a_ab, a_ba),
                     a_bitwise_vs_serial=bool(torch.equal(a_ab, serial)),
                     a_max_abs_vs_serial=diff(a_ab, serial),
                     b_bitwise_across_orders=bool(torch.equal(out_ab[1], out_ba[0])),
                     output_scale=float(a_ab.abs().max())),
    )


def agree_serial(p_serial: np.ndarray, p_batched: np.ndarray) -> bool:
    """Each tensor of one entry: the serial run's whole bits equal the
    batched run's whole bits (a tensor that does not carry the batch) or
    A's half of them (the first half of [A, B])."""
    for t_s, t_b in zip(p_serial, p_batched):
        if np.array_equal(t_s[0], t_b[0]):
            continue
        if not (t_b[1].any() or t_b[2].any()) or not np.array_equal(t_s[0], t_b[1]):
            return False
    return True


def first_module(ent_s, pr_s, ent_b, pr_b, same):
    """The first output entry whose module's inputs agree and whose output
    does not, and the count of differing outputs, over two recordings whose
    entries pair up in order (``same(p_first, p_second)`` compares one)."""
    if [(e["name"], e["kind"]) for e in ent_s] != [(e["name"], e["kind"]) for e in ent_b]:
        raise AssertionError("the two runs fired different hooks")
    first, n_diff, last_in = None, 0, {}
    for e, a, b in zip(ent_s, pr_s, pr_b):
        ok = same(a, b)
        if e["kind"] == "in":
            last_in[e["name"]] = ok
            continue
        if ok:
            continue
        n_diff += 1
        if first is None and last_in.get(e["name"]):
            first = dict(e, inputs_agree=True)
    return first, n_diff


class StageTap:
    """Records what the pipeline's stages hand on: each encode stage's
    (cond, context), the latents after each Euler step and each decoded
    clip, as fingerprints; and every module of the VAE encoder and the UNet
    (``Recorder``)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.encoded, self.steps, self.decoded = [], [], []
        enc, euler, dec = pipe._encode_stage, pipe.scheduler.euler_step, pipe._decode_stage

        def encode(*a, **k):
            out = enc(*a, **k)
            self.encoded.append(torch.stack([tensor_prints(t) for t in out]).cpu().numpy())
            return out

        def step(*a, **k):
            out = euler(*a, **k)
            self.steps.append(tensor_prints(out).cpu().numpy())
            return out

        def decode(*a, **k):
            out = dec(*a, **k)
            self.decoded.append(tensor_prints(out).cpu().numpy())
            return out

        pipe._encode_stage, pipe.scheduler.euler_step, pipe._decode_stage = encode, step, decode
        self.encoder = Recorder(pipe.vae.encoder, "vae.encoder")
        self.unet = Recorder(pipe.unet)

    def close(self):
        for obj, name in ((self.pipe, "_encode_stage"), (self.pipe.scheduler, "euler_step"),
                          (self.pipe, "_decode_stage")):
            del obj.__dict__[name]  # the class's method again
        self.encoder.close()
        self.unet.close()


def serial_window(pipe, frames, noise, steps, channels_last):
    """``run_window_staged(frames, noise, steps)``; with ``channels_last``
    the frames enter the encoder as the permuted view of the dense NHWC clip
    (what ``run_window_staged`` did before it copied its inputs)."""
    if not channels_last:
        return pipe.run_window_staged(frames, noise, steps)
    cond, context = pipe._encode_stage(frames.to(pipe.device).permute(0, 3, 1, 2))
    x = pipe._denoise_loop(cond[None], context[None],
                           noise.contiguous().permute(0, 3, 1, 2)[None], steps)[0]
    return pipe._decode_stage(x).permute(0, 2, 3, 1)


def serial_bisect(pipe, clips, noise, steps, dev, channels_last=False):
    """Clip A of ``run_clips_staged([A, B])`` against ``run_window_staged(A)``:
    which stage first differs (the encode stage's outputs, the latents after
    each Euler step, the decoded clip) and the first module whose inputs
    agree and whose output does not."""
    tap = StageTap(pipe)
    try:
        serial = serial_window(pipe, clips[0], noise, steps, channels_last)
        sync(dev)
        n_enc, n_unet = len(tap.encoder.entries), len(tap.unet.entries)
        batched = pipe.run_clips_staged(torch.stack(clips), noise.expand(2, *noise.shape), steps)
        sync(dev)
    finally:
        tap.close()
    enc_s, enc_b = tap.encoded[0], tap.encoded[1]  # A encodes first in the batched run
    steps_s, steps_b = tap.steps[:steps], tap.steps[steps:]
    encode_agrees = agree_serial(enc_s, enc_b)
    steps_agree = [agree_serial(a[None], b[None]) for a, b in zip(steps_s, steps_b)]
    prints_e = tap.encoder.host_prints()
    # the batched run encodes A, then B: A's encoder entries come first
    first_enc, n_enc_diff = first_module(
        tap.encoder.entries[:n_enc], prints_e[:n_enc],
        tap.encoder.entries[n_enc:2 * n_enc], prints_e[n_enc:2 * n_enc],
        lambda a, b: agree_serial(a, b))
    prints_u = tap.unet.host_prints()
    first_unet, n_unet_diff = first_module(
        tap.unet.entries[:n_unet], prints_u[:n_unet],
        tap.unet.entries[n_unet:], prints_u[n_unet:], agree_serial)
    a_b = batched[0]
    return dict(
        serial_frames_layout="channels-last view of the dense NHWC clip" if channels_last
        else "dense NCHW (run_window_staged's copy)",
        encode_agrees=encode_agrees,
        steps_agree=steps_agree,
        first_step_differing=next((i for i, ok in enumerate(steps_agree) if not ok), None),
        encoder_outputs_recorded=sum(e["kind"] == "out" for e in tap.encoder.entries[:n_enc]),
        encoder_outputs_differing=n_enc_diff,
        first_encoder_op=first_enc,
        unet_outputs_recorded=sum(e["kind"] == "out" for e in tap.unet.entries[:n_unet]),
        unet_outputs_differing=n_unet_diff,
        first_unet_op=first_unet,
        decoded_bitwise=bool(torch.equal(a_b, serial)),
        decoded_max_abs=float((a_b.float() - serial.float()).abs().max()),
        output_scale=float(a_b.abs().max()),
    )


def order_check(fn, a, b, cat_dim=0):
    """fn on [a; b] and on [b; a]: whether a's part is bitwise equal, its max
    abs difference, and whether it equals fn(a) alone."""
    n = a.shape[cat_dim]
    ab = fn(torch.cat([a, b], cat_dim))
    ba = fn(torch.cat([b, a], cat_dim))
    alone = fn(a)
    a_ab, a_ba = ab.narrow(cat_dim, 0, n), ba.narrow(cat_dim, ab.shape[cat_dim] - n, n)
    return dict(bitwise=bool(torch.equal(a_ab, a_ba)),
                max_abs=float((a_ab.float() - a_ba.float()).abs().max()),
                equals_alone=bool(torch.equal(a_ab, alone)))


# the UNet's stages at SVD-XT width on a 384 x 512 clip: latent (h, w),
# channels, heads of 64
SVD_XT_STAGES = (((48, 64), 320, 5), ((24, 32), 640, 10), ((12, 16), 1280, 20),
                 ((6, 8), 1280, 20))


def op_checks(dev, dtype, t, stages):
    """The UNet's single ops at each stage's shapes (``stages``: ((h, w),
    channels, heads) from the first), two random clips of t frames: the
    products of ``nn.Linear`` (cuBLAS; and their repairs per clip and as one
    batched call with the clip as the batch index), the spatial convs (3 x 3,
    3 x 3 from the stage before's channels, 1 x 1, the stride-2 downsampler,
    the fused-upsample transposed conv), the temporal conv, ``GroupNorm``
    over frames and over clips, ``LayerNorm``, the packed flash kernel and
    the temporal attention's plain path."""
    from unigeo_tpu_torch.models.layers import Conv2d, GroupNorm, TemporalConv
    from unigeo_tpu_torch.ops.attention import attention_packed_reference, flash_attention_packed

    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev, dtype=torch.float32).to(dtype)
    out: Dict[str, Any] = {}
    prev_c = stages[0][1]
    with torch.no_grad():
        for si, ((h, w), c, heads) in enumerate(stages):
            rows = t * h * w
            tag = lambda name: f"stage{si}_{name}"
            for name, cin, cout in (("linear_c_c", c, c), ("linear_c_8c", c, 8 * c),
                                    ("linear_4c_c", 4 * c, c)):
                mod = torch.nn.Linear(cin, cout, device=dev, dtype=dtype)
                a, b = rnd(rows, cin), rnd(rows, cin)
                out[tag(name)] = order_check(mod, a, b)
                # the repairs: one product per clip, and one batched call
                # with the clip as the batch index
                per_clip = lambda x, m=mod: torch.cat([m(xi) for xi in x.split(rows)])
                out[tag(name + "_per_clip")] = order_check(per_clip, a, b)

                def batched(x, m=mod):
                    x3 = x.view(-1, rows, x.shape[-1])
                    wt = m.weight.t().expand(x3.shape[0], *m.weight.t().shape)
                    return torch.baddbmm(m.bias.expand(x3.shape[0], 1, -1), x3,
                                         wt).view(-1, wt.shape[-1])

                out[tag(name + "_batched_bmm")] = order_check(batched, a, b)
            convs = {"conv3x3": Conv2d(c, c), "conv3x3_from_prev": Conv2d(prev_c, c),
                     "conv1x1_from_prev": Conv2d(prev_c, c, kernel=1),
                     "downsample_stride2": Conv2d(c, c, stride=2, padding=1),
                     "upsample_fused": Conv2d(c, c, fuse_upsample2x=True)}
            for name, conv in convs.items():
                conv = conv.to(device=dev, dtype=dtype)
                cin = conv.weight.shape[1]
                out[tag(name)] = order_check(conv, rnd(t, cin, h, w), rnd(t, cin, h, w))
            tconv = TemporalConv(c, c).to(device=dev, dtype=dtype)
            out[tag("temporal_conv")] = order_check(tconv, rnd(1, c, t, h, w), rnd(1, c, t, h, w))
            gn = GroupNorm(c).to(device=dev, dtype=dtype)
            out[tag("group_norm")] = order_check(gn, rnd(t, c, h, w), rnd(t, c, h, w))
            out[tag("group_norm_over_frames")] = order_check(gn, rnd(1, c, t, h, w),
                                                              rnd(1, c, t, h, w))
            ln = torch.nn.LayerNorm(c, device=dev, dtype=dtype)
            out[tag("layer_norm")] = order_check(ln, rnd(rows, c), rnd(rows, c))
            if h * w >= 128:
                qa, qb = rnd(t, h * w, 3 * c), rnd(t, h * w, 3 * c)
                qkv = lambda x: [p.contiguous() for p in x.split(c, dim=-1)]
                attn = lambda x, hd=heads: flash_attention_packed(*qkv(x), hd) \
                    if dev.type == "cuda" else attention_packed_reference(*qkv(x), hd,
                                                                          upcast=False)
                out[tag("flash_packed")] = order_check(attn, qa, qb)
            # the temporal self-attention's plain path: [B*HW, T, C], T tokens
            ta, tb = rnd(h * w, t, 3 * c), rnd(h * w, t, 3 * c)
            out[tag("temporal_attention")] = order_check(
                lambda x, hd=heads: attention_packed_reference(*x.split(c, dim=-1), hd,
                                                               upcast=False), ta, tb)
            prev_c = c
    sync(dev)
    return out


@contextlib.contextmanager
def batched_convs():
    """The UNet's convolutions over the whole batch of clips, as before they
    ran per clip (``layers.clipwise``)."""
    from unigeo_tpu_torch.models.depthcrafter import unet

    real = unet.clips_in_batch
    unet.clips_in_batch = lambda n: contextlib.nullcontext()
    try:
        yield
    finally:
        unet.clips_in_batch = real


def unet_timing(pipe, dev, t, h, w, iters=3):
    """ms of one UNet evaluation over two clips with the convolutions per
    clip and over the batch, in turns (per clip, batch, batch, per clip),
    by CUDA events after a warm-up of each."""
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(pipe.dtype)
    args = (rnd(2 * t, 8, h // 8, w // 8), torch.full((2,), 500.0, device=dev),
            rnd(2 * t, 1, pipe.unet.cross_attention_dim),
            torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev), t)

    def run(per_clip):
        with contextlib.nullcontext() if per_clip else batched_convs():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                pipe.unet(*args)
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / iters

    run(True), run(False)  # warm up both
    times = {"per_clip_ms": [], "batched_ms": []}
    for per_clip in (True, False, False, True):
        times["per_clip_ms" if per_clip else "batched_ms"].append(run(per_clip))
    return times


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true", help="the tiny f32 pipeline at 4 x 64 x 64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--serial-only", action="store_true",
                    help="only the batched clip against run_window_staged (serial, "
                         "serial_channels_last)")
    args = ap.parse_args(argv)

    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline, tiny_pipeline

    dev = resolve_device(args.device)
    if args.tiny:
        pipe = tiny_pipeline(device=dev)
        t, h, w = 4, 64, 64
        stages = (((8, 8), 32, 1), ((4, 4), 48, 2))
    else:
        pipe = DepthCrafterPipeline(unet_config=SVD_XT_UNET, clip_config=SVD_XT_CLIP,
                                    dtype=torch.bfloat16, device=dev)
        t, h, w = 25, 384, 512
        stages = SVD_XT_STAGES
    pipe.init_random(torch.Generator(device=dev).manual_seed(0))
    clips = make_clips(t, h, w, seed=1)
    noise, _ = pipe.draw_clip_noise(torch.Generator(device=dev).manual_seed(42), t, h, w)
    result: Dict[str, Any] = dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        shape=[t, h, w], dtype=str(pipe.dtype).replace("torch.", ""), steps=args.steps)
    if dev.type == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    def write():
        text = json.dumps(result)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        return text

    with deterministic_cudnn(), torch.inference_mode():
        result["serial"] = serial_bisect(pipe, clips, noise, args.steps, dev)
        result["serial_channels_last"] = serial_bisect(pipe, clips, noise, args.steps, dev,
                                                       channels_last=True)
        write()
        if args.serial_only:
            print(write(), flush=True)
            return 0
        result["bisect"] = bisect(pipe, clips, noise, args.steps, dev)
        write()  # kept if what follows fails
        with batched_convs():
            result["bisect_batched_convs"] = bisect(pipe, clips, noise, args.steps, dev)
        write()
        result["ops"] = op_checks(dev, pipe.dtype, t, stages)
        if dev.type == "cuda":
            result["unet_ms"] = unet_timing(pipe, dev, t, h, w)
    print(write(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
