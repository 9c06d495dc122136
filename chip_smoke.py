#!/usr/bin/env python3
"""Smoke run of vali_tpu_torch on one CUDA card.

Drives the port's main path — host frames staged by MultiStreamPipeline
into the banded preprocess kernels — at full size: 64 streams of 1080p ->
224x224. It builds the CUDA kernels from the sources in this checkout,
compares every kernel with its plain PyTorch version on the card, runs
MultiStreamPipeline over 64 in-memory frame sources and checks every batch
against the kernels, checks a kernel against the dense exact route, and
when the native engine builds, decodes a synthesised clip through the
pipeline too. It times kernels and plain versions with CUDA events and the
pipeline on the host clock, and prints:

  - the card's name and power limit (nvidia-smi), torch/CUDA versions and
    the kernel build time;
  - one line per comparison and per timing;
  - a JSON line {"kernels": [...]} with each kernel's launches on the main
    path, its error against the plain version and both times;
  - as the last line, {"ok": true, "device": {...}}.

Any failure raises and ends the run with a non-zero exit code before the
last line. Run it from the repository root:

    python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time

B, H, W, DH, DW = 64, 1080, 1920, 224, 224
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
LETTERBOX = 640
TIMED_RUNS = 21
CALLS_PER_SAMPLE = 5
MAIN_BATCHES = 3    # batches per stream on the checked main-path runs
RATE_BATCHES = 30   # batches per stream on the timed pipeline run


def log(*parts):
    print(*parts, flush=True)


def make_frames(np, rng, fmt, b, w, h):
    """[b, host_frame_bytes] uint8 host frames of ``fmt``, laid out like
    decoded frames: even rows of the batch random samples, odd rows smooth
    gradients. 10/12-bit values are MSB-aligned for P10/P12 and
    LSB-aligned for YUV420_10bit."""
    from vali_tpu_torch.core.enums import PixelFormat
    from vali_tpu_torch.core.formats import format_info

    info = format_info(fmt)
    maxv = (1 << info.bit_depth) - 1 if info.dtype == np.uint16 else 255
    frames = np.empty((b, info.host_size(w, h) // info.elem_size),
                      info.dtype)
    grad = []
    for ph, pw in info.plane_dims(w, h):
        yy, xx = np.mgrid[0:ph, 0:pw]
        grad.append(((yy / max(ph - 1, 1) * 0.6 + xx / max(pw - 1, 1) * 0.4)
                     * maxv).astype(np.int64).reshape(-1))
    grad = np.concatenate(grad)
    for i in range(b):
        frames[i] = (rng.integers(0, maxv + 1, frames.shape[1]) if i % 2 == 0
                     else (grad + 7 * i) % (maxv + 1))
    if fmt in (PixelFormat.P10, PixelFormat.P12):
        frames <<= 16 - info.bit_depth
    return frames.view(np.uint8)


def compare(torch, name, out, ref):
    """Print and check kernel vs plain: u8 within 1 LSB on <1e-3 of the
    pixels (same cast points, only the summation order differs), float
    within 1e-3 relative (bfloat16 outputs within one bfloat16 ulp)."""
    d = (out.double() - ref.double()).abs()
    frac = (d > 0).double().mean().item()
    if out.dtype == torch.uint8:
        peak = 255.0
    else:
        peak = (ref.double().max() - ref.double().min()).item()
    mse = (d * d).mean().item()
    psnr = float("inf") if mse == 0 else 10 * torch.log10(
        torch.tensor(peak * peak / mse)).item()
    log(f"{name}: max_abs_diff={d.max().item()} frac_diff={frac} "
        f"psnr_db={psnr}")
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    if out.dtype == torch.uint8:
        if d.max().item() > 1 or frac >= 1e-3:
            raise AssertionError(f"{name}: kernel disagrees with plain")
    else:
        tol = 1e-3 if out.dtype == torch.float32 else 2.0 ** -7
        bound = tol * ref.double().abs().clamp(min=1.0)
        if not (d <= bound).all().item():
            raise AssertionError(f"{name}: kernel disagrees with plain")
    return d.max().item()


def time_ms(torch, fn):
    """Median ms of one call: TIMED_RUNS samples, each CUDA events around
    CALLS_PER_SAMPLE back-to-back calls (so host launch latency overlaps
    device work), after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS_PER_SAMPLE):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS_PER_SAMPLE)
    return statistics.median(times)


def kernel_and_plain(torch, p, fmt, **kw):
    """(kernel call, plain-version call) with the same arguments on the same
    1080p device planes ``p``."""
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                    nv12_preprocess_plain)
    from vali_tpu_torch.ops.yuv420_preprocess import (
        yuv420_preprocess, yuv420_preprocess_plain)

    kw.update(src_w=W, src_h=H, dst_w=DW, dst_h=DH,
              space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    if fmt in (PixelFormat.NV12, PixelFormat.P10):
        return (lambda: nv12_preprocess(p[0], **kw),
                lambda: nv12_preprocess_plain(p[0], **kw))
    return (lambda: yuv420_preprocess(*p, **kw),
            lambda: yuv420_preprocess_plain(*p, **kw))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    import numpy as np

    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.ops import _cuda_build
    from vali_tpu_torch.ops.fused import fused_preprocess, letterbox_params
    from vali_tpu_torch.ops.nv12_preprocess import nv12_preprocess
    from vali_tpu_torch.ops.yuv420_preprocess import yuv420_preprocess
    from vali_tpu_torch.pipeline.multistream import (BatchStager,
                                                     MultiStreamPipeline)
    from vali_tpu_torch.utils.synth import HostFrameSource

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"device={torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda_build.load_kernels()
    log(f"kernel_build_s={time.perf_counter() - t0:.3f} "
        f"library={_cuda_build.library_path()}")

    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    geo = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)
    rng = np.random.default_rng(2024)
    host = {fmt: make_frames(np, rng, fmt, B, W, H)
            for fmt in (PixelFormat.NV12, PixelFormat.P10,
                        PixelFormat.YUV420, PixelFormat.YUV420_10bit)}
    planes = {fmt: BatchStager(fmt, W, H, dev).split(
        torch.from_numpy(x).to(dev)) for fmt, x in host.items()}

    def run_pair(fmt, **kw):
        return kernel_and_plain(torch, planes[fmt], fmt, **kw)

    # ---- kernel_nv12 / kernel_yuv420: kernel vs plain on the card --------
    err = {}
    cases = [
        ("kernel_nv12 u8/bf16", PixelFormat.NV12, {}),
        ("kernel_nv12 u8/f32", PixelFormat.NV12,
         dict(compute_dtype=torch.float32)),
        ("kernel_nv12 p10->f32+norm", PixelFormat.P10,
         dict(out_dtype=torch.float32, normalize=NORM)),
        ("kernel_yuv420 u8/bf16", PixelFormat.YUV420, {}),
        ("kernel_yuv420 u8/f32", PixelFormat.YUV420,
         dict(compute_dtype=torch.float32)),
        ("kernel_yuv420 10bit->f32+norm", PixelFormat.YUV420_10bit,
         dict(out_dtype=torch.float32, normalize=NORM)),
        ("kernel_yuv420 u8->bf16+norm", PixelFormat.YUV420,
         dict(out_dtype=torch.bfloat16, normalize=NORM)),
    ]
    for name, fmt, kw in cases:
        kern, plain = run_pair(fmt, **kw)
        wrapper = (nv12_preprocess if name.startswith("kernel_nv12")
                   else yuv420_preprocess)
        before = wrapper.launches
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        err[name] = compare(torch, name, out, ref)

    # ---- exactness against the dense fp32 route on a small input ---------
    small = make_frames(np, rng, PixelFormat.YUV420, 4, 256, 144)
    sp = BatchStager(PixelFormat.YUV420, 256, 144, dev).split(
        torch.from_numpy(small).to(dev))
    out = yuv420_preprocess(*sp, src_w=256, src_h=144, dst_w=96, dst_h=64,
                            compute_dtype=torch.float32, **bt709)
    ref = fused_preprocess(sp, PixelFormat.YUV420, 256, 144, 96, 64,
                           planar=True, **bt709)
    compare(torch, "kernel_yuv420 f32 vs dense route 256x144->96x64", out,
            ref)

    # ---- main path: MultiStreamPipeline over 64 streams ------------------
    # Every stream is a HostFrameSource that hands the pipeline host frames
    # laid out as the decoder would; stream s yields frames s, s+1, ... of
    # the batch, so row s of batch k is frame (s + k) % B.
    def sources(fmt, n):
        return [HostFrameSource([host[fmt][(s + k) % B] for k in range(n)],
                                fmt, W, H) for s in range(B)]

    iw, ih, left, top, _ = letterbox_params(W, H, LETTERBOX, LETTERBOX)
    runs = (("yuv420", PixelFormat.YUV420, {}, DW, DH),
            ("yuv420 letterbox", PixelFormat.YUV420,
             dict(letterbox=True, out_dtype=torch.bfloat16, normalize=NORM,
                  planar=True), LETTERBOX, LETTERBOX),
            ("nv12", PixelFormat.NV12, {}, DW, DH))
    pipes = {name: MultiStreamPipeline(
        sources(fmt, MAIN_BATCHES), dw, dh, gpu_id=0, batch_size=B,
        sync_streams=True, **bt709, **kw) for name, fmt, kw, dw, dh in runs}
    nv12_preprocess.launches = 0
    yuv420_preprocess.launches = 0
    main = {name: list(pipe) for name, pipe in pipes.items()}
    torch.cuda.synchronize()
    launches = {"nv12_preprocess": nv12_preprocess.launches,
                "yuv420_preprocess": yuv420_preprocess.launches}
    log(f"main_path_launches={json.dumps(launches)}")
    if min(launches.values()) < 1:
        raise AssertionError("a kernel of the main path was not launched")

    # the pipeline's batches must be the kernels' output, bit for bit
    refs = {
        "yuv420": yuv420_preprocess(*planes[PixelFormat.YUV420], **bt709,
                                    **geo).movedim(1, -1),
        "nv12": nv12_preprocess(planes[PixelFormat.NV12][0], **bt709,
                                **geo).movedim(1, -1),
        "yuv420 letterbox": yuv420_preprocess(
            *planes[PixelFormat.YUV420], src_w=W, src_h=H, dst_w=iw,
            dst_h=ih, out_dtype=torch.bfloat16, normalize=NORM, **bt709),
    }
    for name, batches in main.items():
        if len(batches) != MAIN_BATCHES:
            raise AssertionError(f"pipeline {name}: {len(batches)} batches")
        for k, (batch, ids) in enumerate(batches):
            want = torch.roll(refs[name], -k, 0)
            if name == "yuv420 letterbox":
                ok = (batch.shape == (B, 3, LETTERBOX, LETTERBOX)
                      and torch.equal(batch[:, :, top:top + ih,
                                            left:left + iw], want)
                      and bool(torch.isfinite(batch.float()).all()))
            else:
                ok = batch.shape == (B, DH, DW, 3) and torch.equal(batch,
                                                                   want)
            if ids != list(range(B)) or not ok:
                raise AssertionError(f"pipeline {name}: batch {k} differs "
                                     f"from the kernel's output")
    log(f"pipeline_device: ok, MultiStreamPipeline {B} streams x "
        f"{MAIN_BATCHES} batches each: yuv420 {H}p->{DH}x{DW}, nv12 same, "
        f"yuv420 letterbox {LETTERBOX}x{LETTERBOX} (inner {iw}x{ih}) "
        f"bf16+norm; every batch equal to the kernel output")

    # ---- decode -> pipeline, when the native engine builds here ----------
    from vali_tpu_torch.engine._loader import load_native

    try:
        load_native()
    except ImportError as e:
        lines = str(e).splitlines()
        detail = " | ".join(lines[:1] + lines[-3:])
        log(f"pipeline_decode: skipped: the native engine cannot be built "
            f"on this machine: {detail}")
    else:
        decode_phase(torch, np, dev)

    # ---- times at 64 x 1080p -> 224 --------------------------------------
    in_bytes = {fmt: host[fmt].nbytes for fmt in host}
    out_bytes = B * 3 * DH * DW
    times = {}
    for name, fmt in (("nv12_preprocess", PixelFormat.NV12),
                      ("yuv420_preprocess", PixelFormat.YUV420)):
        kern, plain = run_pair(fmt)
        # plain, kernel, kernel, plain: take each side's better median
        t_plain = time_ms(torch, plain)
        t_kern = time_ms(torch, kern)
        t_kern = min(t_kern, time_ms(torch, kern))
        t_plain = min(t_plain, time_ms(torch, plain))
        times[name] = (t_kern, t_plain)
        gbs = (in_bytes[fmt] + out_bytes) / (t_kern * 1e-3) / 1e9
        log(f"time {name} {B}x{H}p->{DH}x{DW} u8/bf16: kernel_ms={t_kern} "
            f"plain_ms={t_plain} kernel_fps={B / (t_kern * 1e-3)} "
            f"kernel_GBps={gbs} ({smi})")

    # ---- pipeline rate: decode replaced by a host copy -------------------
    fmt = PixelFormat.YUV420
    frames = list(host[fmt])
    pinned = torch.empty((B, frames[0].nbytes), dtype=torch.uint8,
                         pin_memory=True)
    stack_ms = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        np.stack(frames, out=pinned.numpy())
        stack_ms.append((time.perf_counter() - t0) * 1e3)
    h2d_ms = time_ms(torch, lambda: pinned.to(dev, non_blocking=True))
    pipe = MultiStreamPipeline(sources(fmt, RATE_BATCHES), DW, DH, gpu_id=0,
                               batch_size=B, sync_streams=True, **bt709)
    t0 = time.perf_counter()
    n = sum(1 for _ in pipe)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if n != RATE_BATCHES:
        raise AssertionError(f"pipeline rate run gave {n} batches")
    log(f"time pipeline {B} streams YUV420 {H}p->{DH}x{DW} u8/bf16, frames "
        f"replayed from host memory (no decode): batches={n} "
        f"ms_per_batch={wall_ms / n} fps={n * B / (wall_ms * 1e-3)} "
        f"kernel_busy_share={n * times['yuv420_preprocess'][0] / wall_ms} "
        f"host_stack_ms={statistics.median(stack_ms)} h2d_ms={h2d_ms} "
        f"h2d_GBps={pinned.nbytes / (h2d_ms * 1e-3) / 1e9} ({smi})")

    kernels = [
        {"name": "nv12_preprocess", "route": "cuda",
         "source": "vali_tpu_torch/csrc/banded_preprocess.cu",
         "replaces": "vali_tpu/ops/pallas_fused.py:158",
         "launches": launches["nv12_preprocess"],
         "max_abs_err": err["kernel_nv12 u8/bf16"],
         "ms": times["nv12_preprocess"][0],
         "plain_ms": times["nv12_preprocess"][1]},
        {"name": "yuv420_preprocess", "route": "cuda",
         "source": "vali_tpu_torch/csrc/banded_preprocess.cu",
         "replaces": "vali_tpu/ops/pallas_fused.py:786",
         "launches": launches["yuv420_preprocess"],
         "max_abs_err": err["kernel_yuv420 u8/bf16"],
         "ms": times["yuv420_preprocess"][0],
         "plain_ms": times["yuv420_preprocess"][1]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def decode_phase(torch, np, dev):
    """Synthesise a 1080p sweep-chroma clip, run 64 streams of it through
    MultiStreamPipeline, and check one batch against the plain version on
    the same decoded frames."""
    from vali_tpu_torch.engine.decoder import PyDecoder
    from vali_tpu_torch.pipeline.multistream import (BatchStager,
                                                     MultiStreamPipeline)
    from vali_tpu_torch.utils.synth import synthesize_clip

    n_batches = 3
    with tempfile.TemporaryDirectory() as tmp:
        clip = synthesize_clip(f"{tmp}/sweep.mp4", W, H, n=n_batches,
                               chroma="sweep")
        dec = PyDecoder(clip, {}, gpu_id=-1)
        fmt = dec.Format
        frame = np.zeros(dec.HostFrameSize, np.uint8)
        decoded = []
        for _ in range(n_batches):
            ok, _ = dec.DecodeSingleFrame(frame)
            if not ok:
                raise AssertionError("decoding the synthesised clip failed")
            decoded.append(frame.copy())
        pipe = MultiStreamPipeline([clip] * B, DW, DH, gpu_id=0,
                                   batch_size=B, sync_streams=True)
        batches = []
        t0 = time.perf_counter()
        for batch, ids in pipe:
            batches.append((batch, ids))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if len(batches) != n_batches:
        raise AssertionError(f"pipeline gave {len(batches)} batches")
    batch, ids = batches[1]
    if sorted(ids) != list(range(B)) or batch.shape != (B, DH, DW, 3):
        raise AssertionError("pipeline_decode: bad batch")
    one = BatchStager(fmt, W, H, dev).split(
        torch.from_numpy(np.stack([decoded[1]] * B)).to(dev))
    ref = kernel_and_plain(torch, one, fmt)[1]().movedim(1, -1)
    compare(torch, f"pipeline_decode {fmt.name} vs plain version on the "
            f"same decoded frames", batch, ref)
    log(f"pipeline_decode: ok {n_batches} batches of {B} streams "
        f"{fmt.name} {W}x{H} in {secs:.3f}s (host clock)")


if __name__ == "__main__":
    sys.exit(main())
