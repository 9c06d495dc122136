#!/usr/bin/env python3
"""Smoke run of vali_tpu_torch on one CUDA card.

Drives the port's main paths at full size. The batched preprocess
path: host frames staged by MultiStreamPipeline into the banded preprocess
kernels, 64 streams of 1080p -> 224x224 in NV12, YUV420, YUV422 (the MJPEG
camera case) and YUV444. The Surface path (VALI's public
API): PyFrameUploader, PySurfaceConverter NV12 -> RGB and PySurfaceResizer
-> 640x360 on 64 distinct 1080p frames, one Surface at a time, read through
DLPack; and a 4K NV12 Surface resized to 1080p (turbo), converted to
YUV420, resized to 960x540 (turbo) and downloaded; then PySurfaceUD and
PySurfaceRotator on 1080p Surfaces, each against the same op on a CPU copy
of its input; and the NV12 kernel-variant lab's entry point
(``vali_tpu_torch.lab.kernel_variants``: stream floor, phase knock-outs,
convert-once and split-chroma variants, multi-frame blocks, static
windows — constant-bank row tables, aligned strip windows, G frames a
block on S2's tensor-core block —, transposed chroma and the tensor-core
H pass) at 64 x 1080p -> 224, each lab kernel against its plain version
and the full-function ones against nv12_preprocess bit for bit (the
tensor-core ones within the kernels' envelope, the combo also against S2
at its strip height); and the 4K NV12 resize lab's
entry point (``vali_tpu_torch.lab.resize_diag``: phase knock-outs, aligned
windows, the skewed H/W pipeline, streamed row bands (TMA into an mbarrier
ring under aligned's tensor-core passes), row-slab split-K sums (aligned's
passes, each slab piece staged by TMA against its own mbarrier), column
stripes) at 16 x 4K -> 1080p, each kernel against its plain version and
the full-function ones but slabs, aligned and streamed (their passes on
the tensor cores, within the kernels' envelope; streamed equal to
aligned8x32 bit for bit, slabs off the rows that straddle a slab edge)
against nv12_resize bit for bit; and the NV12 ->
RGB convert lab's entry point
(``vali_tpu_torch.lab.convert_lab``: bf16-staged variants, read / store /
quantisation / replication probes) at 64 x 1080p, each kernel against its
plain version bit for bit and V1 / V2 against nv12_to_rgb; then the
inference path (the JAX bench's config 4: MultiStreamPipeline over 64
YUV420 1080p streams -> 224x224 float32 normalised through the
yuv420_preprocess kernel -> the full bf16 FCN, its logits held to the same
model on the CPU) and the batched QC ops at 1080p (histograms, luma
statistics, scene cuts, PSNR / SSIM, HDR tone mapping, the device stage
of JPEG encode), each held to the same function on the CPU; then the
device half of ``python -m vali_tpu_torch transcode`` (64 seeded 1080p
YUV420 host frames staged through the decoder's ring into a Surface on
the card, resized to 720p by two plane_resize launches, converted to NV12
and read back through the encoder's download), each frame held to the
same loop on CPU Surfaces, with async uploads bit-equal across the ring's
wrap; and, where the native engine loads, the CLI's transcode of a
synthesised clip; then the multi-device slice (``parallel/mesh.py``): the
pipeline on a mesh of the machine's own cards, and on four positions of
this card with the NV12 preprocess and resize kernels run per data block,
each equal to one unsharded launch bit for bit; the dense preprocess
split over rows (data 1 x spatial 2 x model 2) with the halo bytes each
position receives, the tensor-parallel FCN and one training step, each
held to its unsharded run; then the port's samples
(``vali_tpu_torch.samples``): ``sample_profile`` under torch.profiler at
8 x 848x464 NV12 -> 224, and the four pipeline samples (multistream,
detection letterbox, segmentation into the FCN, multichip on a
four-position mesh of this card) on four in-memory 1080p streams, each
held to its plain path, with get_device_info and the decode-based
samples where the native engine builds; then the bench
(``vali_tpu_torch.bench.run``, what ``python -m vali_tpu_torch bench``
prints, in-process with a 120 s budget): its line logged whole, each
section's kernel launches counted on their own, its headline and config 2
held to this run's own kernel times, the records that need the native
engine null exactly where it does not load, and each shape it launches a
kernel at held to the plain version and timed; then nv12_preprocess's route at
each of its uint8 shapes (the cells', the mesh position's, the samples',
the bench's 4K and the letterbox content's): the kernel it takes, held
to the FMA kernel's own entry and timed against it. It builds the CUDA
kernels from the sources in this checkout, compares every kernel with its
plain PyTorch version on the card and with the dense exact route, checks
every main-path output against the batched kernels bit for bit, and when
the native engine builds, decodes a synthesised clip through the pipeline
too. It times kernels and plain versions with CUDA events and the paths on
the host clock, and prints:

  - the card's name and power limit (nvidia-smi), torch/CUDA versions and
    the build time of the product's and the labs' kernel libraries;
  - one line per comparison and per timing;
  - for the Surface path's four kernels, each main path's launches read
    on their own (Surface paths A and B, the two-stage convert + resize),
    and every timed shape's kernel and plain times, bound and main-path
    launches at that shape;
  - a JSON line {"kernels": [...]} with each kernel's launches on its
    path, its error against the plain version, both times and its bound
    (bytes over 3.35 TB/s or operations over 989 TFLOP/s, the H100 SXM
    data sheet) at its batched shape; the Surface kernels' entries also
    list every timed shape with its main-path launches ("shapes"; at
    N = 1 a wrapper call's time, host work included) and the mean time
    over those launches ("launch_weighted_ms"); nv12_to_rgb's entry also
    each compute dtype's route (bf16 on the tensor cores, f32 on the CUDA
    cores) at the batched shape and at N = 1: the wrapper call, the
    kernel alone through one prepared call and its device time by
    torch.profiler ("routes");
  - a JSON line {"nv12_preprocess_routes": [...]}: per shape the route,
    both kernels' wrapper and device times and the differing samples;
  - as the last line, {"ok": true, "device": {...}}.

Any failure raises and ends the run with a non-zero exit code before the
last line. Run it from the repository root:

    python3 chip_smoke.py
"""

import functools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

from vali_tpu_torch.lab.timing import (CSC_OPS, TIMED_RUNS, bound_ms,
                                       fcn_work, preprocess_work,
                                       resize_work, time_ms)

B, H, W, DH, DW = 64, 1080, 1920, 224, 224
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
LETTERBOX = 640
MAIN_BATCHES = 3    # batches per stream on the checked main-path runs
COMBO_REPLAYS = 10  # replays of each combo instance against its first
PRODLIKE_REPLAYS = 20  # replays of prod_like's and multiframe's instances
RATE_BATCHES = 30   # batches per stream on the timed pipeline run


def log(*parts):
    print(*parts, flush=True)


def launch_counts(*wrappers):
    """{wrapper's name: kernel launches it made so far}, from the
    program's ``launches.<wrapper>`` counters (``utils/tracing``)."""
    from vali_tpu_torch.utils.tracing import counters

    now = counters()
    return {w.__name__: now.get("launches." + w.__name__, 0)
            for w in wrappers}


def launches_of(wrapper):
    """A wrapper's kernel launches so far: a lab wrapper's ``launches``
    attribute, a product wrapper's counter (:func:`launch_counts`)."""
    if hasattr(wrapper, "launches"):
        return wrapper.launches
    return launch_counts(wrapper)[wrapper.__name__]


def launched_since(before, *wrappers):
    """{wrapper's name: its launches since ``before`` (a
    :func:`launch_counts`)}."""
    return {k: n - before[k] for k, n in launch_counts(*wrappers).items()}


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


def compare(torch, name, out, ref, tol=1):
    """Print and check kernel vs plain: u8 within ``tol`` (1 LSB, or a
    per-sample bound of ``out``'s shape) on <1e-3 of the pixels (same
    cast points, only the summation order differs), u16 within 1 LSB on
    <1e-2, float within 1e-3 relative (bfloat16 outputs within one
    bfloat16 ulp)."""
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
        f"psnr_db={psnr}" + ("" if isinstance(tol, int) else
                             f" above_1={int((d > 1).sum().item())}"))
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    if out.dtype == torch.uint8:
        if (d > tol).any().item() or frac >= 1e-3:
            raise AssertionError(f"{name}: kernel disagrees with plain")
    elif out.dtype == torch.uint16:
        # a float32 ulp of a 16-bit sum is ~1/256 LSB: summation-order
        # ties land on the other side more often than for uint8
        if d.max().item() > 1 or frac >= 1e-2:
            raise AssertionError(f"{name}: kernel disagrees with plain")
    else:
        tol = 1e-3 if out.dtype == torch.float32 else 2.0 ** -7
        bound = tol * ref.double().abs().clamp(min=1.0)
        if not (d <= bound).all().item():
            raise AssertionError(f"{name}: kernel disagrees with plain")
    return d.max().item()


def time_pair(kern, plain):
    """(kernel ms, plain ms) taken plain, kernel, kernel, plain; each side
    keeps its better median. Plain versions take 5 single-call samples:
    some run ~100 ms a call."""
    t_plain = time_ms(plain, samples=5, calls=1)
    t_kern = time_ms(kern)
    t_kern = min(t_kern, time_ms(kern))
    t_plain = min(t_plain, time_ms(plain, samples=5, calls=1))
    return t_kern, t_plain


def preprocess_kernels():
    """{format: (kernel wrapper, plain version)} of the four preprocess
    kernels."""
    from vali_tpu_torch.core.enums import PixelFormat as F
    from vali_tpu_torch.ops import (nv12_preprocess, yuv420_preprocess,
                                    yuv422_preprocess, yuv444_preprocess)

    nv12 = (nv12_preprocess.nv12_preprocess,
            nv12_preprocess.nv12_preprocess_plain)
    i420 = (yuv420_preprocess.yuv420_preprocess,
            yuv420_preprocess.yuv420_preprocess_plain)
    return {F.NV12: nv12, F.P10: nv12, F.YUV420: i420, F.YUV420_10bit: i420,
            F.YUV422: (yuv422_preprocess.yuv422_preprocess,
                       yuv422_preprocess.yuv422_preprocess_plain),
            F.YUV444: (yuv444_preprocess.yuv444_preprocess,
                       yuv444_preprocess.yuv444_preprocess_plain)}


def kernel_and_plain(torch, p, fmt, **kw):
    """(kernel call, plain-version call) with the same arguments on the same
    1080p device planes ``p``; BT.709 / MPEG and 224x224 unless ``kw``
    names another colour space and range or output size."""
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat

    kw = dict(dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG,
                   dst_w=DW, dst_h=DH), **kw, src_w=W, src_h=H)
    kern, plain = preprocess_kernels()[PixelFormat(fmt)]
    if fmt in (PixelFormat.NV12, PixelFormat.P10):
        p = p[:1]
    return (lambda: kern(*p, **kw)), (lambda: plain(*p, **kw))


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
    from vali_tpu_torch.ops.yuv422_preprocess import yuv422_preprocess
    from vali_tpu_torch.ops.yuv444_preprocess import yuv444_preprocess
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
    # the product's and the labs' kernel libraries, their nvcc processes
    # all started together
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        lab_build = pool.submit(timed_build, _cuda_build.load_lab_kernels)
        product_s = timed_build(_cuda_build.load_kernels)
        lab_s = lab_build.result()
    log(f"kernel_build_s={time.perf_counter() - t0:.3f} "
        f"(product {product_s:.3f}, labs {lab_s:.3f}, built together) "
        f"library={_cuda_build.library_path()} "
        f"lab_library={_cuda_build.lab_library_path()}")
    clock = [time.perf_counter()]

    def lap(phase):
        """Log the host seconds since the last lap."""
        now = time.perf_counter()
        log(f"phase_s {phase}={now - clock[0]:.1f}")
        clock[0] = now

    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    jpeg601 = dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG)
    geo = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)
    rng = np.random.default_rng(2024)
    host = {fmt: make_frames(np, rng, fmt, B, W, H)
            for fmt in (PixelFormat.NV12, PixelFormat.P10,
                        PixelFormat.YUV420, PixelFormat.YUV420_10bit,
                        PixelFormat.YUV422, PixelFormat.YUV444)}
    planes = {fmt: BatchStager(fmt, W, H, dev).split(
        torch.from_numpy(x).to(dev)) for fmt, x in host.items()}

    def run_pair(fmt, **kw):
        return kernel_and_plain(torch, planes[fmt], fmt, **kw)

    # ---- the four preprocess kernels: kernel vs plain on the card --------
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
        ("kernel_yuv422 u8/bf16 bt601/jpeg", PixelFormat.YUV422, jpeg601),
        ("kernel_yuv422 u8/f32", PixelFormat.YUV422,
         dict(compute_dtype=torch.float32)),
        ("kernel_yuv444 u8/bf16", PixelFormat.YUV444, {}),
        ("kernel_yuv444 u8->f32+norm", PixelFormat.YUV444,
         dict(out_dtype=torch.float32, normalize=NORM)),
        ("kernel_yuv444 u8->bf16+norm", PixelFormat.YUV444,
         dict(out_dtype=torch.bfloat16, normalize=NORM)),
    ]
    for name, fmt, kw in cases:
        kern, plain = run_pair(fmt, **kw)
        wrapper = preprocess_kernels()[fmt][0]
        before = launch_counts(wrapper)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if launched_since(before, wrapper)[wrapper.__name__] != 1:
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
    # 4:2:2 and 4:4:4 at the reference's envelope for its own kernels
    # against the dense route (tests/test_pipeline.py:307-309)
    for fmt, fn in ((PixelFormat.YUV422, yuv422_preprocess),
                    (PixelFormat.YUV444, yuv444_preprocess)):
        small = make_frames(np, rng, fmt, 4, 256, 144)
        sp = BatchStager(fmt, 256, 144, dev).split(
            torch.from_numpy(small).to(dev))
        out = fn(*sp, src_w=256, src_h=144, dst_w=96, dst_h=64,
                 compute_dtype=torch.float32, **bt709)
        ref = fused_preprocess(sp, fmt, 256, 144, 96, 64, planar=True,
                               **bt709)
        d = (out.int() - ref.int()).abs().double()
        log(f"{fn.__name__} f32 vs dense route 256x144->96x64: "
            f"max_abs_diff={d.max().item()} mean_abs_diff={d.mean().item()}")
        if out.shape != ref.shape or d.max().item() > 4 or \
                d.mean().item() >= 1.0:
            raise AssertionError(f"{fn.__name__} outside the envelope of "
                                 f"the dense route")

    lap("preprocess kernels vs plain and dense")

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
            ("nv12", PixelFormat.NV12, {}, DW, DH),
            ("yuv422", PixelFormat.YUV422, jpeg601, DW, DH),
            ("yuv444", PixelFormat.YUV444, {}, DW, DH))
    pipes = {name: MultiStreamPipeline(
        sources(fmt, MAIN_BATCHES), dw, dh, gpu_id=0, batch_size=B,
        sync_streams=True, **dict(bt709, **kw))
        for name, fmt, kw, dw, dh in runs}
    wrappers = (nv12_preprocess, yuv420_preprocess, yuv422_preprocess,
                yuv444_preprocess)
    # each pipeline run read on its own: every count read just before and
    # just after, so that each launch shape has its own count
    main, per_run = {}, {}
    for name, pipe in pipes.items():
        before = launch_counts(*wrappers)
        main[name] = list(pipe)
        torch.cuda.synchronize()
        per_run[name] = launched_since(before, *wrappers)
    launches = {w.__name__: sum(r[w.__name__] for r in per_run.values())
                for w in wrappers}
    log(f"main_path_launches={json.dumps(launches)} "
        f"by_run={json.dumps(per_run)}")
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
        "yuv422": yuv422_preprocess(*planes[PixelFormat.YUV422], **jpeg601,
                                    **geo).movedim(1, -1),
        "yuv444": yuv444_preprocess(*planes[PixelFormat.YUV444], **bt709,
                                    **geo).movedim(1, -1),
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
        f"{MAIN_BATCHES} batches each: yuv420 {H}p->{DH}x{DW}, nv12, "
        f"yuv422 (bt601/jpeg) and yuv444 same, yuv420 letterbox "
        f"{LETTERBOX}x{LETTERBOX} (inner {iw}x{ih}) bf16+norm; every batch "
        f"equal to the kernel output")

    lap("main path")

    # ---- decode -> pipeline, when the native engine builds here ----------
    no_engine = native_engine_missing()
    if no_engine:
        log(f"pipeline_decode: skipped: {no_engine}")
    else:
        decode_phase(torch, np, dev)

    lap("decode")

    # ---- times at every shape the main path launches a kernel at --------
    # (case, wrapper, format, main-path run, chroma layout, keywords, dst)
    letterbox = dict(out_dtype=torch.bfloat16, normalize=NORM)
    shapes = (
        (f"nv12 {H}p->{DW}x{DH} u8/bf16", "nv12_preprocess", PixelFormat.NV12,
         "nv12", "420", {}, (DW, DH)),
        (f"yuv420 {H}p->{DW}x{DH} u8/bf16", "yuv420_preprocess",
         PixelFormat.YUV420, "yuv420", "420", {}, (DW, DH)),
        (f"yuv420 letterbox {H}p->{iw}x{ih} bf16+norm",
         "yuv420_preprocess", PixelFormat.YUV420, "yuv420 letterbox", "420",
         letterbox, (iw, ih)),
        (f"yuv422 {H}p->{DW}x{DH} u8/bf16 bt601/jpeg", "yuv422_preprocess",
         PixelFormat.YUV422, "yuv422", "422", jpeg601, (DW, DH)),
        (f"yuv444 {H}p->{DW}x{DH} u8/bf16", "yuv444_preprocess",
         PixelFormat.YUV444, "yuv444", "444", {}, (DW, DH)))
    times, timed_shapes = {}, {}
    for case, name, fmt, run, layout, kw, (dw, dh) in shapes:
        kern, plain = kernel_and_plain(torch, planes[fmt], fmt, dst_w=dw,
                                       dst_h=dh, **kw)
        # held to the plain version at this shape, then timed
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        shape_err = compare(torch, f"kernel_{name} {case}", out, ref)
        del out, ref
        t_kern, t_plain = time_pair(kern, plain)
        out_b = 2 if kw.get("out_dtype") == torch.bfloat16 else 1
        nbytes, ops = preprocess_work(B, W, H, dw, dh, layout,
                                      out_bytes=out_b)
        bound, bound_by = bound_ms(nbytes, ops)
        n = per_run[run][name]
        timed_shapes.setdefault(name, []).append({
            "case": case, "ms": t_kern, "plain_ms": t_plain,
            "bound_ms": bound, "bound_by": bound_by, "launches": n,
            "max_abs_err": shape_err, "timed": "kernel"})
        times.setdefault(name, (t_kern, t_plain))
        log(f"time {name} {B}x {case}: kernel_ms={t_kern} "
            f"plain_ms={t_plain} bound_ms={bound} bound_by={bound_by} "
            f"main_path_launches={n} kernel_fps={B / (t_kern * 1e-3)} "
            f"kernel_GBps={nbytes / (t_kern * 1e-3) / 1e9} ({smi})")

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
    h2d_ms = time_ms(lambda: pinned.to(dev, non_blocking=True))
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

    lap("preprocess times and pipeline rate")
    surface = surface_phases(torch, np, dev, host[PixelFormat.NV12], smi,
                             times["nv12_preprocess"][0])
    lap("surface")
    rotate_ud_phase(torch, np, host[PixelFormat.NV12][0],
                    host[PixelFormat.YUV422][0], smi)
    lap("rotate and ud")
    lab = lab_phase(torch, np, dev, smi)
    lap("kernel-variant lab")
    lab += resize_lab_phase(torch, np, dev, smi)
    lap("resize lab")
    lab += convert_lab_phase(torch, np, dev, smi)
    lap("convert lab")
    infer_shape, infer_launches = inference_phase(
        torch, np, dev, host[PixelFormat.YUV420], planes[PixelFormat.YUV420],
        smi)
    timed_shapes["yuv420_preprocess"].append(infer_shape)
    launches["yuv420_preprocess"] += infer_launches
    lap("inference")
    analysis_phase(torch, np, dev, planes[PixelFormat.YUV420], smi)
    lap("analysis")
    transcode_shapes, transcode_launches = transcode_device_phase(
        torch, np, dev, smi)
    lap("transcode device half")
    if no_engine:
        log(f"transcode: skipped: {no_engine}")
    else:
        transcode_phase(torch, np, dev, smi)
    lap("transcode")
    # transcode's two shapes join plane_resize's entry of the Surface path
    pr = next(e for e in surface if e["name"] == "plane_resize")
    pr["shapes"] += transcode_shapes
    pr["launches"] += transcode_launches
    pr["max_abs_err"] = max([pr["max_abs_err"]] + [
        x["max_abs_err"] for x in transcode_shapes])
    pr["launch_weighted_ms"] = sum(
        x["ms"] * x["launches"] for x in pr["shapes"]) / sum(
        x["launches"] for x in pr["shapes"])
    mesh = mesh_phase(torch, np, dev, host, planes, smi)
    lap("mesh")
    samples = samples_phase(torch, np, dev, host[PixelFormat.YUV420],
                            planes[PixelFormat.YUV420], no_engine, smi)
    lap("samples")
    bench = bench_phase(torch, np, dev, no_engine, smi,
                        times["nv12_preprocess"][0],
                        sum(e["ms"] for e in surface
                            if e["name"] in ("nv12_to_rgb", "packed_resize")))
    lap("bench")
    # no single PyTorch call computes fused CSC + banded Lanczos:
    # library_ms is null
    preprocess = {  # wrapper: chroma layout, TPU kernel line, checked case
        "nv12_preprocess": ("420", 158, "kernel_nv12 u8/bf16"),
        "yuv420_preprocess": ("420", 786, "kernel_yuv420 u8/bf16"),
        "yuv422_preprocess": ("422", 600,
                              "kernel_yuv422 u8/bf16 bt601/jpeg"),
        "yuv444_preprocess": ("444", 359, "kernel_yuv444 u8/bf16")}
    # ms, plain_ms and bound_ms are each kernel's at 64 x 1080p -> 224;
    # "shapes" holds every shape the main path launches it at, with the
    # launches and the error against the plain version there,
    # launch_weighted_ms the mean over those launches, and max_abs_err
    # the largest error of all its comparisons
    kernels = []
    for name, (layout, line, case) in preprocess.items():
        bound, bound_by = bound_ms(*preprocess_work(B, W, H, DW, DH, layout))
        sh = timed_shapes[name]
        source = "vali_tpu_torch/csrc/banded_preprocess.cu"
        if name == "nv12_preprocess":   # its uint8 / bf16 / uint8 route
            source = ("vali_tpu_torch/csrc/nv12_wgmma_preprocess.cu, "
                      + source)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"vali_tpu/ops/pallas_fused.py:{line}",
            "launches": launches[name],
            "max_abs_err": max([err[case]] + [x["max_abs_err"] for x in sh]),
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "launch_weighted_ms": sum(x["ms"] * x["launches"] for x in sh)
            / max(1, sum(x["launches"] for x in sh)),
            "shapes": sh})
    kernels += surface + lab
    # the mesh path's, the samples' and the bench's launches and shapes
    # join each kernel's entry
    for entry in kernels:
        for more in (mesh, samples, bench):
            if entry["name"] not in more:
                continue
            shapes, n = more[entry["name"]]
            entry["launches"] += n
            entry["shapes"] += shapes
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                x["max_abs_err"] for x in shapes])
            entry["launch_weighted_ms"] = sum(
                x["ms"] * x["launches"] for x in entry["shapes"]) / max(
                1, sum(x["launches"] for x in entry["shapes"]))
    routes = route_phase(torch, dev, smi)
    lap("nv12_preprocess routes")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"nv12_preprocess_routes": routes}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: nv12_preprocess's uint8 shapes and who runs each: (who, batch,
#: src_w, src_h, dst_w, dst_h)
ROUTE_SHAPES = (
    ("fused_nv12_b64 / bench headline / MultiStreamPipeline", 64, W, H, DW,
     DH),
    ("sharded_kernel_preprocess position", 16, W, H, DW, DH),
    ("sample_profile", 8, 848, 464, DW, DH),
    ("bench 4K", 8, 3840, 2160, DW, DH),
    ("letterbox content", 64, W, H, 640, 360),
)


def route_phase(torch, dev, smi):
    """nv12_preprocess's route at each of ROUTE_SHAPES: the kernel it
    takes (``nv12_route``), the wrapper's output against the FMA kernel's
    own entry (``_nv12_preprocess_banded``: within the kernels' envelope,
    differing samples counted), and both timed, as wrapper calls with CUDA
    events and by their kernels' device time (torch.profiler), so that a
    shape where the route is slower than the FMA kernel shows. Returns one
    entry a shape."""
    from vali_tpu_torch.lab import kernel_variants as kv
    from vali_tpu_torch.lab.ab_common import kernel_ms
    from vali_tpu_torch.ops.nv12_preprocess import (_nv12_preprocess_banded,
                                                    nv12_preprocess,
                                                    nv12_route)

    entries = []
    for who, b, w, h, dw, dh in ROUTE_SHAPES:
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        x = kv.make_frames(b, h * 3 // 2, w, dev, seed=b + w + dw)
        route = nv12_route(x, **geo)
        shape = f"{b} x {w}x{h} -> {dw}x{dh}"
        calls = {"routed": lambda: nv12_preprocess(x, **geo),
                 "fma": lambda: _nv12_preprocess_banded(x, **geo)}
        routed, fma = calls["routed"](), calls["fma"]()
        torch.cuda.synchronize()
        err = compare(torch, f"route {who} {shape} ({route}) vs the FMA "
                      f"kernel", routed, fma)
        ndiff = int((routed != fma).sum().item())
        ms = {k: time_ms(fn) for k, fn in calls.items()}
        device = {k: sum(v.values()) for k, v in kernel_ms(calls).items()}
        entries.append({"who": who, "shape": shape, "route": route,
                        "wrapper_ms": ms, "device_ms": device,
                        "differ": ndiff, "samples": routed.numel(),
                        "max_abs_err": err})
        log(f"route nv12_preprocess {who} {shape}: route={route} "
            f"wrapper_ms routed={ms['routed']} fma={ms['fma']} "
            f"device_ms routed={device['routed']} fma={device['fma']} "
            f"(routed/fma {device['routed'] / device['fma']:.3f}) "
            f"differing={ndiff} of {routed.numel()} ({smi})")
        del x, routed, fma
    return entries


INFER_BATCHES = 12   # batches per stream on the pipeline + FCN run


def inference_phase(torch, np, dev, host, planes, smi):
    """The JAX bench's config 4 chain on the card: MultiStreamPipeline
    over 64 in-memory YUV420 1080p streams -> 224x224 float32, normalised
    with ImageNet mean and std, BT.709 MPEG (the yuv420_preprocess kernel;
    the golden oracle's settings) -> the full bf16 FCN with weights from a
    seeded numpy draw. Holds the card's logits of one batch to the same
    model on the CPU (the golden oracle's envelope), the classes of the
    kernel's batch to those of the plain version's batch, and the kernel's
    launches on this path; times the FCN forward (CUDA events), pipeline +
    FCN (host clock over 11 batches) and the card's busy share. Returns
    the kernel's shape entry and its launches on this path."""
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.models import fcn
    from vali_tpu_torch.ops.yuv420_preprocess import (
        yuv420_preprocess, yuv420_preprocess_plain)
    from vali_tpu_torch.pipeline.multistream import MultiStreamPipeline
    from vali_tpu_torch.utils.synth import HostFrameSource

    kw = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG,
              out_dtype=torch.float32, normalize=NORM)
    params = fcn.numpy_params(np.random.default_rng(4))
    model = fcn.params_from_numpy(params, dev, dtype=torch.bfloat16)
    sources = [HostFrameSource([host[(s + k) % B]
                                for k in range(INFER_BATCHES)],
                               PixelFormat.YUV420, W, H) for s in range(B)]
    pipe = MultiStreamPipeline(sources, DW, DH, gpu_id=0, batch_size=B,
                               sync_streams=True, **kw)
    with torch.inference_mode():
        before = launch_counts(yuv420_preprocess)
        n = 0
        for batch, ids in pipe:
            classes = fcn.predict_classes(model, batch)
            if n == 0:
                first, first_ids, first_classes = batch, ids, classes
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = launched_since(before, yuv420_preprocess)[
            "yuv420_preprocess"]
        log("inference_path_launches=" + json.dumps(
            {"yuv420_preprocess": launches}))
        if n != INFER_BATCHES or launches < 1:
            raise AssertionError(f"inference path: {n} batches, "
                                 f"{launches} kernel launches")
        if first_ids != list(range(B)) or first.shape != (B, DH, DW, 3):
            raise AssertionError("inference path: bad first batch")

        # the card's logits against the same model on the CPU
        logits = fcn.apply(model, first)
        host_model = fcn.params_from_numpy(params, torch.device("cpu"),
                                           dtype=torch.bfloat16)
        want = fcn.apply(host_model, first.cpu()).float()
        got = logits.float().cpu()
        scale = max(want.abs().max().item(), 1.0)
        rel = (got - want).abs().max().item() / scale
        hist_g = torch.stack([torch.bincount(g.argmax(-1).reshape(-1),
                                             minlength=21) for g in got])
        hist_w = torch.stack([torch.bincount(w.argmax(-1).reshape(-1),
                                             minlength=21) for w in want])
        agree = (torch.minimum(hist_g, hist_w).sum(1)
                 / hist_w.sum(1)).min().item()
        log(f"fcn card vs cpu ({B}x{DH} bf16): max_abs_diff/max_logit={rel} "
            f"min_class_hist_agreement={agree}")
        if not torch.isfinite(got).all() or rel > 0.02 or agree <= 0.98:
            raise AssertionError("fcn: the card's logits are outside the "
                                 "golden envelope of the CPU's")

        # the kernel's batch against the plain version's, and its classes
        plain_fn = (lambda: yuv420_preprocess_plain(
            *planes, src_w=W, src_h=H, dst_w=DW, dst_h=DH, **kw))
        kern_fn = (lambda: yuv420_preprocess(
            *planes, src_w=W, src_h=H, dst_w=DW, dst_h=DH, **kw))
        plain = plain_fn().movedim(1, -1)
        err = compare(torch, "inference batch kernel vs plain (yuv420 "
                      "f32+norm)", first, plain)
        same = (fcn.predict_classes(model, plain) == first_classes)
        agree_k = same.double().mean().item()
        log(f"fcn classes, kernel batch vs plain batch: agreement={agree_k}")
        if agree_k <= 0.98:
            raise AssertionError("fcn classes of the kernel's batch differ "
                                 "from the plain version's")

        t_kern, t_plain = time_pair(kern_fn, plain_fn)
        fcn_ms = time_ms(lambda: fcn.apply(model, first))
        io_b, layer_b, ops = fcn_work(B, DH, DW, fcn.WIDTHS,
                                         fcn.NUM_CLASSES)
        fcn_bound, fcn_by = bound_ms(io_b, ops)
        layer_bound, layer_by = bound_ms(layer_b, ops)
        profiled = MultiStreamPipeline(
            [HostFrameSource([host[(s + k) % B] for k in range(8)],
                             PixelFormat.YUV420, W, H) for s in range(B)],
            DW, DH, gpu_id=0, batch_size=B, sync_streams=True, **kw)
        busy, busy_ms, prof_ms = device_busy_share(
            torch, profiled, lambda item: fcn.predict_classes(model,
                                                              item[0]))
    timed = n - 1
    fps = timed * B / (wall_ms * 1e-3)
    nbytes, pops = preprocess_work(B, W, H, DW, DH, "420", out_bytes=4)
    bound, bound_by = bound_ms(nbytes, pops)
    log(f"time yuv420_preprocess {B}x {H}p->{DW}x{DH} f32+norm: "
        f"kernel_ms={t_kern} plain_ms={t_plain} bound_ms={bound} "
        f"bound_by={bound_by} inference_path_launches={launches} ({smi})")
    log(f"time fcn forward {B}x{DH}x{DW} bf16: ms_per_batch={fcn_ms} "
        f"bound_ms={fcn_bound} bound_by={fcn_by} (input read and logits "
        f"written once, {ops / 1e9:.2f} GFLOP) layer_by_layer_bound_ms="
        f"{layer_bound} bound_by={layer_by} ({layer_b / 1e9:.3f} GB with "
        f"each layer's bf16 activations written and read once) ({smi})")
    log(f"time pipeline+fcn {B} streams YUV420 {H}p->{DH}x{DW} f32+norm -> "
        f"FCN classes, host clock over {timed} batches: "
        f"ms_per_batch={wall_ms / timed} fps={fps} "
        f"busy_share_from_event_times={timed * (t_kern + fcn_ms) / wall_ms} "
        f"profiler_busy_share={busy} (device {busy_ms} ms of {prof_ms} ms, "
        f"batches 3-8 of 8 under torch.profiler) ({smi})")
    log("inference: ok, MultiStreamPipeline -> yuv420_preprocess f32+norm "
        "-> FCN bf16; card logits within the golden envelope of the CPU's, "
        "kernel and plain classes agree")
    shape = {"case": f"yuv420 inference {H}p->{DW}x{DH} f32+norm",
             "ms": t_kern, "plain_ms": t_plain, "bound_ms": bound,
             "bound_by": bound_by, "launches": launches,
             "max_abs_err": err, "timed": "kernel"}
    return shape, launches


def tonemap_toe_outliers(got, want, d, peak):
    """Samples more than 1 LSB apart whose linear light (the codes
    through the display gamma 2.4) also differs by more than 1e-4 of full
    scale. Near black the 1/2.4 gamma's slope is unbounded: float32
    noise of the two devices' power functions, amplified by the gamut
    matrix's cancellation at the clip boundary, moves dark codes by a few
    LSB while their light agrees."""
    lin = ((got.double() / peak) ** 2.4
           - (want.double() / peak) ** 2.4).abs()
    return int(((d > 1) & (lin > 1e-4)).sum().item())


def device_busy_share(torch, items, consume, skip=2):
    """(busy share, device ms, wall ms) of ``consume(item)`` over the items
    of ``items`` after the first ``skip`` (the steady window), under
    torch.profiler: the union of the card's kernel and copy intervals
    over the host wall time; the share is None where the trace holds no
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    items = iter(items)
    for _ in range(skip):
        consume(next(items))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for item in items:
            consume(item)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not spans:
        return None, None, wall_ms
    return busy_us / 1e3 / wall_ms, busy_us / 1e3, wall_ms


def analysis_phase(torch, np, dev, planes, smi):
    """The batched QC ops on the card at the sizes users run, each held to
    the same port function on the CPU with the same inputs copied back and
    timed with CUDA events: histograms, luma statistics and scene-change
    scores of the 64 x 1080p luma planes of the preprocess sources; PSNR
    and SSIM between the yuv420 kernel's and its plain version's
    64 x 224 outputs, and on 16 x 1080p luma pairs; tone mapping (PQ,
    BT.2390 -> uint8) of 16 x 1080p uint16 RGB with P010-style MSB codes;
    the device stage of JPEG encode (RGB, 4:2:0, q = 85) on the 64 x 224
    uint8 batch and on the 16 x 1080p tone-mapped RGB."""
    from vali_tpu_torch.core.enums import PixelFormat
    from vali_tpu_torch.ops import analytics, jpeg, metrics, tonemap

    cpu = torch.device("cpu")
    rng = np.random.default_rng(5)
    luma = planes[0][:, :H]

    def timed(name, fn, samples=5, calls=2):
        ms = time_ms(fn, samples=samples, calls=calls)
        log(f"time {name}: ms_per_batch={ms} ({smi})")
        return ms

    def close(name, got, want, rtol):
        torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=0,
                                   msg=lambda m: f"{name}: {m}")
        log(f"{name} card vs cpu: within rtol {rtol}")

    def equal(name, got, want):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: the card and the CPU differ")
        log(f"{name} card vs cpu: equal")

    # exposure and shot analytics on the 64 luma planes
    luma_c = luma.cpu()
    equal(f"histogram_batch {B}x{H}p", analytics.histogram_batch(luma),
          analytics.histogram_batch(luma_c))
    st, st_c = analytics.luma_stats_batch(luma), \
        analytics.luma_stats_batch(luma_c)
    for k in st:
        close(f"luma_stats_batch[{k}] {B}x{H}p", st[k], st_c[k], 1e-5)
    close(f"scene_change_scores {B}x{H}p",
          analytics.scene_change_scores(luma),
          analytics.scene_change_scores(luma_c), 1e-5)
    n_cuts = []
    for threshold in (0.3, 0.1):   # the default, and one the frames cross
        cuts = analytics.detect_scene_changes(luma, threshold)
        cuts_c = analytics.detect_scene_changes(luma_c, threshold)
        if not np.array_equal(cuts, cuts_c):
            raise AssertionError(f"scene cuts at {threshold} differ: "
                                 f"{cuts} / {cuts_c}")
        n_cuts.append(len(cuts))
    log(f"detect_scene_changes {B}x{H}p card vs cpu: equal, {n_cuts} cuts "
        f"at thresholds 0.3, 0.1")
    if not any(n_cuts):
        raise AssertionError("no scene cut found: the comparison is empty")
    timed(f"histogram_batch {B}x{H}p", lambda: analytics.histogram_batch(
        luma))
    timed(f"luma_stats_batch {B}x{H}p",
          lambda: analytics.luma_stats_batch(luma))
    timed(f"scene_change_scores {B}x{H}p",
          lambda: analytics.scene_change_scores(luma))

    # quality metrics: the kernel's 224 batch against the plain version's
    kern, plain = kernel_and_plain(torch, planes, PixelFormat.YUV420)
    a, b = kern().movedim(1, -1), plain().movedim(1, -1)
    a_c, b_c = a.cpu(), b.cpu()
    for fn in (metrics.psnr_batch, metrics.ssim_batch):
        close(f"{fn.__name__} {B}x{DH} kernel vs plain", fn(a, b),
              fn(a_c, b_c), 1e-5)
        timed(f"{fn.__name__} {B}x{DH}x{DW}x3", lambda: fn(a, b))
    x = luma[:16]
    noise = torch.from_numpy(rng.integers(-8, 9, tuple(x.shape),
                                          dtype=np.int16)).to(dev)
    y = (x.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)
    x_c, y_c = x.cpu(), y.cpu()
    close(f"ssim_batch 16x{H}p luma pairs", metrics.ssim_batch(x, y),
          metrics.ssim_batch(x_c, y_c), 1e-4)
    close(f"psnr_batch 16x{H}p luma pairs", metrics.psnr_batch(x, y),
          metrics.psnr_batch(x_c, y_c), 1e-5)
    timed(f"ssim_batch 16x{H}p", lambda: metrics.ssim_batch(x, y))

    # HDR -> SDR: P010-style MSB codes
    hdr = torch.from_numpy(rng.integers(0, 1024, (16, H, W, 3),
                                        dtype=np.uint16) << 6).to(dev)
    sdr = tonemap.tonemap_batch(hdr)
    sdr_c = tonemap.tonemap_batch(hdr.cpu())
    d = (sdr.cpu().int() - sdr_c.int()).abs()
    frac = (d > 0).double().mean().item()
    toe = tonemap_toe_outliers(sdr.cpu(), sdr_c, d, 255.0)
    log(f"tonemap_batch pq/bt2390 16x{H}p u16->u8 card vs cpu: "
        f"max_abs_diff={d.max().item()} frac_diff={frac} "
        f"beyond_1_lsb_outside_the_toe={toe}")
    if toe or frac >= 1e-3:
        raise AssertionError("tonemap_batch: the card and the CPU differ "
                             "beyond the envelope")
    timed(f"tonemap_batch 16x{H}p", lambda: tonemap.tonemap_batch(hdr))

    # the device stage of JPEG encode
    def jpeg_pair(name, rgb):
        n, h, w, _ = rgb.shape
        kw = dict(src_fmt=int(PixelFormat.RGB), width=w, height=h,
                  quality=85, subsample420=True)
        packed = rgb.reshape(n, h, 3 * w)
        got = jpeg.jpeg_transform_batch((packed,), **kw)
        want = jpeg.jpeg_transform_batch((packed.cpu(),), **kw)
        for plane, g, c in zip("y cb cr".split(), got, want):
            d = (g.cpu().int() - c.int()).abs()
            frac = (d > 0).double().mean().item()
            log(f"{name} {plane} card vs cpu: max_abs_diff="
                f"{d.max().item()} frac_diff={frac}")
            if g.dtype != torch.int16 or d.max().item() > 1 or frac >= 1e-4:
                raise AssertionError(f"{name} {plane}: the card and the CPU "
                                     f"differ")
        return timed(f"jpeg_device_ms_per_batch {name}",
                     lambda: jpeg.jpeg_transform_batch((packed,), **kw))

    jpeg_224 = jpeg_pair(f"jpeg_transform_batch {B}x{DH}x{DW} rgb 4:2:0 q85",
                         a)
    jpeg_1080 = jpeg_pair(f"jpeg_transform_batch 16x{H}p rgb 4:2:0 q85", sdr)
    log(f"analysis: ok, histograms and cuts equal, statistics, scores, "
        f"PSNR and SSIM within rtol, tone mapping within 1 LSB on < 1e-3 "
        f"(beyond it only in the gamma's toe), JPEG coefficients within 1 "
        f"on < 1e-4; jpeg_device_ms_per_batch={jpeg_224} "
        f"({B}x{DH}) {jpeg_1080} (16x{H}p) ({smi})")


# 4K sources of the resize phases: batch, geometry
B4K, H4K, W4K = 16, 2160, 3840
SURFACE_W, SURFACE_H = 640, 360   # Surface path, part A
HALF_W, HALF_H = 960, 540         # Surface path, part B


def check_envelope(torch, name, out, ref, max_lsb, max_frac_above_1=None,
                   min_psnr=None):
    """Kernel against the dense exact route, at the reference's own
    envelope: max |diff| <= max_lsb, the share of samples more than 1 LSB
    off below ``max_frac_above_1``, PSNR above ``min_psnr``."""
    d = (out.double() - ref.double()).abs()
    peak = 255.0 if out.dtype == torch.uint8 else 65535.0
    mse = (d * d).mean().item()
    psnr = float("inf") if mse == 0 else 10 * torch.log10(
        torch.tensor(peak * peak / mse)).item()
    above = (d > 1).double().mean().item()
    log(f"{name}: max_abs_diff={d.max().item()} frac_above_1={above} "
        f"psnr_db={psnr}")
    if out.shape != ref.shape or d.max().item() > max_lsb:
        raise AssertionError(f"{name}: outside the envelope")
    if max_frac_above_1 is not None and above >= max_frac_above_1:
        raise AssertionError(f"{name}: too many samples above 1 LSB")
    if min_psnr is not None and psnr <= min_psnr:
        raise AssertionError(f"{name}: PSNR {psnr} <= {min_psnr}")


def surface_phases(torch, np, dev, nv12_host, smi, fused_ms):
    """The Surface path's four kernels against their plain versions and the
    exact route, the Surface path itself through the public entry points,
    and its times. Returns the four kernels' entries of the JSON line."""
    import vali_tpu_torch as vali
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.ops import csc, resize
    from vali_tpu_torch.ops.nv12_resize import nv12_resize, nv12_resize_plain
    from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb, nv12_to_rgb_plain
    from vali_tpu_torch.ops.packed_resize import (packed_resize,
                                                  packed_resize_plain)
    from vali_tpu_torch.ops.plane_resize import (plane_resize,
                                                 plane_resize_plain)
    from vali_tpu_torch.utils.device import new_stream

    F = PixelFormat
    f32 = dict(compute_dtype=torch.float32)
    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    bt601 = dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG, swap=True)
    rng = np.random.default_rng(7)
    nv12 = torch.from_numpy(nv12_host).to(dev).view(B, H * 3 // 2, W)
    rgb = nv12_to_rgb(nv12, src_w=W, src_h=H, **bt709)
    rgb32 = rgb.float() / 255.0
    planar32 = rgb32.view(B, H, W, 3).permute(0, 3, 1, 2).reshape(
        B * 3, H, W)
    nv4k = torch.from_numpy(make_frames(np, rng, F.NV12, B4K, W4K, H4K)).to(
        dev).view(B4K, H4K * 3 // 2, W4K)
    p10 = torch.from_numpy(make_frames(np, rng, F.P10, B4K, W4K, H4K)).to(
        dev).view(torch.uint16).view(B4K, H4K * 3 // 2, W4K)
    gray12 = torch.from_numpy(make_frames(np, rng, F.GRAY12, B4K, W4K,
                                          H4K)).to(dev).view(
        torch.uint16).view(B4K, H4K, W4K)
    y4k, u4k, v4k = csc.nv12_split(nv4k, H4K)
    uv4k = torch.cat([u4k, v4k]).contiguous()  # stacked U / V planes

    def pair(fn, plain, x, **kw):
        return (lambda: fn(x, **kw)), (lambda: plain(x, **kw))

    to_rgb = dict(src_w=W, src_h=H)
    to_224 = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)
    to_360 = dict(src_w=W, src_h=H, dst_w=SURFACE_W, dst_h=SURFACE_H)
    to_1080 = dict(src_w=W4K, src_h=H4K, dst_w=W, dst_h=H)
    cases = {
        "nv12_to_rgb rgb bt709/mpeg bf16": pair(
            nv12_to_rgb, nv12_to_rgb_plain, nv12, **to_rgb, **bt709),
        "nv12_to_rgb rgb bt709/mpeg f32": pair(
            nv12_to_rgb, nv12_to_rgb_plain, nv12, **to_rgb, **bt709, **f32),
        "nv12_to_rgb bgr bt601/jpeg bf16": pair(
            nv12_to_rgb, nv12_to_rgb_plain, nv12, **to_rgb, **bt601),
        "nv12_to_rgb bgr bt601/jpeg f32": pair(
            nv12_to_rgb, nv12_to_rgb_plain, nv12, **to_rgb, **bt601, **f32),
        "packed_resize rgb 1080p->224 u8": pair(
            packed_resize, packed_resize_plain, rgb, **to_224),
        "packed_resize rgb 1080p->640x360 u8": pair(
            packed_resize, packed_resize_plain, rgb, **to_360),
        "packed_resize rgb_32f 1080p->224 f32": pair(
            packed_resize, packed_resize_plain, rgb32, **to_224),
        "nv12_resize 4k->1080p bf16": pair(
            nv12_resize, nv12_resize_plain, nv4k, **to_1080),
        "nv12_resize 4k->1080p f32": pair(
            nv12_resize, nv12_resize_plain, nv4k, **to_1080, **f32),
        "nv12_resize p10 4k->1080p": pair(
            nv12_resize, nv12_resize_plain, p10, **to_1080),
        "plane_resize y 4k->1080p u8": pair(
            plane_resize, plane_resize_plain, y4k, src_h=H4K, dst_h=H,
            dst_w=W),
        "plane_resize stacked u/v 4k->540p u8": pair(
            plane_resize, plane_resize_plain, uv4k, src_h=H4K // 2,
            dst_h=H // 2, dst_w=W // 2),
        "plane_resize gray12 4k->1080p u16": pair(
            plane_resize, plane_resize_plain, gray12, src_h=H4K, dst_h=H,
            dst_w=W),
        "plane_resize rgb_32f_planar 1080p->224 f32": pair(
            plane_resize, plane_resize_plain, planar32, src_h=H, dst_h=DH,
            dst_w=DW),
    }
    wrappers = {"nv12_to_rgb": nv12_to_rgb, "packed_resize": packed_resize,
                "nv12_resize": nv12_resize, "plane_resize": plane_resize}

    # ---- phase 1: kernel against plain version on the card ---------------
    err, outs = {}, {}
    for name, (kern, plain) in cases.items():
        wrapper = wrappers[name.split()[0]]
        before = launch_counts(wrapper)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if launched_since(before, wrapper)[wrapper.__name__] != 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        e = compare(torch, name, out, ref)
        if name.startswith("nv12_to_rgb") and not torch.equal(out, ref):
            raise AssertionError(f"{name}: not bit-equal to the plain "
                                 f"version")
        err.setdefault(name.split()[0], e)
        outs[name] = out

    # ---- phase 2: kernel against the dense exact route -------------------
    exact_rgb = csc.convert_batch((nv12,), F.NV12, F.RGB, W, H,
                                  vali.ColorspaceConversionContext(
                                      ColorSpace.BT_709, ColorRange.MPEG),
                                  use_kernel=False)[0]
    check_envelope(torch, "nv12_to_rgb bf16 vs exact route",
                   outs["nv12_to_rgb rgb bt709/mpeg bf16"], exact_rgb, 2,
                   max_frac_above_1=1e-2)
    check_envelope(torch, "nv12_to_rgb f32 vs exact route",
                   outs["nv12_to_rgb rgb bt709/mpeg f32"], exact_rgb, 1)
    lanczos_aa = resize.LANCZOS_AA
    exact_nv = resize.resize_batch((nv4k,), F.NV12, W4K, H4K, W, H,
                                   lanczos_aa, use_kernel=False)[0]
    check_envelope(torch, "nv12_resize bf16 vs exact route, all frames",
                   outs["nv12_resize 4k->1080p bf16"], exact_nv, 3)
    # the PSNR envelope is the reference's on its own content, uniform
    # random samples (tests/test_pallas_kernel.py:198-214): the even frames
    # of make_frames. On bright gradients the bf16-rounded weights' row
    # sums (+0.29 % per pass) lift the output by up to 1.5 LSB.
    check_envelope(torch, "nv12_resize bf16 vs exact route, random frames",
                   outs["nv12_resize 4k->1080p bf16"][::2], exact_nv[::2],
                   3, min_psnr=48.0)
    check_envelope(torch, "nv12_resize f32 vs exact route",
                   outs["nv12_resize 4k->1080p f32"], exact_nv, 1)
    check_envelope(
        torch, "nv12_resize p10 vs exact route",
        outs["nv12_resize p10 4k->1080p"],
        resize.resize_batch((p10,), F.P10, W4K, H4K, W, H, lanczos_aa,
                            use_kernel=False)[0], 1)
    check_envelope(torch, "plane_resize u8 vs exact route",
                   outs["plane_resize y 4k->1080p u8"],
                   resize.resize_plane(y4k, H, W, lanczos_aa), 3)
    check_envelope(torch, "plane_resize u8 f32 vs exact route",
                   plane_resize(y4k, src_h=H4K, dst_h=H, dst_w=W, **f32),
                   resize.resize_plane(y4k, H, W, lanczos_aa), 1)
    check_envelope(torch, "plane_resize u16 vs exact route",
                   outs["plane_resize gray12 4k->1080p u16"],
                   resize.resize_plane(gray12, H, W, lanczos_aa), 1)
    exact_224 = resize.resize_plane(rgb, DH, DW, lanczos_aa, channels=3)
    # bf16 H-pass rows are 1/256-relative: the reference's own envelope
    # for the bf16 packed resize is 4 LSB (tests/test_pallas_kernel.py:426)
    check_envelope(torch, "packed_resize u8 vs exact route",
                   outs["packed_resize rgb 1080p->224 u8"], exact_224, 4)
    check_envelope(torch, "packed_resize u8 f32 vs exact route",
                   packed_resize(rgb, **to_224, **f32), exact_224, 1)
    d32 = (outs["packed_resize rgb_32f 1080p->224 f32"] - resize.resize_plane(
        rgb32, DH, DW, lanczos_aa, channels=3)).abs().max().item()
    d32p = (outs["plane_resize rgb_32f_planar 1080p->224 f32"]
            - resize.resize_plane(planar32, DH, DW, lanczos_aa)
            ).abs().max().item()
    log(f"float32 resizes vs exact route: packed max_abs_diff={d32} "
        f"planar max_abs_diff={d32p}")
    if max(d32, d32p) > 1.0 / 255.0:
        raise AssertionError("float32 resize outside 1 LSB of the exact "
                             "route")

    # ---- phase 3: the Surface path, N = 1 per call -----------------------
    cc = vali.ColorspaceConversionContext(ColorSpace.BT_709,
                                          ColorRange.MPEG)
    want_a = packed_resize(rgb, **to_360, method=resize.LANCZOS)
    nv_1080 = nv12_resize(nv4k, **to_1080, method=resize.LANCZOS)
    y1, u1, v1 = csc.nv12_split(nv_1080, H)
    y_half = plane_resize(y1, src_h=H, dst_h=HALF_H, dst_w=HALF_W,
                          method=resize.LANCZOS)
    c_half = plane_resize(torch.cat([u1, v1]), src_h=H // 2,
                          dst_h=HALF_H // 2, dst_w=HALF_W // 2,
                          method=resize.LANCZOS)
    want_b = torch.cat([y_half.flatten(1), c_half[:B4K].flatten(1),
                        c_half[B4K:].flatten(1)], dim=1).cpu().numpy()
    side = new_stream(0)
    up = vali.PyFrameUploader(gpu_id=0)
    src = vali.Surface.Make(F.NV12, W, H, gpu_id=0)
    full = vali.Surface.Make(F.RGB, W, H, gpu_id=0)
    small = vali.Surface.Make(F.RGB, SURFACE_W, SURFACE_H, gpu_id=0)
    view = torch.from_dlpack(small)  # taken before the first Run
    cvt = vali.PySurfaceConverter(gpu_id=0, stream=side.handle)
    rsz = vali.PySurfaceResizer(F.RGB, gpu_id=0, stream=side.handle)
    event = vali.CudaStreamEvent(cvt.Stream, 0)
    ok = (True, vali.TaskExecInfo.SUCCESS)

    def surface_a(i):
        """Part A on frame i: upload, then RunAsync of the converter and
        the resizer on a side stream, then an event."""
        if (up.Run(nv12_host[i], src) != ok
                or cvt.RunAsync(src, full, cc) != ok
                or rsz.RunAsync(full, small) != ok):
            raise AssertionError(f"surface path A failed on frame {i}")
        event.Record()
        event.Wait()

    src4k = vali.Surface.Make(F.NV12, W4K, H4K, gpu_id=0)
    mid = vali.Surface.Make(F.NV12, W, H, gpu_id=0)
    yuv = vali.Surface.Make(F.YUV420, W, H, gpu_id=0)
    half = vali.Surface.Make(F.YUV420, HALF_W, HALF_H, gpu_id=0)
    down = vali.PySurfaceDownloader(gpu_id=0)
    rsz_nv = vali.PySurfaceResizer(F.NV12, gpu_id=0, turbo=True)
    rsz_yuv = vali.PySurfaceResizer(F.YUV420, gpu_id=0, turbo=True)
    cvt_sync = vali.PySurfaceConverter(gpu_id=0)
    host_out = np.zeros(1, np.uint8)

    def surface_b(i):
        """Part B on 4K frame i, synchronous Run calls."""
        src4k.plane_tensors()[0].copy_(nv4k[i])
        if (rsz_nv.Run(src4k, mid) != ok or cvt_sync.Run(mid, yuv) != ok
                or rsz_yuv.Run(yuv, half) != ok
                or down.Run(half, host_out) != ok):
            raise AssertionError(f"surface path B failed on frame {i}")

    def counted(run):
        """{wrapper: launches} of ``run()``: every count read just before
        and just after."""
        before = launch_counts(*wrappers.values())
        run()
        torch.cuda.synchronize()
        return launched_since(before, *wrappers.values())

    def path_a():
        for i in range(B):
            surface_a(i)
            if not torch.equal(view,
                               want_a[i].view(SURFACE_H, SURFACE_W, 3)):
                raise AssertionError(f"surface path A frame {i} differs "
                                     f"from the batched kernels")

    def path_b():
        for i in range(B4K):
            surface_b(i)
            if not np.array_equal(host_out, want_b[i]):
                raise AssertionError(f"surface path B frame {i} differs "
                                     f"from the batched kernels")

    def two_stage():
        rgbp = csc.convert_batch((nv12,), F.NV12, F.RGB, W, H, cc)
        return resize.resize_batch(rgbp, F.RGB, W, H, DW, DH, lanczos_aa)

    def two_stage_checked():
        if not torch.equal(two_stage()[0],
                           outs["packed_resize rgb 1080p->224 u8"]):
            raise AssertionError("two-stage convert + resize differs from "
                                 "the batched kernels")

    # each main path read on its own; one frame of B shows that its plane
    # launches are one Y and one stacked U/V resize a frame
    runs = {"surface_a": counted(path_a), "surface_b": counted(path_b),
            "two_stage": counted(two_stage_checked)}
    per_b_frame = counted(lambda: surface_b(0))["plane_resize"]
    launches = {name: sum(r[name] for r in runs.values())
                for name in wrappers}
    log(f"main_path_launches_by_path={json.dumps(runs)} "
        f"plane_resize_per_b_frame={per_b_frame}")
    if min(launches.values()) < 1 or per_b_frame != 2:
        raise AssertionError("a kernel of the Surface path was not launched")
    log(f"surface_path: ok, A: {B} 1080p NV12 frames uploaded, converted "
        f"to RGB and resized to {SURFACE_W}x{SURFACE_H} with RunAsync on a "
        f"side stream + CudaStreamEvent, each equal to the batched kernels "
        f"through a DLPack view taken before the first Run; B: {B4K} 4K "
        f"NV12 frames resized to 1080p (turbo), converted to YUV420, "
        f"resized to {HALF_W}x{HALF_H} (turbo) and downloaded, each equal "
        f"to the batched kernels; two-stage convert + resize equal to the "
        f"batched kernels")

    # ---- phase 4: times at every timed shape ----------------------------
    # the batched shapes, then each shape the Surface path launches at N = 1
    lanczos = dict(method=resize.LANCZOS)
    y_half_in, c_half_in = y1[:1], torch.cat([u1[:1], v1[:1]])
    n1_cases = {
        "nv12_to_rgb N=1 1080p bt709/mpeg": pair(
            nv12_to_rgb, nv12_to_rgb_plain, nv12[:1], **to_rgb, **bt709),
        "nv12_to_rgb N=1 1080p bt709/mpeg f32": pair(
            nv12_to_rgb, nv12_to_rgb_plain, nv12[:1], **to_rgb, **bt709,
            **f32),
        "packed_resize N=1 rgb 1080p->640x360 lanczos": pair(
            packed_resize, packed_resize_plain, rgb[:1], **to_360,
            **lanczos),
        "nv12_resize N=1 4k->1080p lanczos": pair(
            nv12_resize, nv12_resize_plain, nv4k[:1], **to_1080, **lanczos),
        "plane_resize N=1 y 1080p->540p lanczos": pair(
            plane_resize, plane_resize_plain, y_half_in, src_h=H,
            dst_h=HALF_H, dst_w=HALF_W, **lanczos),
        "plane_resize B=2 u/v 540p->270p lanczos": pair(
            plane_resize, plane_resize_plain, c_half_in, src_h=H // 2,
            dst_h=HALF_H // 2, dst_w=HALF_W // 2, **lanczos),
    }
    cases.update(n1_cases)
    # (bytes, operations) of one call of each timed case
    aa = resize.LANCZOS_AA

    def nv12_work(b, method):
        y = resize_work(b, H4K, W4K, H, W, 1, method)
        c = resize_work(b, H4K // 2, W4K // 2, H // 2, W // 2, 2, method)
        return y[0] + c[0], y[1] + c[1]

    timed = {  # case: (kernel, work, main-path launches at this shape)
        "nv12_to_rgb rgb bt709/mpeg bf16": (
            "nv12_to_rgb", (nv12.nbytes + rgb.nbytes, CSC_OPS * B * H * W),
            runs["two_stage"]["nv12_to_rgb"]),
        "nv12_to_rgb rgb bt709/mpeg f32": (
            "nv12_to_rgb", (nv12.nbytes + rgb.nbytes, CSC_OPS * B * H * W),
            0),
        "packed_resize rgb 1080p->224 u8": (
            "packed_resize", resize_work(B, H, W, DH, DW, 3, aa),
            runs["two_stage"]["packed_resize"]),
        "packed_resize rgb 1080p->640x360 u8": (
            "packed_resize", resize_work(B, H, W, SURFACE_H, SURFACE_W, 3,
                                         aa), 0),
        "nv12_resize 4k->1080p bf16": ("nv12_resize", nv12_work(B4K, aa), 0),
        "nv12_resize 4k->1080p f32": ("nv12_resize", nv12_work(B4K, aa), 0),
        "plane_resize y 4k->1080p u8": (
            "plane_resize", resize_work(B4K, H4K, W4K, H, W, 1, aa), 0),
        "plane_resize stacked u/v 4k->540p u8": (
            "plane_resize", resize_work(2 * B4K, H4K // 2, W4K // 2, H // 2,
                                        W // 2, 1, aa), 0),
        "nv12_to_rgb N=1 1080p bt709/mpeg": (
            "nv12_to_rgb", (nv12[:1].nbytes + rgb[:1].nbytes,
                            CSC_OPS * H * W),
            runs["surface_a"]["nv12_to_rgb"]),
        "nv12_to_rgb N=1 1080p bt709/mpeg f32": (
            "nv12_to_rgb", (nv12[:1].nbytes + rgb[:1].nbytes,
                            CSC_OPS * H * W), 0),
        "packed_resize N=1 rgb 1080p->640x360 lanczos": (
            "packed_resize", resize_work(1, H, W, SURFACE_H, SURFACE_W, 3,
                                         resize.LANCZOS),
            runs["surface_a"]["packed_resize"]),
        "nv12_resize N=1 4k->1080p lanczos": (
            "nv12_resize", nv12_work(1, resize.LANCZOS),
            runs["surface_b"]["nv12_resize"]),
        "plane_resize N=1 y 1080p->540p lanczos": (
            "plane_resize", resize_work(1, H, W, HALF_H, HALF_W, 1,
                                        resize.LANCZOS),
            runs["surface_b"]["plane_resize"] // 2),
        "plane_resize B=2 u/v 540p->270p lanczos": (
            "plane_resize", resize_work(2, H // 2, W // 2, HALF_H // 2,
                                        HALF_W // 2, 1, resize.LANCZOS),
            runs["surface_b"]["plane_resize"] // 2),
    }
    times = {}
    for case, (kname, work, n) in timed.items():
        t_kern, t_plain = time_pair(*cases[case])
        bound, bound_by = bound_ms(*work)
        times[case] = (t_kern, t_plain, bound, bound_by, n)
        log(f"time {case}: kernel_ms={t_kern} plain_ms={t_plain} "
            f"bound_ms={bound} bound_by={bound_by} main_path_launches={n} "
            f"({smi})")
    # nv12_to_rgb once more through one prepared ctypes call at each of
    # its timed shapes and compute dtypes: the kernel alone, without the
    # wrapper's host work; each held to the wrapper's bits, every launch
    # on the staged route
    from vali_tpu_torch.ops.nv12_to_rgb import (prepare_nv12_to_rgb,
                                                staged_route)

    prepared = {}
    for case, x in (("nv12_to_rgb rgb bt709/mpeg bf16", nv12),
                    ("nv12_to_rgb rgb bt709/mpeg f32", nv12),
                    ("nv12_to_rgb N=1 1080p bt709/mpeg", nv12[:1]),
                    ("nv12_to_rgb N=1 1080p bt709/mpeg f32", nv12[:1])):
        cdt = f32 if case.endswith("f32") else {}
        launch, out = prepare_nv12_to_rgb(x, **to_rgb, **bt709, **cdt)
        launch()
        if not staged_route(x, W) or not torch.equal(
                out, nv12_to_rgb(x, **to_rgb, **bt709, **cdt)):
            raise AssertionError(f"prepared {case} call differs or leaves "
                                 f"the staged route")
        prepared[case] = launch
    alone = {case: time_ms(launch) for case, launch in prepared.items()}
    for case, ms in alone.items():
        log(f"time {case}, kernel alone (one prepared ctypes call): "
            f"kernel_ms={ms} ({smi})")
    for case, nbytes in (("nv12_to_rgb rgb bt709/mpeg bf16",
                          nv12.nbytes + rgb.nbytes),
                         ("nv12_resize 4k->1080p bf16",
                          nv4k.nbytes + nv_1080.nbytes)):
        log(f"{case} read+write GB/s={nbytes / (times[case][0] * 1e-3) / 1e9}")

    t_two = time_ms(two_stage)
    log(f"time two-stage convert+resize {B}x{H}p NV12->RGB->{DH}x{DW}: "
        f"ms={t_two} fps={B / (t_two * 1e-3)} beside fused nv12_preprocess "
        f"ms={fused_ms} ({smi})")
    for rate_name, run, n in (("A", surface_a, B), ("B", surface_b, B4K)):
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"time surface path {rate_name} N=1 over {n} frames (host "
            f"clock): fps={n / secs} ms_per_frame={secs / n * 1e3} ({smi})")
    # each prepared nv12_to_rgb call's device time by torch.profiler, last:
    # its tracing slows the launches timed after it
    from vali_tpu_torch.lab.ab_common import kernel_ms

    device_ms = {case: sum(k.values())
                 for case, k in kernel_ms(prepared).items()}
    log(f"time nv12_to_rgb device (torch.profiler): "
        f"{json.dumps(device_ms)} ({smi})")
    routes = {}
    for case in prepared:
        route = "f32" if case.endswith("f32") else "bf16"
        shape = "n1" if "N=1" in case else "batched"
        routes.setdefault(route, {})[shape] = {
            "case": case, "wrapper_ms": times[case][0],
            "kernel_alone_ms": alone[case], "device_ms": device_ms[case]}

    # nv12_to_rgb.cu runs the staged block of convert_staged.cuh (with the
    # TMA and wgmma helpers) and its own per-pixel kernel
    src_of = {"nv12_to_rgb": ("vali_tpu_torch/csrc/nv12_to_rgb.cu",
                              "vali_tpu/ops/pallas_fused.py:1487"),
              "packed_resize": ("vali_tpu_torch/csrc/banded_resize.cu",
                                "vali_tpu/ops/pallas_fused.py:1637"),
              "nv12_resize": ("vali_tpu_torch/csrc/banded_resize.cu",
                              "vali_tpu/ops/pallas_fused.py:1105"),
              "plane_resize": ("vali_tpu_torch/csrc/banded_resize.cu",
                               "vali_tpu/ops/pallas_fused.py:1272")}
    # ms, plain_ms and bound_ms are each kernel's at its batched shape;
    # "shapes" holds every timed shape with its main-path launches, where
    # the N = 1 times are wrapper calls whose host work outlasts the
    # kernel, and launch_weighted_ms the mean over the main-path launches.
    # No single PyTorch call computes these Lanczos resizes or the
    # bf16-cast-point CSC: library_ms is null
    batched = {"nv12_to_rgb": "nv12_to_rgb rgb bt709/mpeg bf16",
               "packed_resize": "packed_resize rgb 1080p->224 u8",
               "nv12_resize": "nv12_resize 4k->1080p bf16",
               "plane_resize": "plane_resize y 4k->1080p u8"}
    entries = []
    for k, case in batched.items():
        t_kern, t_plain, bound, bound_by, _ = times[case]
        shapes = [dict({"case": c, "ms": v[0], "plain_ms": v[1],
                        "bound_ms": v[2], "bound_by": v[3],
                        "launches": v[4],
                        "timed": ("wrapper call incl. host work"
                                  if c in n1_cases else "kernel")},
                       **({"kernel_alone_ms": alone[c],
                           "device_ms": device_ms[c]}
                          if c in alone else {}))
                  for c, v in times.items() if timed[c][0] == k]
        n = sum(sh["launches"] for sh in shapes)
        entries.append({
            "name": k, "route": "cuda", "source": src_of[k][0],
            "replaces": src_of[k][1], "launches": launches[k],
            "max_abs_err": err[k], "ms": t_kern, "plain_ms": t_plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "launch_weighted_ms": sum(sh["ms"] * sh["launches"]
                                      for sh in shapes) / n,
            "shapes": shapes})
    entries[0].update(
        headers=["vali_tpu_torch/csrc/convert_staged.cuh",
                 "vali_tpu_torch/csrc/tma_common.cuh",
                 "vali_tpu_torch/csrc/wgmma_common.cuh"],
        routes=routes)
    return entries


LAB_REPLACES = {  # lab kernel -> its TPU notebook kernel
    "stream_floor": "bench_kernel_variants.py:266",
    "variant_kernel": "bench_kernel_variants.py:86",
    "prod_like": "bench_kernel_variants.py:307",
    "multiframe": "bench_kernel_variants.py:785",
    "static_kernel": "bench_kernel_variants.py:570",
    "static_kernel2": "bench_kernel_variants.py:674",
    "combo_kernel": "bench_kernel_variants.py:1015",
    "transposed_chroma": "bench_kernel_variants.py:904",
    "grouped_kernel": "bench_kernel_variants.py:437",
}


def lab_phase(torch, np, dev, smi):
    """The NV12 kernel-variant lab at 64 x 1080p -> 224: every lab kernel
    against its plain version on the card (the full-function variants also
    against nv12_preprocess: all run their resize passes on the tensor
    cores, so within the kernels' envelope with their differing samples
    counted; B equal to C; S, Slong and T at 32 and 16 rows equal to S2 at
    their strip bit for bit), the
    combo's six instances against S2 at the same strip height (bit for bit
    where its warpgroups split the chunks as S2's do; at T = 64, which S2
    refuses, its plain version) and each replayed against its first
    output, prod_like's and multiframe's instances (S2's block, the
    combo's; full at S2's strip heights is S2's kernel) each replayed
    against its first output, M2 / M4 / M8 equal to the combo at (G, 32)
    bit for bit, hpass held to ``kv.hpass_tolerance``, the
    floor's sink against the frames, then the lab's entry point
    (``kernel_variants.run``) name by name with the launch counts set to 0
    just before and read just after, and the plain versions' times.
    Returns the lab kernels' entries of the JSON line."""
    from vali_tpu_torch.lab import kernel_variants as kv
    from vali_tpu_torch.lab.chains import CHAINS_TILE, CHAINS_TILES
    from vali_tpu_torch.lab.timing import BF16_OPS_PER_S, HBM_BYTES_PER_S
    from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                    nv12_preprocess_plain)

    def chains_tile(name):   # S / Slong / T's strip height, else None
        m = re.fullmatch(r"(S|Slong|T)(\d*)", name)
        return m and int(m.group(2) or CHAINS_TILE)

    rows = H * 3 // 2
    geo = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)
    frames = kv.make_frames(B, rows, W, dev)
    product = nv12_preprocess(frames, **geo)
    names = kv.DEFAULT_NAMES[1:]   # "A" is nv12_preprocess itself
    cases = {n: kv.case(n, B, rows, **geo) for n in names}

    def on_s2(n):   # prod_like's full at S2's strip heights is S2's kernel
        m = re.fullmatch(r"full(\d*)", n)
        return bool(m) and (int(m.group(1) or kv.PRODLIKE_TILE)
                            not in kv.PRODLIKE_TILES["full"])

    # ---- phase 1: kernel against plain version on the card ---------------
    err, differ, staged = {}, {}, {}
    for name, c in cases.items():
        out, ref = c.call(frames), c.plain(frames)
        if name in ("B", "C"):
            staged[name] = out
        torch.cuda.synchronize()
        # hpass, which stores round(bf16 + bf16), to kv.hpass_tolerance
        err[name] = compare(torch, f"lab {name} vs plain", out, ref,
                            c.tolerance(frames))
        if name == "floor" and not torch.equal(out, ref):
            raise AssertionError("stream_floor differs from its plain "
                                 "version")
        if c.full_function and not c.exact:
            compare(torch, f"lab {name} vs nv12_preprocess", out, product)
            differ[name] = (int((out != product).sum().item()),
                            int((out != ref).sum().item()))
            log(f"lab {name}: {differ[name][0]} of {out.numel()} samples "
                f"differ from nv12_preprocess, {differ[name][1]} from its "
                f"plain version (tensor-core sums)")
        elif c.full_function and not torch.equal(out, product):
            raise AssertionError(f"lab {name} differs from nv12_preprocess")
        elif not c.exact:   # a knock-out on the tensor cores
            differ[name] = (None, int((out != ref).sum().item()))
            log(f"lab {name}: {differ[name][1]} of {out.numel()} samples "
                f"differ from its plain version (tensor-core sums)")
    if not torch.equal(staged["B"], staged["C"]):
        raise AssertionError("lab B (f32 hop) differs from C (u8 -> i32 -> "
                             "bf16): their operands are equal")
    del staged
    # S, Slong and T (S2's block, other cast chains or chroma layout): S2's
    # bits at their strip
    chains_vs_s2 = {}
    for t in CHAINS_TILES:
        s2 = kv.static_kernel2(frames, **geo, tile=t, align=8)
        for name in (n for n in names if chains_tile(n) == t):
            chains_vs_s2[name] = int((cases[name].call(frames) != s2)
                                     .sum().item())
            torch.cuda.synchronize()
            log(f"lab {name}: {chains_vs_s2[name]} of {s2.numel()} samples "
                f"differ from S2 t{t}a8, {differ[name][0]} from "
                f"nv12_preprocess, {differ[name][1]} from its plain version")
            if chains_vs_s2[name]:
                raise AssertionError(f"lab {name} differs from S2 t{t}a8: "
                                     f"equal cast chains and layouts give "
                                     f"S2's bits")
        del s2
    combo_vs_s2 = {}
    for name in (n for n in names if n.startswith("combo")):
        c = cases[name]
        g, t = (int(v) for v in name[len("combo"):].split("x"))
        first = c.call(frames)
        for _ in range(COMBO_REPLAYS):
            if not torch.equal(c.call(frames), first):
                raise AssertionError(f"lab {name} differs between replays")
        if t in (16, 32):
            s2 = kv.static_kernel2(frames, **geo, tile=t, align=8)
            combo_vs_s2[name] = int((first != s2).sum().item())
            if (kv.COMBO_SPLITS[g, t] == "chunks"
                    and combo_vs_s2[name] != 0):
                raise AssertionError(f"lab {name} differs from S2 t{t}a8 in "
                                     f"{combo_vs_s2[name]} samples: its "
                                     f"warpgroups split the chunks as S2's")
            del s2
        torch.cuda.synchronize()
        log(f"lab {name}: {COMBO_REPLAYS} replays equal to the first; "
            + (f"{combo_vs_s2[name]} samples differ from S2 t{t}a8 "
               f"({kv.COMBO_SPLITS[g, t]} split)" if name in combo_vs_s2
               else "no S2 at this strip height (rows split); held to its "
               "plain version above"))
        del first
    # prod_like's and multiframe's own instances: replays, and M* the
    # combo's bits
    for name in (n for n in names
                 if cases[n].wrapper in (kv.prod_like, kv.multiframe)
                 and not on_s2(n)):
        c = cases[name]
        first = c.call(frames)
        for _ in range(PRODLIKE_REPLAYS):
            if not torch.equal(c.call(frames), first):
                raise AssertionError(f"lab {name} differs between replays")
        same = ""
        if name.startswith("M"):
            same = f"combo{name[1:]}x32"
            want = kv.combo_kernel(frames, **geo, gframes=int(name[1:]),
                                   tile=32)
        if same and not torch.equal(first, want):
            raise AssertionError(f"lab {name} differs from {same}")
        torch.cuda.synchronize()
        log(f"lab {name}: {PRODLIKE_REPLAYS} replays equal to the first"
            + (f"; equal to {same} bit for bit" if same else ""))
        del first
    sink = torch.zeros(kv.SINK_WORDS, dtype=torch.int32, device=dev)
    kv.stream_floor(frames, rows=rows, W=W, DH=DH, DW=DW, sink=sink)
    got = np.bitwise_xor.reduce(sink.cpu().numpy().view(np.uint32))
    want = np.bitwise_xor.reduce(frames.cpu().numpy().view(np.uint32),
                                 axis=None)
    if got != want:
        raise AssertionError("stream_floor's sink misses bytes of the "
                             "frames")
    full_fn = ", ".join(n for n in names
                        if cases[n].full_function and cases[n].exact)
    log(f"lab: every bit-exact full-function variant ({full_fn or 'none'}) "
        f"equal to nv12_preprocess, B, C, D, G, S2*, combo*, full*, M*, S*, "
        f"Slong* and T* within their envelope, B equal to C, S* / Slong* / "
        f"T* equal to S2 at their strip; the floor's sink equal to the XOR "
        f"of every word of the frames")

    # ---- phase 2: the lab's entry point, the counts read per name --------
    for w in kv.WRAPPERS:
        w.launches = 0
    results = {}
    for name in kv.DEFAULT_NAMES:
        before = sum(w.launches for w in kv.WRAPPERS)
        (row,) = kv.run([name], frames, **geo, log=log)
        row["launches"] = sum(w.launches for w in kv.WRAPPERS) - before
        results[name] = row
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in kv.WRAPPERS}
    log(f"lab_path_launches={json.dumps(launches)}")
    if min(launches.values()) < 1 or min(
            results[n]["launches"] for n in names) < 1:
        raise AssertionError("a kernel of the lab path was not launched")
    # the full-function variants against nv12_preprocess bit for bit, the
    # others within their limit (kv.run's excess)
    for n, r in results.items():
        if r["excess"] > 0:
            raise AssertionError(f"lab {n} differs from its reference")
    ms = {n: r["ms"] for n, r in results.items()}
    log(f"lab floor: {ms['floor']} ms = {results['floor']['gbps']} GB/s "
        f"of input and output bytes ({smi})")
    for t, sfx in ((16, ""), (32, "32")):
        f, hp, wp = ms["full" + sfx], ms["hpass" + sfx], ms["wpass" + sfx]
        log(f"lab H/W split on S2's block at {t}-row strips: full {f} ms, "
            f"hpass {hp} ms ({hp / f}), wpass {wp} ms ({wp / f}), hpass + "
            f"wpass - full {hp + wp - f} ms; S2 t{t}a8 {ms[f'S2t{t}a8']} ms; "
            f"differing samples off the plain version: hpass "
            f"{differ['hpass' + sfx][1]}, wpass {differ['wpass' + sfx][1]} "
            f"({smi})")
    log("lab prod_like full on S2's block: " + ", ".join(
        f"{n} {ms[n]} ms" for n in names if re.fullmatch(r"full\d*", n))
        + "; multiframe on the combo's: " + ", ".join(
            f"{n} {ms[n]} ms" for n in names if re.fullmatch(r"M\d+", n))
        + f"; combo2x32 {ms['combo2x32']} ms, combo4x32 "
        f"{ms['combo4x32']} ms ({smi})")
    log(f"lab H-pass variants against A {ms['A']} ms: " + ", ".join(
        f"{n} {ms[n]} ms ({ms[n] / ms['A']})"
        for n in ("G", "S2t16a8", "combo2x32")) + f" ({smi})")
    log("lab S / Slong / T (S2's wgmma block: the TPU's short and long cast "
        "chains; the chroma H rows interleaved, read MN-major) over S2 at "
        "their strip: " + ", ".join(
            f"{n} {ms[n]} ms = {ms[n] / ms[s2]} of {s2}'s {ms[s2]} ms"
            for n in chains_vs_s2 for s2 in [f"S2t{chains_tile(n)}a8"])
        + f" ({smi})")
    g_bytes, g_ops = cases["G"].work
    log(f"lab G (wgmma H pass, {kv.GROUPED_WPASS} W pass): {ms['G']} ms = "
        f"{ms['G'] / ms['A']} of A's {ms['A']} ms in this run; "
        f"{differ['G'][0]} of {B * 3 * DH * DW} samples differ from "
        f"nv12_preprocess, {differ['G'][1]} from its plain version; bound "
        f"{g_bytes / HBM_BYTES_PER_S * 1e3} ms by bytes ({g_bytes} B), "
        f"{g_ops / BF16_OPS_PER_S * 1e3} ms by operations ({g_ops} FLOP "
        f"issued, zeros included) ({smi})")
    parts = []
    for n in kv.VARIANTS:
        v_bytes, v_ops = cases[n].work
        parts.append(
            f"{n} {ms[n]} ms = {ms[n] / ms['A']} of A's, {ms[n] / ms['G']} "
            f"of G's, {ms[n] / ms['S2t16a8']} of S2 t16a8's, "
            f"{differ[n][0]} samples off nv12_preprocess, {differ[n][1]} off "
            f"the plain version, bound {v_bytes / HBM_BYTES_PER_S * 1e3} ms "
            f"by bytes, {v_ops / BF16_OPS_PER_S * 1e3} ms by operations "
            f"({v_ops} FLOP issued)")
    log("lab staged B / C / D (S2's wgmma block, the H pass's operand "
        "converted once into shared memory): " + "; ".join(parts)
        + f"; A {ms['A']} ms, G {ms['G']} ms, S2 t16a8 {ms['S2t16a8']} ms "
        f"in this run ({smi})")
    for n in (n for n in names if n.startswith("S2")):
        s_bytes, s_ops = cases[n].work
        log(f"lab {n} (wgmma H and W passes, N = the strip height): {ms[n]} "
            f"ms = {ms[n] / ms['A']} of A's and {ms[n] / ms['G']} of G's in "
            f"this run; {differ[n][0]} of {B * 3 * DH * DW} samples differ "
            f"from nv12_preprocess (G: {differ['G'][0]}), {differ[n][1]} from "
            f"its plain version; bound {s_bytes / HBM_BYTES_PER_S * 1e3} ms "
            f"by bytes, {s_ops / BF16_OPS_PER_S * 1e3} ms by operations "
            f"({s_ops} FLOP issued, zeros included) ({smi})")

    parts = []
    for n in (n for n in names if n.startswith("combo")):
        s2 = "S2t" + n.split("x")[1] + "a8"
        parts.append(f"{n} {ms[n]} ms" + (
            f" = {ms[n] / ms[s2]} of {s2}'s, {combo_vs_s2[n]} samples off it"
            if n in combo_vs_s2 else "") + f", {differ[n][0]} off "
            f"nv12_preprocess, {differ[n][1]} off its plain version")
    log("lab combo (S2's wgmma block, G frames a block, each chunk's W "
        "weights loaded once for the G frames): " + "; ".join(parts)
        + f"; S2 t16a8 {ms['S2t16a8']} ms, t32a8 {ms['S2t32a8']} ms, A "
        f"{ms['A']} ms in this run ({smi})")

    # ---- phase 3: the plain versions' times -------------------------------
    # the product's plain version for the variants that share it, each
    # other's own (the knock-outs', and S2's, the combo's, prod_like's,
    # multiframe's, S's, Slong's, T's and G's table-based ones)
    product_plain = ("B", "C", "D")
    own_plain = tuple(n for n in names if n not in product_plain)
    plain_ms = {"product": time_ms(
        lambda: nv12_preprocess_plain(frames, **geo), samples=5, calls=1)}
    log(f"time lab plain product: ms={plain_ms['product']} ({smi})")
    for name in own_plain:
        plain_ms[name] = time_ms(lambda c=cases[name]: c.plain(frames),
                                 samples=5, calls=1)
        log(f"time lab plain {name}: ms={plain_ms[name]} ({smi})")
    entries = []
    for name in names:
        c = cases[name]
        wrapper = c.wrapper.__name__
        r = results[name]
        entries.append({
            "name": f"{wrapper} {name}", "route": "cuda",
            "source": "vali_tpu_torch/csrc/" + (
                "nv12_static2.cu" if on_s2(name) else {
                    kv.grouped_kernel: "nv12_grouped.cu",
                    kv.static_kernel2: "nv12_static2.cu",
                    kv.combo_kernel: "nv12_combo.cu",
                    kv.multiframe: "nv12_combo.cu",
                    kv.prod_like: "nv12_prodlike.cu",
                    kv.static_kernel: "nv12_chains.cu",
                    kv.transposed_chroma: "nv12_chains.cu",
                    kv.variant_kernel: "nv12_staged.cu"}.get(
                        c.wrapper, "nv12_variants.cu")),
            "replaces": LAB_REPLACES[wrapper], "launches": r["launches"],
            "max_abs_err": err[name], "ms": r["ms"],
            "plain_ms": plain_ms[name if name in plain_ms else "product"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no single PyTorch call streams a frame or computes fused
            # CSC + banded Lanczos
            "library_ms": None})
    return entries


RESIZE_LAB_REPLACES = {  # resize-lab wrapper -> its TPU notebook kernel
    "resize_phases": "resize_diag.py:66",
    "streamed_resize": "resize_diag.py:164",
    "aligned_resize": "resize_diag.py:290",
    "skewed_resize": "resize_diag.py:408",
    "slabs_resize": "resize_diag.py:537",
    "striped_resize": "resize_diag.py:697",
}


def resize_lab_phase(torch, np, dev, smi):
    """The 4K NV12 resize lab at 16 x 4K -> 1080p: every lab kernel against
    its plain version on the card (the knock-outs on aligned's block:
    dma_only equal, h_only within h_only_tolerance, w_only within the
    envelope, ``both`` equal to aligned8x32's luma rows; aligned, skewed,
    streamed, slabs and striped, the tensor-core passes, within the uint8
    envelope of nv12_resize, skewed, streamed and striped equal to
    aligned8x32 bit for bit and slabs equal to it off the rows that
    straddle a slab edge, streamed and slabs staged by TMA; the samples in
    which they differ are counted, with both bounds; skewed's resident
    blocks and striped's clusters, and both timed against aligned8x32 in
    alternating rounds), the sinks of
    dma_only and w_only against the frames, then the lab's entry point
    (``resize_diag.run``) name by name with the launch counts set to 0 just
    before and read just after, the H/W split, and the plain versions'
    times. Returns the lab kernels' entries of the JSON line."""
    from vali_tpu_torch.lab import phases_ab, resize_diag as rd
    from vali_tpu_torch.lab import striped_ab
    from vali_tpu_torch.lab.ab_common import rounds
    from vali_tpu_torch.lab.timing import BF16_OPS_PER_S, HBM_BYTES_PER_S
    from vali_tpu_torch.ops.nv12_resize import nv12_resize, nv12_resize_plain

    geo = dict(src_w=W4K, src_h=H4K, dst_w=W, dst_h=H)
    frames = rd.make_frames(B4K, H4K * 3 // 2, W4K, dev)
    product = nv12_resize(frames, **geo)
    names = rd.DEFAULT_NAMES[1:]   # "prod" is nv12_resize itself
    cases = {n: rd.case(n, B4K, **geo) for n in names}

    # ---- phase 1: kernel against plain version on the card ---------------
    # one plain run of the full function serves every full-function variant
    # and both (its luma rows); the 4K plain versions take ~0.1 s a call
    plain_full = nv12_resize_plain(frames, **geo)
    # both, skewed*, streamed and striped are held to aligned8x32 bit for bit
    aligned8x32 = cases["aligned8x32"].call(frames)
    err = {}
    for name, c in cases.items():
        tma = rd.streamed_resize.tma_launches + rd.slabs_resize.tma_launches
        out = c.call(frames)
        full_plain = c.wrapper in (rd.aligned_resize, rd.skewed_resize,
                                   rd.streamed_resize, rd.striped_resize)
        ref = (plain_full[:, :H] if name == "both" else plain_full
               if full_plain else c.plain(frames))
        torch.cuda.synchronize()
        if name == "h_only":
            # the low bytes of truncated H values: the distance mod 256,
            # within rd.h_only_tolerance on fewer than 1e-3 of the samples
            d = rd.wrap_distance(out, ref)
            err[name] = int(d.max().item())
            log(f"resize lab h_only vs plain: max_wrap_diff={err[name]} "
                f"frac_diff={(d > 0).double().mean().item()} above_1="
                f"{int((d > 1).sum().item())}")
            if not c.within(out, frames):
                raise AssertionError("resize lab h_only lies outside "
                                     "h_only_tolerance of its plain version")
        else:
            err[name] = compare(torch, f"resize lab {name} vs plain", out,
                                ref)
        if name == "dma_only" and not torch.equal(out, ref):
            raise AssertionError("dma_only differs from its plain version")
        if c.wrapper is rd.resize_phases:
            nb, ops = c.work
            held = ""
            if name == "both":
                if not torch.equal(out, aligned8x32[:, :H]):
                    raise AssertionError("resize lab both differs from "
                                         "aligned8x32's luma rows")
                compare(torch, "resize lab both vs nv12_resize luma rows",
                        out, product[:, :H])
                held = (f", 0 from aligned8x32's luma rows, "
                        f"{int((out != product[:, :H]).sum().item())} from "
                        f"nv12_resize's")
            log(f"resize lab {name}: {int((out != ref).sum().item())} of "
                f"{out.numel()} samples differ from its plain version{held}"
                f"; bound {nb / HBM_BYTES_PER_S * 1e3} ms by bytes ({nb} B),"
                f" {ops / BF16_OPS_PER_S * 1e3} ms by operations ({ops} "
                f"FLOP issued, zeros included)")
        if c.wrapper in (rd.aligned_resize, rd.skewed_resize,
                         rd.streamed_resize, rd.slabs_resize,
                         rd.striped_resize):
            compare(torch, f"resize lab {name} vs nv12_resize", out, product)
            nb, ops = c.work
            staged = ""
            if c.wrapper in (rd.skewed_resize, rd.striped_resize):
                if not torch.equal(out, aligned8x32):
                    raise AssertionError(f"resize lab {name} differs from "
                                         f"aligned8x32")
                staged = ", 0 from aligned8x32"
            if c.wrapper is rd.striped_resize:
                nw, store = re.fullmatch(r"striped(\d+)(\w+)",
                                         name).groups()
                held = rd.striped_clusters(frames, **geo, nw=int(nw),
                                           store=store)
                staged += f"; resident clusters (luma, chroma) {held}"
            if c.wrapper is rd.skewed_resize:
                held = rd.resident_blocks(frames, **geo, mode="skewed")
                staged += f"; resident blocks an SM (luma, chroma) {held}"
            if c.wrapper in (rd.streamed_resize, rd.slabs_resize):
                # slabs: the rows whose band lies in one slab
                keep = (torch.from_numpy(~rd.straddling_rows(
                    H4K, H, rd.slab_rows(H4K, int(name[5:])))).to(dev)
                        if c.wrapper is rd.slabs_resize else slice(None))
                if not torch.equal(out[:, keep], aligned8x32[:, keep]):
                    raise AssertionError(f"resize lab {name} differs from "
                                         f"aligned8x32")
                path = ("TMA" if rd.streamed_resize.tma_launches
                        + rd.slabs_resize.tma_launches > tma
                        else "element loads")
                if dev.type == "cuda" and path != "TMA":
                    raise AssertionError(f"resize lab {name}: contiguous "
                                         f"frames were not staged by TMA")
                staged = (f", {int((out != aligned8x32).sum().item())} "
                          f"from aligned8x32"
                          + (" (equal off the rows that straddle a slab "
                             "edge)" if c.wrapper is rd.slabs_resize else "")
                          + f"; staged by {path}")
            log(f"resize lab {name}: {int((out != product).sum().item())} "
                f"of {out.numel()} samples differ from nv12_resize, "
                f"{int((out != ref).sum().item())} from its plain version "
                f"(tensor-core sums){staged}; bound "
                f"{nb / HBM_BYTES_PER_S * 1e3} ms by bytes ({nb} B), "
                f"{ops / BF16_OPS_PER_S * 1e3} ms by operations ({ops} FLOP "
                f"issued, zeros included)")
    del plain_full
    want = np.bitwise_xor.reduce(frames.cpu().numpy().view(np.uint32),
                                 axis=None)
    for mode in ("dma_only", "w_only"):
        sink = torch.zeros(rd.SINK_WORDS, dtype=torch.int32, device=dev)
        rd.resize_phases(frames, **geo, mode=mode, sink=sink)
        got = np.bitwise_xor.reduce(sink.cpu().numpy().view(np.uint32))
        if got != want:
            raise AssertionError(f"{mode}'s sink misses bytes of the frames")
    log("resize lab: dma_only equal to its plain version, h_only within "
        "h_only_tolerance, w_only within the envelope, both equal to "
        "aligned8x32's luma rows; aligned, skewed, streamed, slabs and "
        "striped within the envelope of nv12_resize, skewed, streamed and "
        "striped equal to aligned8x32, slabs off the slab edges; the "
        "dma_only and w_only sinks equal to the XOR of every word of the "
        "frames")
    # striped and skewed against aligned8x32 in alternating rounds (their
    # A/B labs, lab/striped_ab.py and lab/phases_ab.py, also time the
    # earlier designs)
    ab = {f"current_{n}": functools.partial(cases[n].call, frames)
          for n in names if n.startswith("striped")}
    ab["aligned8x32"] = functools.partial(cases["aligned8x32"].call, frames)
    log(f"striped A/B summary ({smi}): " + json.dumps(
        {k: v for k, v in striped_ab.summary(rounds(ab, 3)).items()
         if k.endswith(("_ms", "_median"))}))
    ab = {n: functools.partial(cases[n].call, frames)
          for n in names if n.startswith("skewed")}
    ab["aligned8x32"] = functools.partial(cases["aligned8x32"].call, frames)
    log(f"skewed A/B summary ({smi}): "
        + json.dumps(phases_ab.over_aligned(rounds(ab, 3))))

    # ---- phase 2: the lab's entry point, the counts read per name --------
    for w in rd.WRAPPERS:
        w.launches = 0
    results = {}
    for name in rd.DEFAULT_NAMES:
        # the name's own wrapper: both's reference launches aligned_resize
        wrapper = (cases[name] if name in cases else
                   rd.case(name, B4K, **geo)).wrapper
        before = launches_of(wrapper)
        (row,) = rd.run([name], frames, **geo, log=log)
        row["launches"] = launches_of(wrapper) - before
        results[name] = row
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in rd.WRAPPERS}
    log(f"resize_lab_path_launches={json.dumps(launches)}")
    if min(launches.values()) < 1 or min(
            results[n]["launches"] for n in names) < 1:
        raise AssertionError("a kernel of the resize lab was not launched")
    for n, r in results.items():
        if not r["within"]:
            raise AssertionError(f"resize lab {n} differs from its reference")
    ms = {n: r["ms"] for n, r in results.items()}
    log("resize lab H/W split: " + ", ".join(
        f"{k} {ms[k]} ms ({ms[k] / ms['prod']})"
        for k in ("dma_only", "h_only", "w_only", "both"))
        + f" of prod {ms['prod']} ms ({smi})")

    # ---- phase 3: the plain versions' times (3 samples of 1 call) --------
    plain_ms = {"full": time_ms(lambda: nv12_resize_plain(frames, **geo),
                                samples=3, calls=1)}
    # each knock-out's own plain version; one of each split full function
    # stands for its names (their plain versions do the same products)
    plain_of = {n: n if n in rd.MODES else "full" for n in names}
    plain_of.update({n: "slabs4" for n in names if n.startswith("slabs")})
    plain_of.update({n: "striped3dyn" for n in names
                     if n.startswith("striped")})
    for name in set(plain_of.values()) - {"full"}:
        plain_ms[name] = time_ms(lambda c=cases[name]: c.plain(frames),
                                 samples=3, calls=1)
    log(f"time resize lab plain versions: {json.dumps(plain_ms)} ({smi})")
    entries = []
    for name in names:
        c = cases[name]
        wrapper = c.wrapper.__name__
        r = results[name]
        entries.append({
            "name": f"{wrapper} {name}", "route": "cuda",
            "source": "vali_tpu_torch/csrc/" + {
                rd.resize_phases: "nv12_phases.cu",
                rd.aligned_resize: "nv12_aligned.cu",
                rd.skewed_resize: "nv12_skewed.cu",
                rd.streamed_resize: "nv12_streamed.cu",
                rd.slabs_resize: "nv12_slabs.cu",
                rd.striped_resize: "nv12_striped.cu"}[c.wrapper],
            "replaces": RESIZE_LAB_REPLACES[wrapper],
            "launches": r["launches"], "max_abs_err": err[name],
            "ms": r["ms"],
            "plain_ms": plain_ms[plain_of[name]],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no PyTorch call computes a banded Lanczos resize
            "library_ms": None})
    return entries


CONVERT_LAB_REPLACES = {  # convert-lab wrapper -> its TPU notebook kernel
    "convert_variant": "convert_lab.py:84",
    "convert_probe": "convert_lab.py:179",
}


def convert_lab_phase(torch, np, dev, smi):
    """The NV12 -> RGB convert lab at 64 x 1080p: every lab kernel against
    its plain version on the card bit for bit (V1 and V2 also against
    nv12_to_rgb), the sinks of dma and inonly against the frames, then the
    lab's entry point (``convert_lab.run``) name by name with the launch
    counts set to 0 just before and read just after, the read / store /
    quantisation / replication split of nv12_to_rgb, and the plain
    versions' times. Returns the lab kernels' entries of the JSON line."""
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace
    from vali_tpu_torch.lab import convert_lab as cl
    from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb, nv12_to_rgb_plain

    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    rows = H * 3 // 2
    frames = cl.make_frames(B, rows, W, dev)
    product = nv12_to_rgb(frames, src_w=W, src_h=H, **bt709)
    names = cl.DEFAULT_NAMES[1:]   # "prod" is nv12_to_rgb itself
    cases = {n: cl.case(n, B, rows, W, H) for n in names}

    # ---- phase 1: kernel against plain version on the card ---------------
    err = {}
    for name, c in cases.items():
        out, ref = c.call(frames), c.plain(frames)
        torch.cuda.synchronize()
        err[name] = compare(torch, f"convert lab {name} vs plain", out, ref)
        if not torch.equal(out, ref):
            raise AssertionError(f"convert lab {name} differs from its plain "
                                 f"version")
        if name in cl.VARIANTS and not torch.equal(out, product):
            raise AssertionError(f"convert lab {name} differs from "
                                 f"nv12_to_rgb")
    want = np.bitwise_xor.reduce(frames.cpu().numpy().view(np.uint32),
                                 axis=None)
    for mode in ("dma", "inonly"):
        sink = torch.zeros(cl.SINK_WORDS, dtype=torch.int32, device=dev)
        cl.convert_probe(frames, src_w=W, src_h=H, mode=mode, sink=sink)
        got = np.bitwise_xor.reduce(sink.cpu().numpy().view(np.uint32))
        if got != want:
            raise AssertionError(f"{mode}'s sink misses bytes of the frames")
    log(f"convert lab: {', '.join(cl.VARIANTS)} equal to nv12_to_rgb, every "
        f"probe equal to its plain version; the dma and inonly sinks equal "
        f"to the XOR of every word of the frames")

    # ---- phase 2: the lab's entry point, the counts read per name --------
    for w in cl.WRAPPERS:
        w.launches = 0
    results = {}
    for name in cl.DEFAULT_NAMES:
        before = sum(w.launches for w in cl.WRAPPERS)
        (row,) = cl.run([name], frames, src_w=W, src_h=H, log=log)
        row["launches"] = sum(w.launches for w in cl.WRAPPERS) - before
        results[name] = row
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in cl.WRAPPERS}
    log(f"convert_lab_path_launches={json.dumps(launches)}")
    if min(launches.values()) < 1 or min(
            results[n]["launches"] for n in names) < 1:
        raise AssertionError("a kernel of the convert lab was not launched")
    for n, r in results.items():
        if r["maxdiff"] != 0:
            raise AssertionError(f"convert lab {n} differs from its "
                                 f"reference")
    ms = {n: r["ms"] for n, r in results.items()}
    p = ms["prod"]
    log(f"convert lab split of nv12_to_rgb {p} ms: read (inonly) "
        f"{ms['inonly'] / p}, store (outonly) {ms['outonly'] / p}, store in "
        f"216-row blocks (outband) {ms['outband'] / p}, read + store (dma) "
        f"{ms['dma'] / p}, quantisation (prod - noquant) "
        f"{(p - ms['noquant']) / p}, replication (prod - noh) "
        f"{(p - ms['noh']) / p} ({smi})")

    # ---- phase 3: the plain versions' times (3 samples of 1 call) --------
    plain_ms = {"prod": time_ms(lambda: nv12_to_rgb_plain(
        frames, src_w=W, src_h=H, **bt709), samples=3, calls=1)}
    for name in cl.PROBES:
        plain_ms[name] = time_ms(lambda c=cases[name]: c.plain(frames),
                                 samples=3, calls=1)
    log(f"time convert lab plain versions: {json.dumps(plain_ms)} ({smi})")
    entries = []
    for name in names:
        wrapper = cases[name].wrapper.__name__
        r = results[name]
        entry = {
            "name": f"{wrapper} {name}", "route": "cuda",
            "source": "vali_tpu_torch/csrc/" + (
                "nv12_convert_staged.cu" if name in cl.VARIANTS
                else "nv12_to_rgb_variants.cu"),
            "replaces": CONVERT_LAB_REPLACES[wrapper],
            "launches": r["launches"], "max_abs_err": err[name],
            "ms": r["ms"], "plain_ms": plain_ms.get(name, plain_ms["prod"]),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no PyTorch call computes the bf16-cast-point CSC or the probes
            "library_ms": None}
        if name in cl.VARIANTS:
            # the bound by bytes; by the FLOPs its products issue, zeros
            # included (a bound of this design); by the CSC's own operations
            nbytes, ops = cases[name].work
            entry["bytes_bound_ms"] = bound_ms(nbytes, 0)[0]
            entry["issued_operations_bound_ms"] = bound_ms(0, ops)[0]
            entry["csc_operations_bound_ms"] = bound_ms(
                0, cl.case("prod", B, rows, W, H).work[1])[0]
        entries.append(entry)
    return entries


def rotate_ud_phase(torch, np, nv12_frame, yuv422_frame, smi):
    """PySurfaceUD and PySurfaceRotator on 1080p Surfaces on the card, each
    against the same op on a CPU copy of its input: right angles bit-equal,
    UD and other angles as ``compare`` holds a kernel to its plain version.
    Logs each op's host ms on the card (synchronous Run)."""
    import vali_tpu_torch as vali

    F = vali.PixelFormat
    ok = (True, vali.TaskExecInfo.SUCCESS)
    cc = vali.ColorspaceConversionContext(vali.ColorSpace.BT_709,
                                          vali.ColorRange.MPEG)
    down = vali.PySurfaceDownloader(gpu_id=0)

    def upload(frame, fmt, w, h, gpu_id):
        surf = vali.Surface.Make(fmt, w, h, gpu_id=gpu_id)
        if vali.PyFrameUploader(gpu_id=gpu_id).Run(frame, surf) != ok:
            raise AssertionError(f"upload of a {fmt.name} frame failed")
        return surf

    def cpu_copy(surf):
        frame = np.zeros(1, np.uint8)
        if down.Run(surf, frame) != ok:
            raise AssertionError("download failed")
        return upload(frame, surf.Format, surf.Width, surf.Height, -1)

    nv12 = upload(nv12_frame, F.NV12, W, H, 0)
    yuv422 = upload(yuv422_frame, F.YUV422, W, H, 0)
    yuv420 = vali.Surface.Make(F.YUV420, W, H, gpu_id=0)
    rgb = vali.Surface.Make(F.RGB, W, H, gpu_id=0)
    cvt = vali.PySurfaceConverter(gpu_id=0)
    if cvt.Run(nv12, yuv420) != ok or cvt.Run(nv12, rgb, cc) != ok:
        raise AssertionError("converting the NV12 Surface failed")
    ops = (  # name, op, source, dst format and size, angle (rotator)
        ("ud nv12->yuv444 1080p", vali.PySurfaceUD, nv12, F.YUV444, W, H,
         None),
        ("ud nv12->rgb 960x540", vali.PySurfaceUD, nv12, F.RGB, HALF_W,
         HALF_H, None),
        ("rotate yuv422 90", vali.PySurfaceRotator, yuv422, F.YUV422, H, W,
         90.0),
        ("rotate yuv420 (from nv12) 180", vali.PySurfaceRotator, yuv420,
         F.YUV420, W, H, 180.0),
        ("rotate rgb 33.5", vali.PySurfaceRotator, rgb, F.RGB, W, H, 33.5))
    for name, cls, src, fmt, w, h, angle in ops:
        args = () if angle is None else (angle,)
        outs = []
        for gpu_id, s in ((0, src), (-1, cpu_copy(src))):
            dst = vali.Surface.Make(fmt, w, h, gpu_id=gpu_id)
            if cls(gpu_id=gpu_id).Run(s, dst, *args) != ok:
                raise AssertionError(f"{name} failed (gpu_id={gpu_id})")
            outs.append(dst)
        op = cls(gpu_id=0)
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            op.Run(src, outs[0], *args)
            times.append((time.perf_counter() - t0) * 1e3)
        card, cpu = outs
        for i, (a, b) in enumerate(zip(card.plane_tensors(),
                                       cpu.plane_tensors())):
            a = a.cpu()
            if angle is not None and angle % 90 == 0:
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} plane {i}: the card and "
                                         f"the CPU differ")
                log(f"{name} plane {i}: card == CPU, bit-equal")
            else:
                compare(torch, f"{name} plane {i} card vs CPU", a, b)
        log(f"time {name} on the card, Run (host clock): "
            f"ms={statistics.median(times[1:])} ({smi})")
    log("surface_rotate_ud: ok, PySurfaceUD and PySurfaceRotator on the "
        "card equal to the same ops on CPU copies of their inputs")


TRANSCODE_N = 64                  # 1080p frames through the device half
TRANSCODE_W, TRANSCODE_H = 1280, 720
CLIP_N = 16                       # frames of transcode_phase's clip


def native_engine_missing():
    """Why the native engine (FFmpeg decode and encode) cannot load on
    this machine, or "" when it loads."""
    from vali_tpu_torch.bench_configs import engine_missing

    return engine_missing()


def copy_into(frame):
    """A StagingRing fill that writes ``frame`` into the buffer, where the
    decoder's native copy_frame writes a decoded frame."""
    def fill(buf):
        buf[:] = frame
        return buf.nbytes
    return fill


def transcode_loop(torch, np, frames, device, sync=True, steps=None):
    """transcode's device half: ``python -m vali_tpu_torch transcode``'s
    loop without the codecs. Each flat 1080p YUV420 host frame is staged
    and copied into a Surface on ``device`` by StagingRing.upload, as
    PyDecoder.DecodeSingleSurface does with a decoded frame (pinned
    buffers on the card, async unless ``sync``); resized to 720p and
    converted to NV12 by the CLI's ToNV12 step (turbo resize: one Y and
    one stacked U/V plane_resize); and read back by download_host_frame,
    as PyNvEncoder.EncodeSingleSurface reads it. Returns the [n, bytes]
    NV12 frames; ``steps`` collects each step's host seconds."""
    from vali_tpu_torch.__main__ import ToNV12
    from vali_tpu_torch.core.enums import PixelFormat as F
    from vali_tpu_torch.engine.decoder import StagingRing
    from vali_tpu_torch.memory.host import download_host_frame
    from vali_tpu_torch.memory.surface import Surface

    tw, th = TRANSCODE_W, TRANSCODE_H
    ring = StagingRing(device)
    src = Surface.Make(F.YUV420, W, H, device=device)
    step = ToNV12(F.YUV420, tw, th, device)
    out = np.empty((len(frames), tw * th * 3 // 2), np.uint8)
    steps = {} if steps is None else steps
    for i, frame in enumerate(frames):
        t = [time.perf_counter()]
        fill = copy_into(frame)

        def timed_fill(buf):
            written = fill(buf)
            t.append(time.perf_counter())
            return written
        ring.upload(timed_fill, F.YUV420, W, H, src, sync)
        t.append(time.perf_counter())
        step.resize(src)
        t.append(time.perf_counter())
        nv12 = step.convert()
        t.append(time.perf_counter())
        out[i] = download_host_frame(nv12)
        t.append(time.perf_counter())
        for k, name in enumerate(("stage", "upload", "resize", "convert",
                                  "download")):
            steps[name] = steps.get(name, 0.0) + t[k + 1] - t[k]
    return out


def transcode_device_phase(torch, np, dev, smi):
    """transcode's device half at full size on the card: 64 seeded 1080p
    YUV420 host frames through transcode_loop to 720p NV12, each held to
    the same loop on CPU Surfaces (the plain versions); the loop once more
    with async uploads over a ring shorter than the frames, bit-equal; the
    async uploads alone into 64 Surfaces, each bit-equal to its host frame
    before and after the ring wraps; the two plane_resize shapes held to
    the plain version and timed. Returns those shapes' entries and the
    plane_resize launches of the main-path run."""
    from vali_tpu_torch.core.enums import PixelFormat as F
    from vali_tpu_torch.engine.decoder import STAGING_SLOTS, StagingRing
    from vali_tpu_torch.memory.surface import Surface
    from vali_tpu_torch.ops import nv12_resize, nv12_to_rgb, packed_resize
    from vali_tpu_torch.ops.plane_resize import (plane_resize,
                                                 plane_resize_plain,
                                                 prepare_plane_resize)
    from vali_tpu_torch.ops.resize import LANCZOS

    n, tw, th = TRANSCODE_N, TRANSCODE_W, TRANSCODE_H
    frames = make_frames(np, np.random.default_rng(11), F.YUV420, n, W, H)
    transcode_loop(torch, np, frames[:2], dev)   # tables, streams, pinned
    torch.cuda.synchronize()
    wrappers = [k for k, _ in preprocess_kernels().values()] + [
        nv12_to_rgb.nv12_to_rgb, packed_resize.packed_resize,
        nv12_resize.nv12_resize, plane_resize]
    before = launch_counts(*wrappers)
    steps = {}
    t0 = time.perf_counter()
    card = transcode_loop(torch, np, frames, dev, steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    made = launched_since(before, *wrappers)
    log(f"transcode_device main_path_launches={json.dumps(made)}")
    if made.pop("plane_resize") != 2 * n or any(made.values()):
        raise AssertionError("transcode's device half did not launch "
                             "plane_resize twice a frame (and nothing else)")
    per_step = {k: v / n * 1e3 for k, v in steps.items()}
    log(f"time transcode device half {n} x {W}x{H} YUV420 -> {tw}x{th} "
        f"NV12, sync uploads (host clock): ms_per_frame={wall / n * 1e3} "
        f"fps={n / wall} steps_ms_per_frame={json.dumps(per_step)} "
        f"shares={json.dumps({k: v / (wall / n * 1e3) for k, v in per_step.items()})} "
        f"({smi})")

    cpu = transcode_loop(torch, np, frames, torch.device("cpu"))
    worst = (0, 0.0)
    for i, (a, b) in enumerate(zip(card, cpu)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        frac = float((d > 0).mean())
        if d.max() > 1 or frac >= 1e-3:
            raise AssertionError(f"transcode frame {i}: card vs CPU "
                                 f"max_abs_diff={d.max()} frac_diff={frac}")
        worst = max(worst, (int(d.max()), frac))
    log(f"transcode_device card vs CPU Surfaces, {n} NV12 frames: worst "
        f"max_abs_diff={worst[0]} frac_diff={worst[1]}")

    t0 = time.perf_counter()
    card_async = transcode_loop(torch, np, frames, dev, sync=False)
    torch.cuda.synchronize()
    wall_async = time.perf_counter() - t0
    if not np.array_equal(card_async, card):
        raise AssertionError("transcode with async uploads differs from "
                             "the sync run")
    log(f"time transcode device half, async uploads over a "
        f"{STAGING_SLOTS}-slot ring (host clock): ms_per_frame="
        f"{wall_async / n * 1e3}; every frame equal to the sync run")

    # the staging race on its own: 64 async uploads into 64 Surfaces
    ring = StagingRing(dev)
    want = torch.from_numpy(frames).to(dev)
    surfs = [Surface.Make(F.YUV420, W, H, device=dev) for _ in range(n)]

    def held(i):
        return torch.equal(torch.cat([p.reshape(-1) for p in
                                      surfs[i].plane_tensors()]), want[i])

    for i in range(n):
        ring.upload(copy_into(frames[i]), F.YUV420, W, H, surfs[i],
                    sync=False)
        if i == STAGING_SLOTS - 1:
            ring.stream.synchronize()
            if not all(held(j) for j in range(i + 1)):
                raise AssertionError("an async upload differs from its "
                                     "host frame before the ring wraps")
    ring.stream.synchronize()
    if not all(held(i) for i in range(n)):
        raise AssertionError("an async upload differs from its host frame "
                             "after the ring wrapped")
    log(f"transcode_device async uploads: {n} Surfaces bit-equal to their "
        f"host frames before and after the {STAGING_SLOTS}-slot ring "
        f"wrapped")
    del surfs, want

    # the two plane_resize shapes, at N = 1 as the Surface op launches them
    y = torch.from_numpy(frames[0, :W * H].reshape(1, H, W)).to(dev)
    uv = torch.from_numpy(frames[0, W * H:].reshape(2, H // 2, W // 2)).to(
        dev)
    shapes = []
    for case, x, sh in (
            (f"transcode N=1 y {H}p->{th}p lanczos", y, (H, th, tw)),
            (f"transcode B=2 u/v {H // 2}p->{th // 2}p lanczos", uv,
             (H // 2, th // 2, tw // 2))):
        kw = dict(src_h=sh[0], dst_h=sh[1], dst_w=sh[2], method=LANCZOS)
        out, ref = plane_resize(x, **kw), plane_resize_plain(x, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"plane_resize {case}", out, ref)
        alone, alone_out = prepare_plane_resize(x, **kw)
        alone()
        torch.cuda.synchronize()
        if not torch.equal(alone_out, out):
            raise AssertionError(f"prepared plane_resize call differs at "
                                 f"{case}")
        t_kern, t_plain = time_pair(lambda: plane_resize(x, **kw),
                                    lambda: plane_resize_plain(x, **kw))
        t_alone = time_ms(alone)
        bound, bound_by = bound_ms(*resize_work(x.shape[0], sh[0], x.shape[2],
                                                sh[1], sh[2], 1, LANCZOS))
        shapes.append({"case": case, "ms": t_kern, "plain_ms": t_plain,
                       "bound_ms": bound, "bound_by": bound_by,
                       "launches": n, "max_abs_err": e,
                       "timed": "wrapper call incl. host work",
                       "kernel_alone_ms": t_alone})
        log(f"time plane_resize {case}: wrapper_ms={t_kern} "
            f"kernel_alone_ms={t_alone} plain_ms={t_plain} bound_ms={bound} "
            f"bound_by={bound_by} main_path_launches={n} ({smi})")
    return shapes, 2 * n


def transcode_phase(torch, np, dev, smi):
    """``python -m vali_tpu_torch transcode`` on a synthesised 1080p clip
    to 720p, in-process through the CLI's function on ``dev``; the output
    decoded on the host: its frame count, size, and each frame within
    35 dB PSNR of the device half's NV12 on the same decoded frames."""
    from vali_tpu_torch.__main__ import cmd_transcode
    from vali_tpu_torch.core.enums import PixelFormat as F
    from vali_tpu_torch.engine.decoder import PyDecoder
    from vali_tpu_torch.utils.synth import synthesize_clip

    tw, th = TRANSCODE_W, TRANSCODE_H

    def decode(path):
        dec = PyDecoder(path, {}, gpu_id=-1)
        frame = np.zeros(dec.HostFrameSize, np.uint8)
        out = []
        while dec.DecodeSingleFrame(frame)[0]:
            out.append(frame.copy())
        return dec, out

    with tempfile.TemporaryDirectory() as tmp:
        clip = synthesize_clip(f"{tmp}/in.mp4", W, H, n=CLIP_N,
                               chroma="sweep")
        out_path = f"{tmp}/out.h264"
        t0 = time.perf_counter()
        cmd_transcode([clip, out_path, f"{tw}x{th}"], dev)
        secs = time.perf_counter() - t0
        src_dec, src = decode(clip)
        out_dec, out = decode(out_path)
    if src_dec.Format != F.YUV420 or len(src) != CLIP_N:
        raise AssertionError("decoding the synthesised clip failed")
    if (len(out) != CLIP_N or (out_dec.Width, out_dec.Height) != (tw, th)
            or out_dec.Format != F.YUV420):
        raise AssertionError(f"transcode gave {len(out)} frames of "
                             f"{out_dec.Width}x{out_dec.Height}")
    want = transcode_loop(torch, np, np.stack(src), dev)
    psnr = []
    for got, nv in zip(out, want):
        uv = nv[tw * th:].reshape(th // 2, tw)
        i420 = np.concatenate([nv[:tw * th], uv[:, 0::2].reshape(-1),
                               uv[:, 1::2].reshape(-1)]).astype(np.float64)
        mse = float(np.mean((got.astype(np.float64) - i420) ** 2))
        psnr.append(float("inf") if mse == 0
                    else 10 * np.log10(255.0 ** 2 / mse))
    log(f"transcode: {CLIP_N} frames {W}x{H} -> {tw}x{th} in {secs:.3f}s "
        f"(host clock, decode + device half + encode); PSNR against the "
        f"device half min={min(psnr)} mean={sum(psnr) / len(psnr)} ({smi})")
    if min(psnr) < 35.0:
        raise AssertionError("transcode output below 35 dB of the device "
                             "half")


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

MESH_POSITIONS = 4      # positions of the one-card data mesh
MESH_TRAIN_B = 8        # frames of the data x spatial x model step
MESH_CLASSES = 16       # the dry run's head (21 does not divide by 2)


def mesh_phase(torch, np, dev, host, planes, smi):
    """The multi-device slice (``parallel/mesh.py``) on the card.

    A mesh over the machine's own cards (``make_mesh()``): the pipeline
    over 64 in-memory 1080p YUV420 streams -> 224, batch for batch equal
    to the pipeline without a mesh. Four positions on this card: the
    NV12 preprocess kernel per data block (4 x 16 frames) and the same
    pipeline with NV12 streams, each equal to one unsharded launch; the
    NV12 resize per data block at 16 x 4K -> 1080p (4 x 4 frames), equal
    to one unsharded launch; the whole sharded call and each position's
    launch timed against the single launch. data 1 x spatial 2 x model 2:
    the dense preprocess split over rows at 8 x 1080p NV12 -> 224 f32
    against the unsharded route, with the halo bytes each position
    receives; the tensor-parallel FCN (full widths, 16 classes) against
    the unsharded FCN; one training step (a replica of the model per
    spatial place, each on half the frames, the gradients summed) against
    the unsharded step: its loss, gradients and update. Each shape the
    mesh path launches a kernel at is held to the plain version once and
    timed. Every count is set to 0 just before each mesh run and read
    just after. Returns {kernel: (shape entries, launches on the mesh path)}."""
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.models import fcn
    from vali_tpu_torch.ops.fused import fused_preprocess
    from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                    nv12_preprocess_plain)
    from vali_tpu_torch.ops.nv12_resize import nv12_resize, nv12_resize_plain
    from vali_tpu_torch.ops.yuv420_preprocess import (
        yuv420_preprocess, yuv420_preprocess_plain)
    from vali_tpu_torch.parallel import dryrun
    from vali_tpu_torch.parallel.mesh import (Mesh, P, distribute, make_mesh,
                                              map_over_data, shard_planes,
                                              sharded_kernel_preprocess)
    from vali_tpu_torch.pipeline.multistream import MultiStreamPipeline
    from vali_tpu_torch.utils.synth import HostFrameSource

    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    geo = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)
    wrappers = (nv12_preprocess, yuv420_preprocess, nv12_resize)
    out = {w.__name__: ([], 0) for w in wrappers}

    def counted(run):
        """run() with every count read just before and just after; the
        launches join each kernel's mesh-path total."""
        before = launch_counts(*wrappers)
        result = run()
        torch.cuda.synchronize()
        got = launched_since(before, *wrappers)
        for name, n in got.items():
            out[name] = (out[name][0], out[name][1] + n)
        return result, got

    def sources(fmt):
        return [HostFrameSource([host[fmt][(s + k) % B]
                                 for k in range(MAIN_BATCHES)], fmt, W, H)
                for s in range(B)]

    def pipeline(fmt, mesh):
        pipe = MultiStreamPipeline(sources(fmt), DW, DH, gpu_id=0,
                                   batch_size=B, sync_streams=True,
                                   mesh=mesh, **bt709)
        return [(b, ids) for b, ids in pipe]

    def held_and_timed(case, kern, plain):
        """kern() against plain() once on the card, checked as every
        shape is (``compare``), then both timed: (the error against the
        plain version, kernel ms, plain ms). These launches lie outside
        the counted runs."""
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(torch, f"kernel_{case}", got, ref)
        del got, ref
        return (err,) + time_pair(kern, plain)

    def same_batches(name, got, want):
        if len(got) != len(want) or len(got) != MAIN_BATCHES:
            raise AssertionError(f"{name}: {len(got)} batches")
        for k, ((batch, ids), (ref, rids)) in enumerate(zip(got, want)):
            if ids != rids or not torch.equal(batch.gather(dev), ref):
                raise AssertionError(f"{name}: batch {k} differs")

    # ---- the machine's own cards ----------------------------------------
    own = make_mesh()
    n_own = own.shape["data"]
    whole = pipeline(PixelFormat.YUV420, None)
    split, got = counted(lambda: pipeline(PixelFormat.YUV420, own))
    same_batches(f"mesh pipeline on make_mesh() ({n_own} card)", split,
                 whole)
    if got["yuv420_preprocess"] != MAIN_BATCHES * n_own:
        raise AssertionError(f"make_mesh() pipeline launches {got}")
    own_b = B // n_own
    own_planes = tuple(p[:own_b] for p in planes[PixelFormat.YUV420])
    own_err, t_kern, t_plain = held_and_timed(
        f"yuv420_preprocess mesh make_mesh() {own_b} x {H}p",
        lambda: yuv420_preprocess(*own_planes, **geo, **bt709),
        lambda: yuv420_preprocess_plain(*own_planes, **geo, **bt709))
    nbytes, ops = preprocess_work(own_b, W, H, DW, DH, "420")
    bound, bound_by = bound_ms(nbytes, ops)
    out["yuv420_preprocess"][0].append({
        "case": f"mesh make_mesh() pipeline {n_own} x {own_b} x {H}p->"
                f"{DW}x{DH} u8/bf16", "ms": t_kern, "plain_ms": t_plain,
        "bound_ms": bound, "bound_by": bound_by,
        "launches": got["yuv420_preprocess"], "max_abs_err": own_err,
        "timed": "kernel"})
    log(f"mesh make_mesh(): {own.shape} pipeline {B} YUV420 streams x "
        f"{MAIN_BATCHES} batches equal to the pipeline without a mesh; "
        f"launches={json.dumps(got)} kernel_ms={t_kern} ({smi})")

    # ---- four positions on this card: the data split -------------------
    grid = np.empty(MESH_POSITIONS, dtype=object)
    grid[:] = [dev] * MESH_POSITIONS
    quad = Mesh(grid, ("data",))
    per = B // MESH_POSITIONS
    nv12 = planes[PixelFormat.NV12][0]
    single = nv12_preprocess(nv12, **geo, **bt709)
    blocks = distribute(nv12, quad, P("data"))
    serve = sharded_kernel_preprocess(quad, W, H, DW, DH, **bt709)
    sharded, got_serve = counted(lambda: serve(blocks))
    if got_serve["nv12_preprocess"] != MESH_POSITIONS or not torch.equal(
            sharded.gather(dev), single):
        raise AssertionError(f"sharded_kernel_preprocess: {got_serve}, or "
                             f"it differs from one unsharded launch")
    ref = single.movedim(1, -1)
    split, got_pipe = counted(lambda: pipeline(PixelFormat.NV12, quad))
    same_batches("mesh pipeline nv12 on 4 positions", split,
                 [(torch.roll(ref, -k, 0), list(range(B)))
                  for k in range(MAIN_BATCHES)])
    if got_pipe["nv12_preprocess"] != MAIN_BATCHES * MESH_POSITIONS:
        raise AssertionError(f"4-position pipeline launches {got_pipe}")
    t_single = time_ms(lambda: nv12_preprocess(nv12, **geo, **bt709))
    t_call = time_ms(lambda: serve(blocks))
    t_pos = [time_ms(lambda x=sh.data: nv12_preprocess(x, **geo, **bt709))
             for sh in blocks.shards]
    block0 = blocks.shards[0].data
    block_err, t_kern, t_plain = held_and_timed(
        f"nv12_preprocess mesh position block {per} x {H}p",
        lambda: nv12_preprocess(block0, **geo, **bt709),
        lambda: nv12_preprocess_plain(block0, **geo, **bt709))
    nbytes, ops = preprocess_work(per, W, H, DW, DH, "420")
    bound, bound_by = bound_ms(nbytes, ops)
    out["nv12_preprocess"][0].append({
        "case": f"mesh {MESH_POSITIONS} positions x {per} x {H}p->{DW}x{DH} "
                f"u8/bf16 (sharded_kernel_preprocess and the pipeline)",
        "ms": t_kern, "plain_ms": t_plain, "bound_ms": bound,
        "bound_by": bound_by, "launches": got_serve["nv12_preprocess"]
        + got_pipe["nv12_preprocess"], "max_abs_err": block_err,
        "timed": "kernel", "whole_call_ms": t_call,
        "position_ms": t_pos, "single_launch_ms": t_single})
    log(f"time mesh sharded_kernel_preprocess {MESH_POSITIONS} x {per} x "
        f"{H}p NV12->{DW}x{DH} on one card: whole_call_ms={t_call} "
        f"position_launch_ms={t_pos} single_{B}_frame_launch_ms={t_single} "
        f"bound_ms={bound} per position ({smi})")
    log(f"mesh 4 positions: sharded_kernel_preprocess and the NV12 pipeline "
        f"equal one unsharded launch bit for bit; launches "
        f"{json.dumps(got_serve)} {json.dumps(got_pipe)}")

    # the resize leg: 16 x 4K NV12 -> 1080p, 4 frames a position
    rng = np.random.default_rng(13)
    nv4k = torch.from_numpy(make_frames(np, rng, PixelFormat.NV12, B4K, W4K,
                                        H4K)).to(dev).view(B4K, H4K * 3 // 2,
                                                           W4K)
    rgeo = dict(src_w=W4K, src_h=H4K, dst_w=W, dst_h=H)
    single = nv12_resize(nv4k, **rgeo)
    rblocks = distribute(nv4k, quad, P("data"))
    resize = map_over_data(lambda x: nv12_resize(x, **rgeo), quad)
    small, got_resize = counted(lambda: resize(rblocks))
    if got_resize["nv12_resize"] != MESH_POSITIONS or not torch.equal(
            small.gather(dev), single):
        raise AssertionError(f"sharded nv12_resize: {got_resize}, or it "
                             f"differs from one unsharded launch")
    t_single = time_ms(lambda: nv12_resize(nv4k, **rgeo))
    t_call = time_ms(lambda: resize(rblocks))
    t_pos = [time_ms(lambda x=sh.data: nv12_resize(x, **rgeo))
             for sh in rblocks.shards]
    rblock0 = rblocks.shards[0].data
    rper = B4K // MESH_POSITIONS
    resize_err, t_kern, t_plain = held_and_timed(
        f"nv12_resize mesh position block {rper} x 4k->1080p",
        lambda: nv12_resize(rblock0, **rgeo),
        lambda: nv12_resize_plain(rblock0, **rgeo))
    y = resize_work(rper, H4K, W4K, H, W, 1)
    c = resize_work(rper, H4K // 2, W4K // 2, H // 2, W // 2, 2)
    bound, bound_by = bound_ms(y[0] + c[0], y[1] + c[1])
    out["nv12_resize"][0].append({
        "case": f"mesh {MESH_POSITIONS} positions x {rper} x 4k->1080p "
                f"bf16", "ms": t_kern, "plain_ms": t_plain,
        "bound_ms": bound, "bound_by": bound_by,
        "launches": got_resize["nv12_resize"], "max_abs_err": resize_err,
        "timed": "kernel", "whole_call_ms": t_call, "position_ms": t_pos,
        "single_launch_ms": t_single})
    log(f"time mesh nv12_resize {MESH_POSITIONS} x {rper} x 4K->1080p on "
        f"one card: whole_call_ms={t_call} position_launch_ms={t_pos} "
        f"single_{B4K}_frame_launch_ms={t_single} bound_ms={bound} per "
        f"position; equal to one unsharded launch bit for bit ({smi})")
    del nv4k, rblocks, small, single, blocks, sharded, split

    # ---- data 1 x spatial 2 x model 2 on this card ---------------------
    mesh = dryrun.mesh3([dev] * 4)
    x = nv12[:MESH_TRAIN_B]
    prep_whole = fused_preprocess((x,), PixelFormat.NV12, W, H, DW, DH,
                                  **bt709, out_dtype=torch.float32)
    model = fcn.params_from_numpy(
        fcn.numpy_params(np.random.default_rng(5), num_classes=MESH_CLASSES),
        dev, dtype=torch.bfloat16)
    reps = dryrun.replicas(model, mesh, fcn.param_specs(model))
    logits_h = -(-DH // 8)
    labels = torch.from_numpy(np.random.default_rng(6).integers(
        0, MESH_CLASSES, (MESH_TRAIN_B, logits_h, -(-DW // 8))))
    nv12_sh = shard_planes((x,), mesh)
    loss, prep = dryrun.loss_and_grads(mesh, reps, nv12_sh, labels, W, H,
                                       DW, DH)
    rgb = prep(nv12_sh)
    d = (rgb.gather(dev) - prep_whole).abs().max().item()
    group = x.numel() * x.element_size()
    log(f"mesh data1 x spatial2 x model2 sharded_preprocess {MESH_TRAIN_B} x "
        f"{H}p NV12->{DW}x{DH} f32 vs the unsharded dense route: "
        f"max_abs_diff={d}; halo bytes received per position "
        f"{json.dumps({str(k): v for k, v in prep.received.items()})}, "
        f"held {json.dumps({str(k): v for k, v in prep.held.items()})}, "
        f"of {group} input bytes")
    if d > 1e-5 or any(v + prep.held[k] >= group
                       for k, v in prep.received.items()):
        raise AssertionError("sharded_preprocess: outside the dense "
                             "route's envelope, or a position received "
                             "the whole input")
    # the tensor-parallel forward against the unsharded FCN
    with torch.no_grad():
        tp = fcn.apply_sharded(reps[(0, 0)], prep_whole).float()
        want = fcn.apply(model, prep_whole).float()
    scale = max(want.abs().max().item(), 1.0)
    rel = (tp - want).abs().max().item() / scale
    log(f"mesh tensor-parallel FCN (widths {fcn.WIDTHS}, {MESH_CLASSES} "
        f"classes, model 2) vs unsharded: max_abs_diff/max_logit={rel}")
    if not torch.isfinite(tp).all() or rel > 0.02:
        raise AssertionError("tensor-parallel FCN outside the bf16 "
                             "envelope of the unsharded FCN")
    # one training step against the unsharded step
    model.zero_grad()
    loss_w = dryrun.unsharded_loss_and_grads(model, x, labels, W, H, DW, DH)
    lrel, worst = dryrun.step_differences(reps, loss, model, loss_w)
    # the update p - 1e-3 g: element for element on every replica, and
    # against the unsharded step's in units of 1e-3 max|g|
    wrong, moved, off = dryrun.update_differences(reps, model)
    log(f"mesh training step (data1 x spatial2 x model2, {MESH_TRAIN_B} x "
        f"{H}p NV12, one replica per spatial place on {MESH_TRAIN_B // 2} "
        f"frames): loss={loss.item()} unsharded={loss_w.item()} "
        f"rel={lrel}; max |grad diff| / max |grad| = {worst}; update: "
        f"{wrong} elements off p - lr*g, {moved} moved, max |update diff| "
        f"beyond one bf16 ulp / (lr max|g|) = {off}")
    if not np.isfinite(loss.item()) or lrel > dryrun.LOSS_RTOL \
            or worst > dryrun.GRAD_TOL or wrong or not moved \
            or off > dryrun.GRAD_TOL:
        raise AssertionError("the sharded training step is outside the "
                             "envelope of the unsharded step")
    log("mesh: ok, the machine's mesh, 4 positions (kernels, pipeline, "
        "resize) and data x spatial x model (halo, FCN, training step)")
    return out


SAMPLE_STREAMS = 4     # in-memory 1080p YUV420 streams of the samples
SAMPLE_FRAMES = 6      # frames of each stream (stream s repeats frame s)
SAMPLE_POSITIONS = 4   # sample_multichip's mesh positions on this card
SAMPLE_BATCHES = 2     # batches sample_multichip takes
#: the samples that need the native engine, with their arguments ({clip}
#: is a synthesised 848x464 clip in the directory {tmp})
DECODE_SAMPLES = (
    ("get_device_info", ()), ("sample_decode", ("{clip}",)),
    ("sample_seek", ("{clip}",)),
    ("sample_decode_from_network", ("{clip}",)),
    ("sample_transcode", ("{clip}", "{tmp}/out.mp4", "320", "180")),
    ("sample_jpeg", ("{clip}", "2")),
    ("sample_torch_interop", ("{clip}", "2")),
    ("sample_scene_detection", ("{clip}",)),
    ("sample_hdr_tonemap", ("{tmp}/hdr.h264", "{tmp}/sdr.h264")))


def samples_phase(torch, np, dev, frames, planes, no_engine, smi):
    """The port's samples (``vali_tpu_torch/samples``) on the card.

    ``sample_profile``: 8 x 848x464 NV12 -> 224 through preprocess_batch
    under torch.profiler; its batch held to nv12_preprocess_plain, its
    trace checked for the sample's scope, its frames/s logged. The four
    pipeline samples on SAMPLE_STREAMS in-memory 1080p YUV420 streams
    (``frames``, with their device ``planes``), stream s repeating frame
    s, so that every row of a batch is known from its stream id:
    sample_multistream (224 u8), sample_detection_preprocess (640
    letterbox), sample_segmentation (224 f32 -> the FCN) and
    sample_multichip (a mesh of SAMPLE_POSITIONS positions on this card),
    each sample's batches held to the plain version on the same frames
    and the FCN's classes to those of the plain batches. Every count is
    set to 0 just before each sample and read just after; each shape a
    sample launches a kernel at is held to the plain version and timed.
    get_device_info, the decode-based samples and sample_multistream's
    jpeg mode run where the native engine loads; else one line says why
    not. They are counted too, plane_resize and nv12_to_rgb among the
    wrappers (sample_transcode's ToNV12, sample_torch_interop's
    converter), and their launches join each kernel's total; the shapes
    they launch at (a decoded clip's) are not timed or held to the plain
    version here, each sample checking its own output. Returns {kernel:
    (shape entries, launches in the samples)}."""
    import importlib

    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.models import fcn
    from vali_tpu_torch.ops.fused import letterbox_params
    from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                    nv12_preprocess_plain)
    from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb
    from vali_tpu_torch.ops.plane_resize import plane_resize
    from vali_tpu_torch.ops.yuv420_preprocess import (
        yuv420_preprocess, yuv420_preprocess_plain)
    from vali_tpu_torch.samples import (sample_detection_preprocess,
                                        sample_multichip, sample_multistream,
                                        sample_profile, sample_segmentation)
    from vali_tpu_torch.utils.synth import HostFrameSource, synthesize_clip

    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    wrappers = (nv12_preprocess, yuv420_preprocess, plane_resize,
                nv12_to_rgb)
    out = {w.__name__: ([], 0) for w in wrappers}

    def counted(name, run):
        """run() with every count read just before and just after; the
        launches join each kernel's samples total."""
        before = launch_counts(*wrappers)
        result = run()
        torch.cuda.synchronize()
        got = launched_since(before, *wrappers)
        for k, n in got.items():
            out[k] = (out[k][0], out[k][1] + n)
        log(f"sample {name}: launches={json.dumps(got)}")
        return result, got

    def shape(kernel, case, kern, plain, work, launches):
        """kern() against plain() once, both timed: the shape's entry.
        These launches lie outside the counted runs."""
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(torch, f"kernel_{kernel} {case}", got, ref)
        del got, ref
        t_kern, t_plain = time_pair(kern, plain)
        bound, bound_by = bound_ms(*work)
        log(f"time {kernel} {case}: kernel_ms={t_kern} plain_ms={t_plain} "
            f"bound_ms={bound} bound_by={bound_by} "
            f"sample_launches={launches} ({smi})")
        out[kernel][0].append({
            "case": case, "ms": t_kern, "plain_ms": t_plain,
            "bound_ms": bound, "bound_by": bound_by, "launches": launches,
            "max_abs_err": err, "timed": "kernel"})

    # ---- sample_profile: the NV12 kernel at 8 x 848x464 -> 224 ----------
    sp = sample_profile
    with tempfile.TemporaryDirectory() as tmp:
        (nv12, batch, path, fps), got = counted(
            "sample_profile", lambda: sp.profile(tmp, dev))
        with open(path) as f:
            trace = f.read()
    pgeo = dict(src_w=sp.W, src_h=sp.H, dst_w=sp.D, dst_h=sp.D, **bt709)
    n = got["nv12_preprocess"]
    if n != sp.STEPS + 1:
        raise AssertionError(f"sample_profile launched nv12_preprocess {n} "
                             f"times, expected {sp.STEPS + 1}")
    compare(torch, "sample_profile batch vs nv12_preprocess_plain", batch,
            nv12_preprocess_plain(nv12, **pgeo).movedim(1, -1))
    scope = f"vali::{sp.SCOPE}"
    if scope not in trace:
        raise AssertionError(f"sample_profile's trace lacks {scope}")
    log(f"sample_profile: frames_per_s={fps} under torch.profiler (host "
        f"clock, {sp.STEPS} x {sp.B} frames {sp.W}x{sp.H} NV12 -> "
        f"{sp.D}x{sp.D}, each step synchronised); trace {len(trace)} bytes "
        f"names {scope}; names the kernel (preprocess_kernel): "
        f"{'preprocess_kernel' in trace} ({smi})")
    shape("nv12_preprocess", f"sample_profile {sp.B} x {sp.W}x{sp.H}->"
          f"{sp.D}x{sp.D} u8/bf16", lambda: nv12_preprocess(nv12, **pgeo),
          lambda: nv12_preprocess_plain(nv12, **pgeo),
          preprocess_work(sp.B, sp.W, sp.H, sp.D, sp.D, "420"), n)

    # ---- the pipeline samples on in-memory 1080p streams ----------------
    S = SAMPLE_STREAMS
    p = tuple(x[:S] for x in planes)

    def streams():
        return [HostFrameSource([frames[s]] * SAMPLE_FRAMES,
                                PixelFormat.YUV420, W, H) for s in range(S)]

    def stacked(seen, ref):
        """(the batches' rows, the rows of ``ref`` of their streams)."""
        ids = torch.tensor([i for _, ids in seen for i in ids],
                           device=ref.device)
        return torch.cat([b for b, _ in seen]), ref[ids]

    def plain(**kw):
        return yuv420_preprocess_plain(*p, **dict(
            dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH), **bt709, **kw))

    def kern(**kw):
        return lambda: yuv420_preprocess(*p, **dict(
            dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH), **bt709, **kw))

    seen = []
    (n, _), got = counted("sample_multistream", lambda: sample_multistream.run(
        streams(), dev, on_batch=lambda b, ids: seen.append((b, ids))))
    batch, want = stacked(seen, plain().movedim(1, -1))
    if n != S * SAMPLE_FRAMES or batch.shape != (n, DH, DW, 3):
        raise AssertionError(f"sample_multistream: {n} frames")
    compare(torch, "sample_multistream batches vs the plain version", batch,
            want)
    shape("yuv420_preprocess", f"sample_multistream {S} x {H}p->{DW}x{DH} "
          f"u8/bf16", kern(), plain,
          preprocess_work(S, W, H, DW, DH, "420"),
          got["yuv420_preprocess"])

    iw, ih, left, top, _ = letterbox_params(W, H, LETTERBOX, LETTERBOX)
    seen = []
    (n, _, _), got = counted(
        "sample_detection_preprocess",
        lambda: sample_detection_preprocess.run(
            streams(), dev, LETTERBOX,
            on_batch=lambda b, ids: seen.append((b, ids))))
    batch, want = stacked(seen, plain(dst_w=iw, dst_h=ih).movedim(1, -1))
    canvas = torch.full_like(batch, 114)
    canvas[:, top:top + ih, left:left + iw] = batch[:, top:top + ih,
                                                    left:left + iw]
    if n != S * SAMPLE_FRAMES or not torch.equal(canvas, batch):
        raise AssertionError("sample_detection_preprocess: frames or bars")
    compare(torch, "sample_detection_preprocess content vs the plain "
            "version", batch[:, top:top + ih, left:left + iw], want)
    shape("yuv420_preprocess", f"sample_detection_preprocess {S} x {H}p->"
          f"{iw}x{ih} u8/bf16 (letterbox {LETTERBOX})",
          kern(dst_w=iw, dst_h=ih), lambda: plain(dst_w=iw, dst_h=ih),
          preprocess_work(S, W, H, iw, ih, "420"),
          got["yuv420_preprocess"])

    seen = []
    (n, model), got = counted(
        "sample_segmentation", lambda: sample_segmentation.run(
            streams(), dev,
            on_batch=lambda b, ids, c: seen.append(((b, c), ids))))
    f32 = dict(out_dtype=torch.float32)
    batch, want = stacked([(b, ids) for (b, _), ids in seen],
                          plain(**f32).movedim(1, -1))
    classes = torch.cat([c for (_, c), _ in seen])
    compare(torch, "sample_segmentation batches vs the plain version",
            batch, want)
    agree = (fcn.predict_classes(model, want) == classes).double().mean()
    log(f"sample_segmentation: {n} frames; FCN classes of the kernel's "
        f"batches vs the plain batches: agreement={agree.item()}")
    if n != S * SAMPLE_FRAMES or agree.item() <= 0.98:
        raise AssertionError("sample_segmentation: frames or classes")
    shape("yuv420_preprocess", f"sample_segmentation {S} x {H}p->{DW}x{DH} "
          f"f32", kern(**f32), lambda: plain(**f32),
          preprocess_work(S, W, H, DW, DH, "420", out_bytes=4),
          got["yuv420_preprocess"])

    seen = []
    done, got = counted("sample_multichip", lambda: sample_multichip.run(
        streams(), dev, SAMPLE_POSITIONS, SAMPLE_BATCHES,
        on_batch=lambda b, ids: seen.append((b.gather(dev), ids))))
    batch, want = stacked(seen, plain().movedim(1, -1))
    if done != SAMPLE_BATCHES or batch.shape[0] != 2 * SAMPLE_POSITIONS * done:
        raise AssertionError(f"sample_multichip: {done} batches")
    compare(torch, "sample_multichip batches vs the plain version", batch,
            want)
    per = 2  # frames a position preprocesses per batch
    shape("yuv420_preprocess", f"sample_multichip {SAMPLE_POSITIONS} "
          f"positions x {per} x {H}p->{DW}x{DH} u8/bf16",
          lambda: yuv420_preprocess(*(x[:per] for x in p), src_w=W, src_h=H,
                                    dst_w=DW, dst_h=DH, **bt709),
          lambda: yuv420_preprocess_plain(*(x[:per] for x in p), src_w=W,
                                          src_h=H, dst_w=DW, dst_h=DH,
                                          **bt709),
          preprocess_work(per, W, H, DW, DH, "420"),
          got["yuv420_preprocess"])

    # ---- get_device_info and the samples that need the native engine ----
    names = ", ".join([n for n, _ in DECODE_SAMPLES]
                      + ["sample_multistream jpeg"])
    if no_engine:
        log(f"samples {names}: skipped: {no_engine}")
        return out
    with tempfile.TemporaryDirectory() as tmp:
        clip = synthesize_clip(f"{tmp}/clip.mp4")
        from vali_tpu_torch.samples.sample_hdr_tonemap import (
            synthesize_hdr_clip)

        synthesize_hdr_clip(f"{tmp}/hdr.h264")
        for name, args in DECODE_SAMPLES:
            main = importlib.import_module(
                f"vali_tpu_torch.samples.{name}").main
            counted(name, lambda: main(
                [a.format(clip=clip, tmp=tmp) for a in args]
                + ["--device", str(dev)]))
    (blobs, n, _), _ = counted("sample_multistream jpeg",
                               lambda: sample_multistream.run_jpeg(
                                   streams(), dev))
    if n != S * SAMPLE_FRAMES or not all(b[:2].tolist() == [0xFF, 0xD8]
                                         for b in blobs):
        raise AssertionError("sample_multistream jpeg: bad JPEGs")
    log(f"samples {names}: ok")
    return out


BENCH_BUDGET_S = 120   # the bench's budget inside this run
#: the bench's records that need the native engine
BENCH_ENGINE_CONFIGS = ("1_sw_decode_cpu_convert", "3_transcode_4k_hevc",
                        "4_decode_preprocess_inference_e2e",
                        "5_pipeline_64x1080p_jpeg")


def bench_phase(torch, np, dev, no_engine, smi, kernel_ms, two_stage_ms):
    """``python -m vali_tpu_torch bench``'s measurement
    (``vali_tpu_torch.bench.run``) in-process on the card, its line
    logged whole. Every count is set to 0 as each of the bench's sections
    starts and read as the next starts (or the run ends), so each kernel
    of a section has its own count. Checks: no abort and no config error;
    a positive headline; each engine-bound record null, with the engine's
    reason, exactly when ``no_engine``; 5_pipeline_chipside's frames
    decoded or synthetic to match; the five kernels of the bench's path
    launched, in the sections that call them, and the dense sections
    launch none; the headline's ms within 0.67-1.5x of ``kernel_ms`` (the
    main path's nv12_preprocess at 64 x 1080p -> 224) and config 2's within
    0.67-1.5x of ``two_stage_ms`` (nv12_to_rgb + packed_resize there), which
    an unsynchronised or plain-version timing would miss by far. Each
    shape a section launches a kernel at is held to the plain version on
    seeded frames and timed. Returns {kernel: (shape entries, launches in
    the bench)}."""
    from vali_tpu_torch import bench
    from vali_tpu_torch import bench_configs as bc
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                    nv12_preprocess_plain)
    from vali_tpu_torch.ops.nv12_resize import nv12_resize, nv12_resize_plain
    from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb, nv12_to_rgb_plain
    from vali_tpu_torch.ops.packed_resize import (packed_resize,
                                                  packed_resize_plain)
    from vali_tpu_torch.ops.yuv420_preprocess import (
        yuv420_preprocess, yuv420_preprocess_plain)
    from vali_tpu_torch.pipeline.multistream import BatchStager

    wrappers = (nv12_preprocess, yuv420_preprocess, nv12_to_rgb,
                packed_resize, nv12_resize)
    sections, current = {}, [None, None]

    def read_counts():
        if current[0] is not None:
            sections[current[0]] = launched_since(current[1], *wrappers)

    def progress(section):
        read_counts()
        current[:] = section, launch_counts(*wrappers)

    t0 = time.perf_counter()
    result = bench.run(dev, budget_s=BENCH_BUDGET_S, progress=progress)
    torch.cuda.synchronize()
    read_counts()
    log(f"bench: {json.dumps(result)} run_s={time.perf_counter() - t0} "
        f"({smi})")
    log(f"bench launches by section: {json.dumps(sections)}")
    total = {w.__name__: sum(c[w.__name__] for c in sections.values())
             for w in wrappers}

    configs = result["configs"]
    errors = {k: r["error"] for k, r in configs.items() if "error" in r}
    if result.get("aborted") or errors:
        raise AssertionError(f"bench: aborted={result.get('aborted')} "
                             f"errors={errors}")
    if not result["value"] or result["value"] <= 0:
        raise AssertionError("bench: no headline")
    if bench.exit_status(result):
        raise AssertionError("bench: exit status 1")
    for name in BENCH_ENGINE_CONFIGS:
        rec = configs[name]
        if (rec != {"value": None, "reason": no_engine} if no_engine
                else not rec.get("value")):
            raise AssertionError(f"bench {name}: {rec} with engine reason "
                                 f"{no_engine!r}")
    if (result["sw_decode_fps_single_stream_848x464"] is None) != bool(
            no_engine):
        raise AssertionError("bench: the decode rate against the engine")
    frames_from = configs["5_pipeline_chipside"]["frames_from"]
    if frames_from != (f"synthetic: {no_engine}" if no_engine
                       else "decoded"):
        raise AssertionError(f"bench chipside frames_from={frames_from}")
    for section in ("dense contrast", "H2D"):
        if any(sections[section].values()):
            raise AssertionError(f"bench {section} launched a kernel")
    headline = result["ms_per_64frame_batch_kernel"]
    two_stage = configs["2_tpu_two_stage_convert_resize"]["ms_per_batch"]
    for what, got, want in (("headline", headline, kernel_ms),
                            ("config 2", two_stage, two_stage_ms)):
        log(f"bench {what} ms={got} against {want} earlier in this run: "
            f"ratio={got / want}")
        if not 0.67 <= got / want <= 1.5:
            raise AssertionError(f"bench {what}: {got} ms against {want}")

    # the shapes of the sections that launch kernels, on seeded frames
    B, H, W, D = bc.B, bc.H, bc.W, bc.DST
    B4R, B4, H4K, W4K = bench.B4R, bench.B4, bench.H4K, bench.W4K
    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    rng = np.random.default_rng(14)

    def nv12_frames(b, w, h):
        return torch.from_numpy(make_frames(np, rng, PixelFormat.NV12, b, w,
                                            h)).to(dev).view(b, h * 3 // 2, w)

    nv12, nv4k = nv12_frames(B, W, H), nv12_frames(B4R, W4K, H4K)
    i420 = BatchStager(PixelFormat.YUV420, W, H, dev).split(torch.from_numpy(
        make_frames(np, rng, PixelFormat.YUV420, B, W, H)).to(dev))
    rgb = nv12_to_rgb(nv12, src_w=W, src_h=H, **bt709)
    to_d = dict(src_w=W, src_h=H, dst_w=D, dst_h=D)
    to_1080 = dict(src_w=W4K, src_h=H4K, dst_w=W, dst_h=H)
    aa = "lanczos_aa"
    y = resize_work(B4R, H4K, W4K, H, W, 1, aa)
    c = resize_work(B4R, H4K // 2, W4K // 2, H // 2, W // 2, 2, aa)
    # (section, kernel, case, plain version, arguments, keywords,
    #  (bytes, operations))
    cases = (
        ("headline kernel", nv12_preprocess,
         f"bench headline {B} x {H}p->{D} u8/bf16", nv12_preprocess_plain,
         (nv12,), dict(to_d, **bt709), preprocess_work(B, W, H, D, D)),
        ("config 5_pipeline_chipside", yuv420_preprocess,
         f"bench 5_pipeline_chipside {B} x {H}p->{D} u8/bf16",
         yuv420_preprocess_plain, i420, dict(to_d, **bt709),
         preprocess_work(B, W, H, D, D)),
        ("config 2_tpu_two_stage_convert_resize", nv12_to_rgb,
         f"bench config 2 {B} x {H}p rgb", nv12_to_rgb_plain, (nv12,),
         dict(src_w=W, src_h=H, **bt709),
         (nv12.nbytes + rgb.nbytes, CSC_OPS * B * H * W)),
        ("config 2_tpu_two_stage_convert_resize", packed_resize,
         f"bench config 2 {B} x rgb {H}p->{D}", packed_resize_plain, (rgb,),
         to_d, resize_work(B, H, W, D, D, 3, aa)),
        ("4K resize", nv12_resize, f"bench {B4R} x 4k->{H}p bf16",
         nv12_resize_plain, (nv4k,), to_1080, (y[0] + c[0], y[1] + c[1])),
        ("4K preprocess", nv12_preprocess,
         f"bench {B4} x 4k->{D} u8/bf16", nv12_preprocess_plain,
         (nv4k[:B4],), dict(to_d, src_w=W4K, src_h=H4K, **bt709),
         preprocess_work(B4, W4K, H4K, D, D)))
    out = {w.__name__: ([], total[w.__name__]) for w in wrappers}
    for section, kern, case, plain, args, kw, work in cases:
        name = kern.__name__
        n = sections[section][name]
        if n < 1:
            raise AssertionError(f"bench {section}: {name} not launched")
        got, ref = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        err = compare(torch, f"kernel_{name} {case}", got, ref)
        del got, ref
        t_kern, t_plain = time_pair(lambda: kern(*args, **kw),
                                    lambda: plain(*args, **kw))
        bound, bound_by = bound_ms(*work)
        log(f"time {name} {case}: kernel_ms={t_kern} plain_ms={t_plain} "
            f"bound_ms={bound} bound_by={bound_by} bench_launches={n} "
            f"({smi})")
        out[name][0].append({
            "case": case, "ms": t_kern, "plain_ms": t_plain,
            "bound_ms": bound, "bound_by": bound_by, "launches": n,
            "max_abs_err": err, "timed": "kernel"})
    if min(total.values()) < 1:
        raise AssertionError(f"bench: a kernel was not launched: {total}")
    return out


if __name__ == "__main__":
    sys.exit(main())
