"""Multi-stream batched decode -> GPU preprocess pipeline.

Counterpart of ``vali_tpu/pipeline/multistream.py``. Architecture:

  N demux/decode threads (GIL released in the native engine)
      -> per-stream host frame ring
      -> batch assembler (pinned staging buffers, one H2D copy per batch)
      -> one fused CSC+resize kernel launch per batch on the GPU
      -> device tensors handed to the consumer, still in flight

Decode runs on host cores and overlaps with device compute; the GPU sees one
large batched kernel per tick instead of one small one per stream.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat, TaskExecInfo
from ..core.formats import format_info
from ..engine.decoder import PyDecoder
from ..ops import colors
from ..ops.banded import kernel_preprocess, kernel_preprocess_formats
from ..ops.fused import fused_preprocess, letterbox_pad, letterbox_params
from ..ops.resize import LANCZOS_AA
from ..parallel.mesh import (Mesh, P, Shard, ShardedTensor,
                             on_position_streams)
from ..utils.device import get_device, kernel_platform_available
from ..utils.tracing import count, span


def _kernel_usable(src_fmt, space, crange, device) -> bool:
    """True when a banded kernel covers the format on this device (format
    set shared with the kernel_preprocess dispatch — one source of
    truth)."""
    return (kernel_platform_available(device)
            and PixelFormat(src_fmt) in kernel_preprocess_formats()
            and colors.yuv2rgb_matrix(space, crange) is not None)


def _open(src, opts):
    """The host-frame decoder of one source: a path or file-like object
    gets a PyDecoder; an object that already has PyDecoder's host-frame
    interface (``Width``, ``Height``, ``Format``, ``HostFrameSize``,
    ``DecodeSingleFrame``) is used as it is."""
    if hasattr(src, "DecodeSingleFrame"):
        return src
    return PyDecoder(src, opts, gpu_id=-1)


class _StreamWorker(threading.Thread):
    """Decodes a GROUP of streams round-robin on one thread.

    Frames are decoded straight into recycled buffers from ``buf_pool``
    (no per-frame copy); the consumer returns them to the pool after the
    batch is staged. One thread per stream (group size 1) is the
    reference's model; for stream counts far above the host core count
    that thrashes the scheduler, so groups multiplex several decoders on
    one thread while every stream still progresses.
    """

    def __init__(self, streams, opts, out_q: "queue.Queue",
                 stop_event: threading.Event, buf_pool: "queue.Queue"):
        ids = [sid for sid, _ in streams]
        name = (f"vali-decode-{ids[0]}" if len(ids) == 1
                else f"vali-decode-mux-{ids[0]}-{ids[-1]}")
        super().__init__(daemon=True, name=name)
        self.streams = list(streams)  # [(stream_id, source), ...]
        self.n_streams = len(self.streams)
        self.opts = dict(opts)
        self.out_q = out_q
        self.stop_event = stop_event
        self.buf_pool = buf_pool
        self.error: Optional[Exception] = None

    def run(self):
        ended = set()
        live = {}
        try:
            for sid, src in self.streams:
                live[sid] = _open(src, self.opts)
            while live and not self.stop_event.is_set():
                for sid in list(live):
                    if self.stop_event.is_set():
                        break
                    try:
                        buf = self.buf_pool.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    ok, info = live[sid].DecodeSingleFrame(buf)
                    if not ok or info != TaskExecInfo.SUCCESS:
                        self.buf_pool.put(buf)
                        del live[sid]
                        self.out_q.put((sid, None))
                        ended.add(sid)
                        continue
                    self.out_q.put((sid, buf))
        except Exception as e:
            self.error = e
        finally:
            for sid, _ in self.streams:  # sentinels for streams cut short
                if sid not in ended:
                    self.out_q.put((sid, None))
                    ended.add(sid)


class BatchStager:
    """Host frames -> batched storage-layout planes on ``device``.

    On a CUDA device the frames of a batch are stacked into a pinned
    ``[B, frame_bytes]`` uint8 buffer and copied with ONE non-blocking H2D
    copy; the planes are device views carved from that copy. A CUDA event
    recorded after the batch's dispatch guards the pinned buffer: it is
    reused only once the event reports completion, because overwriting it
    while the async copy is still reading would corrupt the batch in
    flight. On the CPU the planes are views of a freshly stacked array.
    :meth:`run_on_mesh` splits a staged batch over a mesh's "data" axis.
    """

    def __init__(self, src_fmt: PixelFormat, src_w: int, src_h: int,
                 device: torch.device, keep: int = 4):
        self.src_fmt = PixelFormat(src_fmt)
        self.src_w, self.src_h = src_w, src_h
        self.device = torch.device(device)
        self.keep = keep
        #: (pinned buffer, the events of the copies that read it)
        self._inflight: List[Tuple[torch.Tensor, list]] = []
        self._free: List[torch.Tensor] = []

    def split(self, batch: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[B, host_frame_bytes] uint8 -> batched storage-layout planes
        (views; multi-plane formats become strided views)."""
        info = format_info(self.src_fmt)
        b = batch.shape[0]
        flat = batch.view(getattr(torch, info.dtype.name))
        planes = []
        off = 0
        for (h, w) in info.plane_dims(self.src_w, self.src_h):
            planes.append(flat[:, off:off + h * w].unflatten(1, (h, w)))
            off += h * w
        return tuple(planes)

    def _acquire(self, n: int, total: int) -> torch.Tensor:
        """A pinned [n, total] buffer no pending copy reads any more."""
        still = []
        for buf, events in self._inflight:
            if all(e.query() for e in events):
                self._free.append(buf)
            else:
                still.append((buf, events))
        self._inflight = still
        for i, buf in enumerate(self._free):
            if tuple(buf.shape) == (n, total):
                return self._free.pop(i)
        # no exact-shape buffer: evict mismatched ones beyond the keep
        # depth. Batch shape shrinks as streams hit EOS; without eviction
        # every shrink strands the old multi-MB buffers for the pipeline's
        # lifetime.
        if len(self._free) > self.keep:
            self._free = self._free[-self.keep:]
        count("stage.pinned_allocs")
        return torch.empty((n, total), dtype=torch.uint8, pin_memory=True)

    def run(self, frames: Sequence[np.ndarray],
            dispatch: Callable[[Tuple[torch.Tensor, ...]], torch.Tensor]
            ) -> torch.Tensor:
        """Stage ``frames`` (flat host frames of equal size), run
        ``dispatch(planes)`` and return its result."""
        with span("stage"):
            if self.device.type != "cuda":
                return dispatch(self.split(torch.from_numpy(
                    np.stack(frames))))
            with span("stage.acquire"):
                host = self._acquire(len(frames), frames[0].nbytes)
            with span("stage.stack"):
                np.stack([f.view(np.uint8) for f in frames], out=host.numpy())
            with span("stage.h2d"):
                dev = host.to(self.device, non_blocking=True)
            out = dispatch(self.split(dev))
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._inflight.append((host, [event]))
            return out

    def run_on_mesh(self, frames: Sequence[np.ndarray], mesh: Mesh,
                    dispatch: Callable[[Tuple[torch.Tensor, ...]],
                                       torch.Tensor]) -> ShardedTensor:
        """Stage ``frames`` and run ``dispatch`` on every position of
        ``mesh``, each on its own block of the batch: the batch is split
        over the "data" axis (positions along other axes hold replicas).

        The frames are stacked into one batch, padded by repeating the
        last frame until the "data" axis divides it (the EOS tail); the
        padding is sliced off the result. On a card the batch is stacked
        into one pinned buffer, each position's rows go to its device with
        one non_blocking copy on its own stream, where its ``dispatch``
        runs too (``parallel/mesh.on_position_streams``); the buffer is
        reused only after every position's copy event."""
        with span("stage"):
            n = len(frames)
            data = mesh.axis_size("data")
            frames = list(frames) + [frames[-1]] * (-n % data)
            rows = len(frames) // data
            cuda = any(d.type == "cuda" for d in mesh.devices.flat)
            if cuda:
                with span("stage.acquire"):
                    host = self._acquire(len(frames), frames[0].nbytes)
                with span("stage.stack"):
                    np.stack([f.view(np.uint8) for f in frames],
                             out=host.numpy())
            else:
                host = torch.from_numpy(np.stack(frames))

            def job(part, dev):
                with span("stage.h2d"):
                    part = part.to(dev, non_blocking=True)
                return dispatch(self.split(part))
            jobs, index = [], []
            for pos in mesh.positions():
                dev = mesh.device(pos)
                d = mesh.coord(pos, "data")
                part = host[d * rows:(d + 1) * rows]
                jobs.append((dev, [], functools.partial(job, part, dev)))
                index.append((pos, dev, slice(d * rows, (d + 1) * rows)))
            outs, events = on_position_streams(jobs)
            if cuda:
                self._inflight.append((host, events))
            shards = [Shard(pos, dev, (b,) + tuple(
                slice(0, k) for k in out.shape[1:]), out)
                for (pos, dev, b), out in zip(index, outs)]
            return ShardedTensor((len(frames),) + tuple(outs[0].shape[1:]),
                                 mesh, P("data"), shards).head(n)


class MultiStreamPipeline:
    """Decode N streams and yield batched, preprocessed device tensors.

    Yields (batch, stream_ids): ``batch`` is a [B, dst_h, dst_w, 3] tensor
    on the target device (uint8, or float when ``normalize`` / a float
    ``out_dtype``); ``stream_ids`` names the source of each row. The
    batch may still be in flight on the device's current stream. With a
    ``mesh`` the batch is a ``parallel/mesh.ShardedTensor`` split over the
    mesh's "data" axis.
    """

    def __init__(self, sources: Sequence, dst_w: int, dst_h: int,
                 gpu_id: int = 0, opts: Optional[dict] = None,
                 batch_size: Optional[int] = None,
                 space: ColorSpace = ColorSpace.BT_709,
                 crange: ColorRange = ColorRange.MPEG,
                 out_dtype: torch.dtype = torch.uint8, planar: bool = False,
                 method: str = LANCZOS_AA,
                 normalize=None,
                 queue_depth: int = 4,
                 sync_streams: bool = False,
                 prefetch: int = 2,
                 decode_threads: Optional[int] = None,
                 mesh=None,
                 letterbox: bool = False,
                 pad_value: int = 114):
        """``sources`` are URLs/paths, file-like objects, or decoder objects
        with PyDecoder's host-frame interface (e.g.
        ``utils/synth.HostFrameSource``); a decoder object feeds one
        stream, since one worker thread reads it.
        ``sync_streams=True`` assembles batches with exactly one frame
        per live stream (lock-step across streams, e.g. for synchronized
        multi-camera rigs); the default takes frames in arrival order for
        maximum throughput. ``prefetch`` batches are staged and dispatched
        ahead of the consumer (host staging + H2D overlap with downstream
        compute). ``decode_threads`` bounds the decode thread pool: when
        streams outnumber host cores, streams are multiplexed round-robin
        over this many threads instead of one thread per stream (default:
        min(n_streams, 4*cpu_count); sync_streams always uses one thread
        per stream). ``gpu_id=-1`` runs the preprocess on the CPU.
        ``mesh``: a ``parallel/mesh.Mesh`` with a "data" axis — staged
        batches are split over it and the preprocess runs on every
        position of the mesh, each on its own device and stream
        (batch_size must be divisible by the data-axis size; gpu_id is
        then ignored). ``letterbox=True`` keeps the source aspect ratio: content is
        resized to fit inside dst_w x dst_h and centered on a
        ``pad_value`` canvas (see ops/fused.letterbox_params for mapping
        model outputs back to source coordinates)."""
        if not sources:
            raise ValueError("Need at least one source")
        self.sources = list(sources)
        self.dst_w, self.dst_h = dst_w, dst_h
        self.batch_size = batch_size or len(self.sources)
        self.mesh = mesh
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                                 f"{type(mesh).__name__}")
            if "data" not in mesh.axis_names:
                raise ValueError("mesh needs a 'data' axis")
            data_size = mesh.shape["data"]
            if self.batch_size % data_size:
                raise ValueError(
                    f"batch_size {self.batch_size} not divisible by the "
                    f"mesh data axis ({data_size})")
            self.device = mesh.devices.flat[0]
        else:
            self.device = get_device(gpu_id)
        self.space, self.crange = space, crange
        self.out_dtype = out_dtype
        self.planar = planar
        self.method = method
        # per-channel (mean, std) folded into the preprocess kernel so
        # model-ready tensors come straight off the device
        if normalize is not None and out_dtype == torch.uint8:
            raise ValueError(
                "normalize requires a float out_dtype (e.g. torch.float32 "
                "or torch.bfloat16)")
        self.normalize = normalize
        self.letterbox = bool(letterbox)
        self.pad_value = int(pad_value)
        self.sync_streams = sync_streams
        self.prefetch = max(1, int(prefetch))

        # probe every source: the shared buffer pool and batch geometry
        # require uniform width/height/format across streams
        probe = _open(self.sources[0], opts or {})
        self.src_w, self.src_h = probe.Width, probe.Height
        self.src_fmt = PixelFormat(probe.Format)
        probe_size = probe.HostFrameSize
        del probe
        self._stager = BatchStager(self.src_fmt, self.src_w, self.src_h,
                                   self.device, keep=self.prefetch + 2)
        # additional path sources use the probe-only native decoder
        # (demux headers only, no codec open) — the workers' decoders are
        # the full opens; decoder objects report their own geometry
        from ..engine._opts import opt_str

        # the probe must see the SAME opts the workers decode with:
        # geometry-affecting options (e.g. video_size for raw input)
        # otherwise make uniform streams fail validation — or mismatched
        # ones pass it
        probe_opts = {opt_str(k): opt_str(v)
                      for k, v in (opts or {}).items()}
        seen = {self.sources[0]} if isinstance(self.sources[0],
                                               (str, bytes)) else set()
        for i, src in enumerate(self.sources[1:], start=1):
            if hasattr(src, "DecodeSingleFrame"):
                geom = (src.Width, src.Height, PixelFormat(src.Format))
            elif not isinstance(src, (str, bytes)) or src in seen:
                continue  # file-like sources are validated by their worker
            else:
                from ..engine._loader import load_native

                seen.add(src)
                p = load_native().Decoder(src, probe_opts, None,
                                          True).props()
                geom = (p["width"], p["height"], PixelFormat(p["format"]))
            if geom != (self.src_w, self.src_h, self.src_fmt):
                raise ValueError(
                    f"Source {i} geometry {geom[0]}x{geom[1]}/"
                    f"{geom[2].name} differs from source 0 "
                    f"{self.src_w}x{self.src_h}/"
                    f"{PixelFormat(self.src_fmt).name}; all streams in a "
                    f"pipeline must share resolution and pixel format")

        self._stop = threading.Event()
        # recycled decode buffers: enough for all queue slots + in-flight
        pool_size = (queue_depth + 2) * max(len(self.sources),
                                            self.batch_size)
        self._buf_pool: "queue.Queue" = queue.Queue()
        for _ in range(pool_size):
            self._buf_pool.put(np.zeros(probe_size, dtype=np.uint8))
        if sync_streams:
            self._queues: List["queue.Queue"] = [
                queue.Queue(maxsize=queue_depth)
                for _ in range(len(self.sources))
            ]
            self._workers = [
                _StreamWorker([(i, src)], opts or {}, self._queues[i],
                              self._stop, self._buf_pool)
                for i, src in enumerate(self.sources)
            ]
            self._frame_q = None
        else:
            self._frame_q = queue.Queue(
                maxsize=queue_depth * self.batch_size)
            self._queues = []
            n_threads = decode_threads or min(
                len(self.sources), 4 * (os.cpu_count() or 1))
            n_threads = max(1, min(n_threads, len(self.sources)))
            if n_threads == len(self.sources):
                groups = [[(i, src)] for i, src in enumerate(self.sources)]
            else:
                groups = [[] for _ in range(n_threads)]
                for i, src in enumerate(self.sources):
                    groups[i % n_threads].append((i, src))
            self._workers = [
                _StreamWorker(g, opts or {}, self._frame_q,
                              self._stop, self._buf_pool)
                for g in groups if g
            ]
        self._started = False
        self._live = 0
        self._alive_mask: List[bool] = [True] * len(self.sources)

    def start(self) -> "MultiStreamPipeline":
        if not self._started:
            for w in self._workers:
                w.start()
            # one EOS sentinel arrives per STREAM (mux workers own several)
            self._live = sum(w.n_streams for w in self._workers)
            self._started = True
        return self

    def _drain(self) -> None:
        """Empty the frame queues, recycling their buffers."""
        for q in ([self._frame_q] if self._frame_q else self._queues):
            try:
                while True:
                    _, frame = q.get_nowait()
                    if frame is not None:
                        self._buf_pool.put(frame)
            except queue.Empty:
                pass

    def stop(self) -> None:
        self._stop.set()
        # drain so workers blocked on put() can exit; recycle their buffers
        self._drain()
        # join decode threads so interpreter teardown never kills a thread
        # mid-FFmpeg-call (they poll the stop event every 0.2s)
        deadline = 5.0
        for w in self._workers:
            t0 = time.monotonic()
            while w.is_alive() and time.monotonic() - t0 < deadline:
                # keep draining: a worker may be blocked on out_q.put
                self._drain()
                w.join(timeout=0.1)

    def _q_get(self, q):
        """Queue get that honors the stop event. A public ``stop()`` call
        drains the queues — including the per-stream EOS sentinels — so a
        stager blocked in a plain ``q.get()`` would never wake. Returns
        None when stopped (treated as end of streams)."""
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    def _assemble(self) -> Optional[Tuple[List[np.ndarray], List[int]]]:
        frames: List[np.ndarray] = []
        ids: List[int] = []
        if self.sync_streams:
            # lock-step: exactly one frame per live stream
            for sid, q in enumerate(self._queues):
                if not self._alive_mask[sid]:
                    continue
                item = self._q_get(q)
                if item is None:  # stopped mid-batch: recycle + bail
                    for buf in frames:
                        self._buf_pool.put(buf)
                    return None
                _, frame = item
                if frame is None:
                    self._alive_mask[sid] = False
                    self._live -= 1
                    continue
                frames.append(frame)
                ids.append(sid)
        else:
            while len(frames) < self.batch_size and self._live > 0:
                item = self._q_get(self._frame_q)
                if item is None:
                    for buf in frames:
                        self._buf_pool.put(buf)
                    return None
                stream_id, frame = item
                if frame is None:
                    self._live -= 1
                    continue
                frames.append(frame)
                ids.append(stream_id)
        if not frames:
            return None
        return frames, ids

    def _stage_one(self):
        """Assemble one batch, upload and dispatch its preprocess.

        Returns (device tensor, ids) or None at end of streams."""
        item = self._assemble()
        if item is None:
            return None
        frames, ids = item
        try:
            if self.mesh is not None:
                out = self._stager.run_on_mesh(frames, self.mesh,
                                               self._dispatch_planes)
            else:
                out = self._stager.run(frames, self._dispatch_planes)
        finally:
            for buf in frames:  # recycle decode buffers
                self._buf_pool.put(buf)
        return out, ids

    def _dispatch_planes(self, planes):
        """Device-side half of :meth:`_stage_one`: the fused preprocess
        over already device-resident planes (with a mesh, one position's
        block, on that position's device and stream)."""
        return preprocess_batch(
            planes, self.src_fmt, self.src_w, self.src_h,
            self.dst_w, self.dst_h, space=self.space,
            crange=self.crange, out_dtype=self.out_dtype,
            planar=self.planar, method=self.method,
            normalize=self.normalize, letterbox=self.letterbox,
            pad_value=self.pad_value)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, List[int]]]:
        self.start()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def stager():
            try:
                while not self._stop.is_set():
                    staged = self._stage_one()
                    out_q.put(staged)
                    if staged is None:
                        return
                # stopped (public stop() or iterator teardown): the
                # consumer may be parked in out_q.get() — terminate it
                out_q.put(None)
            except Exception as e:  # surfaced below
                out_q.put(e)

        t = threading.Thread(target=stager, daemon=True,
                             name="vali-stager")
        t.start()
        # Local binding: the finally block can run at generator
        # finalization during interpreter shutdown, when module globals
        # (queue) may already be cleared.
        _empty = queue.Empty
        try:
            while True:
                staged = out_q.get()
                if staged is None:
                    for w in self._workers:
                        if w.error is not None:
                            raise w.error
                    return
                if isinstance(staged, Exception):
                    raise staged
                yield staged
        finally:
            self._stop.set()
            # unblock a stager waiting on out_q.put
            try:
                while True:
                    out_q.get_nowait()
            except _empty:
                pass
            t.join(timeout=10.0)
            # full teardown: unblock + join decode workers and recycle
            # their queued buffers (without this, abandoning the iterator
            # leaks N parked threads plus the decode buffer pool)
            self.stop()


def preprocess_batch(planes, src_fmt: PixelFormat, src_w: int, src_h: int,
                     dst_w: int, dst_h: int,
                     space: ColorSpace = ColorSpace.BT_709,
                     crange: ColorRange = ColorRange.MPEG,
                     out_dtype: torch.dtype = torch.uint8,
                     planar: bool = False,
                     method: str = LANCZOS_AA,
                     normalize=None,
                     use_kernel: Optional[bool] = None,
                     letterbox: bool = False,
                     pad_value: int = 114) -> torch.Tensor:
    """Fused preprocess over already-batched planes on one device.

    On a CUDA device NV12/P10/P12/YUV420/YUV420_10bit/YUV422/YUV444 route
    to the banded kernels (ops/nv12_preprocess.py, ops/yuv420_preprocess.py,
    ops/yuv422_preprocess.py, ops/yuv444_preprocess.py); every other
    format (YUV444_10bit), and every format on the CPU, takes the dense
    ``fused_preprocess``. ``use_kernel=False`` forces the dense route,
    ``use_kernel=True`` the kernel route (its plain version on CPU
    tensors). ``letterbox=True`` resizes aspect-preserving onto a centered
    ``pad_value`` canvas (ops/fused.letterbox_preprocess semantics) — the
    content resample still takes the kernel route when available.
    Returns [B, dst_h, dst_w, 3], or [B, 3, dst_h, dst_w] when planar.
    """
    with span("preprocess_batch"):
        src_fmt = PixelFormat(src_fmt)
        if use_kernel is None:
            use_kernel = _kernel_usable(src_fmt, space, crange,
                                        planes[0].device)
        if normalize is not None:
            normalize = (tuple(float(v) for v in normalize[0]),
                         tuple(float(v) for v in normalize[1]))
        if letterbox:
            inner_w, inner_h, left, top, _ = letterbox_params(
                src_w, src_h, dst_w, dst_h)
            inner = preprocess_batch(
                planes, src_fmt, src_w, src_h, inner_w, inner_h, space=space,
                crange=crange, out_dtype=out_dtype, planar=False,
                method=method, normalize=normalize, use_kernel=use_kernel)
            return letterbox_pad(inner, dst_w, dst_h, left, top,
                                 pad_value=int(pad_value), normalize=normalize,
                                 planar=planar)
        if use_kernel and src_fmt in kernel_preprocess_formats():
            out = kernel_preprocess(
                planes, src_fmt, src_w=src_w, src_h=src_h, dst_w=dst_w,
                dst_h=dst_h, space=space, crange=crange, out_dtype=out_dtype,
                method=method, normalize=normalize)
            return out if planar else out.movedim(1, -1)
        return fused_preprocess(
            tuple(planes), src_fmt, src_w, src_h, dst_w, dst_h, space, crange,
            out_dtype, planar, method, normalize)
