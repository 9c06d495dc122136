"""The NV12 lab's combo kernel (``csrc/nv12_combo.cu``) on the CPU: a numpy
replay of its blocks' walk — the ring's steps (column groups x frames),
what each slot holds, which frame, chunk and strip rows each warpgroup
multiplies and sums in each of its three splits — through S2's host
tables at the lab's 1080p -> 224 and at the card tests' shapes, within
the uint8 envelope of ``static_kernel2_plain`` and, where the warpgroups
split the chunks as S2's do, equal to the same replay of S2's own walk;
the work and W-fragment bytes it counts, its shared memory, the instances
the source compiles, and its refusals before any launch."""

import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab import kernel_variants as kv
from vali_tpu_torch.ops import _cuda_build, banded
from vali_tpu_torch.ops.resize import LANCZOS_AA, round_to

from tests.test_torch_port_static2_tables import _b_as_read, _w_as_read

INSTANCES = list(banded.COMBO_SPLITS)
#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
GEOMETRIES = [(1920, 1080, 224, 224), (162, 90, 50, 20), (130, 62, 34, 30),
              (256, 96, 48, 40), (256, 144, 96, 64), (322, 150, 202, 70)]
STAGES = banded.STATIC2_STAGES


def _rounds(gframes, split):
    """Rounds of frames a block walks (nv12_combo.cu Cfg::R)."""
    return gframes // 4 if split == "rounds" else 1


def _layout(gframes, tile):
    """(slot columns, a warpgroup's N, frames a warpgroup sums a round) of
    an instance, as nv12_combo.cu's Cfg lays them out."""
    split = banded.COMBO_SPLITS[gframes, tile]
    per_round = gframes // _rounds(gframes, split)
    return ((64, tile // 2, gframes) if split == "rows" else
            (128, tile, per_round // 2 if split in ("frames", "rounds")
             else gframes))


def _step(split, fw, s, rsteps):
    """Step s's round, column group q, frame f, and its slot halves:
    (frame of the block's G, first column from x0) each (nv12_combo.cu
    issue_step; ``rsteps`` steps a round)."""
    rd, sr = divmod(s, rsteps)
    q, f = divmod(sr, fw)
    if split == "chunks":
        return rd, q, f, [(f, 128 * q), (f, 128 * q + 64)]
    if split in ("frames", "rounds"):
        first = 2 * fw * rd    # the round's first frame
        return rd, q, f, [(first + f, 64 * q), (first + fw + f, 64 * q)]
    return rd, q, f, [(f, 64 * q)]


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def _walk(nv12, geo, gframes, tile, split=None):
    """The combo's blocks in numpy from S2's tables at (tile, 8), step by
    step as its ring hands them over, each warpgroup's H chains (fp32
    products rounded to bf16) and W products into its frames' sums, the
    chunks split's partial sums added at the end; then the product's tail.
    ``split`` overrides the instance's (S2's own walk: 1 frame, chunks).
    Returns the output, the W-fragment bytes the warpgroups load and, per
    block, the (frame, chunk) pairs each warpgroup's W products took and
    the most W accumulators a thread held at once."""
    src_w, src_h, dst_w, dst_h = geo
    split = split or banded.COMBO_SPLITS[gframes, tile]
    sc, n, fw = ((128, tile, gframes) if split == "chunks" else
                 _layout(gframes, tile))
    b = nv12.shape[0]
    t = banded.static2_tables(*geo, LANCZOS_AA, tile, 8)
    wt = banded.static2_w_tables(*geo, LANCZOS_AA)
    by, bc = _b_as_read(t.luma), _b_as_read(t.chroma)
    ky, kc = t.k_luma, t.k_chroma
    strips = by.shape[0]
    rng = np.random.default_rng(7)
    sums = np.zeros((3, b, strips * tile, dst_w), np.float32)
    frag_bytes = 0
    visits, most_acc = [], 0
    rounds = _rounds(gframes, split)
    for strip in range(strips):
        rows = np.concatenate([
            np.minimum(t.starts[strip, 0] + np.arange(ky), src_h - 1),
            src_h + np.minimum(t.starts[strip, 1] + np.arange(kc),
                               src_h // 2 - 1)])
        for tile_i in range(wt.heads.shape[0]):
            x0, chunks, ay, ac = _w_as_read(wt, tile_i)
            groups = chunks // 2 if split == "chunks" else chunks
            for z in range(b // gframes):
                frames = nv12[z * gframes:(z + 1) * gframes]
                # stale bytes past a row: anything, since they weigh 0
                ring = [None] * STAGES
                rsteps = groups * fw
                nsteps = rsteps * rounds
                seen = []

                def issue(s):
                    _, q, f, halves = _step(split, fw, s, rsteps)
                    slot = rng.integers(0, 256, (ky + kc, sc)).astype(
                        np.float32)
                    for h, (fr, c0) in enumerate(halves):
                        c = min(64, max(0, src_w - x0 - c0))
                        slot[:, 64 * h:64 * h + c] = \
                            frames[fr][rows, x0 + c0:x0 + c0 + c]
                    # the slot's last step, read two steps ago
                    assert ring[s % STAGES] is None or \
                        ring[s % STAGES][0] == s - STAGES
                    ring[s % STAGES] = (s, slot)

                for s in range(min(STAGES - 1, nsteps)):
                    issue(s)
                for s in range(nsteps):
                    tag, slot = ring[s % STAGES]
                    assert tag == s    # the step this slot was filled for
                    if s + STAGES - 1 < nsteps:
                        issue(s + STAGES - 1)
                    rd, q, f, halves = _step(split, fw, s, rsteps)
                    if s % rsteps == 0:   # a round's accumulators
                        acc = np.zeros((2, fw, 3, n, 64), np.float32)
                        # luma N / 2 and U, V N a frame, per thread
                        most_acc = max(most_acc, fw * (n // 2 + n))
                    for wg in range(2):
                        chunk = 2 * q + wg if split == "chunks" else q
                        fr = (halves[wg][0] if split in ("frames", "rounds")
                              else f)
                        seen.append((fr, chunk))
                        if f == 0:
                            frag_bytes += 6 * 128 * 16
                        a = slot[:, 64 * wg:64 * wg + 64] \
                            if split != "rows" else slot
                        r0 = n * wg if split == "rows" else 0
                        hy = _bf16(by[strip, r0:r0 + n] @ a[:ky])
                        hc = _bf16(bc[strip, r0:r0 + n] @ a[ky:])
                        for c, (h, w, cols) in enumerate((
                                (hy, ay, 64), (hc[:, 0::2], ac, 32),
                                (hc[:, 1::2], ac, 32))):
                            acc[wg, f, c] += np.einsum(
                                "mk,rk->rm",
                                w[:, cols * chunk:cols * (chunk + 1)], h)
                    if s % rsteps < rsteps - 1:
                        continue
                    # the round's end: its frames' sums, stored
                    p0 = 64 * tile_i
                    m = min(64, dst_w - p0)
                    r = slice(strip * tile, (strip + 1) * tile)
                    first = z * gframes + rd * (gframes // rounds)
                    for f in range(fw):
                        if split == "chunks":
                            out = acc[0, f] + acc[1, f]
                            sums[:, first + f, r, p0:p0 + m] = out[..., :m]
                        elif split in ("frames", "rounds"):
                            for wg in range(2):
                                sums[:, first + wg * fw + f, r,
                                     p0:p0 + m] = acc[wg, f][..., :m]
                        else:
                            for wg in range(2):
                                rr = slice(strip * tile + n * wg,
                                           strip * tile + n * (wg + 1))
                                sums[:, first + f, rr, p0:p0 + m] = \
                                    acc[wg, f][..., :m]
                visits.append(seen)
    eye = torch.eye(dst_w)
    tail = banded.tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0,
                              torch.uint8, None)
    y, u, v = (torch.from_numpy(x[:, :dst_h]) for x in sums)
    return (banded.w_pass_tail_plain(y, u, v, eye, eye, tail,
                                     torch.uint8).numpy(), frag_bytes,
            visits, most_acc)


def _frames(geo, batch, seed):
    src_w, src_h = geo[:2]
    return np.random.default_rng(seed).integers(
        0, 256, (batch, src_h * 3 // 2, src_w), dtype=np.uint8)


def _plain(x, geo, tile):
    src_w, src_h, dst_w, dst_h = geo
    return kv.static_kernel2_plain(torch.from_numpy(x), src_w=src_w,
                                   src_h=src_h, dst_w=dst_w, dst_h=dst_h,
                                   tile=tile, align=8).numpy()


def _close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("gframes,tile", INSTANCES)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_walk_equals_static_kernel2_plain(geo, gframes, tile):
    """The replay of each instance's walk lies within 1 LSB of
    static_kernel2_plain at (tile, 8) on fewer than 1e-3 of the samples
    (fp32 sums in another order): every frame gets every chunk of its
    tiles and every row of its strips once, from the slot its step
    filled; bytes past a row, stale in the ring, weigh 0. Where the
    warpgroups split the chunks as S2's do, the replay equals S2's own
    walk bit for bit, and the W fragments it loads are S2's over
    gframes."""
    x = _frames(geo, 2 * gframes, sum(geo) + tile)
    got, frag, _, _ = _walk(x, geo, gframes, tile)
    _close(got, _plain(x, geo, tile))
    assert frag == kv.combo_w_fragment_bytes(2 * gframes, *geo,
                                             gframes=gframes, tile=tile)
    if banded.COMBO_SPLITS[gframes, tile] == "chunks":
        s2, s2_frag, _, _ = _walk(x, geo, 1, tile, split="chunks")
        assert np.array_equal(got, s2)
        assert frag * gframes == s2_frag


def test_w_fragment_bytes_at_1080p():
    """At 64 x 1080p -> 224, S2 at 16-row strips loads 396 MB of W
    fragments a batch (twice the frame bytes); the combo divides them by
    the frames a warpgroup sums a chunk for."""
    geo = (1920, 1080, 224, 224)
    chunk = 6 * 128 * 16     # 12,288 B: one chunk's 6 k-steps
    assert chunk * 36 == 442368   # the table: 36 chunks over 4 tiles
    mb = {(g, t): kv.combo_w_fragment_bytes(64, *geo, gframes=g, tile=t)
          for g, t in INSTANCES + [(1, 16), (1, 32)]}
    assert mb[1, 16] == 36 * chunk * 14 * 64 == 396361728
    assert mb[2, 16] * 2 == mb[4, 16] * 4 == mb[1, 16]
    assert mb[1, 32] == 36 * chunk * 7 * 64
    assert mb[2, 32] * 2 == mb[1, 32]
    assert mb[4, 32] == mb[1, 32] // 2   # each warpgroup: 2 of 4 frames
    assert mb[8, 32] == mb[4, 32]        # M8: two rounds of 4x32's walk
    assert mb[1, 64] == 36 * chunk * 4 * 64 * 2 == 2 * mb[2, 64]


def test_work_and_shared_memory_at_1080p():
    """At 64 x 1080p -> 224 the combo counts S2's FLOPs at its strip height
    (49.6 GFLOP issued at 64 rows against 20.1 at 16), its block keeps
    S2's shared memory at 16 and 32 rows (two blocks an SM at 16), and its
    64-row instances stage 64-column chunks: 185,728 B, where S2's layout
    would need 303,488 B."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    gflop = {}
    for g, t in INSTANCES:
        work = kv.combo_work(64, **geo, tile=t)
        assert work == kv.static2_work(64, **geo, tile=t, align=8)
        assert work[0] == 208699392
        gflop[g, t] = work[1] / 1e9
        tab = banded.static2_tables(*geo.values(), LANCZOS_AA, t, 8)
        smem = banded.combo_smem_bytes(g, t, tab.k_luma, tab.k_chroma)
        want = {16: 81792, 32: 152960, 64: 185728}[t]
        assert smem == want, (g, t)
        if t < 64:
            assert smem == banded.static2_smem_bytes(t, tab.k_luma,
                                                     tab.k_chroma)
    assert round(gflop[2, 16], 1) == 20.1 and round(gflop[2, 64], 1) == 49.6
    assert gflop[2, 16] < gflop[2, 32] < gflop[2, 64]
    assert 2 * (81792 + 1024) <= 233472   # two blocks an SM at T = 16
    tab = banded.static2_tables(1920, 1080, 224, 224, LANCZOS_AA, 64, 8)
    assert (tab.k_luma, tab.k_chroma) == (352, 176)
    assert banded.static2_smem_bytes(64, 352, 176) == 303488 > \
        banded.SMEM_LIMIT
    assert 3 * 528 * 64 + 2 * 528 * 64 + 2 * (8 * 528 + 4 * 1040) == 185728


def test_trade_fits_the_ring_where_the_chunks_split():
    """The partial sums the chunks split trades at the end (gframes frames
    of 4 (T / 2 + T) 128 bytes: 49,152 B at 4x16 and 2x32) reuse the
    ring's bytes, and a tiny window makes them set the block's size."""
    for (g, t), split in banded.COMBO_SPLITS.items():
        if split != "chunks":
            continue
        trade = g * 4 * (t // 2 + t) * 128
        assert trade == {(2, 16): 24576, (4, 16): 49152,
                         (2, 32): 49152}[g, t]
        tab = banded.static2_tables(1920, 1080, 224, 224, LANCZOS_AA, t, 8)
        assert trade <= STAGES * (tab.k_luma + tab.k_chroma) * 128
        chunk = 8 * (16 * t + 16) + 4 * (32 * t + 16)
        assert banded.combo_smem_bytes(g, t, 16, 16) == \
            max(trade, STAGES * 32 * 128) + 2 * 32 * t + 2 * chunk


def test_source_instances_are_the_splits():
    """nv12_combo.cu compiles exactly COMBO_SPLITS' instances, each with
    its split, and its launcher's ctypes signature is the labs'."""
    import os

    src = open(os.path.join(_cuda_build._PKG_DIR, "csrc",
                            "nv12_combo.cu")).read()
    split = {"kChunks": "chunks", "kFrames": "frames", "kRows": "rows",
             "kRounds": "rounds"}
    got = {(int(g), int(t)): split[s] for g, t, s in re.findall(
        r"case (\d)0(\d\d): return go\(Cfg<\d+, \d+, (\w+)>", src)}
    assert got == banded.COMBO_SPLITS
    cfgs = re.findall(r"Cfg<(\d+), (\d+), (\w+)>\(\)", src)
    assert {(int(g), int(t)): split[s] for t, g, s in cfgs} == got
    assert "nv12_combo_launch" in _cuda_build._LAB_SIGNATURES
    assert "csrc/nv12_combo.cu" in _cuda_build._LAB_SOURCES
    assert "csrc/nv12_combo.cu" not in _cuda_build._SOURCES


@pytest.mark.parametrize("geo,gframes,tile,why", [
    ((256, 144, 96, 64), 3, 16, r"runs \(gframes, tile\)"),
    ((256, 144, 96, 64), 1, 16, r"runs \(gframes, tile\)"),
    ((256, 144, 96, 64), 2, 48, r"runs \(gframes, tile\)"),
    ((256, 144, 96, 64), 4, 64, r"runs \(gframes, tile\)"),
    ((3840, 2160, 224, 224), 4, 32, "shared memory"),
    ((3840, 2160, 224, 224), 1, 64, "shared memory"),
])
def test_refusal_refuses_what_does_not_fit(geo, gframes, tile, why):
    """A (gframes, tile) that is no instance, or a geometry whose ring,
    weights and H rows pass a block's shared memory (4K -> 224's windows),
    is refused before any launch, on the CPU too, with the wrapper's
    launch count unchanged; S2 refuses 64-row strips (its 128-column
    layout needs 303,488 B at 1080p)."""
    assert re.search(why, banded.combo_refusal(*geo, LANCZOS_AA, gframes,
                                               tile))
    sw, sh, dw, dh = geo
    x = torch.zeros((gframes, sh * 3 // 2, sw), dtype=torch.uint8)
    before = kv.combo_kernel.launches
    with pytest.raises(ValueError, match=why):
        kv.combo_kernel(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh,
                        gframes=gframes, tile=tile)
    assert kv.combo_kernel.launches == before
    assert banded.static2_refusal(1920, 1080, 224, 224, LANCZOS_AA, 64, 8)


@pytest.mark.parametrize("gframes,tile", INSTANCES)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_refusal_admits_the_instances_at_the_test_shapes(geo, gframes,
                                                         tile):
    """Every instance launches at the lab's size and the card tests'
    shapes: no refusal; the CPU route is static_kernel2_plain at (tile,
    8), bit for bit."""
    assert banded.combo_refusal(*geo, LANCZOS_AA, gframes, tile) == ""
    if geo[0] > 400:
        return
    x = _frames(geo, gframes, 3)
    src_w, src_h, dst_w, dst_h = geo
    got = kv.combo_kernel(torch.from_numpy(x), src_w=src_w, src_h=src_h,
                          dst_w=dst_w, dst_h=dst_h, gframes=gframes,
                          tile=tile).numpy()
    assert np.array_equal(got, _plain(x, geo, tile))


def test_bf16_w_tables_are_s2s():
    """The combo reads S2's W fragments: the bf16 column weights (round_to
    is the tables' cast)."""
    geo = (256, 144, 96, 64)
    dw = banded.dense_weights(*geo, LANCZOS_AA, "420")
    wy = round_to(dw.luma_w, torch.bfloat16).numpy()
    x0, chunks, ay, _ = _w_as_read(banded.static2_w_tables(*geo, LANCZOS_AA),
                                   0)
    assert np.array_equal(ay[:64, :min(64 * chunks, 256 - x0)],
                          wy[:64, x0:x0 + min(64 * chunks, 256 - x0)])
