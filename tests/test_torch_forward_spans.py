"""The forward compositor's spans, on the CPU: the work items a tile's
segment is cut into, and the plain forwards at several spans.

The CUDA forward kernels cut a heavy tile's segment into spans of S blocks
that run at once (splatter360_tpu_torch/csrc/composite_fwd.cuh): a span
starts from the sums of log1p(-alpha) over the spans before it, added in a
fixed order, and the colour sums of the spans are added span by span, so S
sets the association of the sums across blocks, and the plain versions take
the same one. Spans of 1 block and one span a tile add across blocks in
walk order alike, so their results are equal; other spans differ from them
only by rounding. Nothing here imports JAX: the plain forward at the
default span is held against the Pallas kernels in
tests/test_torch_render.py and tests/test_torch_unfused.py. Inputs are the
tiny scenes of tests/test_torch_unfused.py's compositor_inputs (up to 3
segment blocks a tile in the random scene, 18 in the saturating one, whose
tiles exit within 8), their covariances built by the port.
"""

import bisect

import numpy as np
import pytest
import torch
from test_torch_cuda import saturating_scene

from splatter360_tpu_torch.geometry.transforms import build_covariance_sym6
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.projection import project_erp, sh_colors
from splatter360_tpu_torch.ops.tiling import assign_tiles

torch.set_num_threads(2)
# the spans' threshold divisor the plain versions take on the CPU, and the
# forward's floor over the mean segment
SLOTS = tc.split_slots(torch.device("cpu"))
OVER_MEAN = tc.FWD_HEAVY_OVER_MEAN


@pytest.fixture(scope="module", autouse=True)
def cut_every_tile():
    """No tile of the tiny scenes holds FWD_HEAVY_OVER_MEAN times the mean
    segment, so the plain forwards would run every tile as one span; with
    the floor at 0 only the slots rule is left, whose threshold is 0 here,
    and every tile is cut."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tc, "FWD_HEAVY_OVER_MEAN", 0)
        yield
# colour and alpha of spans that reassociate the sums across blocks, and
# logT below |logT| = 10 (the bar grows with max|logT| / 10 beyond)
SPAN_TOL = 1e-6
# segment blocks a tile: 0, multiples of a span, one short of one, one past
# one; and 300 tiles of 2 blocks beside two heavy ones
NSEG = {
    "small": [[0, 1, 3, 4, 5, 8, 12, 0], [16, 17, 0, 2, 33, 64, 7, 9]],
    "lumpy": [[2] * 150 + [3 * SLOTS, 0], [2] * 150 + [40, 7]],
}


def span_tol(lt):
    """SPAN_TOL where |logT| <= 10, growing with max|logT| / 10 beyond: a
    float32 reassociation of logT moves it by a few ulps of |logT|."""
    return SPAN_TOL * max(1.0, float(lt.abs().max()) / 10.0)


def random_scene(n=1000, seed=1):
    """tests/test_torch_render.py's scene(n): numpy-seeded Gaussians around
    the origin, in its order of draws, sh degree 2."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    means = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(0.5, 6.0, (n, 1))
    q = rng.normal(size=(n, 4))
    scales = rng.uniform(0.01, 0.12, (n, 3))
    sh = 0.3 * rng.normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    return (64, 256), means, scales, q / np.linalg.norm(q, axis=-1, keepdims=True), sh, \
        rng.uniform(0.3, 0.95, n)


def compositor_inputs(kind, views):
    """attrs, gidx, tile_ids, starts, counts (V views) of a scene, built as
    tests/test_torch_unfused.py's compositor_inputs builds them."""
    shape, *arrays = random_scene() if kind == "random" else saturating_scene()
    means, scales, quats, sh, op = (torch.as_tensor(np.asarray(x, np.float32)) for x in arrays)
    covs = build_covariance_sym6(scales, quats)
    attrs, asg = [], []
    for i in range(views):
        c2w = torch.eye(4)
        c2w[:3, 3] = torch.tensor([0.05 * i, -0.03 * i, 0.0])
        p = project_erp(means, covs, c2w, shape, 0.1, opacities=op)
        asg.append(assign_tiles(p, shape, True))
        attrs.append(tc.build_attrs(p.mean2d, p.conic, sh_colors(sh, means, c2w[:3, 3], 2), op,
                                    p.depth, p.radius))
    stack = lambda f: torch.stack([f(a) for a in asg])  # noqa: E731
    return (torch.stack(attrs), stack(lambda a: a.gaussian_idx), stack(lambda a: a.tile_ids),
            stack(lambda a: a.tile_starts), stack(lambda a: a.tile_counts),
            asg[0].num_tiles_y, asg[0].num_tiles_x, float(shape[1]))


def segments(n_blk, seed=0):
    """starts/counts [V, T] int32 whose segments span n_blk [V, T] blocks,
    each from a random lane of its first block."""
    rng = np.random.default_rng(seed)
    n = np.asarray(n_blk, np.int64)
    # an empty segment from a block's first lane spans no block
    offset = np.where(n > 0, rng.integers(0, tc.CHUNK, n.shape), 0)
    # any count from one lane into the last block to its end
    lo, hi = np.maximum((n - 1) * tc.CHUNK - offset + 1, 1), n * tc.CHUNK - offset
    counts = np.where(n > 0, rng.integers(lo, np.maximum(hi, lo) + 1), 0)
    starts = np.cumsum(np.roll((offset + counts + tc.CHUNK - 1) // tc.CHUNK * tc.CHUNK, 1,
                               axis=1), axis=1)
    starts[:, 0] = 0
    starts = starts + offset
    return (torch.tensor(starts, dtype=torch.int32), torch.tensor(counts, dtype=torch.int32))


def covered_blocks(nseg, span):
    """{tile index: sorted blocks} over the forward's work items, each found
    as the kernel finds it (find_item in csrc/composite_common.cuh, spans
    counted from block 0 in composite_fwd.cuh); the item count must stay
    inside the grid span_items_bound gives."""
    v, t = nseg.shape
    item_end, heavy = tc.span_item_end(nseg, span, OVER_MEAN)
    heavy = int(heavy)
    total = int(nseg.sum())
    assert heavy == max(total // SLOTS, OVER_MEAN * total // nseg.numel())
    nblk = int(nseg.sum(dim=1).max())  # a view's segments span at most NBLK + T blocks
    ends = item_end.tolist()
    assert ends[-1] <= tc.span_items_bound(v, t, nblk, span)
    flat = nseg.reshape(-1).tolist()
    s = span or 1 << 30
    got = {}
    for item in range(ends[-1]):
        seg = bisect.bisect_right(ends, item)
        n = flat[seg]
        length = s if n > heavy else max(n, 1)
        n_spans = -(-n // length)
        k = item - (ends[seg] - n_spans)
        j_lo, j_end = k * length, min(n, (k + 1) * length)
        assert 0 <= k < n_spans and 0 <= j_lo < j_end
        got.setdefault(seg, []).extend(range(j_lo, j_end))
    return {k: sorted(v) for k, v in got.items()}, heavy, ends[-1]


@pytest.mark.parametrize("span", [1, 3, 4, 16, None])
@pytest.mark.parametrize("case", ["small", "lumpy"])
def test_forward_span_items_cover_each_segment_block_once(case, span):
    """Every block of a tile's segment belongs to exactly one work item, in
    order from block 0, and no item takes another block; a tile is cut
    into spans of `span` only when its segment spans more than the call's
    segment blocks over the slots and OVER_MEAN times their mean."""
    starts, counts = segments(NSEG[case])
    nseg = tc.segment_blocks(starts, counts)
    assert nseg.tolist() == NSEG[case]
    got, heavy, n_items = covered_blocks(nseg, span)
    flat = nseg.reshape(-1).tolist()
    assert got == {k: list(range(n)) for k, n in enumerate(flat) if n}
    assert 2 < heavy < 40  # some tiles of each case are cut, some not
    s = span or 1 << 30
    assert n_items == sum(-(-n // s) if n > heavy else int(n > 0) for n in flat)


SPANS = [1, 2, 3, tc.FWD_SPAN, None]


@pytest.fixture(scope="module", params=["random", "saturating"])
def scene_inputs(request):
    """A scene's compositor inputs (two views of the random scene, one of
    the saturating one), the unfused path's instance blocks, and the plain
    fused forward's planes at each span of SPANS."""
    attrs, gidx, tile_ids, starts, counts, nty, ntx, w_img = compositor_inputs(
        request.param, views=2 if request.param == "random" else 1)
    inst = tc.pack_instances(attrs, gidx, tile_ids, nty * ntx)
    seg = (starts, counts, nty, ntx, w_img, True)
    nseg = tc.segment_blocks(starts, counts)
    assert int(nseg.max()) >= 3  # several spans of 1 and of 2
    assert int(tc.span_item_end(nseg, None, tc.FWD_HEAVY_OVER_MEAN)[1]) == 0  # every tile cut
    fused = {span: tc.composite_forward(attrs, gidx, *seg, span=span) for span in SPANS}
    return request.param, inst, seg, fused


def test_plain_forward_span_one_equals_one_span(scene_inputs):
    """Spans of one block add across blocks in walk order, as one span a
    tile does: the same bits in all 8 planes."""
    fused = scene_inputs[-1]
    assert torch.equal(fused[1], fused[None])


def test_plain_forward_spans_agree(scene_inputs):
    """The plain fused forward at spans 2 and 3 against one span a tile:
    colour and alpha within SPAN_TOL, logT within span_tol, n_processed
    equal; on the saturating scene, tiles exit early at every span."""
    kind, _, seg, fused = scene_inputs
    whole = fused[None]
    starts, counts = seg[:2]
    n_blocks = tc.segment_blocks(starts, counts).float()
    tol = span_tol(whole[:, :, 5])
    for span in (2, 3):
        got = fused[span]
        assert torch.isfinite(got).all()
        colour = (got[:, :, 0:3] - whole[:, :, 0:3]).abs().max()
        alpha = (got[:, :, 4] - whole[:, :, 4]).abs().max()
        assert float(colour) <= SPAN_TOL and float(alpha) <= SPAN_TOL, (span, colour, alpha)
        assert float((got[:, :, 5] - whole[:, :, 5]).abs().max()) <= tol, span
        assert torch.equal(got[:, :, 6], whole[:, :, 6]), span
        if kind == "saturating":
            assert bool((got[:, :, 6, 0] < n_blocks).any()), "the per-tile early exit never fired"


@pytest.mark.parametrize("span", SPANS)
def test_plain_unfused_forward_equals_fused(scene_inputs, span):
    """At every span the plain unfused forward equals the plain fused one
    exactly on the instances pack_instances gives."""
    _, inst, seg, fused = scene_inputs
    assert torch.equal(tc.composite_forward_unfused(inst, *seg, span=span), fused[span])
