"""The backward compositor's spans, on the CPU: the work items a tile's walk
is cut into, and the plain backwards at several spans.

The CUDA backward kernels cut each tile's walk into spans of S blocks that
run at once (splatter360_tpu_torch/csrc/composite_bwd.cuh); a span starts
from the sums of log1p(-alpha) and psi over the later spans, added in a
fixed order, so S sets the association of the sums across blocks, and the
plain versions take the same one. Spans of 1 block and one span a tile add
across blocks in walk order alike, so their results are equal; other spans
differ from them only by rounding. Inputs are the tiny scenes of
tests/test_torch_unfused.py (up to 3 blocks a tile in the random scene, 8 in
the saturating one, where logT falls to -177).
"""

import bisect

import pytest
import torch
from test_torch_unfused import compositor_inputs

from splatter360_tpu_torch.ops.cuda import composite as tc

torch.set_num_threads(2)
# the spans' threshold divisor the plain versions take on the CPU
SLOTS = tc.split_slots(torch.device("cpu"))
# spans that reassociate the sums across blocks: within SPAN_TOL of max|g|
# per row where |logT| <= 10; deeper, log_t_end = logT_final - suffix
# cancels, and a float32 reassociation of the suffix moves log_t_end (so T,
# relatively) by a few ulps of |logT|: the bar grows with max|logT| / 10
SPAN_TOL = 1e-6


def span_tol(lt_final):
    return SPAN_TOL * max(1.0, float(lt_final.abs().max()) / 10.0)


def walked_blocks(nproc, span):
    """{tile index: sorted blocks} over the work items of span_item_end,
    each found as the kernel's find_item finds it (csrc/composite_bwd.cuh);
    the item count must stay inside the grid span_items_bound gives."""
    v, t = nproc.shape
    item_end, heavy = tc.span_item_end(nproc, span)
    heavy = int(heavy)
    assert heavy == int(nproc.sum()) // SLOTS
    nblk = int(nproc.sum(dim=1).max())  # a view's tiles walk at most NBLK + T blocks
    ends = item_end.tolist()
    assert ends[-1] <= tc.span_items_bound(v, t, nblk, span)
    flat = nproc.reshape(-1).tolist()
    s = span or 1 << 30
    got = {}
    for item in range(ends[-1]):
        seg = bisect.bisect_right(ends, item)
        n = flat[seg]
        length = s if n > heavy else max(n, 1)  # only a tile past heavy is cut
        n_spans = -(-n // length)
        k = item - (ends[seg] - n_spans)
        j_hi = n - 1 - k * length
        j_lo = max(0, j_hi - (length - 1))
        assert 0 <= k < n_spans and 0 <= j_lo <= j_hi
        got.setdefault(seg, []).extend(range(j_lo, j_hi + 1))
    return {k: sorted(v) for k, v in got.items()}, heavy, ends[-1]


NPROC = {
    # walks of 0 blocks, multiples of the span, one short of one, one past one
    "small": [[0, 1, 3, 4, 5, 8, 12, 0], [16, 17, 0, 2, 33, 64, 7, 9]],
    # 300 tiles of 2 blocks and two heavy ones: only tiles past the call's
    # blocks over SLOTS are cut
    "lumpy": [[2] * 150 + [3 * SLOTS, 0], [2] * 150 + [40, 7]],
}


@pytest.mark.parametrize("span", [1, 3, 4, 16, None])
@pytest.mark.parametrize("case", ["small", "lumpy"])
def test_span_items_cover_each_walked_block_once(case, span):
    """Every block a tile walks belongs to exactly one work item, and no
    item walks another block; a tile is cut into spans of `span` only when
    it walks more than the call's blocks over SLOTS."""
    nproc = torch.tensor(NPROC[case], dtype=torch.int32)
    got, heavy, n_items = walked_blocks(nproc, span)
    flat = nproc.reshape(-1).tolist()
    assert got == {k: list(range(n)) for k, n in enumerate(flat) if n}
    assert (heavy == 0) if case == "small" else (2 < heavy < 40)
    s = span or 1 << 30
    assert n_items == sum(-(-n // s) if n > heavy else int(n > 0) for n in flat)


def backward_at(path, inputs, span):
    """The plain fused backward's g_attrs, or the unfused one's out-blocks
    and their scatter, at `span`."""
    attrs, gidx, tile_ids, starts, counts, nty, ntx, w_img, inst, bwd = inputs
    if path == "fused":
        return tc.composite_backward(attrs, gidx, starts, counts, *bwd, span=span), None
    dout = tc.composite_backward_unfused(inst, starts, counts, *bwd, span=span)
    nproc = bwd[2]
    g = tc.scatter_out_blocks(dout, gidx, starts, counts, nproc, attrs.shape[1])
    _, live = tc.out_block_map(starts, counts, nproc, dout.shape[1])
    return g, dout[live][:, : tc.N_GRAD]


@pytest.fixture(scope="module", params=["random", "saturating"])
def span_inputs(request):
    """A scene's compositor inputs, the plain forward's planes and a seeded
    cotangent on planes 0-4."""
    attrs, gidx, tile_ids, starts, counts, nty, ntx, w_img = compositor_inputs(
        request.param, views=2 if request.param == "random" else 1)
    planes = tc.composite_forward(attrs, gidx, starts, counts, nty, ntx, w_img, True)
    g_planes = torch.zeros_like(planes)
    gen = torch.Generator().manual_seed(11)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen)
    nproc = planes[:, :, 6, 0].to(torch.int32)
    assert int(nproc.max()) >= 3  # several spans of 1 and of 2
    inst = tc.pack_instances(attrs, gidx, tile_ids, nty * ntx)
    bwd = (g_planes, planes[:, :, 5].contiguous(), nproc, nty, ntx, w_img, True)
    return attrs, gidx, tile_ids, starts, counts, nty, ntx, w_img, inst, bwd


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_plain_backward_spans_agree(span_inputs, path):
    """The plain backward at spans 1 and 2 against one span a tile: span 1
    equal, span 2 within span_tol of max|g| per row of g_attrs and,
    unfused, of the live out-blocks' rows."""
    ref, ref_blocks = backward_at(path, span_inputs, None)
    scale = ref[..., : tc.N_GRAD].abs().amax(dim=(0, 1))
    assert torch.isfinite(ref).all() and bool((scale > 0).all())
    tol = span_tol(span_inputs[-1][1])
    for span in (1, 2):
        got, blocks = backward_at(path, span_inputs, span)
        err = (got - ref)[..., : tc.N_GRAD].abs().amax(dim=(0, 1)) / scale
        assert float(err.max()) <= (0.0 if span == 1 else tol), (span, err)
        if blocks is not None:
            rows = ref_blocks.transpose(0, 1).reshape(tc.N_GRAD, -1)
            diff = (blocks - ref_blocks).transpose(0, 1).reshape(tc.N_GRAD, -1)
            b_err = diff.abs().amax(dim=1) / rows.abs().amax(dim=1).clamp(min=1e-30)
            assert float(b_err.max()) <= (0.0 if span == 1 else tol), (span, b_err)
