"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``).

SSD's ``MultiBoxPrior``/``MultiBoxTarget``/``MultiBoxDetection``, the box
ops (``box_iou``, ``box_nms``, ``bipartite_matching``), ``ROIPooling`` and
``ROIAlign``, region proposals (``Proposal``/``MultiProposal``), the
deformable pair, ``_contrib_flash_attention``, ``_contrib_fused_bn_relu``
(the K3 kernel site), the FFT pair and ``count_sketch``.

The detection ops compute the JAX package's functions, formula by formula
where a value is made, by other forms where XLA's static shapes would not
fit a detector's widths (the JAX package's O(N^2) loops and masks of the
whole feature map), all in plain torch on the caller's device:

- Greedy NMS (``_nms``) runs on the valid candidates only, compacted in the
  stable score order (an invalid candidate neither keeps nor suppresses, so
  this is the same function), limited to ``topk``/``rpn_pre_nms_top_n`` of
  them.  The suppression matrix is built in row chunks; the sequential
  loop becomes the fixed point ``keep = valid & ~any_i(keep_i & can_ij)``,
  whose unique solution is the loop's keep set.  Iterated in rounds of 1,
  2, 4, ... steps, with one read back to the host after each round to see
  whether it has converged: the launches grow with the depth of the
  suppression chains, not with the candidates.
- ``ROIPooling`` gathers each bin's window, sized by the largest bin of the
  call (read back once), in ROI chunks, and takes ``amax``; its backward
  recomputes the windows and gives each tied maximum an equal share (the
  JAX package's ``max`` VJP).  ``PSROIPooling`` (``misc.py``) sums bins
  from a float64 summed-area table.
- Sorting is ``torch.argsort(..., stable=True)`` throughout (ties keep the
  input order, as ``jnp.argsort``), a ``mode="clip"`` take clamps its
  index, and host constants are filled on the device, so no host array is
  copied to the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import Param as P, _coerce, normalize_tuple, register

# elements of one float32 temporary of the NMS suppression matrix's rows,
# and bytes of one chunk of ROIPooling's gathered windows
_NMS_CHUNK = 1 << 26
_ROI_CHUNK_BYTES = 1 << 30
# NMS calls, fixed-point steps and convergence reads since they were last
# zeroed (reported by chip_smoke.py's phase 26)
NMS_COUNTS = {"calls": 0, "steps": 0, "host_reads": 0}


def _consts(values, dtype, device):
    """A 1-d tensor of host scalars, filled on ``device`` (no copy from
    the host)."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def _div(x, n):
    """``x / n`` by a device scalar: CUDA turns a division by a host scalar
    into a multiplication by its reciprocal, which can move a quotient by
    an ulp, and a bin bound taken by floor/ceil by a whole cell."""
    return x / x.new_full((), float(n))


def _floats(v):
    return tuple(float(x) for x in np.atleast_1d(np.asarray(_coerce(v),
                                                             float)))


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------
def _corner_iou(a, b):
    """IoU matrix between corner boxes ``a`` (..., N, 4) and ``b``
    (..., M, 4): (..., N, M)."""
    ax1, ay1, ax2, ay2 = (a[..., k:k + 1] for k in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, k] for k in range(4))
    zero = a.new_zeros(())
    iw = torch.maximum(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                       zero)
    ih = torch.maximum(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                       zero)
    inter = iw * ih
    area_a = torch.maximum(ax2 - ax1, zero) * torch.maximum(ay2 - ay1, zero)
    area_b = torch.maximum(bx2 - bx1, zero) * torch.maximum(by2 - by1, zero)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, zero)


def _center_to_corner(boxes):
    x, y, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([x - hw, y - hh, x + hw, y + hh], dim=-1)


def _corner_to_center(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5), **attrs):
    """SSD anchors of a feature map (reference: multibox_prior.cc:43-71):
    data (B, C, H, W) -> (1, H*W*A, 4) corner boxes in [0, 1] units,
    ordered (h, w, a), with A = len(sizes) + len(ratios) - 1.  The half
    extents are taken in float64 and cast to float32, as in the JAX
    package, so the anchors are its bit for bit."""
    sizes, ratios = _floats(sizes), _floats(ratios)
    steps, offsets = _floats(steps), _floats(offsets)
    in_h, in_w = data.shape[-2], data.shape[-1]
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if len(steps) > 1 and steps[1] > 0 else 1.0 / in_w
    dev = data.device
    f32 = torch.float32
    cy = (torch.arange(in_h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=f32, device=dev) + offsets[1]) * step_x
    hws = [s * in_h / in_w / 2.0 for s in sizes]
    hhs = [s / 2.0 for s in sizes]
    for r in ratios[1:]:
        sr = float(np.sqrt(r))
        hws.append(sizes[0] * in_h / in_w * sr / 2.0)
        hhs.append(sizes[0] / sr / 2.0)
    hw, hh = _consts(hws, f32, dev), _consts(hhs, f32, dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    boxes = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes.to(data.dtype).detach()


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2), **attrs):
    """SSD training targets (reference: multibox_target.cc:72-280).

    anchor (1, N, 4), label (B, M, 5+) rows [cls, x1, y1, x2, y2] (pad
    rows cls -1), cls_pred (B, classes, N) -> (loc_target (B, N*4),
    loc_mask (B, N*4), cls_target (B, N)), the whole batch at once: M
    rounds of the greedy bipartite phase (the global first argmax of the
    masked IoU matrix), the threshold phase, hard-negative mining ranked
    by the background softmax probability (stable order), and the
    variance encoding of the matched boxes."""
    vx, vy, vw, vh = _floats(variances)
    thr = float(overlap_threshold)
    ratio = float(negative_mining_ratio)
    with torch.no_grad():
        anchors = anchor.reshape(-1, 4)
        N = anchors.shape[0]
        B, M = label.shape[0], label.shape[1]
        dev = anchors.device
        valid_gt = label[:, :, 0] >= 0                          # (B, M)
        iou = torch.where(valid_gt[:, None, :],
                          _corner_iou(anchors, label[:, :, 1:5]), -1.0)
        ar_n = torch.arange(N, device=dev)
        ar_m = torch.arange(M, device=dev)
        a_matched = torch.zeros((B, N), dtype=torch.bool, device=dev)
        g_matched = torch.zeros((B, M), dtype=torch.bool, device=dev)
        match_gt = torch.full((B, N), -1, dtype=torch.int64, device=dev)
        match_iou = torch.full((B, N), -1.0, dtype=iou.dtype, device=dev)
        for _ in range(M):
            masked = torch.where(a_matched[:, :, None] | g_matched[:, None, :],
                                 -1.0, iou).reshape(B, -1)
            flat = masked.argmax(1)
            val = masked.gather(1, flat[:, None])[:, 0]
            take = (val > 1e-6)[:, None]
            hit_a = (ar_n == (flat // M)[:, None]) & take
            a_matched |= hit_a
            g_matched |= (ar_m == (flat % M)[:, None]) & take
            match_gt = torch.where(hit_a, (flat % M)[:, None], match_gt)
            match_iou = torch.where(hit_a, val[:, None], match_iou)
        best_gt = iou.argmax(2)
        best_iou = iou.amax(2)
        thresh_pos = ~a_matched & (best_iou > thr) & (thr > 0)
        match_gt = torch.where(thresh_pos, best_gt, match_gt)
        match_iou = torch.where(a_matched, match_iou, best_iou)
        positive = a_matched | thresh_pos
        if ratio > 0:
            prob_bg = torch.softmax(cls_pred, dim=1)[:, 0]       # (B, N)
            candidate = ~positive & (match_iou < float(
                negative_mining_thresh))
            num_pos = positive.sum(1)
            num_neg = torch.minimum(
                torch.clamp((num_pos * ratio).to(torch.int64),
                            min=int(minimum_negative_samples)),
                N - num_pos)
            order = torch.argsort(torch.where(candidate, prob_bg,
                                              float("inf")),
                                  dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, ar_n.expand(B, N))
            negative = candidate & (rank < num_neg[:, None])
        else:
            negative = ~positive
        take_gt = match_gt.clamp(0, M - 1)           # jnp.take mode="clip"
        cls_ids = torch.where(valid_gt, label[:, :, 0], 0.0)
        cls_target = torch.where(
            positive, cls_ids.gather(1, take_gt) + 1.0,
            torch.where(negative, 0.0, float(ignore_label)))
        a_ctr = _corner_to_center(anchors)
        g_ctr = _corner_to_center(label[:, :, 1:5].gather(
            1, take_gt[:, :, None].expand(B, N, 4)))
        aw = a_ctr[:, 2].clamp_min(1e-12)
        ah = a_ctr[:, 3].clamp_min(1e-12)
        tx = _div((g_ctr[..., 0] - a_ctr[:, 0]) / aw, vx)
        ty = _div((g_ctr[..., 1] - a_ctr[:, 1]) / ah, vy)
        tw = _div(torch.log((g_ctr[..., 2] / aw).clamp_min(1e-12)), vw)
        th = _div(torch.log((g_ctr[..., 3] / ah).clamp_min(1e-12)), vh)
        loc = torch.where(positive[..., None],
                          torch.stack([tx, ty, tw, th], dim=-1), 0.0)
        mask = positive[..., None].to(loc.dtype).expand(B, N, 4)
        return loc.reshape(B, -1), mask.reshape(B, -1), cls_target


# ---------------------------------------------------------------------------
# NMS core (shared by box_nms, MultiBoxDetection and Proposal)
# ---------------------------------------------------------------------------
def _nms_sorted(boxes, valid, thresh, ids=None):
    """Greedy NMS of candidates already in score order: boxes (B, K, 4)
    corner, valid (B, K), ids (B, K) or None (candidates of different ids
    never suppress each other).  Returns the keep mask (B, K) of the
    sequential loop, as the fixed point of one matrix-vector step (the
    module docstring); reads a convergence flag back to the host after
    each round of steps."""
    B, K = valid.shape
    if K == 0 or valid.device.type == "meta":
        return valid
    dev = valid.device
    # 0/1 sums are exact for the > 0 test in any precision
    dt = torch.float16 if valid.is_cuda else torch.float32
    can = torch.empty((B, K, K), dtype=dt, device=dev)
    idx = torch.arange(K, device=dev)
    rows = max(1, _NMS_CHUNK // (B * K))
    for s in range(0, K, rows):
        e = min(K, s + rows)
        c = _corner_iou(boxes[:, s:e], boxes) > thresh
        c &= idx[s:e, None] < idx
        if ids is not None:
            c &= ids[:, s:e, None] == ids[:, None, :]
        can[:, s:e] = c
    keep, steps = valid, 1
    NMS_COUNTS["calls"] += 1
    while True:
        for _ in range(steps):
            prev = keep
            keep = valid & ~(torch.bmm(keep.to(dt)[:, None], can)[:, 0] > 0)
        NMS_COUNTS["steps"] += steps
        NMS_COUNTS["host_reads"] += 1
        if torch.equal(keep, prev):
            return keep
        steps *= 2


def _nms(boxes, scores, valid, thresh, ids=None, limit=-1):
    """The keep mask (B, N), in input order, of greedy NMS over the valid
    candidates in stable descending score order, the first ``limit`` of
    them (all for ``limit`` <= 0)."""
    B, N = valid.shape
    order = torch.argsort(-torch.where(valid, scores, float("-inf")),
                          dim=1, stable=True)
    top = order[:, :min(limit, N) if limit > 0 else N]
    keep = _nms_sorted(
        boxes.gather(1, top[..., None].expand(-1, -1, 4)),
        valid.gather(1, top), thresh,
        None if ids is None else ids.gather(1, top))
    return torch.zeros_like(valid).scatter_(1, top, keep)


def _kept_first(keep, scores):
    """The stable order that puts kept rows first, by descending score."""
    return torch.argsort(-torch.where(keep, scores, float("-inf")), dim=1,
                         stable=True)


@register("_contrib_box_iou", params=[
    P("format", ("corner", "center"), default="corner")])
def _box_iou(lhs, rhs, format="corner", **attrs):
    """Pairwise IoU over the last axis of 4 (reference: bounding_box-inl.h
    box_iou): shape lhs.shape[:-1] + rhs.shape[:-1]."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _corner_iou(lhs.reshape(-1, 4), rhs.reshape(-1, 4)).reshape(
        tuple(lhs.shape[:-1]) + tuple(rhs.shape[:-1]))


@register("_contrib_box_nms", params=[
    P("overlap_thresh", float, default=0.5, low=0.0, high=1.0),
    P("valid_thresh", float, default=0.0),
    P("topk", int, default=-1),
    P("coord_start", int, default=2),
    P("score_index", int, default=1),
    P("id_index", int, default=-1),
    P("force_suppress", bool, default=False),
    P("in_format", ("corner", "center"), default="corner"),
    P("out_format", ("corner", "center"), default="corner")],
          aliases=("_contrib_box_non_maximum_suppression",))
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1,
             force_suppress=False, in_format="corner",
             out_format="corner", **attrs):
    """NMS over (..., N, K) rows (reference: bounding_box-inl.h
    BoxNMSForward): suppressed rows become -1, kept rows come first in
    descending score order; differentiable in the kept rows."""
    shape = data.shape
    x = data.reshape(-1, shape[-2], shape[-1])
    cs, si = int(coord_start), int(score_index)
    with torch.no_grad():
        boxes = x[:, :, cs:cs + 4]
        if in_format == "center":
            boxes = _center_to_corner(boxes)
        scores = x[:, :, si]
        ids = None
        if not force_suppress and int(id_index) >= 0:
            ids = x[:, :, int(id_index)]
        keep = _nms(boxes, scores, scores > valid_thresh,
                    float(overlap_thresh), ids,
                    -1 if topk is None else int(topk))
        order = _kept_first(keep, scores)
    out = torch.where(keep[..., None], x, -1.0)
    if out_format != in_format:
        ob = out[:, :, cs:cs + 4]
        ob = (_corner_to_center(ob) if out_format == "center"
              else _center_to_corner(ob))
        ob = torch.where(keep[..., None], ob, -1.0)
        out = torch.cat([out[:, :, :cs], ob, out[:, :, cs + 4:]], dim=2)
    return out.gather(1, order[..., None].expand_as(out)).reshape(shape)


@register("_contrib_bipartite_matching", num_outputs=2)
def _bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1,
                        **attrs):
    """Greedy bipartite matching on a score matrix (..., N, M) ->
    (row_match (..., N), col_match (..., M)), -1 where unmatched
    (reference: bounding_box-inl.h BipartiteMatchingForward): up to
    min(N, M) (or ``topk``) rounds of the global first argmin of the signed
    scores, each accepted pair's row and column struck out, the first
    refused pair ending the matching."""
    shape = data.shape
    N, M = shape[-2], shape[-1]
    x = data.detach().reshape(-1, N, M)
    G = x.shape[0]
    sign = 1.0 if is_ascend else -1.0
    K = min(N, M) if topk is None or int(topk) <= 0 \
        else min(int(topk), min(N, M))
    dev = x.device
    inf = float("inf")
    ar_n = torch.arange(N, device=dev)
    ar_m = torch.arange(M, device=dev)
    sc = sign * x
    rm = torch.full((G, N), -1.0, device=dev)
    cm = torch.full((G, M), -1.0, device=dev)
    for _ in range(K):
        flat = sc.reshape(G, -1).argmin(1)
        i, j = flat // M, flat % M
        val = sc.reshape(G, -1).gather(1, flat[:, None])[:, 0] * sign
        ok = (val < threshold) if is_ascend else (val > threshold)
        rm = torch.where((ar_n == i[:, None]) & ok[:, None],
                         j[:, None].to(rm.dtype), rm)
        cm = torch.where((ar_m == j[:, None]) & ok[:, None],
                         i[:, None].to(cm.dtype), cm)
        struck = (ar_n[:, None] == i[:, None, None]) | \
            (ar_m == j[:, None, None])
        sc = torch.where(ok[:, None, None], sc.masked_fill(struck, inf), inf)
    return (rm.reshape(tuple(shape[:-1])),
            cm.reshape(tuple(shape[:-2]) + (M,)))


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                        background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1,
                        **attrs):
    """Decode SSD heads into detections (reference:
    multibox_detection.cc): cls_prob (B, classes, N) softmax
    probabilities, loc_pred (B, N*4), anchor (1, N, 4) -> (B, N, 6) rows
    [cls_id, score, x1, y1, x2, y2], the kept ones first by descending
    score, the rest -1.  A class id above ``background_id`` shifts down by
    one; NMS is class-aware unless ``force_suppress``, over the first
    ``nms_topk`` valid candidates."""
    vx, vy, vw, vh = _floats(variances)
    bg = int(background_id)
    with torch.no_grad():
        B, C, N = cls_prob.shape
        anchors = anchor.reshape(N, 4)
        a_ctr = _corner_to_center(anchors)
        is_bg = (torch.arange(C, device=cls_prob.device) == bg)[:, None]
        masked = torch.where(is_bg, float("-inf"), cls_prob)
        cls_id = masked.argmax(1)
        score = masked.amax(1)
        loc = loc_pred.reshape(B, N, 4)
        cx = loc[..., 0] * vx * a_ctr[:, 2] + a_ctr[:, 0]
        cy = loc[..., 1] * vy * a_ctr[:, 3] + a_ctr[:, 1]
        w = torch.exp(loc[..., 2] * vw) * a_ctr[:, 2]
        h = torch.exp(loc[..., 3] * vh) * a_ctr[:, 3]
        boxes = _center_to_corner(torch.stack([cx, cy, w, h], dim=-1))
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        keep = _nms(boxes, score, score > threshold, float(nms_threshold),
                    None if force_suppress else cls_id, int(nms_topk))
        out_id = torch.where(cls_id > bg, cls_id - 1, cls_id)
        rows = torch.cat([out_id[..., None].to(cls_prob.dtype),
                          score[..., None], boxes], dim=-1)
        rows = torch.where(keep[..., None], rows, -1.0)
        order = _kept_first(keep, score)
        return rows.gather(1, order[..., None].expand_as(rows))


# ---------------------------------------------------------------------------
# ROI pooling / align
# ---------------------------------------------------------------------------
def _roi_windows(hwc, bidx, hs, he, ws, we, kh, kw):
    """The windows of ROIPooling's bins, gathered from the NHWC map:
    (values (R, PH, PW, kh, kw, C), -inf outside each bin; the in-bin mask
    (R, PH, PW, kh, kw); the (b, y, x) index tensors)."""
    H, W = hwc.shape[1], hwc.shape[2]
    dev = hwc.device
    yy = hs[:, :, None] + torch.arange(kh, device=dev)         # (R, PH, kh)
    xx = ws[:, :, None] + torch.arange(kw, device=dev)         # (R, PW, kw)
    mask = (yy < he[:, :, None])[:, :, None, :, None] & \
        (xx < we[:, :, None])[:, None, :, None, :]
    idx = (bidx[:, None, None, None, None],
           yy.clamp(max=H - 1)[:, :, None, :, None],
           xx.clamp(max=W - 1)[:, None, :, None, :])
    vals = hwc[idx].masked_fill(~mask[..., None], float("-inf"))
    return vals, mask, idx


class _ROIMaxPool(torch.autograd.Function):
    """ROIPooling's max over each bin's window, ROIs in chunks of
    ``step``; the backward recomputes the windows and shares each bin's
    gradient equally among its tied maxima."""

    @staticmethod
    def forward(ctx, data, bidx, hs, he, ws, we, kh, kw, step):
        hwc = data.permute(0, 2, 3, 1).contiguous()
        outs = []
        for s in range(0, bidx.shape[0], step):
            sl = slice(s, s + step)
            vals, mask, _ = _roi_windows(hwc, bidx[sl], hs[sl], he[sl],
                                         ws[sl], we[sl], kh, kw)
            empty = ~mask.any(4).any(3)
            outs.append(vals.amax((3, 4)).masked_fill(empty[..., None], 0.0))
        out = torch.cat(outs)                           # (R, PH, PW, C)
        ctx.save_for_backward(data, bidx, hs, he, ws, we, out)
        ctx.window = (kh, kw, step)
        return out.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        data, bidx, hs, he, ws, we, out = ctx.saved_tensors
        kh, kw, step = ctx.window
        hwc = data.permute(0, 2, 3, 1).contiguous()
        g = g.permute(0, 2, 3, 1)
        grad = torch.zeros_like(hwc)
        for s in range(0, bidx.shape[0], step):
            sl = slice(s, s + step)
            vals, _, idx = _roi_windows(hwc, bidx[sl], hs[sl], he[sl],
                                        ws[sl], we[sl], kh, kw)
            ties = vals == out[sl][:, :, :, None, None, :]
            cnt = ties.sum((3, 4))
            share = torch.where(cnt > 0, g[sl] / cnt, 0.0)
            grad.index_put_(idx, ties * share[:, :, :, None, None, :],
                            accumulate=True)
        return (grad.permute(0, 3, 1, 2),) + (None,) * 8


@register("ROIPooling", aliases=("_contrib_ROIPooling",))
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0, **attrs):
    """Max-pool regions of interest (reference: roi_pooling-inl.h): data
    (B, C, H, W), rois (R, 5) rows [batch_idx, x1, y1, x2, y2] in image
    coordinates -> (R, C, PH, PW).  Bin bounds as the reference's loops
    (rounded corners, floor/ceil, clamped to the map); an empty bin gives
    0.  Memory O(R * C * PH * PW * the largest bin's area), in chunks of
    ROIs; the largest bin's extent is read back to the host."""
    PH, PW = normalize_tuple(pooled_size, 2)
    B, C, H, W = data.shape
    R = rois.shape[0]
    if data.device.type == "meta" or R == 0:
        return data.new_empty((R, C, PH, PW))
    scale = float(spatial_scale)
    with torch.no_grad():
        r = rois.detach()
        bidx = r[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (torch.round(r[:, k] * scale) for k in range(1, 5))
        one = r.new_ones(())
        bin_h = _div(torch.maximum(y2 - y1 + 1.0, one), PH)
        bin_w = _div(torch.maximum(x2 - x1 + 1.0, one), PW)
        ph = torch.arange(PH, dtype=r.dtype, device=r.device)
        pw = torch.arange(PW, dtype=r.dtype, device=r.device)
        hs = (torch.floor(ph * bin_h[:, None]) + y1[:, None]).clamp(0, H)
        he = (torch.ceil((ph + 1) * bin_h[:, None]) + y1[:, None]).clamp(0, H)
        ws = (torch.floor(pw * bin_w[:, None]) + x1[:, None]).clamp(0, W)
        we = (torch.ceil((pw + 1) * bin_w[:, None]) + x1[:, None]).clamp(0, W)
        hs, he, ws, we = (t.to(torch.int64) for t in (hs, he, ws, we))
        kh, kw = (max(int(v), 1) for v in torch.stack(
            [(he - hs).amax(), (we - ws).amax()]).tolist())
    per_roi = PH * PW * kh * kw * C * data.element_size()
    step = max(1, _ROI_CHUNK_BYTES // per_roi)
    return _ROIMaxPool.apply(data, bidx, hs, he, ws, we, kh, kw, step)


@register("_contrib_ROIAlign", params=[
    P("pooled_size", tuple, required=True, low=1),
    P("spatial_scale", float, required=True, low=0.0),
    P("sample_ratio", int, default=2)])
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=2, **attrs):
    """ROIAlign (the reference's successor to ROIPooling): no rounding of
    the ROI, the mean of ``sample_ratio``^2 bilinear samples a bin
    (``sample_ratio`` <= 0: a fixed 2 x 2 grid, as in the JAX package);
    differentiable in the map and in the ROI coordinates."""
    PH, PW = normalize_tuple(pooled_size, 2)
    S = 2 if int(sample_ratio) <= 0 else int(sample_ratio)
    B, C, H, W = data.shape
    scale = float(spatial_scale)
    dev, dt = data.device, data.dtype
    hwc = data.permute(0, 2, 3, 1).contiguous()
    bidx = rois[:, 0].detach().to(torch.int64)
    x1, y1, x2, y2 = (rois[:, k] * scale for k in range(1, 5))
    one = rois.new_ones(())
    bh = _div(torch.maximum(y2 - y1, one), PH)
    bw = _div(torch.maximum(x2 - x1, one), PW)
    ph = torch.arange(PH, dtype=dt, device=dev)[:, None, None, None]
    pw = torch.arange(PW, dtype=dt, device=dev)[None, :, None, None]
    sy = torch.arange(S, dtype=dt, device=dev)[None, None, :, None]
    sx = torch.arange(S, dtype=dt, device=dev)[None, None, None, :]
    r4 = (slice(None), None, None, None, None)
    shape = (rois.shape[0], PH, PW, S, S)
    yy = (y1[r4] + (ph + _div(sy + 0.5, S)) * bh[r4]).expand(shape)
    xx = (x1[r4] + (pw + _div(sx + 0.5, S)) * bw[r4]).expand(shape)
    y = torch.minimum(torch.maximum(yy, data.new_zeros(())),
                      data.new_full((), H - 1.0))
    x = torch.minimum(torch.maximum(xx, data.new_zeros(())),
                      data.new_full((), W - 1.0))
    y0 = torch.floor(y).detach()
    x0 = torch.floor(x).detach()
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i, x1i = (y0i + 1).clamp(max=H - 1), (x0i + 1).clamp(max=W - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    b = bidx[r4]
    v = (hwc[b, y0i, x0i] * (1 - ly) * (1 - lx)
         + hwc[b, y0i, x1i] * (1 - ly) * lx
         + hwc[b, y1i, x0i] * ly * (1 - lx)
         + hwc[b, y1i, x1i] * ly * lx)                # (R, PH, PW, S, S, C)
    return v.mean((3, 4)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Region proposals (RPN)
# ---------------------------------------------------------------------------
def _rpn_anchors(H, W, feature_stride, scales, ratios, device):
    """Shifted base anchors in pixels, (H*W*A, 4) ordered (h, w, a); the
    base sizes rounded half to even in float64, as ``np.round``."""
    base = float(feature_stride)
    ws, hs = [], []
    for r in ratios:
        size = base * base / float(r)
        w0 = np.round(np.sqrt(size))
        h0 = np.round(w0 * float(r))
        for s in scales:
            ws.append(w0 * float(s))
            hs.append(h0 * float(s))
    f32 = torch.float32
    ws, hs = _consts(ws, f32, device), _consts(hs, f32, device)
    ctr = (base - 1.0) / 2.0
    base_boxes = torch.stack([ctr - 0.5 * (ws - 1), ctr - 0.5 * (hs - 1),
                              ctr + 0.5 * (ws - 1), ctr + 0.5 * (hs - 1)],
                             dim=-1)                             # (A, 4)
    sy = torch.arange(H, dtype=f32, device=device) * base
    sx = torch.arange(W, dtype=f32, device=device) * base
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([sxg, syg, sxg, syg], dim=-1)           # (H, W, 4)
    return (shifts[:, :, None, :] + base_boxes[None, None]).reshape(-1, 4)


@register("_contrib_Proposal", aliases=("Proposal", "_contrib_MultiProposal"),
          num_outputs=lambda attrs: 2 if _coerce(
              attrs.get("output_score", False)) else 1)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False,
              **attrs):
    """RPN proposals (reference: multi_proposal-inl.h): cls_prob (B, 2A,
    H, W), bbox_pred (B, 4A, H, W), im_info (B, 3) [height, width, scale]
    -> rois (B*post_n, 5) [batch_idx, x1, y1, x2, y2] (and scores
    (B*post_n, 1) with ``output_score``).  Deltas decoded against the
    anchors (``exp`` clipped to +-10), boxes clipped to the image, those
    under ``rpn_min_size`` dropped, NMS over the best ``rpn_pre_nms_top_n``;
    slots past the kept count repeat the best box."""
    scales, ratios = _floats(scales), _floats(ratios)
    B, A2, H, W = cls_prob.shape
    A = A2 // 2
    post_n = int(rpn_post_nms_top_n)
    with torch.no_grad():
        dev = cls_prob.device
        anchors = _rpn_anchors(H, W, feature_stride, scales, ratios, dev)
        K = anchors.shape[0]
        a_ctr = _corner_to_center(anchors)
        score = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
        d = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
            .reshape(B, -1, 4)
        cx = d[..., 0] * a_ctr[:, 2] + a_ctr[:, 0]
        cy = d[..., 1] * a_ctr[:, 3] + a_ctr[:, 1]
        w = torch.exp(torch.clamp(d[..., 2], -10, 10)) * a_ctr[:, 2]
        h = torch.exp(torch.clamp(d[..., 3], -10, 10)) * a_ctr[:, 3]
        boxes = _center_to_corner(torch.stack([cx, cy, w, h], dim=-1))
        zero = boxes.new_zeros(())
        im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
        boxes = torch.stack([
            torch.minimum(torch.maximum(boxes[..., 0], zero), im_w - 1),
            torch.minimum(torch.maximum(boxes[..., 1], zero), im_h - 1),
            torch.minimum(torch.maximum(boxes[..., 2], zero), im_w - 1),
            torch.minimum(torch.maximum(boxes[..., 3], zero), im_h - 1)],
            dim=-1)
        min_size = float(rpn_min_size) * im_info[:, 2:3]
        keep_size = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
            ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
        score = torch.where(keep_size, score, float("-inf"))
        keep = _nms(boxes, score, keep_size, float(threshold), None,
                    min(int(rpn_pre_nms_top_n), K))
        order = _kept_first(keep, score)
        top = torch.where(
            torch.arange(post_n, device=dev) < keep.sum(1, keepdim=True),
            order[:, :post_n], order[:, :1])
        rois = torch.cat([
            torch.arange(B, dtype=boxes.dtype, device=dev)
            .repeat_interleave(post_n)[:, None],
            boxes.gather(1, top[..., None].expand(-1, -1, 4))
            .reshape(-1, 4)], dim=-1)
        if _coerce(output_score):
            return rois, score.gather(1, top).reshape(-1, 1)
        return rois


# ---------------------------------------------------------------------------
# Deformable convolution / PSROI pooling
# ---------------------------------------------------------------------------
@register("_contrib_DeformableConvolution")
def _deformable_conv(data, offset, weight, bias=None, kernel=(3, 3),
                     stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                     num_filter=1, num_group=1, num_deformable_group=1,
                     no_bias=False, **attrs):
    """Deformable convolution v1 (reference:
    deformable_convolution-inl.h): each kernel tap samples the padded
    input bilinearly at its learned offset (a sample outside the padded
    map gives 0), then one matmul with the kernel.  data (B, C, H, W);
    offset (B, 2*DG*KH*KW, OH, OW) as (dg, tap, (dy, dx)); weight
    (num_filter, C/num_group, KH, KW).  Differentiable in data, offset
    (through the bilinear weights) and weight."""
    KH, KW = normalize_tuple(kernel, 2)
    SH, SW = normalize_tuple(stride, 2)
    DH, DW = normalize_tuple(dilate, 2)
    PH_, PW_ = normalize_tuple(pad, 2)
    B, C, H, W = data.shape
    OH = (H + 2 * PH_ - DH * (KH - 1) - 1) // SH + 1
    OW = (W + 2 * PW_ - DW * (KW - 1) - 1) // SW + 1
    DG, G, Fn = int(num_deformable_group), int(num_group), int(num_filter)
    Cg, KK = C // DG, KH * KW
    Hp, Wp = H + 2 * PH_, W + 2 * PW_
    dev, dt = data.device, data.dtype
    fmap = F.pad(data, (PW_, PW_, PH_, PH_)).reshape(B, DG, Cg, Hp * Wp)
    off = offset.reshape(B, DG, KK, 2, OH, OW)
    taps = torch.arange(KK, device=dev)
    ky = ((taps // KW) * DH).to(dt)[:, None, None]
    kx = ((taps % KW) * DW).to(dt)[:, None, None]
    oy = (torch.arange(OH, dtype=dt, device=dev) * SH)[:, None]
    ox = (torch.arange(OW, dtype=dt, device=dev) * SW)[None, :]
    y = oy + ky + off[:, :, :, 0]                     # (B, DG, KK, OH, OW)
    x = ox + kx + off[:, :, :, 1]
    y0 = torch.floor(y).detach()
    x0 = torch.floor(x).detach()
    ly, lx = y - y0, x - x0
    y0i = y0.to(torch.int64).clamp(0, Hp - 1)
    x0i = x0.to(torch.int64).clamp(0, Wp - 1)
    y1i, x1i = (y0i + 1).clamp(0, Hp - 1), (x0i + 1).clamp(0, Wp - 1)
    inb = (y > -1.0) & (y < Hp) & (x > -1.0) & (x < Wp)

    def g(yi, xi):
        idx = (yi * Wp + xi).reshape(B, DG, 1, -1).expand(B, DG, Cg, -1)
        return fmap.gather(3, idx).reshape(B, DG, Cg, KK, OH, OW)

    w = lambda t: t[:, :, None]                               # noqa: E731
    v = (g(y0i, x0i) * w(1 - ly) * w(1 - lx) + g(y0i, x1i) * w(1 - ly)
         * w(lx) + g(y1i, x0i) * w(ly) * w(1 - lx) + g(y1i, x1i) * w(ly)
         * w(lx))
    col = torch.where(w(inb), v, 0.0).reshape(B, C * KK, OH * OW)
    wmat = weight.reshape(Fn, -1)
    if G == 1:
        out = torch.matmul(wmat, col)
    else:
        out = torch.einsum("gfk,bgkn->bgfn", wmat.reshape(G, Fn // G, -1),
                           col.reshape(B, G, (C // G) * KK, OH * OW))
    out = out.reshape(B, Fn, OH, OW)
    if bias is not None and not no_bias:
        out = out + bias[:, None, None]
    return out


@register("_contrib_DeformablePSROIPooling")
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=7,
                              part_size=0, sample_per_part=4,
                              trans_std=0.1, no_trans=False, **attrs):
    """Position-sensitive ROI pooling with learned part offsets
    (reference: deformable_psroi_pooling-inl.h): data channels
    (output_dim * group_size^2); each bin (od, ph, pw) averages
    ``sample_per_part``^2 bilinear samples of its channel, shifted by
    ``trans`` (R, 2, part, part) * ``trans_std`` * the ROI's size.
    Differentiable in data and trans."""
    P_, GS, OD = int(pooled_size), int(group_size), int(output_dim)
    S = max(int(sample_per_part), 1)
    PS = int(part_size) or P_
    B, C, H, W = data.shape
    R = rois.shape[0]
    scale = float(spatial_scale)
    dev, dt = data.device, data.dtype
    grid = torch.arange(P_, device=dev)
    part = (grid * PS // P_).clamp(max=PS - 1)
    grp = (grid * GS // P_).clamp(max=GS - 1)
    chan = (torch.arange(OD, device=dev)[:, None, None] * GS
            + grp[:, None]) * GS + grp                      # (OD, P, P)
    r = rois.detach()
    bidx = r[:, 0].to(torch.int64)
    x1 = torch.round(r[:, 1]) * scale - 0.5
    y1 = torch.round(r[:, 2]) * scale - 0.5
    x2 = (torch.round(r[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(r[:, 4]) + 1.0) * scale - 0.5
    tenth = r.new_full((), 0.1)
    rw = torch.maximum(x2 - x1, tenth)
    rh = torch.maximum(y2 - y1, tenth)
    bw, bh = _div(rw, P_), _div(rh, P_)
    if trans is None or _coerce(no_trans):
        tr = data.new_zeros((R, 2, PS, PS))
    else:
        tr = trans.reshape(-1, 2, PS, PS)[:R]
    pp = (slice(None), part[:, None], part[None, :])
    r2 = (slice(None), None, None)
    dy = tr[:, 0][pp] * float(trans_std) * rh[r2]              # (R, P, P)
    dx = tr[:, 1][pp] * float(trans_std) * rw[r2]
    ph = torch.arange(P_, dtype=dt, device=dev)
    sy = _div((torch.arange(S, dtype=dt, device=dev) + 0.5) * bh[:, None],
              S)
    sx = _div((torch.arange(S, dtype=dt, device=dev) + 0.5) * bw[:, None],
              S)
    r4 = (slice(None), None, None, None, None)
    yy = (y1[r4] + ph[None, :, None, None, None] * bh[r4]
          + dy[:, :, :, None, None] + sy[:, None, None, :, None])
    xx = (x1[r4] + ph[None, None, :, None, None] * bw[r4]
          + dx[:, :, :, None, None] + sx[:, None, None, None, :])
    y = torch.minimum(torch.maximum(yy, data.new_zeros(())),
                      data.new_full((), H - 1.0))
    x = torch.minimum(torch.maximum(xx, data.new_zeros(())),
                      data.new_full((), W - 1.0))
    y0 = torch.floor(y).detach()
    x0 = torch.floor(x).detach()
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i, x1i = (y0i + 1).clamp(max=H - 1), (x0i + 1).clamp(max=W - 1)
    ly, lx = y - y0, x - x0                                   # (R, P, P, S, S)
    b = bidx[:, None, None, None, None, None]
    c = chan[None, :, :, :, None, None]
    at = lambda yi, xi: data[b, c, yi[:, None], xi[:, None]]   # noqa: E731
    v = (at(y0i, x0i) * ((1 - ly) * (1 - lx))[:, None]
         + at(y0i, x1i) * ((1 - ly) * lx)[:, None]
         + at(y1i, x0i) * (ly * (1 - lx))[:, None]
         + at(y1i, x1i) * (ly * lx)[:, None])          # (R, OD, P, P, S, S)
    return v.mean((4, 5))


@register("_contrib_flash_attention")
def _flash_attention_op(q, k, v, causal=False, scale=None, **attrs):
    """Softmax attention over (B, T, H, D) tensors; K/V may carry fewer
    heads (GQA).  Runs ``parallel.attention.local_attention``: the K7a
    flash kernel where it is eligible, else the einsum logits with the
    K5a/K2 softmax or plain torch; differentiable through each route's
    backward (K7b and K7c, K5b, or torch's autograd).  Under an active
    mesh with ``sp > 1`` (``parallel.mesh_scope``) it is
    ``parallel.ring_attention`` over that axis instead, as in the JAX
    package: the same model becomes sequence-parallel."""
    from ..parallel.attention import local_attention, ring_attention
    from ..parallel.mesh import current_mesh
    if scale is not None:
        scale = float(scale)
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        return ring_attention(q, k, v, mesh=mesh, causal=bool(causal),
                              scale=scale)
    return local_attention(q, k, v, causal=bool(causal), scale=scale)


@register("_contrib_fused_bn_relu")
def _fused_bn_relu(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
                   act=True, **attrs):
    """Inference BatchNorm folded into per-channel scale and bias, and
    ReLU (``act``), over NCHW data: ``relu(x * scale + bias)`` with
    ``scale = gamma * rsqrt(var + eps)`` and ``bias = beta - mean *
    scale`` (gamma is used as given).  With ``MXNET_PALLAS_BN_RELU`` on
    for data's device (``auto``: CUDA tensors) this is one K3 launch
    (``nn.fused_bn_relu_eval`` -> ``cuda_kernels.scale_bias_relu``, the
    plain version for CPU tensors); with the knob at 0 the plain
    version."""
    from . import cuda_kernels as ck
    from .nn import fused_bn_relu_eval
    if ck.family_enabled("MXNET_PALLAS_BN_RELU", data.device):
        return fused_bn_relu_eval(data, gamma, beta, moving_mean, moving_var,
                                  eps=eps, fix_gamma=False, relu=bool(act))
    scale = (gamma * torch.rsqrt(moving_var + eps)).float()
    bias = (beta - moving_mean * scale).float()
    return ck.scale_bias_relu_ref(data, scale, bias, relu=bool(act))


@register("_contrib_fft")
def _fft(data, compute_size=128, **attrs):
    """FFT over the last axis: real (..., D) -> interleaved (re, im)
    (..., 2D) (reference: contrib/fft-inl.h); ``compute_size`` is the
    reference's batching and is ignored."""
    out = torch.fft.fft(data.float(), dim=-1)
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        tuple(data.shape[:-1]) + (2 * data.shape[-1],)).to(data.dtype)


@register("_contrib_ifft")
def _ifft(data, compute_size=128, **attrs):
    """The inverse: interleaved (..., 2D) -> real (..., D), unnormalised
    (scaled by D, as the reference's cuFFT plan leaves it)."""
    d = data.shape[-1] // 2
    x = data.reshape(tuple(data.shape[:-1]) + (d, 2)).float()
    out = torch.fft.ifft(torch.complex(x[..., 0], x[..., 1]), dim=-1).real
    return (out * d).to(data.dtype)


@register("_contrib_count_sketch")
def _count_sketch(data, h, s, out_dim=0, **attrs):
    """Count-sketch projection (reference: contrib/count_sketch-inl.h):
    ``out[..., h[i]] += s[i] * data[..., i]``."""
    hi = h.reshape(-1).to(torch.int64)
    si = s.reshape(-1).to(data.dtype)
    out = torch.zeros(tuple(data.shape[:-1]) + (int(out_dim),),
                      dtype=data.dtype, device=data.device)
    return out.index_add(-1, hi, data * si)
