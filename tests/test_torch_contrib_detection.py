"""The port's detection and ROI operators against the JAX package, on the
CPU, at small sizes (24-200 anchors, 1-5 boxes, 2-3 images, maps of 2-8
channels), from numpy inputs made from a seed.

Bands: integer-valued outputs (class ids, matches, masks, targets, the
rows ``box_nms`` keeps, ROIPooling's maxima) bitwise; other values within
``F32_BAND`` (1e-6) of the largest; gradients within ``GRAD_BAND``
(1e-5) of the largest, for ROIPooling (tied maxima and empty bins
included), ROIAlign, PSROIPooling and the deformable pair.

Hard-negative mining ranks anchors by the background softmax
probability, which torch and XLA may round differently in the last bit:
a mining decision may differ between the packages only as a flip that
``chip_smoke.mining_flips`` accepts (two anchors whose probabilities lie
within four fp32 spacings of each other on both sides, swapped).  The
tests count and print the flips: 0 at these inputs
(``test_mining_at_ssd_widths_counts_its_flips``).

Also: the fixed-point NMS against the sequential loop on suppression
chains of every depth, the chunked forms against the unchunked ones, the
namespaces, a graph bound through the executor, and two flows with the
JAX package's initial weights carried across: three steps of
example/ssd/train.py's 32x32 ``SSDNet`` with its decode, and
example/rcnn/train_end2end.py's ``detect`` pipeline; phase 26's
rehearsal at tiny widths.  A test that takes more than ~5 s here (most of
it the JAX package's compiles) is marked ``slow``: every op it holds is
also held, gradients included, by its ``chip_smoke.OP_CASES`` entries in
tests/test_torch_ops_nn.py.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

F32_BAND = 1e-6
GRAD_BAND = 1e-5
f32 = np.float32


def corners(rng, *shape, lo=0.0, hi=1.0):
    a = rng.uniform(lo, hi, shape + (2,))
    b = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([np.minimum(a, b), np.maximum(a, b)], -1) \
        .astype(f32)


def case(name, inputs, attrs=None, band="exact", grad=False):
    return {"name": name, "inputs": list(inputs), "attrs": dict(attrs or {}),
            "band": band, "grad": grad, "ctx": False, "canon": None,
            "after": False}


def held(c):
    """``chip_smoke.case_checks`` of one case, the port on the CPU against
    the JAX package: the checks outside their bands."""
    return [(what, err, lim) for what, err, lim in chip_smoke.case_checks(
        c, tmx, tmx.cpu(), jmx, jmx.cpu()) if not err <= lim]


def both(name, inputs, **attrs):
    """``name`` through both packages: (port outputs, JAX outputs) as
    lists of numpy arrays."""
    c = case(name, inputs, attrs)
    return (chip_smoke.run_case(tmx, c, tmx.cpu(), grad=False)[0],
            chip_smoke.run_case(jmx, c, jmx.cpu(), grad=False)[0])


# ---------------------------------------------------------------------------
# the box ops
# ---------------------------------------------------------------------------
def _dets(seed, n=40, images=2, ties=True):
    rng = np.random.RandomState(seed)
    d = np.concatenate([rng.randint(0, 3, (images, n, 1)).astype(f32),
                        rng.uniform(0, 1, (images, n, 1)).astype(f32),
                        corners(rng, images, n)], -1)
    if ties:
        d[:, 3:9, 1] = d[:, 2:3, 1]                   # equal scores
        d[:, 10:13, 2:] = d[:, 9:10, 2:]              # equal boxes
    return d


NMS_ATTRS = [
    pytest.param({"overlap_thresh": 0.3}, marks=pytest.mark.slow),
    {"overlap_thresh": 0.5, "topk": 7},
    {"overlap_thresh": 0.4, "id_index": 0},
    {"overlap_thresh": 0.4, "id_index": 0, "force_suppress": True},
    {"overlap_thresh": 0.3, "id_index": 0, "topk": 15, "valid_thresh": 0.3},
    {"overlap_thresh": 0.3, "in_format": "center", "out_format": "center"},
    {"overlap_thresh": 0.3, "in_format": "center", "out_format": "corner"},
    {"overlap_thresh": 0.3, "in_format": "corner", "out_format": "center"},
    {"overlap_thresh": 0.6, "coord_start": 1, "score_index": 0,
     "id_index": 5},
]


@pytest.mark.parametrize("attrs", NMS_ATTRS, ids=str)
def test_box_nms_matches_the_jax_package(attrs):
    d = _dets(1, n=60)
    assert held(case("_contrib_box_nms", [d], attrs, grad=True)) == []


def test_box_nms_keeps_a_score_tie_in_input_order():
    d = np.array([[[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                   [0, 0.5, 0.0, 0.0, 0.2, 0.2],
                   [0, 0.5, 0.5, 0.5, 0.7, 0.7],
                   [0, 0.9, 0.05, 0.0, 1.0, 1.0]]], f32)
    got, want = both("_contrib_box_nms", [d], overlap_thresh=0.5)
    np.testing.assert_array_equal(got[0], want[0])
    out = got[0][0]
    # the two 0.9 boxes overlap: the first in input order wins
    np.testing.assert_array_equal(out[0], d[0, 0])
    np.testing.assert_array_equal(out[1:3], d[0, 1:3])
    assert (out[3] == -1).all()


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_the_jax_package(fmt):
    rng = np.random.RandomState(2)
    lhs = corners(rng, 2, 5) if fmt == "corner" else \
        rng.uniform(0.2, 0.8, (2, 5, 4)).astype(f32)
    rhs = corners(rng, 7) if fmt == "corner" else \
        rng.uniform(0.2, 0.8, (7, 4)).astype(f32)
    assert held(case("_contrib_box_iou", [lhs, rhs], {"format": fmt},
                     band=F32_BAND, grad=True)) == []


@pytest.mark.parametrize("attrs", [
    {"threshold": 0.4}, {"threshold": 0.4, "topk": 2},
    {"threshold": 0.6, "is_ascend": True},
    {"threshold": 0.6, "is_ascend": True, "topk": 3},
    {"threshold": 2.0}], ids=str)
def test_bipartite_matching_matches_the_jax_package(attrs):
    rng = np.random.RandomState(3)
    scores = rng.uniform(0, 1, (3, 7, 5)).astype(f32)
    scores[0, 2, :] = scores[0, 1, :]                  # tied rows
    assert held(case("_contrib_bipartite_matching", [scores], attrs)) == []


# ---------------------------------------------------------------------------
# SSD: priors, targets, detection
# ---------------------------------------------------------------------------
PRIORS = [((38, 19, 10, 5, 3, 1)[i],
           {"sizes": chip_smoke.SSD300["sizes"][i],
            "ratios": chip_smoke.SSD300["ratios"][i],
            "steps": (chip_smoke.SSD300["steps"][i],) * 2})
          for i in range(6)] + [
    (8, {"sizes": (0.3, 0.6), "ratios": (1.0, 2.0), "clip": True}),
    (5, {"offsets": (0.25, 0.75), "steps": (0.3, -1.0)})]


@pytest.mark.parametrize("side,attrs", PRIORS, ids=str)
def test_multibox_prior_is_the_jax_packages_bit_for_bit(side, attrs):
    """SSD300's six maps at their own sizes, ratios and steps (the half
    extents in float64, cast once), the example's clipped priors, and
    offsets with one default step."""
    got, want = both("MultiBoxPrior", [np.zeros((1, 2, side, side + 1),
                                                f32)], **attrs)
    np.testing.assert_array_equal(got[0], want[0])


def _ssd_inputs(seed, n, m, images, classes):
    rng = np.random.RandomState(seed)
    anchors = corners(rng, 1, n)
    labels = np.concatenate([rng.randint(0, classes - 1, (images, m, 1))
                             .astype(f32), corners(rng, images, m)], -1)
    if images > 1 and m > 1:
        labels[1, m // 2:] = -1.0                      # padded label rows
    logits = rng.uniform(-2, 2, (images, classes, n)).astype(f32)
    return anchors, labels, logits


def _targets_held(anchors, labels, logits, attrs):
    got, want = both("MultiBoxTarget", [anchors, labels, logits], **attrs)
    np.testing.assert_array_equal(got[1], want[1])         # loc_mask
    err = chip_smoke.case_error([got[0]], [want[0]], F32_BAND)
    assert err <= F32_BAND, err
    if attrs.get("negative_mining_ratio", -1) > 0:
        prob_t = torch.softmax(torch.from_numpy(logits), 1)[:, 0].numpy()
        import jax
        prob_j = np.asarray(jax.nn.softmax(logits.transpose(0, 2, 1),
                                           axis=-1))[..., 0]
        flips, bad = chip_smoke.mining_flips(got[2], want[2], prob_t, prob_j)
        assert bad == 0
        return flips
    np.testing.assert_array_equal(got[2], want[2])
    return 0


@pytest.mark.parametrize("n,m,images,attrs", [
    (24, 1, 2, {"overlap_threshold": 0.3}),
    (60, 4, 3, {"overlap_threshold": 0.4}),
    (60, 4, 3, {"overlap_threshold": 0.3, "negative_mining_ratio": 3.0}),
    pytest.param(120, 5, 2, {"overlap_threshold": 0.2,
                             "negative_mining_ratio": 2.0,
                             "negative_mining_thresh": 0.3,
                             "minimum_negative_samples": 10}, marks=pytest.mark.slow),
    pytest.param(200, 3, 3, {"overlap_threshold": 0.5,
                             "negative_mining_ratio": 3.0,
                             "ignore_label": -2.0,
                             "variances": (0.1, 0.1, 0.25, 0.25)}, marks=pytest.mark.slow),
    (50, 5, 2, {"overlap_threshold": 0.0}),
], ids=str)
def test_multibox_target_matches_the_jax_package(n, m, images, attrs):
    flips = _targets_held(*_ssd_inputs(n + m, n, m, images, 4), attrs)
    print("mining flips: %d" % flips)


def test_mining_at_ssd_widths_counts_its_flips():
    """21 classes over 200 anchors of 3 images, mining 3:1: the flips
    between the packages' softmaxes counted (0 here), none outside fp32
    rounding."""
    flips = _targets_held(*_ssd_inputs(26, 200, 5, 3, 21),
                          {"overlap_threshold": 0.5,
                           "negative_mining_ratio": 3.0})
    print("mining flips at 200 anchors x 21 classes: %d" % flips)
    assert flips == 0


def test_mining_flips_accepts_only_rounding_swaps():
    ign = -1.0
    a = np.array([[0, ign, 1, 0]], f32)
    b = np.array([[ign, 0, 1, 0]], f32)
    p = np.array([[0.25, np.nextafter(f32(0.25), f32(1)), 0.9, 0.1]], f32)
    q = p[:, [1, 0, 2, 3]]
    assert chip_smoke.mining_flips(a, b, p, q) == (2, 0)
    far = np.array([[0.25, 0.3, 0.9, 0.1]], f32)
    assert chip_smoke.mining_flips(a, b, far, far) == (0, 2)
    assert chip_smoke.mining_flips(a, np.array([[1, ign, 1, 0]], f32), p,
                                   p)[1] == 1


@pytest.mark.parametrize("attrs", [
    pytest.param({"nms_threshold": 0.3}, marks=pytest.mark.slow),
    {"nms_threshold": 0.45, "nms_topk": 10},
    {"nms_threshold": 0.3, "force_suppress": True, "clip": False},
    {"nms_threshold": 0.5, "background_id": 2, "threshold": 0.2}], ids=str)
def test_multibox_detection_matches_the_jax_package(attrs):
    anchors, _, logits = _ssd_inputs(5, 80, 1, 2, 5)
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype(f32)
    loc = np.random.RandomState(6).uniform(-1, 1, (2, 320)).astype(f32)
    got, want = both("MultiBoxDetection", [prob, loc, anchors], **attrs)
    np.testing.assert_array_equal(got[0][..., :2], want[0][..., :2])
    err = chip_smoke.case_error(got, want, F32_BAND)
    assert err <= F32_BAND, err


def test_multibox_detection_equals_the_numpy_oracle():
    """The port's decode, held to chip_smoke's sequential numpy NMS (the
    oracle phase 26 holds the card to)."""
    anchors, _, logits = _ssd_inputs(7, 150, 1, 3, 6)
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype(f32)
    loc = np.random.RandomState(8).uniform(-1, 1, (3, 600)).astype(f32)
    for topk in (20, -1):
        got = tmx.nd.contrib.MultiBoxDetection(
            *[tmx.nd.array(a, ctx=tmx.cpu()) for a in (prob, loc, anchors)],
            nms_threshold=0.45, nms_topk=topk).asnumpy()
        for i in range(3):
            ok, diff = chip_smoke.detections_match(
                got[i], chip_smoke.detection_oracle(
                    prob[i], loc[i], anchors[0], nms_threshold=0.45,
                    nms_topk=topk))
            assert ok, diff


# ---------------------------------------------------------------------------
# the NMS core
# ---------------------------------------------------------------------------
def _greedy_loop(boxes, valid, thresh):
    keep = valid.copy()
    iou = tcontrib._corner_iou(torch.from_numpy(boxes),
                               torch.from_numpy(boxes)).numpy()
    for i in range(len(boxes)):
        if keep[i]:
            keep[i + 1:] &= ~(iou[i, i + 1:] > thresh)
    return keep


@pytest.mark.parametrize("depth", [1, 2, 5, 16, 33, 64])
def test_fixed_point_nms_equals_the_sequential_loop(depth):
    """A chain of ``depth`` boxes in score order, each overlapping only
    its neighbours (the greedy loop keeps every other one: the fixed
    point's worst case), beside random boxes; the steps taken grow with
    the chain's depth, the reads back with its logarithm."""
    rng = np.random.RandomState(depth)
    chain = np.array([[0.5 * i, 0, 0.5 * i + 1, 1] for i in range(depth)],
                     f32) / depth
    boxes = np.concatenate([chain, corners(rng, 40)])[None]
    valid = np.ones((1, boxes.shape[1]), bool)
    valid[0, -5:] = False
    for k in tcontrib.NMS_COUNTS:
        tcontrib.NMS_COUNTS[k] = 0
    keep = tcontrib._nms_sorted(torch.from_numpy(boxes),
                                torch.from_numpy(valid), 0.2).numpy()
    np.testing.assert_array_equal(keep[0], _greedy_loop(boxes[0], valid[0],
                                                        0.2))
    assert (keep[0, :depth] == (np.arange(depth) % 2 == 0)).all()
    steps, reads = (tcontrib.NMS_COUNTS[k] for k in ("steps", "host_reads"))
    assert depth <= steps < 4 * depth + 4
    assert reads <= int(np.log2(depth + 1)) + 2


def test_chunked_forms_equal_the_whole(monkeypatch):
    """NMS's suppression matrix a row at a time and ROIPooling one ROI a
    chunk give the same outputs and gradients."""
    d = _dets(9, n=50, images=3)
    rng = np.random.RandomState(10)
    data = rng.randint(-3, 4, (2, 3, 8, 9)).astype(f32)
    rois = np.array([[0, 2, 3, 40, 50], [1, 0, 0, 60, 60],
                     [1, -20, 5, 30, 90]], f32)

    def run():
        c = tmx.cpu()
        nms = tmx.nd.contrib.box_nms(tmx.nd.array(d, ctx=c),
                                     overlap_thresh=0.3).asnumpy()
        x = tmx.nd.array(data, ctx=c)
        x.attach_grad()
        with tmx.autograd.record():
            out = tmx.nd.ROIPooling(x, tmx.nd.array(rois, ctx=c),
                                    pooled_size=(3, 3), spatial_scale=0.125)
        out.backward(tmx.nd.ones(out.shape, ctx=c))
        return nms, out.asnumpy(), x.grad.asnumpy()

    whole = run()
    monkeypatch.setattr(tcontrib, "_NMS_CHUNK", 1)
    monkeypatch.setattr(tcontrib, "_ROI_CHUNK_BYTES", 1)
    for a, b in zip(run(), whole):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ROI ops and the deformable pair, with gradients
# ---------------------------------------------------------------------------
ROIS = np.array([[0, 2, 3, 40, 50], [1, 0, 0, 60, 60], [0, 10, 10, 11, 12],
                 [1, -20, 5, 30, 90], [1, 70, 70, 90, 95],
                 [0, 33.5, 8.5, 44.5, 20.5]], f32)


@pytest.mark.slow
def test_roi_pooling_shares_tied_maxima_and_zeroes_empty_bins():
    rng = np.random.RandomState(11)
    data = rng.randint(-2, 3, (2, 3, 8, 9)).astype(f32)   # many ties
    c = case("ROIPooling", [data, ROIS], {"pooled_size": (3, 2),
                                          "spatial_scale": 0.125},
             grad=True)
    assert held(c) == []
    out, _, grads = chip_smoke.run_case(tmx, c, tmx.cpu())
    # the ROI past the map's corner pools empty bins to 0 ...
    assert (out[0][4] == 0).all()
    # ... and some gradient is a fraction: a share of tied maxima
    g = grads[0]
    assert np.any((g != np.round(g)) & (g != 0))


@pytest.mark.parametrize("name,data_shape,attrs", [
    ("ROIPooling", (2, 4, 8, 9), {"pooled_size": (2, 3),
                                  "spatial_scale": 0.25}),
    ("_contrib_ROIPooling", (2, 2, 6, 7), {"pooled_size": (4, 4),
                                           "spatial_scale": 0.125}),
    pytest.param("_contrib_ROIAlign", (2, 4, 8, 9),
                 {"pooled_size": (3, 2), "spatial_scale": 0.125}, marks=pytest.mark.slow),
    pytest.param("_contrib_ROIAlign", (2, 3, 7, 8),
                 {"pooled_size": (2, 2), "spatial_scale": 0.125,
                  "sample_ratio": 3}, marks=pytest.mark.slow),
    ("_contrib_ROIAlign", (2, 3, 7, 8), {"pooled_size": (2, 3),
                                         "spatial_scale": 0.2,
                                         "sample_ratio": 0}),
    ("_contrib_PSROIPooling", (2, 18, 8, 9), {"spatial_scale": 0.125,
                                              "output_dim": 2,
                                              "pooled_size": 3}),
    ("_contrib_PSROIPooling", (2, 8, 8, 9), {"spatial_scale": 0.25,
                                             "output_dim": 2,
                                             "pooled_size": 4,
                                             "group_size": 2}),
], ids=lambda v: str(v) if isinstance(v, dict) else None)
def test_roi_op_and_gradient_match_the_jax_package(name, data_shape, attrs):
    rng = np.random.RandomState(12)
    data = rng.uniform(-1, 1, data_shape).astype(f32)
    band = "exact" if "ROIPooling" in name and "PS" not in name \
        else F32_BAND
    assert held(case(name, [data, ROIS], attrs, band=band, grad=True)) == []


@pytest.mark.parametrize("offset_scale,attrs", [
    pytest.param(1.5, {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5},
                 marks=pytest.mark.slow),
    (3.0, {"kernel": (3, 3), "dilate": (2, 2), "pad": (2, 2),
           "num_filter": 4, "no_bias": True}),
    pytest.param(2.0, {"kernel": (2, 2), "stride": (2, 2), "pad": (1, 1),
                       "num_filter": 4, "num_group": 2,
                       "num_deformable_group": 2}, marks=pytest.mark.slow),
], ids=str)
def test_deformable_convolution_matches_the_jax_package(offset_scale, attrs):
    rng = np.random.RandomState(13)
    B, C, H, W = 2, 4, 6, 7
    kh, kw = attrs["kernel"]
    sh, sw = attrs.get("stride", (1, 1))
    dh, dw = attrs.get("dilate", (1, 1))
    ph, pw = attrs["pad"]
    oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = attrs.get("num_deformable_group", 1)
    g = attrs.get("num_group", 1)
    ins = [rng.uniform(-1, 1, (B, C, H, W)).astype(f32),
           rng.uniform(-offset_scale, offset_scale,
                       (B, 2 * dg * kh * kw, oh, ow)).astype(f32),
           rng.uniform(-1, 1, (attrs["num_filter"], C // g, kh, kw))
           .astype(f32)]
    if not attrs.get("no_bias"):
        ins.append(rng.uniform(-1, 1, attrs["num_filter"]).astype(f32))
    assert held(case("_contrib_DeformableConvolution", ins, attrs,
                     band=F32_BAND, grad=True)) == []


def test_deformable_convolution_without_offsets_is_a_convolution():
    rng = np.random.RandomState(14)
    x = rng.uniform(-1, 1, (2, 3, 6, 7)).astype(f32)
    w = rng.uniform(-1, 1, (4, 3, 3, 3)).astype(f32)
    c = tmx.cpu()
    got = tmx.nd.contrib.DeformableConvolution(
        tmx.nd.array(x, ctx=c), tmx.nd.zeros((2, 18, 6, 7), ctx=c),
        tmx.nd.array(w, ctx=c), kernel=(3, 3), pad=(1, 1), num_filter=4,
        no_bias=True).asnumpy()
    want = torch.nn.functional.conv2d(torch.from_numpy(x),
                                      torch.from_numpy(w), padding=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("trans_shape,attrs", [
    pytest.param((6, 2, 3, 3), {"group_size": 3, "output_dim": 2,
                                "pooled_size": 3, "trans_std": 0.1}, marks=pytest.mark.slow),
    pytest.param((6, 4, 2, 2), {"group_size": 2, "output_dim": 2,
                                "pooled_size": 3, "part_size": 2,
                                "sample_per_part": 2, "trans_std": 0.3},
                 marks=pytest.mark.slow),
    (None, {"group_size": 3, "output_dim": 2, "pooled_size": 3,
            "no_trans": True}),
], ids=str)
def test_deformable_psroi_pooling_matches_the_jax_package(trans_shape,
                                                          attrs):
    rng = np.random.RandomState(15)
    gs, od = attrs["group_size"], attrs["output_dim"]
    ins = [rng.uniform(-1, 1, (2, od * gs * gs, 8, 9)).astype(f32), ROIS]
    if trans_shape:
        ins.append(rng.uniform(-1, 1, trans_shape).astype(f32))
    assert held(case("_contrib_DeformablePSROIPooling", ins,
                     dict(attrs, spatial_scale=0.125), band=F32_BAND,
                     grad=True)) == []


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,attrs", [
    pytest.param("_contrib_Proposal", {"rpn_pre_nms_top_n": 30,
                                       "rpn_post_nms_top_n": 10,
                                       "threshold": 0.5}, marks=pytest.mark.slow),
    ("Proposal", {"rpn_pre_nms_top_n": 60, "rpn_post_nms_top_n": 50,
                  "threshold": 0.3, "output_score": True}),
    ("_contrib_MultiProposal", {"rpn_pre_nms_top_n": 200,
                                "rpn_post_nms_top_n": 20, "threshold": 0.7,
                                "rpn_min_size": 24, "output_score": True}),
], ids=str)
def test_proposal_matches_the_jax_package(name, attrs):
    rng = np.random.RandomState(16)
    A, H, W = 6, 4, 5
    ins = [rng.uniform(0, 1, (2, 2 * A, H, W)).astype(f32),
           rng.uniform(-0.5, 0.5, (2, 4 * A, H, W)).astype(f32),
           np.array([[64, 80, 1.0], [60, 70, 1.5]], f32)]
    attrs = dict(attrs, scales=(2, 4, 8), ratios=(0.5, 2.0),
                 feature_stride=16)
    attrs.setdefault("rpn_min_size", 8)
    got, want = both(name, ins, **attrs)
    assert len(got) == len(want) == (2 if attrs.get("output_score") else 1)
    for g, w in zip(got, want):
        err = chip_smoke.case_error([g], [w], F32_BAND)
        assert err <= F32_BAND, err
    np.testing.assert_array_equal(got[0][:, 0], np.repeat(
        [0.0, 1.0], attrs["rpn_post_nms_top_n"]))


@pytest.mark.slow
def test_proposal_pads_past_the_kept_count_with_the_best_box():
    """Fewer boxes survive NMS than ``rpn_post_nms_top_n``: the slots past
    them repeat the best one, in both packages."""
    rng = np.random.RandomState(17)
    A, H, W = 1, 4, 4
    ins = [rng.uniform(0, 1, (1, 2 * A, H, W)).astype(f32),
           np.zeros((1, 4 * A, H, W), f32),
           np.array([[64, 64, 1.0]], f32)]
    attrs = dict(rpn_pre_nms_top_n=16, rpn_post_nms_top_n=12, threshold=0.1,
                 rpn_min_size=1, scales=(4,), ratios=(1.0,),
                 feature_stride=16, output_score=True)
    got, want = both("_contrib_Proposal", ins, **attrs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rois, scores = got
    kept = len(np.unique(rois[:, 1:], axis=0))
    assert 0 < kept < 12
    assert (rois[kept:] == rois[0]).all() and (scores[kept:] == scores[0]).all()
    assert scores[0, 0] == scores.max()


# ---------------------------------------------------------------------------
# namespaces and graphs
# ---------------------------------------------------------------------------
SHORT = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "Proposal",
         "MultiProposal", "ROIPooling", "ROIAlign", "PSROIPooling",
         "DeformableConvolution", "DeformablePSROIPooling",
         "bipartite_matching", "box_iou", "box_nms",
         "box_non_maximum_suppression")
TOP = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "Proposal",
       "ROIPooling")


def test_the_namespaces_hold_the_jax_packages_names():
    for space in ("nd", "sym"):
        for name in TOP:
            assert hasattr(getattr(jmx, space), name)
            assert hasattr(getattr(tmx, space), name), (space, name)
        for name in SHORT:
            assert hasattr(getattr(jmx, space).contrib, name)
            assert hasattr(getattr(tmx, space).contrib, name), (space, name)
    assert tmx.nd.contrib.box_non_maximum_suppression is not None


def _graph(mx):
    data = mx.sym.var("data")
    rois = mx.sym.var("rois")
    pooled = mx.sym.ROIPooling(data, rois, pooled_size=(2, 2),
                               spatial_scale=0.125, name="pool")
    align = mx.sym.contrib.ROIAlign(data, rois, pooled_size=(2, 2),
                                    spatial_scale=0.125, name="align")
    fc = mx.sym.FullyConnected(mx.sym.concat(pooled, align, dim=1),
                               num_hidden=3, name="fc")
    return mx.sym.MakeLoss(fc.sum(), name="loss")


def test_a_graph_of_them_binds_through_the_executor():
    """ROIPooling and ROIAlign under a FullyConnected loss: the JAX
    package's ``tojson()``, and ``simple_bind`` forward and backward equal
    to the imperative calls; MultiBoxPrior's ``Symbol.eval`` equal to
    ``nd``'s."""
    with jmx.name.NameManager():
        js = _graph(jmx)
    with tmx.name.NameManager():
        ts = _graph(tmx)
    assert ts.tojson() == js.tojson()
    rng = np.random.RandomState(18)
    data = rng.uniform(-1, 1, (2, 3, 8, 9)).astype(f32)
    rois = ROIS[:4]
    c = tmx.cpu()
    exe = ts.simple_bind(ctx=c, data=data.shape, rois=rois.shape,
                         grad_req={"data": "write", "rois": "null",
                                   "fc_weight": "write", "fc_bias": "write"})
    w = rng.uniform(-1, 1, exe.arg_dict["fc_weight"].shape).astype(f32)
    for k, v in (("data", data), ("rois", rois), ("fc_weight", w),
                 ("fc_bias", np.zeros(3, f32))):
        exe.arg_dict[k][:] = tmx.nd.array(v, ctx=c)
    outs = exe.forward(is_train=True)
    exe.backward()
    x = tmx.nd.array(data, ctx=c)
    x.attach_grad()
    r = tmx.nd.array(rois, ctx=c)
    with tmx.autograd.record():
        feat = tmx.nd.concat(
            tmx.nd.ROIPooling(x, r, pooled_size=(2, 2), spatial_scale=0.125),
            tmx.nd.contrib.ROIAlign(x, r, pooled_size=(2, 2),
                                    spatial_scale=0.125), dim=1)
        loss = tmx.nd.FullyConnected(feat, tmx.nd.array(w, ctx=c),
                                     tmx.nd.zeros((3,), ctx=c),
                                     num_hidden=3).sum()
    loss.backward()
    np.testing.assert_allclose(outs[0].asnumpy(), loss.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(),
                               x.grad.asnumpy(), rtol=1e-6, atol=1e-7)
    prior = tmx.sym.MultiBoxPrior(tmx.sym.var("data"), sizes=(0.3, 0.5),
                                  ratios=(1, 2))
    np.testing.assert_array_equal(
        prior.eval(ctx=c, data=x)[0].asnumpy(),
        tmx.nd.MultiBoxPrior(x, sizes=(0.3, 0.5), ratios=(1, 2)).asnumpy())


# ---------------------------------------------------------------------------
# the two flows
# ---------------------------------------------------------------------------
def _carry(jnet, tnet):
    tmx.convert.block_params_from_numpy(
        tnet, {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}, ctx=tmx.cpu())


def _ssd_run(mx, ctx, net, x_np, lab_np, steps):
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
    target = {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0}
    x = mx.nd.array(x_np, ctx=ctx)
    label = mx.nd.array(lab_np, ctx=ctx)
    losses = [float(chip_smoke.ssd_step(mx, net, trainer, x, label, target)
                    .asnumpy().sum()) for _ in range(steps)]
    dets = chip_smoke.ssd_decode(mx, net, x, nms_threshold=0.45)
    params = {k[len(net.prefix):]: v.data().asnumpy()
              for k, v in net.collect_params().items()}
    return losses, dets.asnumpy(), params


@pytest.mark.slow
def test_ssd_example_three_steps_and_decode_match_the_jax_package():
    """example/ssd/train.py's 32x32 SSDNet, the JAX package's Xavier
    weights carried across: three SGD steps (its loss) and the decode."""
    rng = np.random.RandomState(19)
    x_np, lab_np = chip_smoke.ssd_example_batch(rng, 8)
    with jmx.name.NameManager():
        jnet = chip_smoke.ssd_example_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x_np))
    with tmx.name.NameManager():
        tnet = chip_smoke.ssd_example_net(tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tnet(tmx.nd.array(x_np, ctx=tmx.cpu()))
    _carry(jnet, tnet)
    tl, td, tp = _ssd_run(tmx, tmx.cpu(), tnet, x_np, lab_np, 3)
    jl, jd, jp = _ssd_run(jmx, jmx.cpu(), jnet, x_np, lab_np, 3)
    np.testing.assert_allclose(tl, jl, rtol=GRAD_BAND)
    assert tl[-1] < tl[0]
    for k in jp:
        err = chip_smoke.case_error([tp[k]], [jp[k]], GRAD_BAND)
        assert err <= GRAD_BAND, (k, err)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    assert chip_smoke.case_error([td], [jd], GRAD_BAND) <= GRAD_BAND


def _rcnn_lite(mx):
    """example/rcnn/train_end2end.py's ``FasterRCNNLite`` (64 px, stride
    8, A 2, three classes)."""
    nn = mx.gluon.nn

    class FasterRCNNLite(mx.gluon.nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                for ch in (16, 32, 64):
                    self.backbone.add(nn.Conv2D(ch, 3, strides=2, padding=1),
                                      nn.Activation("relu"))
                self.rpn_conv = nn.Conv2D(64, 3, padding=1,
                                          activation="relu")
                self.rpn_cls = nn.Conv2D(4, 1)
                self.rpn_box = nn.Conv2D(8, 1)
                self.head_fc = nn.Dense(64, activation="relu")
                self.head_cls = nn.Dense(3)
                self.head_box = nn.Dense(4)

        def features(self, x):
            f = self.backbone(x)
            r = self.rpn_conv(f)
            return f, self.rpn_cls(r), self.rpn_box(r)

        def head(self, pooled):
            h = self.head_fc(pooled)
            return self.head_cls(h), self.head_box(h)

        def hybrid_forward(self, F, x):
            f, c, b = self.features(x)
            return c, b

    return FasterRCNNLite()


def _rcnn_detect(mx, ctx, net, img):
    """example/rcnn/train_end2end.py's ``detect``: Proposal -> ROIAlign ->
    head -> the offsets decoded in numpy -> class-aware ``box_nms``."""
    x = mx.nd.array(img[None], ctx=ctx)
    f, rpn_c, rpn_b = net.features(x)
    B, _, H, W = rpn_c.shape
    probs = mx.nd.softmax(rpn_c.reshape((B, 2, 2 * H * W)), axis=1) \
        .reshape((B, 4, H, W))
    info = mx.nd.array(np.array([[64, 64, 1.0]], f32), ctx=ctx)
    rois = mx.nd.contrib.Proposal(probs, rpn_b, info, rpn_pre_nms_top_n=64,
                                  rpn_post_nms_top_n=8, threshold=0.7,
                                  rpn_min_size=4, scales=(3.0, 5.0),
                                  ratios=(1.0,), feature_stride=8)
    pooled = mx.nd.contrib.ROIAlign(f, rois, pooled_size=(4, 4),
                                    spatial_scale=1.0 / 8, sample_ratio=2)
    cls_scores, box_deltas = net.head(pooled)
    cls_prob = mx.nd.softmax(cls_scores, axis=-1).asnumpy()
    r = rois.asnumpy()[:, 1:]
    d = box_deltas.asnumpy()
    rw, rh = r[:, 2] - r[:, 0], r[:, 3] - r[:, 1]
    cx = r[:, 0] + rw / 2 + d[:, 0] * rw
    cy = r[:, 1] + rh / 2 + d[:, 1] * rh
    w = np.exp(np.clip(d[:, 2], -4, 4)) * rw
    h = np.exp(np.clip(d[:, 3], -4, 4)) * rh
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    dets = np.concatenate([cls_prob.argmax(1)[:, None],
                           cls_prob.max(1)[:, None], boxes], 1)
    keep = mx.nd.contrib.box_nms(
        mx.nd.array(dets[None].astype(f32), ctx=ctx), overlap_thresh=0.5,
        score_index=1, id_index=0, coord_start=2).asnumpy()[0]
    return rois.asnumpy(), keep


@pytest.mark.slow
def test_rcnn_lite_detect_matches_the_jax_package():
    """example/rcnn/train_end2end.py's ``detect`` pipeline on two scenes,
    the JAX package's initial weights carried across."""
    rng = np.random.RandomState(20)
    with jmx.name.NameManager():
        jnet = _rcnn_lite(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet.features(jmx.nd.zeros((1, 3, 64, 64)))
    jnet.head(jmx.nd.zeros((1, 64, 4, 4)))
    with tmx.name.NameManager():
        tnet = _rcnn_lite(tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tnet.features(tmx.nd.zeros((1, 3, 64, 64), ctx=tmx.cpu()))
    tnet.head(tmx.nd.zeros((1, 64, 4, 4), ctx=tmx.cpu()))
    _carry(jnet, tnet)
    for _ in range(2):
        img = rng.rand(3, 64, 64).astype(f32) * 0.1
        img[rng.randint(3), 10:40, 20:50] += 0.8
        trois, tkeep = _rcnn_detect(tmx, tmx.cpu(), tnet, img)
        jrois, jkeep = _rcnn_detect(jmx, jmx.cpu(), jnet, img)
        assert chip_smoke.case_error([trois], [jrois], F32_BAND) <= F32_BAND
        np.testing.assert_array_equal(tkeep[:, 0], jkeep[:, 0])
        assert chip_smoke.case_error([tkeep], [jkeep], GRAD_BAND) <= \
            GRAD_BAND
        assert (tkeep[:, 0] >= 0).any()


# ---------------------------------------------------------------------------
# phase 26's rehearsal
# ---------------------------------------------------------------------------
VGG_TINY = ((4, 4), (4, 4), (8, 8, 8), (8, 8, 8), (8, 8, 8))
SSD_TINY = dict(chip_smoke.SSD300, image=64, batch=2, classes=4, vgg=VGG_TINY,
                fc=8, extras=((4, 8, 2, 1), (4, 8, 2, 1)),
                sizes=chip_smoke.SSD300["sizes"][:4],
                ratios=chip_smoke.SSD300["ratios"][:4],
                steps=(8 / 64, 16 / 64, 32 / 64, 1.0), warmup=1, timed=3,
                decode_reps=1, oracle_images=2, label_rows=6, boxes=(1, 3))
FRCNN_TINY = dict(chip_smoke.FRCNN, images=2, height=64, width=96,
                  classes=4, vgg=VGG_TINY, rpn=8, scales=(2, 4), pre=40,
                  post=10, min_size=4, fc=16, check_rois=4, reps=1)
DEFORM_TINY = dict(chip_smoke.DEFORM, height=6, width=7, channels=8,
                   rois=10, classes=2, group=3, pooled=3, image=(96, 112),
                   reps=1)


def test_chip_smoke_detection_phase_rehearses_on_the_cpu():
    """Phase 26 at tiny widths with ``ctx=cpu()``: every check passes (the
    loss falls, the targets and decodes equal the CPU's and the numpy
    oracle's, the gradients within band) and no kernel is launched."""
    rec = chip_smoke.detection_phase(tmx, ck, "cpu", SSD_TINY, FRCNN_TINY,
                                     DEFORM_TINY, ctx=tmx.cpu(),
                                     cpu=tmx.cpu())
    a = rec["ssd300"]
    assert a["loss_last"] < a["loss_first"]
    assert a["decode_topk"]["oracle_equal"] and a["decode_all"][
        "oracle_equal"]
    assert rec["faster_rcnn"]["rois"] == 2 * FRCNN_TINY["post"]
    assert rec["launches"] == {}


@pytest.mark.slow
def test_queue3_item21_class_specific_trans_pairs_rois_with_others_offsets():
    """ROADMAP queue 3, 21 (copied): with class-specific offsets, trans
    (R, 2 * classes, part, part), the reference takes ROI n's offsets for
    class c from ``trans[n, 2c:2c+2]``; the JAX package reshapes trans to
    (R * classes, 2, part, part) and keeps its first R rows, so ROI 1 pools
    with ROI 0's second pair.  Both packages do so."""
    rng = np.random.RandomState(21)
    data = rng.uniform(-1, 1, (2, 2 * 9, 8, 9)).astype(f32)
    rois = ROIS[:3]
    trans = rng.uniform(-1, 1, (3, 4, 3, 3)).astype(f32)
    attrs = dict(spatial_scale=0.125, output_dim=2, group_size=3,
                 pooled_size=3, trans_std=0.3)
    rows = trans.reshape(-1, 2, 3, 3)[:3]
    for mx, ctx in ((tmx, tmx.cpu()), (jmx, jmx.cpu())):
        def pool(t):
            return mx.nd.contrib.DeformablePSROIPooling(
                *[mx.nd.array(a, ctx=ctx) for a in (data, rois, t)],
                **attrs).asnumpy()
        np.testing.assert_array_equal(pool(trans), pool(rows))
        np.testing.assert_array_equal(pool(trans)[1],
                                      pool(trans[[0, 0, 0], 2:4])[1])
