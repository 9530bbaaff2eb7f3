"""Shape, indexing and linear-algebra operators (counterpart of
``mxnet_tpu/ops/matrix.py``; reference: src/operator/tensor/
matrix_op-inl.h, indexing_op.h, dot-inl.h, la_op.h).

Each op is torch on the caller's device, as the JAX package computes it:
indices arrive as float32 and are truncated to integers, out-of-range
ids clip or wrap where the JAX op does, ``where`` broadcasts its
condition numpy-style (a 1-D condition lines up with the LAST axis, as
in the JAX package, not with the rows), and the ``linalg_*`` ops run on
``torch.linalg`` with the JAX package's formulas (``trsm`` from the
right through transposes, ``gelqf`` from the QR of the transpose,
``syevd`` with the eigenvectors as rows).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_torch
from .registry import Param as P, normalize_tuple, register


def _rev(x):
    """numpy's ``x.T``: every axis reversed."""
    return x.permute(*reversed(range(x.dim())))


# -- dot / batch_dot ---------------------------------------------------------
@register("dot")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, **attrs):
    """Reference: dot-inl.h: contracts the last axis of lhs with the first
    of rhs, whatever their ranks."""
    a = _rev(lhs) if transpose_a else lhs
    b = _rev(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **attrs):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("khatri_rao")
def _khatri_rao(*mats, **attrs):
    """Column-wise Khatri-Rao product (reference: contrib/krprod.h)."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


@register("Flatten", aliases=("flatten",))
def _flatten(x, **attrs):
    return x.reshape(x.shape[0], -1)


def _infer_reshape(src_shape, target):
    """MXNet reshape spec with 0/-1/-2/-3/-4 codes
    (reference: matrix_op-inl.h ReshapeParam/InferReshapeShape)."""
    out, src_idx = [], 0
    i = 0
    target = list(target)
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src_shape[src_idx])
            src_idx += 1
        elif t == -1:
            out.append(-1)
            src_idx += 1
        elif t == -2:
            out.extend(src_shape[src_idx:])
            src_idx = len(src_shape)
        elif t == -3:
            out.append(src_shape[src_idx] * src_shape[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src_shape[src_idx]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_idx += 1
            i += 2
        else:
            out.append(t)
            src_idx += 1
        i += 1
    return tuple(out)


@register("Reshape", aliases=("reshape",), params=[
    P("shape", tuple, default=None),
    P("reverse", bool, default=False)])
def _reshape(x, shape=None, reverse=False, **attrs):
    """Reference: src/operator/tensor/matrix_op-inl.h Reshape."""
    if shape is None:
        raise MXNetError("Reshape: a target shape is required")
    shape = normalize_tuple(shape)
    if reverse:
        tgt = _infer_reshape(tuple(x.shape)[::-1], list(shape)[::-1])[::-1]
    else:
        tgt = _infer_reshape(tuple(x.shape), shape)
    return x.reshape(tgt)


@register("transpose")
def _transpose(x, axes=None, **attrs):
    if axes is None or axes == ():
        return _rev(x)
    return x.permute(*normalize_tuple(axes))


@register("expand_dims", params=[P("axis", int, required=True)])
def _expand_dims(x, axis=0, **attrs):
    return x.unsqueeze(axis)


@register("squeeze")
def _squeeze(x, axis=None, **attrs):
    if axis is None:
        return x.squeeze()
    axes = tuple(a % x.dim() for a in normalize_tuple(axis))
    for a in axes:
        if x.shape[a] != 1:
            raise MXNetError("squeeze: axis %d has size %d, not 1"
                             % (a, x.shape[a]))
    return x.squeeze(axes)


@register("SwapAxis", aliases=("swapaxes",))
def _swapaxes(x, dim1=0, dim2=0, **attrs):
    return x.transpose(dim1, dim2)


@register("depth_to_space")
def _depth_to_space(x, block_size=1, **attrs):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(x, block_size=1, **attrs):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


# -- slicing -----------------------------------------------------------------
def _slice_dim(x, dim, b, e, s):
    """``x[..., b:e:s, ...]`` along ``dim`` with numpy's rules, a negative
    step included (torch slicing takes none: the flipped array is sliced
    forward instead)."""
    n = x.shape[dim]
    start, stop, step = slice(b, e, s).indices(n)
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]
    count = len(range(start, stop, step))
    first = n - 1 - start
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(first, first + (-step) * (count - 1) + 1 if count
                     else first, -step)
    return torch.flip(x, dims=(dim,))[tuple(idx)]


@register("slice", aliases=("crop",))
def _slice(x, begin=None, end=None, step=None, **attrs):
    begin = normalize_tuple(begin) if begin is not None else ()
    end = normalize_tuple(end) if end is not None else ()
    st = normalize_tuple(step) if step is not None else ()
    for i in range(x.dim()):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = st[i] if i < len(st) and st[i] != 0 else None
        if (b, e, s) != (None, None, None):
            x = _slice_dim(x, i, b, e, s)
    return x


@register("slice_axis", params=[
    P("axis", int, required=True),
    P("begin", int, required=True)])
def _slice_axis(x, axis=0, begin=0, end=None, **attrs):
    return _slice_dim(x, axis % x.dim(), begin, end, None)


@register("slice_like")
def _slice_like(x, like, axes=(), **attrs):
    """``x`` cut to ``like``'s extent along ``axes`` (all axes when
    empty), from index 0."""
    axes = normalize_tuple(axes) if axes else tuple(range(x.dim()))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a % x.dim()] = slice(0, like.shape[a % x.dim()])
    return x[tuple(idx)]


@register("Concat", aliases=("concat",), params=[
    P("dim", int, default=1),
    P("num_args", int, default=0, low=1,
      doc="number of inputs (the unset default 0 means the call's)")])
def _concat(*args, dim=1, num_args=None, **attrs):
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0, num_args=None, **attrs):
    return torch.stack(args, dim=axis)


def _split_nout(attrs):
    return int(attrs.get("num_outputs", attrs.get("num_output", 1)))


@register("SliceChannel", aliases=("split",), num_outputs=_split_nout,
          params=[
              P("num_outputs", int, required=True, low=1),
              P("axis", int, default=1),
              P("squeeze_axis", bool, default=False)])
def _split(x, num_outputs=1, axis=1, squeeze_axis=False, **attrs):
    """Reference: src/operator/slice_channel-inl.h: equal parts."""
    n = x.shape[axis]
    if n % num_outputs:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (axis, n, num_outputs))
    parts = torch.split(x, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("tile", params=[P("reps", tuple, required=True, low=1)])
def _tile(x, reps=(), **attrs):
    return torch.tile(x, normalize_tuple(reps))


@register("repeat", params=[
    P("repeats", int, required=True, low=1),
    P("axis", int, default=None)])
def _repeat(x, repeats=1, axis=None, **attrs):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("reverse", aliases=("flip",))
def _reverse(x, axis=(), **attrs):
    return torch.flip(x, dims=normalize_tuple(axis))


def _pad_index(n, lo, hi, mode, device):
    """Source index along one axis of an ``edge`` or ``reflect`` pad
    (numpy's modes), built on ``device``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    m = 2 * (n - 1)
    j = torch.remainder(i, m)
    return torch.where(j >= n, m - j, j)


@register("Pad", aliases=("pad",), params=[
    P("mode", ("constant", "edge", "reflect"), required=True),
    P("pad_width", tuple, required=True, low=0),
    P("constant_value", float, default=0.0)])
def _pad(x, mode="constant", pad_width=(), constant_value=0.0, **attrs):
    """Reference: src/operator/pad-inl.h (``pad_width`` in flattened
    (before, after) pairs, one per axis), any rank, as ``jnp.pad``."""
    pw = normalize_tuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        return F.pad(x, flat, value=constant_value)
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, mode, x.device))
    return x


@register("Embedding", params=[
    P("input_dim", int, required=True, low=1),
    P("output_dim", int, required=True, low=1),
    P("sparse_grad", bool, default=False)])
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False, **attrs):
    """Reference: src/operator/tensor/indexing_op.h EmbeddingOp.  Ids
    arrive as float32, as in the reference, and are cast to integers;
    an out-of-range id raises."""
    return F.embedding(data.to(torch.int64), weight)


def _take_index(indices, n, mode):
    idx = indices.to(torch.int32)
    if mode == "wrap":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


@register("take", params=[
    P("axis", int, default=0),
    P("mode", ("clip", "wrap", "raise"), default="clip")])
def _take(a, indices, axis=0, mode="clip", **attrs):
    """``a`` gathered along ``axis`` at ``indices`` of any shape; ``raise``
    clips, as in the JAX package."""
    idx = _take_index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take")
def _batch_take(a, indices, **attrs):
    """``a[i, indices[i]]``; a negative index counts from the end and an
    index out of range gives NaN, as ``jnp.take_along_axis`` does."""
    n = a.shape[1]
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    got = torch.gather(a, 1, idx.clamp(0, n - 1).unsqueeze(1)).squeeze(1)
    return torch.where(ok, got, torch.full((), float("nan"), dtype=a.dtype,
                                           device=a.device))


@register("pick", params=[
    P("axis", int, default=-1),
    P("keepdims", bool, default=False),
    P("mode", ("clip", "wrap"), default="clip")])
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **attrs):
    """Reference: broadcast_reduce_op_index.cc pick, as the JAX package
    computes it: one element of ``data`` along ``axis`` per position of
    ``index`` (ids may arrive as float32); out-of-range ids clip or wrap,
    and ``axis=None`` picks from the flattened input."""
    idx = index.to(torch.int64)
    if axis is None:
        flat = data.reshape(-1)
        n = flat.shape[0]
        idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
        out = flat[idx]
        return out.unsqueeze(-1) if keepdims else out
    dim = data.shape[axis]
    idx = idx % dim if mode == "wrap" else idx.clamp(0, dim - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("one_hot", params=[
    P("depth", int, required=True, low=1),
    P("on_value", float, default=1.0),
    P("off_value", float, default=0.0)])
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32", **attrs):
    i = indices.to(torch.int32)
    oh = i.unsqueeze(-1) == torch.arange(depth, dtype=torch.int32,
                                         device=i.device)
    return torch.where(oh, on_value, off_value).to(dtype_torch(dtype))


def _nd_index(indices):
    idx = indices.to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd")
def _gather_nd(data, indices, **attrs):
    """Reference: indexing_op.h GatherND: indices of shape (M, ...) index
    the first M axes."""
    return data[_nd_index(indices)]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None, **attrs):
    out = torch.zeros(normalize_tuple(shape), dtype=data.dtype,
                      device=data.device)
    return out.index_put(_nd_index(indices), data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, indices, rhs, shape=None, **attrs):
    return lhs.index_put(_nd_index(indices), rhs)


@register("where")
def _where(condition, x, y, **attrs):
    return torch.where(condition != 0, x, y)


# -- sequence ops (reference: src/operator/sequence_{mask,last,reverse}) -----
def _seq_len_mask(sequence_length, maxlen):
    t = torch.arange(maxlen, device=sequence_length.device)
    return t[:, None] < sequence_length[None, :].to(torch.int32)


@register("SequenceMask")
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0, **attrs):
    if not use_sequence_length or sequence_length is None:
        return data
    data_t = data.transpose(0, 1) if axis == 1 else data
    mask = _seq_len_mask(sequence_length, data_t.shape[0])
    mask = mask.reshape(mask.shape + (1,) * (data_t.dim() - 2))
    out = torch.where(mask, data_t, torch.full((), value, dtype=data.dtype,
                                               device=data.device))
    return out.transpose(0, 1) if axis == 1 else out


@register("SequenceLast")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0, **attrs):
    if axis == 1:
        data = data.transpose(0, 1)
    if not use_sequence_length or sequence_length is None:
        return data[-1]
    idx = sequence_length.to(torch.int64) - 1
    idx = idx.reshape((1, -1) + (1,) * (data.dim() - 2)).expand(
        (1,) + tuple(data.shape[1:]))
    return torch.gather(data, 0, idx)[0]


@register("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0, **attrs):
    """The first ``sequence_length[b]`` steps of each sequence reversed
    along axis 0 (the JAX package reverses axis 0 whatever ``axis``)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    maxlen = data.shape[0]
    t = torch.arange(maxlen, device=data.device)[:, None]
    ln = sequence_length.to(torch.int64)[None, :]
    src = torch.where(t < ln, ln - 1 - t, t)
    src = src.reshape((maxlen, -1) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(data.shape))


@register("L2Normalization", params=[
    P("eps", float, default=1e-10, low=0.0),
    P("mode", ("instance", "channel", "spatial"), default="instance")])
def _l2_normalization(x, eps=1e-10, mode="instance", **attrs):
    """Reference: src/operator/l2_normalization-inl.h."""
    if mode == "instance":
        ax = tuple(range(1, x.dim()))
    elif mode == "channel":
        ax = (1,)
    else:
        ax = tuple(range(2, x.dim()))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True) + eps)
    return x / norm


# -- linalg (reference: src/operator/tensor/la_op.h) ------------------------
def _mt(x):
    return x.transpose(-1, -2)


def _solve_tri(a, b, lower):
    """``jax.scipy.linalg.solve_triangular(a, b, lower=lower)``."""
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                  **attrs):
    a = _mt(A) if transpose_a else A
    b = _mt(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False,
                 alpha=1.0, beta=1.0, **attrs):
    a = _mt(A) if transpose_a else A
    b = _mt(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_potrf", aliases=("linalg_potrf",))
def _linalg_potrf(A, lower=True, **attrs):
    """A matrix that is not positive definite gives NaN in its lower
    triangle, as ``jnp.linalg.cholesky`` does (and no wait on the card
    for the solver's flag)."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.tril(torch.where((info == 0)[..., None, None], L,
                               float("nan")))
    return L if lower else _mt(L)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0, **attrs):
    a = _mt(A) if transpose else A
    lower_eff = (not lower) if transpose else lower
    if rightside:
        # X A = alpha B  <=>  A^T X^T = alpha B^T
        return _mt(_solve_tri(_mt(a), _mt(alpha * B), not lower_eff))
    return _solve_tri(a, alpha * B, lower_eff)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0, **attrs):
    tri = torch.tril(A) if lower else torch.triu(A)
    a = _mt(tri) if transpose else tri
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("_linalg_syrk", aliases=("linalg_syrk",))
def _linalg_syrk(A, transpose=False, alpha=1.0, **attrs):
    a = _mt(A) if transpose else A
    return alpha * torch.matmul(a, _mt(a))


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _linalg_sumlogdiag(A, **attrs):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("_linalg_potri", aliases=("linalg_potri",))
def _linalg_potri(A, lower=True, **attrs):
    """The inverse from a Cholesky factor: (A A^T)^-1 for a lower A,
    (A^T A)^-1 for an upper one (reference: la_op.cc linalg_potri)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    inv = _solve_tri(A, eye, bool(lower))
    return _mt(inv) @ inv if lower else inv @ _mt(inv)


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def _linalg_gelqf(A, **attrs):
    """A = L Q with orthonormal rows in Q, from the QR of A^T (reference:
    la_op.cc linalg_gelqf)."""
    q, r = torch.linalg.qr(_mt(A))
    return _mt(r), _mt(q)


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def _linalg_syevd(A, **attrs):
    """A = U^T diag(L) U with the eigenvectors as the ROWS of U
    (reference: la_op.cc linalg_syevd)."""
    w, v = torch.linalg.eigh(A)
    return _mt(v), w
