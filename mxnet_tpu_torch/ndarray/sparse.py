"""Sparse NDArrays: the ``row_sparse`` and ``csr`` storage types.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
python/mxnet/ndarray/sparse.py, over the storage types
kRowSparseStorage/kCSRStorage of include/mxnet/ndarray.h:61-65, which
hold only the stored values and their index arrays).

The compact payload is the source of truth: ``_values`` with
``_indices`` (a row-sparse array's stored rows) or with ``_indices`` and
``_indptr`` (a CSR matrix's column of each value and its row pointer),
torch tensors on the array's device, the indices int64 (MXNet's aux
type; the JAX package's come back int32, it runs without 64-bit types).
An op that needs the dense value reads ``_data``, which scatters the
payload into a dense tensor once and caches it.  Assigning ``_data``
(the rebind every dense op and optimizer uses) keeps the dense value and
marks the payload stale; the next access compacts the dense value again
on its device, at the cost of one host scalar, the count of stored rows
or values (``torch.nonzero`` reads it).  The sparse-aware paths, the
CSR ``dot``, ``retain``, the lazy row updates of ``optimizer.py`` and
``KVStore.row_sparse_pull``, read the payload and never the dense
value of the CSR matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import engine
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import Context, resolve
from .ndarray import _NARROW, NDArray

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "cast_storage", "retain", "zeros", "empty", "array",
           "sparse_array", "csr_matrix", "row_sparse_array", "dot"]


def _values_tensor(x, device, dtype=None):
    """Stored values as a tensor: a tensor or an NDArray's keeps its
    device unless ``device`` is given; a host array goes to ``device`` (the
    current context when None), its 64-bit types narrowed."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
    else:
        t = torch.as_tensor(np.asarray(x))
        t = t.to(device=resolve(device), dtype=_NARROW.get(t.dtype, t.dtype))
    return t if dtype is None else t.to(dtype_torch(dtype))


def _index_tensor(x, device):
    """An index array as int64 on ``device``."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.int64))
    return x.to(device=device, dtype=torch.int64)


class BaseSparseNDArray(NDArray):
    """Compact sparse storage with a lazily materialised dense value."""

    __slots__ = ("_stype", "_indices", "_indptr", "_values", "_sshape",
                 "_dense_cache", "_stale")

    def _init_sparse(self, stype, values, indices, indptr, shape, ctx=None):
        # NDArray.__init__ would want a dense tensor: set its slots here
        if ctx is not None:
            dev = resolve(ctx)
            values = values.to(dev)
            indices = None if indices is None else indices.to(dev)
            indptr = None if indptr is None else indptr.to(dev)
        self._grad = None
        self._grad_req = "null"
        self._stype = stype
        self._values = values
        self._indices = indices
        self._indptr = indptr
        self._sshape = tuple(int(s) for s in shape)
        self._dense_cache = None
        self._stale = False

    def _set_payload(self, values, indices, indptr, shape):
        """Replace the compact payload (the dense cache goes)."""
        self._values = values
        self._indices = indices
        self._indptr = indptr
        self._sshape = tuple(int(s) for s in shape)
        self._dense_cache = None
        self._stale = False

    # -- the dense bridge ---------------------------------------------------
    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._materialize()
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        self._dense_cache = value
        self._sshape = tuple(int(s) for s in value.shape)
        self._stale = True

    def _fresh(self):
        """The payload compacted again from the dense value after a
        rebind (one host scalar: the count of what is stored)."""
        if self._stale:
            self._compact_from_dense(self._dense_cache)
            self._stale = False
        return self

    def __setitem__(self, key, value):
        # a write lands in the dense value, so the payload goes stale
        super().__setitem__(key, value)
        self._stale = True

    # -- metadata from the payload (no materialisation) ---------------------
    @property
    def shape(self):
        return self._sshape

    @property
    def dtype(self):
        return dtype_name(self._values.dtype)

    @property
    def size(self):
        n = 1
        for s in self._sshape:
            n *= s
        return n

    @property
    def ndim(self):
        return len(self._sshape)

    @property
    def context(self):
        d = self._values.device
        return Context("gpu" if d.type == "cuda" else "cpu", d.index or 0)

    ctx = context

    @property
    def stype(self):
        return self._stype

    def wait_to_read(self):
        engine.check_raise()
        if self._values.device.type == "cuda":
            torch.cuda.synchronize(self._values.device)

    wait_to_write = wait_to_read

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self.shape)), self.context)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return dot(self, other, transpose_a=transpose_a,
                   transpose_b=transpose_b)

    def tostype(self, stype):
        if stype == self._stype:
            return self
        if stype == "default":
            return NDArray(self._data)
        return cast_storage(NDArray(self._data), stype)


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse: a subset of the rows is stored (reference:
    sparse.py:778): ``values (nnz, *row_shape)`` and ``indices (nnz,)``."""

    __slots__ = ()

    def __init__(self, data, indices=None, shape=None, ctx=None):
        if indices is None:
            # a dense value: the stored rows are its nonzero rows
            if isinstance(data, (torch.Tensor, NDArray)):
                dense = data._data if isinstance(data, NDArray) else data
                self._init_sparse("row_sparse", dense, None, None,
                                  dense.shape)
                self._compact_from_dense(dense)
                if ctx is not None:
                    dev = resolve(ctx)
                    self._values = self._values.to(dev)
                    self._indices = self._indices.to(dev)
                else:
                    self._dense_cache = dense
                return
            dense_np = np.asarray(data)
            idx_np = np.flatnonzero(
                dense_np.reshape(dense_np.shape[0], -1).any(axis=1))
            dev = resolve(ctx)
            self._init_sparse("row_sparse",
                              _values_tensor(dense_np[idx_np], dev),
                              torch.as_tensor(idx_np, dtype=torch.int64,
                                              device=dev),
                              None, dense_np.shape)
            if ctx is None:
                # the dense value is in hand: keep it as the cache
                self._dense_cache = _values_tensor(dense_np, dev)
            return
        values = _values_tensor(data, None if ctx is None else resolve(ctx))
        idx = _index_tensor(indices, values.device)
        if shape is None:
            shape = (int(idx.max().item()) + 1 if idx.numel() else 0,) \
                + tuple(values.shape[1:])
        self._init_sparse("row_sparse", values, idx, None, shape, ctx=ctx)

    def _materialize(self):
        zeros = torch.zeros(self._sshape, dtype=self._values.dtype,
                            device=self._values.device)
        if self._indices.numel() == 0:
            return zeros
        return zeros.index_copy(0, self._indices, self._values)

    def _compact_from_dense(self, dense):
        """Compaction on the dense value's device: the nonzero rows'
        indices (``torch.nonzero`` reads their count, the one host
        scalar) and a gather of those rows."""
        mask = (dense.reshape(dense.shape[0], -1) != 0).any(dim=1)
        idx = torch.nonzero(mask).reshape(-1)
        self._indices = idx
        self._values = dense.index_select(0, idx)

    @property
    def indices(self):
        self._fresh()
        return NDArray(self._indices)

    @property
    def data(self):
        self._fresh()
        return NDArray(self._values)

    def retain(self, indices):
        return retain(self, indices)


class CSRNDArray(BaseSparseNDArray):
    """csr: a compressed sparse row matrix (reference: sparse.py:532):
    ``data (nnz,)``, ``indices (nnz,)`` and ``indptr (rows + 1,)``."""

    __slots__ = ()

    def __init__(self, data, indptr=None, indices=None, shape=None, ctx=None):
        if indptr is None:
            # a dense 2-D value
            if isinstance(data, (torch.Tensor, NDArray)):
                dense = data._data if isinstance(data, NDArray) else data
            else:
                dense = _values_tensor(data, resolve(ctx))
            if dense.dim() != 2:
                raise MXNetError("csr requires 2D")
            self._init_sparse("csr", dense, None, None, dense.shape)
            self._compact_from_dense(dense)
            if ctx is not None:
                dev = resolve(ctx)
                self._values = self._values.to(dev)
                self._indices = self._indices.to(dev)
                self._indptr = self._indptr.to(dev)
            else:
                self._dense_cache = dense
            return
        vals = _values_tensor(data, None if ctx is None else resolve(ctx))
        ip = _index_tensor(indptr, vals.device)
        ix = _index_tensor(indices, vals.device)
        if shape is None:
            n_cols = int(ix.max().item()) + 1 if ix.numel() else 0
            shape = (int(ip.shape[0]) - 1, n_cols)
        self._init_sparse("csr", vals, ix, ip, shape, ctx=ctx)

    def _materialize(self):
        zeros = torch.zeros(self._sshape, dtype=self._values.dtype,
                            device=self._values.device)
        if self._values.numel() == 0:
            return zeros
        rows = _csr_row_ids(self._indptr, self._values.numel())
        return zeros.index_put((rows, self._indices), self._values)

    def _compact_from_dense(self, dense):
        """Compaction on the dense value's device: ``indptr`` is a
        cumulative sum, and ``torch.nonzero`` reads the count of nonzero
        values (the one host scalar)."""
        nz = dense != 0
        self._indptr = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dense.device),
            torch.cumsum(nz.sum(dim=1), 0)])
        r, c = torch.nonzero(nz).unbind(1)
        self._indices = c
        self._values = dense[r, c]

    @property
    def indices(self):
        self._fresh()
        return NDArray(self._indices)

    @property
    def indptr(self):
        self._fresh()
        return NDArray(self._indptr)

    @property
    def data(self):
        self._fresh()
        return NDArray(self._values)


def _csr_row_ids(indptr, nnz):
    """The row of each stored value on indptr's device: value p lies in
    the row r with indptr[r] <= p < indptr[r + 1]."""
    return torch.searchsorted(
        indptr[1:], torch.arange(nnz, device=indptr.device), right=True)


def cast_storage(arr, stype):
    """``arr`` in the storage type ``stype`` (reference:
    src/operator/tensor/cast_storage-inl.h)."""
    if stype == "default":
        return NDArray(arr._data)
    if stype == "row_sparse":
        return RowSparseNDArray(arr._data)
    if stype == "csr":
        if arr.ndim != 2:
            raise MXNetError("csr requires 2D")
        return CSRNDArray(arr._data)
    raise MXNetError("unknown stype %s" % stype)


def retain(arr, indices):
    """The rows of ``arr`` named in ``indices``, row-sparse (reference:
    the sparse_retain op).  The stored pairs are filtered on the device
    (``torch.isin`` and a gather; the count of kept rows is the one host
    scalar); the dense value is not read."""
    if not isinstance(arr, BaseSparseNDArray):
        # a dense operand, which the op accepts: compact it first
        arr = RowSparseNDArray(arr._data)
    arr._fresh()
    ids = indices._data if isinstance(indices, NDArray) \
        else torch.as_tensor(np.asarray(indices))
    stored = arr._indices
    keep = torch.isin(stored, ids.to(device=stored.device,
                                     dtype=stored.dtype))
    pos = torch.nonzero(keep).reshape(-1)
    return RowSparseNDArray(arr._values.index_select(0, pos),
                            indices=stored.index_select(0, pos),
                            shape=arr.shape)


def zeros(stype, shape, ctx=None, dtype=None, **kwargs):
    """An all-zero array of ``stype`` on ``ctx`` (default the current
    context): nothing stored."""
    dt = dtype_torch(dtype)
    dev = resolve(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            indices=torch.zeros(0, dtype=torch.int64, device=dev),
            shape=shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                          indptr=torch.zeros(shape[0] + 1,
                                             dtype=torch.int64, device=dev),
                          indices=torch.zeros(0, dtype=torch.int64,
                                              device=dev),
                          shape=shape)
    return NDArray(torch.zeros(tuple(shape), dtype=dt, device=dev))


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """A sparse copy of ``source_array``: a sparse array's payload, or a
    dense value as row-sparse."""
    if isinstance(source_array, RowSparseNDArray):
        source_array._fresh()
        return RowSparseNDArray(source_array._values,
                                indices=source_array._indices,
                                shape=source_array.shape)
    if isinstance(source_array, CSRNDArray):
        source_array._fresh()
        return CSRNDArray(source_array._values,
                          indptr=source_array._indptr,
                          indices=source_array._indices,
                          shape=source_array.shape)
    a = source_array.asnumpy() if isinstance(source_array, NDArray) \
        else source_array
    return RowSparseNDArray(_values_tensor(a, resolve(ctx), dtype))


sparse_array = array


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSR matrix from ``(data, indices, indptr)`` or from a dense 2-D
    value (reference: sparse.py csr_matrix)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indptr=indptr, indices=indices, shape=shape,
                          ctx=ctx)
    a = arg1.asnumpy() if isinstance(arg1, NDArray) else arg1
    return CSRNDArray(_values_tensor(a, resolve(ctx), dtype))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A row-sparse array from ``(data, indices)`` or from a dense value
    (reference: sparse.py row_sparse_array)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices=indices, shape=shape, ctx=ctx)
    a = arg1.asnumpy() if isinstance(arg1, NDArray) else arg1
    return RowSparseNDArray(_values_tensor(a, resolve(ctx), dtype))


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware matrix product (reference: src/operator/tensor/
    dot-inl.h, DotCsrDnsDns and DotCsrTDnsDns).

    ``dot(csr, rhs)`` gathers rhs's rows at the stored columns, scales
    them by the stored values and sums them into their rows
    (``index_add_``); ``transpose_a`` sums them into the rows of their
    columns.  Only the CSR payload is read.  A row-sparse ``rhs`` takes
    this path with its dense value (the JAX package sends it to the dense
    product, which materialises the CSR matrix).  Every other pair of
    operands goes to the dense ``dot`` op."""
    if isinstance(lhs, CSRNDArray) and not transpose_b and \
            not isinstance(rhs, CSRNDArray):
        lhs._fresh()
        n_rows, n_cols = lhs.shape
        vals = lhs._values
        cols = lhs._indices
        rows = _csr_row_ids(lhs._indptr, vals.numel())
        r = rhs._data
        squeeze = r.dim() == 1
        if squeeze:
            r = r[:, None]
        if transpose_a:
            contrib = vals[:, None] * r[rows]
            out = torch.zeros((n_cols, r.shape[1]), dtype=r.dtype,
                              device=r.device).index_add_(0, cols, contrib)
        else:
            contrib = vals[:, None] * r[cols]
            out = torch.zeros((n_rows, r.shape[1]), dtype=r.dtype,
                              device=r.device).index_add_(0, rows, contrib)
        if squeeze:
            out = out[:, 0]
        return NDArray(out)
    from ..imperative import invoke
    return invoke("dot", [
        NDArray(lhs._data) if isinstance(lhs, BaseSparseNDArray) else lhs,
        NDArray(rhs._data) if isinstance(rhs, BaseSparseNDArray) else rhs],
        {"transpose_a": transpose_a, "transpose_b": transpose_b})
