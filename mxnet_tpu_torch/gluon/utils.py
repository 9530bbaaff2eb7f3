"""Gluon utilities (reference: python/mxnet/gluon/utils.py; counterpart of
``mxnet_tpu/gluon/utils.py``): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``.

``download`` fetches nothing: it returns a file that is already in place
(with the right sha1, when one is given) and otherwise raises
MXNetError naming where to put it, as the JAX package's does.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

from .. import ndarray
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``, the last
    taking what is left (reference: utils.py:31); with ``even_split`` a
    size that ``num_slice`` does not divide raises ValueError."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    ends = [(i + 1) * step if i < num_slice - 1 else size
            for i in range(num_slice)]
    if batch_axis == 0:
        return [data[i * step:end] for i, end in enumerate(ends)]
    return [data.slice_axis(batch_axis, i * step, end)
            for i, end in enumerate(ends)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` into one slice per context and
    each slice copied there (reference: utils.py:67)."""
    if not isinstance(data, NDArray):
        data = ndarray.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that the 2-norm of them all together
    is at most ``max_norm``; returns that norm before scaling, as a float
    (reference: utils.py:87)."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    ctx = arrays[0].context

    def _norm(array):
        x = array.reshape((-1,))
        return ndarray.dot(x, x)

    total_norm = ndarray.add_n(*[_norm(arr).as_in_context(ctx)
                                 for arr in arrays])
    total_norm = float(total_norm.sqrt().asscalar())
    if check_isfinite and not math.isfinite(total_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping results "
                                  "will be undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the sha1 of ``filename`` is ``sha1_hash`` (reference:
    utils.py:117)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file for ``url`` (reference: utils.py:137): ``path``, a
    file in the directory ``path``, or the url's last part in the working
    directory.  It is returned when it exists (unless ``overwrite``) and
    matches ``sha1_hash`` when one is given; nothing is fetched, so
    otherwise MXNetError names where to put the file."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(
        "download(%s): this package fetches nothing over the network; "
        "place the file at %s" % (url, fname))
