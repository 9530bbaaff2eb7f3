"""PythonModule / PythonLossModule — modules written in Python.

Counterpart of ``mxnet_tpu/module/python_module.py`` (reference:
``python/mxnet/module/python_module.py``, PythonModule:36,
PythonLossModule:253): arbitrary Python code in a ``SequentialModule``
chain, most often a hand-written loss whose gradient is computed with
NDArray operations and fed back to the module before it.  The code runs
eagerly on the host thread; a loss layer of the graph
(``SoftmaxOutput``, ``MakeLoss``) is the faster path.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Base for modules written directly in Python (reference:
    python_module.py:36).  Subclasses implement ``forward``/``backward``
    (and parameter handling if they own parameters — the base assumes
    none, so ``update`` and ``init_params`` are no-ops)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- symbol information ------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    # -- shapes ------------------------------------------------------------
    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none by default) --------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write", "PythonModule only supports write"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else None
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        """Subclasses define how output shapes follow from input shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss stage expressed in Python (reference: python_module.py:253).

    ``forward`` passes scores through unchanged; ``backward`` produces the
    input gradient — either from ``grad_func(scores, labels)`` (numpy in,
    numpy out) or, when no function is given, by differentiating
    ``-log(score[label])`` (the softmax-cross-entropy convention the
    reference documents)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         ["%s_output" % name], logger=logger)
        self._name = name
        assert len(self._data_names) == 1
        assert len(self._label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._output_names[0], self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0] \
                if data_batch.label else None

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "pyloss is a LOSS — it has no out grad"
        assert self.for_training
        from .. import nd

        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad)
            self._scores_grad = grad
            return
        # default: d/ds of -log softmax(s)[label]; depth by keyword (the
        # JAX package passes it by position, which one_hot refuses, so its
        # default backward raises)
        prob = nd.softmax(self._scores)
        one_hot = nd.one_hot(self._labels,
                             depth=int(self._scores.shape[1]))
        self._scores_grad = prob - one_hot

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
