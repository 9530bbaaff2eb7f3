"""Network visualization.

Counterpart of ``mxnet_tpu/visualization.py`` (reference:
python/mxnet/visualization.py): ``print_summary``, the layer table with
parameter counts, and ``plot_network``, a graphviz digraph (ImportError
where the ``graphviz`` package is absent).
"""
from __future__ import annotations

import json


__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Layer-by-layer summary with parameter counts
    (reference: visualization.py print_summary)."""
    if positions is None:
        positions = [0.44, 0.64, 0.74, 1.0]
    shape_dict = {}
    if shape is not None:
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(**shape)
        shape_dict = dict(zip(symbol.list_arguments(), arg_shapes))
        shape_dict.update(dict(zip(symbol.list_auxiliary_states(),
                                   aux_shapes)))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {h[0] for h in conf["heads"]}
    positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)
    total_params = 0
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        inputs = [nodes[item[0]]["name"] for item in node["inputs"]]
        params = 0
        for item in node["inputs"]:
            inode = nodes[item[0]]
            if inode["op"] == "null" and \
                    ("weight" in inode["name"] or "bias" in inode["name"] or
                     "gamma" in inode["name"] or "beta" in inode["name"]):
                shp = shape_dict.get(inode["name"])
                if shp:
                    n = 1
                    for d in shp:
                        n *= d
                    params += n
        total_params += params
        first = "%s(%s)" % (name, op)
        out_shape = ""
        print_row([first, out_shape, params,
                   ",".join(i for i in inputs if "weight" not in i
                            and "bias" not in i)], positions)
        print("_" * line_length)
    print("Total params: {params}".format(params=total_params))
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz digraph of a Symbol (reference: visualization.py
    plot_network).  Requires the `graphviz` package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    node_attrs = node_attrs or {}
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]

    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)

    def looks_like_weight(name):
        weight_like = (".*_weight", ".*_bias", ".*_beta", ".*_gamma",
                       ".*_moving_var", ".*_moving_mean", ".*_running_var",
                       ".*_running_mean")
        import re
        return any(re.match(w, name) for w in weight_like)

    hidden_nodes = set()
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        attr = dict(node_attr)
        if op == "null":
            if looks_like_weight(name) and hide_weights:
                hidden_nodes.add(i)
                continue
            attr["shape"] = "oval"
            label = name
            attr["fillcolor"] = "#8dd3c7"
        else:
            label = op
            attr["fillcolor"] = {
                "Convolution": "#fb8072", "FullyConnected": "#fb8072",
                "BatchNorm": "#bebada", "Activation": "#ffffb3",
                "Pooling": "#80b1d3", "Concat": "#fdb462",
                "SoftmaxOutput": "#b3de69"}.get(op, "#fccde5")
        dot.node(name=name, label=label, **attr)
    for i, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        for item in node["inputs"]:
            if item[0] in hidden_nodes:
                continue
            src = nodes[item[0]]["name"]
            dot.edge(tail_name=src, head_name=node["name"])
    return dot
