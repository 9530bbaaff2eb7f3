"""Inception-BN symbol (GoogLeNet v2 with BatchNorm).

A copy of example/image-classification/symbols/inception_bn.py owned by
this package (that file imports the JAX package).  The graph it builds —
node names, attributes, topology — is identical, so its ``tojson()``
equals the example's.
"""
from .. import symbol as sym


def conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                 name=None):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name="conv_%s" % name)
    bn = sym.BatchNorm(conv, fix_gamma=False, name="bn_%s" % name)
    return sym.Activation(bn, act_type="relu", name="relu_%s" % name)


def inception_a(data, num1, num3red, num3, numd3red, numd3, pool, proj, name):
    c1 = conv_factory(data, num1, (1, 1), name="%s_1x1" % name)
    c3 = conv_factory(data, num3red, (1, 1), name="%s_3x3r" % name)
    c3 = conv_factory(c3, num3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    cd3 = conv_factory(data, numd3red, (1, 1), name="%s_d3x3r" % name)
    cd3 = conv_factory(cd3, numd3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    cd3 = conv_factory(cd3, numd3, (3, 3), pad=(1, 1), name="%s_d3x3b" % name)
    pooling = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type=pool, name="%s_pool" % name)
    cproj = conv_factory(pooling, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1, c3, cd3, cproj, name="ch_concat_%s" % name)


def inception_b(data, num3red, num3, numd3red, numd3, name):
    c3 = conv_factory(data, num3red, (1, 1), name="%s_3x3r" % name)
    c3 = conv_factory(c3, num3, (3, 3), stride=(2, 2), pad=(1, 1),
                      name="%s_3x3" % name)
    cd3 = conv_factory(data, numd3red, (1, 1), name="%s_d3x3r" % name)
    cd3 = conv_factory(cd3, numd3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    cd3 = conv_factory(cd3, numd3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_d3x3b" % name)
    pooling = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", name="%s_pool" % name)
    return sym.Concat(c3, cd3, pooling, name="ch_concat_%s" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    net = conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = conv_factory(net, 64, (1, 1), name="2_red")
    net = conv_factory(net, 192, (3, 3), pad=(1, 1), name="2")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = inception_a(net, 64, 64, 64, 64, 96, "avg", 32, "3a")
    net = inception_a(net, 64, 64, 96, 64, 96, "avg", 64, "3b")
    net = inception_b(net, 128, 160, 64, 96, "3c")
    net = inception_a(net, 224, 64, 96, 96, 128, "avg", 128, "4a")
    net = inception_a(net, 192, 96, 128, 96, 128, "avg", 128, "4b")
    net = inception_a(net, 160, 128, 160, 128, 160, "avg", 128, "4c")
    net = inception_a(net, 96, 128, 192, 160, 192, "avg", 128, "4d")
    net = inception_b(net, 128, 192, 192, 256, "4e")
    net = inception_a(net, 352, 192, 320, 160, 224, "avg", 128, "5a")
    net = inception_a(net, 352, 192, 320, 192, 224, "max", 128, "5b")
    net = sym.Pooling(net, global_pool=True, kernel=(1, 1),
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")
