"""Generic object registry helpers.

Counterpart of ``mxnet_tpu/registry.py`` (reference:
python/mxnet/registry.py, the machinery behind ``mx.optimizer.register``
and ``create``, ``mx.metric`` and ``mx.init``'s string lookup).  The
optimizer, metric and initializer modules each keep their own dict, as
in the JAX package; this module gives user code the same generic factory
surface, to register and create its own classes by name or config
string.
"""
import json

from .base import MXNetError

_REGISTRIES = {}

__all__ = ["get_register_func", "get_alias_func", "get_create_func",
           "register", "alias", "create", "lookup"]


def _registry(base_class, nickname):
    return _REGISTRIES.setdefault((base_class, nickname), {})


def get_register_func(base_class, nickname):
    """Returns a ``register(klass, name=None)`` decorator factory
    (reference: registry.py get_register_func)."""
    reg = _registry(base_class, nickname)

    def register(klass, name=None):
        assert isinstance(klass, type) and issubclass(klass, base_class), \
            "Can only register subclass of %s" % base_class.__name__
        key = (name or klass.__name__).lower()
        if key in reg and reg[key] is not klass:
            import warnings
            warnings.warn(
                "New %s %s.%s registered with name %s is overriding "
                "existing %s" % (nickname, klass.__module__,
                                 klass.__name__, key, nickname))
        reg[key] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    """Returns an ``alias(*names)`` decorator (reference: get_alias_func)."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    return alias


def get_create_func(base_class, nickname):
    """Returns ``create(spec, *args, **kwargs)`` accepting a name, an
    instance, or a json config string (reference: get_create_func)."""
    reg = _registry(base_class, nickname)

    def create(*args, **kwargs):
        if args:
            name, args = args[0], args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert not args and not kwargs, \
                "%s is already an instance; additional arguments are " \
                "invalid" % nickname
            return name
        if isinstance(name, str) and name.startswith("{"):
            conf = json.loads(name)
            name = conf.pop(nickname.replace(" ", "_"), None) or conf.pop(
                nickname, None)
            kwargs = dict(conf, **kwargs)
        key = str(name).lower()
        if key not in reg:
            raise MXNetError(
                "%s is not registered as a %s; known: %s"
                % (name, nickname, ", ".join(sorted(reg))))
        return reg[key](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create


def register(base_class, nickname, klass, name=None):
    return get_register_func(base_class, nickname)(klass, name)


def alias(base_class, nickname, *names):
    return get_alias_func(base_class, nickname)(*names)


def create(base_class, nickname, *args, **kwargs):
    return get_create_func(base_class, nickname)(*args, **kwargs)


def lookup(base_class, nickname, name):
    """Direct class lookup by registered name."""
    reg = _registry(base_class, nickname)
    return reg.get(str(name).lower())
