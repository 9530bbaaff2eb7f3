"""Version info (counterpart of ``mxnet_tpu/libinfo.py``; reference:
python/mxnet/libinfo.py:76).  The port reports the JAX package's version
string: the two packages implement the same MXNet 1.2 API."""
__version__ = "1.2.0.tpu0"
