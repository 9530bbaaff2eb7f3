"""Pretrained-model parameter store (reference:
python/mxnet/gluon/model_zoo/model_store.py; counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``).  It maps a model name to
a sha1-pinned ``.params`` file and is local-first, as the JAX package's
is:

1. The cache root (default ``~/.mxnet/models``, as in the reference) is
   consulted first.
2. Then ``$MXNET_GLUON_REPO``, as a local directory or a ``file://``
   URL, holding ``<name>-<sha1[:8]>.params`` or plain ``<name>.params``
   files; a file found there is copied into the cache root.
3. Only if both miss is ``gluon.utils.download`` asked, which fetches
   nothing and raises MXNetError naming the file and where to stage it.

Checksums: the reference pins each file by sha1.  Locally staged files
named ``<name>-<sha1[:8]>.params`` are verified against the full hash;
bare ``<name>.params`` files are trusted (operator-staged).
"""
import os
import shutil

from ...base import MXNetError
from ..utils import check_sha1, download

__all__ = ["get_model_file", "purge"]

# name -> sha1 of the canonical released weights (reference
# model_store.py:27 table).  Files staged locally under a matching
# short-hash name are verified against these.
_model_sha1 = {name: checksum for checksum, name in [
    ("44335d1f0046b328243b32a26a4fbd62d9057b45", "alexnet"),
    ("f27dbf2dbd5ce9a80b102d89c7483342cd33cb31", "densenet121"),
    ("b6c8a95717e3e761bd88d145f4d0a214aaa515dc", "densenet161"),
    ("2603f878403c6aa5a71a124c4a3307143d6820e9", "densenet169"),
    ("1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb", "densenet201"),
    ("ed47ec45a937b656fcc94dabde85495bbef5ba1f", "inceptionv3"),
    ("9f83e440996887baf91a6aff1cccc1c903a64274", "mobilenet0.25"),
    ("8e9d539cc66aa5efa71c4b6af983b936ab8701c3", "mobilenet0.5"),
    ("529b2c7f4934e6cb851155b22c96c9ab0a7c4dc2", "mobilenet0.75"),
    ("6b8c5106c730e8750bcd82ceb75220a3351157cd", "mobilenet1.0"),
    ("38d6d423c22828718ec3397924b8e116a03e6ac0", "resnet18_v1"),
    ("4dc2c2390a7c7990e0ca1e53aeebb1d1a08592d1", "resnet34_v1"),
    ("c940b1a062b32e3a5762f397c9d1e178b5abd007", "resnet50_v1"),
    ("d992389084bc5475c370e9b52c3561706e755799", "resnet101_v1"),
    ("48ce7775d375987d019ec9aa96bc43b98165dfcb", "resnet152_v1"),
    ("8aacf80ff4014c1efa2362a963ac5ec82cf92d5b", "resnet18_v2"),
    ("0ed3cd06da41932c03dea1de7bc2506ef3fb97b3", "resnet34_v2"),
    ("81a4e66af7859a5aa904e2b4051aa0d3bc472b2f", "resnet50_v2"),
    ("7eb2b3cde097883c11941b927048a705ed334294", "resnet101_v2"),
    ("64c75ac8c292f6ac54f873f9ef62e0531105878b", "resnet152_v2"),
    ("264ba4970a0cc87a4f15c96e25246a1307caf523", "squeezenet1.0"),
    ("33ba0f93753c83d86e1eb397f38a667eaf2e9376", "squeezenet1.1"),
    ("dd221b160977f36a53f464cb54648d227c707a05", "vgg11"),
    ("ee79a8098a91fbe05b7a973fed2017a6117723a8", "vgg11_bn"),
    ("6bc5de58a05a5e2e7f493e2d75a580d83efde38c", "vgg13"),
    ("7d97a06c3c7a1aecc88b6e7385c2b373a249e95e", "vgg13_bn"),
    ("649467530119c0f78c4859999e264e7bf14471a9", "vgg16"),
    ("6b9dbe6194e5bfed30fd7a7c9a71f7e5a276cb14", "vgg16_bn"),
    ("f713436691eee9a20d70a145ce0d53ed24bf7399", "vgg19"),
    ("9730961c9cea43fd7eeefb00d792e386c45847d6", "vgg19_bn"),
]}

_DEFAULT_REPO = "https://apache-mxnet.s3-accelerate.dualstack.amazonaws.com/"


def short_hash(name):
    if name not in _model_sha1:
        raise ValueError(
            "No released weights are known for model '%s'." % name)
    return _model_sha1[name][:8]


def _repo():
    return os.environ.get("MXNET_GLUON_REPO", _DEFAULT_REPO)


def _local_repo_dir():
    """MXNET_GLUON_REPO as a local directory, if it is one."""
    repo = _repo()
    if repo.startswith("file://"):
        return repo[len("file://"):]
    if "://" not in repo and os.path.isdir(os.path.expanduser(repo)):
        return os.path.expanduser(repo)
    return None


def _candidates(name, dirname):
    """Paths under ``dirname`` that can satisfy ``name``, best first."""
    out = []
    if name in _model_sha1:
        out.append(os.path.join(
            dirname, "%s-%s.params" % (name, short_hash(name))))
    else:
        # weights this table doesn't pin (e.g. mobilenetv2 families
        # released after the reference tag) may still be staged under
        # the upstream <name>-<hash8>.params convention
        import glob
        out.extend(sorted(glob.glob(
            os.path.join(glob.escape(dirname), "%s-*.params" % name))))
    out.append(os.path.join(dirname, "%s.params" % name))
    return out


def _verify(path, name):
    """sha1-check ``path`` when ``name`` is pinned and the file uses the
    short-hash naming; bare ``<name>.params`` files are operator-staged
    and trusted."""
    base = os.path.basename(path)
    if name in _model_sha1 and base != name + ".params":
        if not check_sha1(path, _model_sha1[name]):
            raise MXNetError(
                "File %s fails its sha1 check; delete it and restage."
                % path)


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """Resolve the ``.params`` file for pretrained model ``name``.

    Checks the local cache, then a local ``MXNET_GLUON_REPO`` staging
    directory, then ``download`` (which fetches nothing).  Returns the
    file path.
    """
    root = os.path.expanduser(root)
    # 1. cache
    for path in _candidates(name, root):
        if os.path.exists(path):
            _verify(path, name)
            return path
    # 2. operator-staged local repo
    repo_dir = _local_repo_dir()
    if repo_dir is not None:
        for sub in ("", "gluon/models"):
            for path in _candidates(name, os.path.join(repo_dir, sub)):
                if os.path.exists(path):
                    _verify(path, name)
                    os.makedirs(root, exist_ok=True)
                    dst = os.path.join(root, os.path.basename(path))
                    shutil.copyfile(path, dst)
                    return dst
    # 3. download: nothing is fetched, so it raises unless the file is in
    #    place
    if name not in _model_sha1:
        raise ValueError(
            "No weights for model '%s' are staged or pinned in the "
            "release table; train it or stage a %s.params file under "
            "MXNET_GLUON_REPO." % (name, name))
    file_name = "%s-%s.params" % (name, short_hash(name))
    os.makedirs(root, exist_ok=True)
    url = "%sgluon/models/%s.zip" % (_repo(), file_name)
    try:
        # verify-then-install: extract into a scratch dir and sha1-check
        # there, so a corrupted or tampered archive never lands in the
        # cache the loader trusts
        import tempfile
        import zipfile
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            zip_path = download(url,
                                path=os.path.join(tmp, file_name + ".zip"),
                                overwrite=True)
            with zipfile.ZipFile(zip_path) as zf:
                zf.extractall(tmp)
            staged = os.path.join(tmp, file_name)
            if not check_sha1(staged, _model_sha1[name]):
                raise MXNetError(
                    "downloaded archive fails its sha1 pin")
            path = os.path.join(root, file_name)
            shutil.move(staged, path)
    except MXNetError:
        raise
    except Exception as exc:
        raise MXNetError(
            "Pretrained weights %s are not staged locally and could not "
            "be downloaded (%s). Place the file under %s or point "
            "MXNET_GLUON_REPO at a directory containing it."
            % (file_name, exc, root))
    return path


def load_pretrained(net, name, ctx=None, root=None):
    """Load released weights for ``name`` into ``net`` (used by every
    model-zoo constructor's ``pretrained=True`` path)."""
    if root is None:
        root = os.path.join("~", ".mxnet", "models")
    net.load_params(get_model_file(name, root=root), ctx=ctx)
    return net


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Remove all cached model files (reference: model_store.py purge)."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
