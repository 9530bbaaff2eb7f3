"""RecordIO — the binary record container of image datasets.

Counterpart of ``mxnet_tpu/recordio.py`` (reference:
``python/mxnet/recordio.py``: MXRecordIO, MXIndexedRecordIO, IRHeader,
pack/unpack/pack_img/unpack_img over the dmlc-core reader).  The files
are the JAX package's, byte for byte:

record := kMagic(uint32 = 0xced7230a)
          lrecord(uint32: upper 3 bits cflag, lower 29 bits length)
          data[length]  padded to 4-byte boundary

cflag: 0 = whole record, 1 = start of multi-chunk, 2 = middle, 3 = last.
IRHeader := {flag: uint32, label: float32, id: uint64, id2: uint64}; if
flag > 0 the payload starts with `flag` extra float32 labels.  The
``.idx`` sidecar holds one ``key<TAB>offset`` line per record.  Images
are encoded and decoded with PIL.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a

IRHeader = namedtuple("HeaderType", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: recordio.py:28)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.fid = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()

    def close(self):
        if self.fid is not None and not self.fid.closed:
            self.fid.close()
        self.pid = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_closed = self.fid is None or self.fid.closed
        d = dict(self.__dict__)
        d["fid"] = None
        d["is_closed"] = is_closed
        return d

    def __setstate__(self, d):
        is_closed = d.pop("is_closed")
        self.__dict__ = d
        if not is_closed:
            self.open()

    def _check_pid(self, allow_reset=False):
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise MXNetError("Forbidden operation in multiple processes")

    def write(self, buf):
        """Write one record (reference: recordio.py write)."""
        assert self.writable
        self._check_pid(allow_reset=False)
        self.fid.write(struct.pack("<II", _kMagic, len(buf) & ((1 << 29) - 1)))
        self.fid.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fid.write(b"\x00" * pad)

    def read(self):
        """Read one record, None at EOF (reference: recordio.py read)."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        header = self.fid.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _kMagic:
            raise MXNetError("invalid RecordIO magic %x" % magic)
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        data = self.fid.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fid.read(pad)
        if cflag != 0:
            # multi-chunk record: keep reading continuation chunks
            chunks = [data]
            while cflag not in (0, 3):
                header = self.fid.read(8)
                magic, lrec = struct.unpack("<II", header)
                cflag = lrec >> 29
                length = lrec & ((1 << 29) - 1)
                chunks.append(self.fid.read(length))
                pad = (4 - length % 4) % 4
                if pad:
                    self.fid.read(pad)
            data = b"".join(chunks)
        return data

    def tell(self):
        return self.fid.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with .idx sidecar (reference: recordio.py:155)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.fid is None:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.fid.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


def pack(header, s):
    """Pack IRHeader + payload into bytes (reference: recordio.py:207)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(flag=0, label=float(header.label))
        return struct.pack(_IR_FORMAT, *header) + s
    label = np.asarray(header.label, dtype=np.float32)
    header = header._replace(flag=label.size, label=0.0)
    return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s


def unpack(s):
    """Unpack bytes into (IRHeader, payload) (reference: recordio.py:234)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image and pack (reference: recordio.py:257)."""
    try:
        from PIL import Image
        import io as _pyio
        buf = _pyio.BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        Image.fromarray(np.asarray(img).astype(np.uint8)).save(
            buf, format=fmt, quality=quality)
        return pack(header, buf.getvalue())
    except ImportError:  # pragma: no cover
        raise MXNetError("pack_img requires PIL in this build")


def unpack_img(s, iscolor=-1):
    """Unpack and decode an image record (reference: recordio.py:289)."""
    header, s = unpack(s)
    try:
        from PIL import Image
        import io as _pyio
        img = np.asarray(Image.open(_pyio.BytesIO(s)).convert("RGB"))
    except ImportError:  # pragma: no cover
        raise MXNetError("unpack_img requires PIL in this build")
    return header, img
