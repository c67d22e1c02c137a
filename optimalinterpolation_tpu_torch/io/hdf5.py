"""The corner of HDF5 that the quicklook NetCDF uses, written and read with
numpy and ``struct`` alone (no h5py).

The quicklook file (``io/quicklook.py``) is a root group of float64 2-D
datasets, each with a few string attributes, plus string attributes on the
root. This module writes that file in the layout h5py writes by default,
message for message, and reads it back, h5py's own files of that schema
included:

- superblock version 0, 8-byte offsets and lengths;
- the root group as a symbol table: a version-1 B-tree of group nodes, a
  local heap of link names and symbol-table nodes (``SNOD``), entries
  sorted by name (HDF5 binary-searches them in byte order);
- version-1 object headers (messages 8-byte aligned, continuation blocks
  followed on reading);
- each dataset: a simple dataspace (maximum dimensions = dimensions), an
  IEEE float64 datatype, a fill-value message and a contiguous layout;
- each attribute: a version-1 attribute message of a fixed-length ASCII
  string (size = byte length, null-padded) on a scalar dataspace, as h5py
  stores ``np.bytes_``.

Nothing in the file needs a checksum. ``read_hdf5`` raises ``ValueError``
naming what it met on anything outside this subset (another superblock
version, a version-2 object header, a new-style or dense group, a chunked
or filtered layout, another datatype class): for such files, such as those
of the netCDF4 library, ``io.quicklook.read_quicklook`` falls back to h5py.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_hdf5", "read_hdf5"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFF_FFFF_FFFF_FFFF
_SUPERBLOCK_SIZE = 96
_LEAF_K, _NODE_K = 4, 16  # the superblock's default group leaf and internal node K
_SNOD_ENTRIES = 2 * _LEAF_K
_BTREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8  # header, children, keys
_SNOD_SIZE = 8 + _SNOD_ENTRIES * 40
_HEAP_FREE_NULL = 1  # a local heap's "no next free block"

# object header message types
_NIL, _DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x03, 0x04, 0x05
_LAYOUT, _ATTRIBUTE, _MTIME_OLD, _CONTINUATION, _STAB, _MTIME = 0x08, 0x0C, 0x0E, 0x10, 0x11, 0x12
_SUBSET = {_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _LAYOUT, _ATTRIBUTE, _MTIME_OLD, _STAB,
           _MTIME}
_OUTSIDE = {  # messages met outside the subset, by what they mean
    0x02: "a link info message (a new-style group)",
    0x06: "a link message (a compact new-style group)",
    0x07: "an external data files message",
    0x0A: "a group info message (a new-style group)",
    0x0B: "a filter pipeline message (compressed or filtered data)",
    0x15: "an attribute info message (dense attribute storage)",
}
_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield", "opaque",
            "compound", "reference", "enumerated", "variable-length", "array")
_LAYOUTS = ("compact", "contiguous", "chunked", "virtual")

# the bytes h5py writes for a float64 dataset: IEEE little-endian, 8 bytes
# (class 1 version 1; sign bit 63; exponent 52/11, mantissa 0/52, bias 1023)
_FLOAT64 = bytes([0x11, 0x20, 0x3F, 0x00]) + struct.pack("<IHHBBBBI", 8, 0, 64, 52, 11, 0, 52,
                                                         1023)
# fill value message version 2: allocation late, write if set, default fill
_FILL_VALUE = bytes([2, 2, 2, 1]) + struct.pack("<I", 0)


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _ascii_name(name: str) -> bytes:
    b = name.encode("ascii")
    if not b or b"\0" in b or b"/" in b:
        raise ValueError(f"invalid HDF5 name {name!r}")
    return b


def _attribute(name: str, value: bytes) -> bytes:
    """A scalar fixed-length ASCII string attribute, as h5py writes
    ``np.bytes_(value)``."""
    value = bytes(value)
    if not value:
        raise ValueError(f"attribute {name!r}: an HDF5 string needs at least one byte")
    nm = _ascii_name(name) + b"\0"
    dtype = struct.pack("<BBBxI", 0x13, 0x01, 0x00, len(value))  # string, NULLPAD, ASCII
    space = struct.pack("<BBBx4x", 1, 0, 0)  # version 1, rank 0
    return _message(_ATTRIBUTE, struct.pack("<BxHHH", 1, len(nm), len(dtype), len(space))
                    + _pad8(nm) + _pad8(dtype) + _pad8(space) + value)


def _attributes(attrs) -> list:
    return [_attribute(k, v) for k, v in (attrs or {}).items()]


def _dataset_header(arr: np.ndarray, attrs, data_addr: int) -> bytes:
    dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
    space = struct.pack("<BBBx4x", 1, arr.ndim, 1) + dims + dims  # maximum dimensions given
    return _object_header([
        _message(_DATASPACE, space),
        _message(_DATATYPE, _FLOAT64, flags=1),
        _message(_FILL, _FILL_VALUE, flags=1),
        _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)),
        *_attributes(attrs),
    ])


def _root_header(btree: int, heap: int, attrs) -> bytes:
    return _object_header([_message(_STAB, struct.pack("<QQ", btree, heap)),
                           *_attributes(attrs)])


def write_hdf5(path: str, datasets: dict, dataset_attrs: dict | None = None,
               root_attrs: dict | None = None) -> None:
    """Write ``datasets`` ({name: array}, stored as ``<f8`` in C order, bit
    for bit) into a new HDF5 file at ``path``, with ``dataset_attrs``
    ({dataset: {name: bytes}}) and ``root_attrs`` ({name: bytes}) as scalar
    fixed-length ASCII string attributes. Headers and data follow the order
    of ``datasets``; the symbol table holds the names in byte order."""
    dataset_attrs = dataset_attrs or {}
    arrays = {n: np.ascontiguousarray(a, dtype="<f8") for n, a in datasets.items()}
    names = sorted(arrays, key=_ascii_name)
    if len(names) > _SNOD_ENTRIES * 2 * _NODE_K:
        raise ValueError(f"{len(names)} datasets: one B-tree node holds "
                         f"{_SNOD_ENTRIES * 2 * _NODE_K}")
    heap = bytearray(8)  # offset 0: the empty name
    name_off = {}
    for n in names:
        name_off[n] = len(heap)
        heap += _pad8(_ascii_name(n) + b"\0")
    free = len(heap)
    heap += struct.pack("<QQ", _HEAP_FREE_NULL, 16)  # one free block, as HDF5 leaves it
    snods = [names[i:i + _SNOD_ENTRIES] for i in range(0, len(names), _SNOD_ENTRIES)]

    a_root = _SUPERBLOCK_SIZE
    a_btree = a_root + len(_root_header(0, 0, root_attrs))
    a_heap = a_btree + _BTREE_SIZE
    a_snod = a_heap + 32 + len(heap)
    a_next = a_snod + len(snods) * _SNOD_SIZE
    a_header = {}
    for n, a in arrays.items():
        a_header[n] = a_next
        a_next += len(_dataset_header(a, dataset_attrs.get(n), 0))
    a_data = {}
    for n, a in arrays.items():
        a_data[n] = a_next
        a_next += a.nbytes

    meta = bytearray(_SIGNATURE)
    meta += struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0)
    meta += struct.pack("<QQQQ", 0, _UNDEFINED, a_next, _UNDEFINED)  # base, no free space, EOF
    meta += struct.pack("<QQI4xQQ", 0, a_root, 1, a_btree, a_heap)  # root entry, cached stab
    meta += _root_header(a_btree, a_heap, root_attrs)
    btree = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, 0, len(snods), _UNDEFINED, _UNDEFINED))
    btree += struct.pack("<Q", 0)
    for i, group in enumerate(snods):
        btree += struct.pack("<QQ", a_snod + i * _SNOD_SIZE, name_off[group[-1]])
    meta += btree + bytes(_BTREE_SIZE - len(btree))
    meta += struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), free, a_heap + 32) + heap
    for group in snods:
        snod = bytearray(struct.pack("<4sBxH", b"SNOD", 1, len(group)))
        for n in group:
            snod += struct.pack("<QQI4x16x", name_off[n], a_header[n], 0)
        meta += snod + bytes(_SNOD_SIZE - len(snod))
    for n, a in arrays.items():
        meta += _dataset_header(a, dataset_attrs.get(n), a_data[n])
    with open(path, "wb") as f:
        f.write(meta)
        for a in arrays.values():
            f.write(memoryview(a).cast("B"))


def _unpack(fmt: str, buf: bytes, off: int) -> tuple:
    return struct.unpack_from(fmt, buf, off)


def _messages(buf: bytes, addr: int) -> list:
    """[(type, body)] of the version-1 object header at ``addr``, its
    continuation blocks followed and NIL messages dropped."""
    if buf[addr:addr + 4] == b"OHDR":
        raise ValueError(f"a version-2 object header (OHDR) at byte {addr}")
    version, _, _, size = _unpack("<BxHII", buf, addr)
    if version != 1:
        raise ValueError(f"object header version {version} at byte {addr}")
    blocks, out = [(addr + 16, size)], []
    while blocks:
        start, length = blocks.pop(0)
        off = start
        while off + 8 <= start + length:
            mtype, msize, flags = _unpack("<HHB", buf, off)
            body = buf[off + 8:off + 8 + msize]
            off += 8 + msize
            if mtype == _NIL:
                continue
            if mtype == _CONTINUATION:
                blocks.append(_unpack("<QQ", body, 0))
                continue
            if mtype not in _SUBSET:
                raise ValueError(_OUTSIDE.get(mtype, f"object header message type 0x{mtype:04x}")
                                 + f" in the object header at byte {addr}")
            if flags & 0x02:
                raise ValueError(f"a shared message of type 0x{mtype:04x} at byte {addr}")
            out.append((mtype, body))
    return out


def _dims(body: bytes, where: str) -> tuple:
    version, rank = body[0], body[1]
    if version != 1:
        raise ValueError(f"{where}: dataspace message version {version}")
    return _unpack(f"<{rank}Q", body, 8)


def _class(body: bytes, where: str, want: int, size: int | None = None) -> int:
    cls, n = body[0] & 0x0F, _unpack("<I", body, 4)[0]
    if cls != want or (size is not None and n != size):
        name = _CLASSES[cls] if cls < len(_CLASSES) else str(cls)
        raise ValueError(f"{where}: datatype class {cls} ({name}) of {n} bytes, not "
                         + ("a fixed-length string" if want == 3 else "an 8-byte float"))
    return n


def _attribute_value(body: bytes, where: str) -> tuple:
    version, nlen, tlen, slen = _unpack("<BxHHH", body, 0)
    if version != 1:
        raise ValueError(f"{where}: attribute message version {version}")
    off = 8
    name = body[off:off + nlen].rstrip(b"\0").decode()
    off += nlen + -nlen % 8
    dtype = body[off:off + tlen]
    off += tlen + -tlen % 8
    where = f"{where}, attribute {name!r}"
    size = _class(dtype, where, 3)
    if _dims(body[off:off + slen], where) != ():
        raise ValueError(f"{where}: not a scalar")
    off += slen + -slen % 8
    return name, bytes(body[off:off + size]).rstrip(b"\0")


def _attrs(msgs: list, where: str) -> dict:
    return dict(_attribute_value(b, where) for t, b in msgs if t == _ATTRIBUTE)


def _dataset(buf: bytes, msgs: list, where: str) -> np.ndarray:
    by_type = {t: b for t, b in msgs}
    if _STAB in by_type:
        raise ValueError(f"{where}: a group, not a dataset")
    if not {_DATASPACE, _DATATYPE, _LAYOUT} <= set(by_type):
        raise ValueError(f"{where}: no dataspace, datatype or layout message")
    dims = _dims(by_type[_DATASPACE], where)
    dtype = by_type[_DATATYPE]
    _class(dtype, where, 1, 8)
    layout = by_type[_LAYOUT]
    if layout[0] != 3:
        raise ValueError(f"{where}: data layout message version {layout[0]}")
    if layout[1] != 1:
        kind = _LAYOUTS[layout[1]] if layout[1] < len(_LAYOUTS) else str(layout[1])
        raise ValueError(f"{where}: a {kind} layout, not contiguous")
    addr, size = _unpack("<QQ", layout, 2)
    count = int(np.prod(dims, dtype=np.int64))
    if addr == _UNDEFINED or size != 8 * count or addr + size > len(buf):
        raise ValueError(f"{where}: {size} bytes of data at {addr} for shape {dims}")
    order = ">f8" if dtype[1] & 0x01 else "<f8"
    return np.frombuffer(buf, order, count, addr).reshape(dims).astype(np.float64)


def read_hdf5(path: str) -> tuple:
    """Read a file of the subset: ``(datasets, dataset_attrs, root_attrs)``,
    the datasets as owned, writable, native float64 arrays by name (in byte
    order of the names), the attributes as ``bytes`` with trailing NULs
    stripped ({dataset: {name: value}} and {name: value}). Raises
    ``ValueError`` naming what it met outside the subset."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        return _read(buf)
    except (struct.error, IndexError) as e:
        raise ValueError(f"{path}: truncated or malformed HDF5 ({e})") from e


def _read(buf: bytes) -> tuple:
    if buf[:8] != _SIGNATURE:
        raise ValueError("no HDF5 signature at byte 0")
    if buf[8] != 0:
        raise ValueError(f"superblock version {buf[8]}")
    if (buf[13], buf[14]) != (8, 8):
        raise ValueError(f"{buf[13]}-byte offsets and {buf[14]}-byte lengths")
    if _unpack("<Q", buf, 24)[0] != 0:
        raise ValueError("a base address other than 0")
    root = _unpack("<Q", buf, 64)[0]
    msgs = _messages(buf, root)
    stab = [b for t, b in msgs if t == _STAB]
    if not stab:
        raise ValueError("a root group without a symbol table")
    btree, heap_addr = _unpack("<QQ", stab[0], 0)
    if buf[heap_addr:heap_addr + 4] != b"HEAP":
        raise ValueError(f"no local heap at byte {heap_addr}")
    heap_size, _, heap_data = _unpack("<QQQ", buf, heap_addr + 8)
    heap = buf[heap_data:heap_data + heap_size]

    entries, nodes = [], [btree]
    while nodes:
        node = nodes.pop(0)
        if buf[node:node + 4] != b"TREE":
            raise ValueError(f"no B-tree node at byte {node}")
        ntype, level, used = _unpack("<BBH", buf, node + 4)
        if ntype != 0:
            raise ValueError(f"B-tree node type {ntype} at byte {node}, not a group node")
        children = [_unpack("<Q", buf, node + 32 + 16 * i)[0] for i in range(used)]
        if level:
            nodes.extend(children)
            continue
        for snod in children:
            if buf[snod:snod + 4] != b"SNOD":
                raise ValueError(f"no symbol-table node at byte {snod}")
            for i in range(_unpack("<H", buf, snod + 6)[0]):
                name_off, header = _unpack("<QQ", buf, snod + 8 + 40 * i)
                entries.append((heap[name_off:heap.index(b"\0", name_off)].decode(), header))

    datasets, dataset_attrs = {}, {}
    for name, header in sorted(entries, key=lambda e: e[0].encode()):
        where = repr(name)
        d_msgs = _messages(buf, header)
        datasets[name] = _dataset(buf, d_msgs, where)
        dataset_attrs[name] = _attrs(d_msgs, where)
    return datasets, dataset_attrs, _attrs(msgs, "the root group")
