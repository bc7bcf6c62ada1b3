"""Length-prefixed framed wire format for the multi-process runtime.

One frame =

    offset  size  field
    0       2     magic  b"CW"
    2       1     version (1)
    3       1     kind    (net.py's frame-kind enum)
    4       2     src     sender rank (0xFFFF = coordinator)
    6       2     tag     sub-channel within a kind (TRUNC/HIST/...)
    8       4     step    GD iteration the payload belongs to
    12      4     length  payload byte count
    16      len   payload

Big-endian throughout; `FrameReader` reassembles frames from arbitrary
stream chunkings and raises `WireError` on a bad magic, an unknown
version, an oversized length, or a stream that ends mid-frame
(tests/test_torch_runtime_transport.py holds every byte to the JAX
package's wire).

Array payloads travel as a tiny self-describing header (dtype + shape)
followed by the raw C-order bytes -- `pack_array`/`unpack_array`.  No
pickle on the hot path: array frames are fixed-format and cannot execute
anything on receipt.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy

MAGIC = b"CW"
VERSION = 1
HEADER = struct.Struct("!2sBBHHII")
HEADER_SIZE = HEADER.size          # 16 bytes
MAX_PAYLOAD = 1 << 28              # 256 MiB: far above any COPML frame
_MAX_NDIM = 8


class WireError(ValueError):
    """Malformed frame: bad magic/version, oversized, or truncated."""


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: int
    src: int
    tag: int
    step: int
    payload: bytes

    def __len__(self) -> int:
        return HEADER_SIZE + len(self.payload)


def encode_frame(kind: int, src: int, tag: int, step: int,
                 payload: bytes = b"") -> bytes:
    if len(payload) > MAX_PAYLOAD:
        raise WireError(f"payload of {len(payload)} bytes exceeds "
                        f"MAX_PAYLOAD ({MAX_PAYLOAD})")
    return HEADER.pack(MAGIC, VERSION, kind, src, tag, step,
                       len(payload)) + payload


class FrameReader:
    """Incremental frame parser over an arbitrarily-chunked byte stream."""

    def __init__(self, max_payload: int = MAX_PAYLOAD):
        self._buf = bytearray()
        self._max = max_payload

    @property
    def pending(self) -> int:
        """Bytes buffered but not yet parsed into a full frame."""
        return len(self._buf)

    def feed(self, data: bytes) -> list:
        """Consume a chunk; return every frame it completes (in order)."""
        self._buf += data
        frames = []
        while len(self._buf) >= HEADER_SIZE:
            magic, ver, kind, src, tag, step, length = HEADER.unpack_from(
                self._buf)
            if magic != MAGIC:
                raise WireError(f"bad magic {bytes(magic)!r} "
                                f"(expected {MAGIC!r})")
            if ver != VERSION:
                raise WireError(f"unknown wire version {ver}")
            if length > self._max:
                raise WireError(f"frame length {length} exceeds cap "
                                f"{self._max}")
            if len(self._buf) < HEADER_SIZE + length:
                break
            payload = bytes(self._buf[HEADER_SIZE:HEADER_SIZE + length])
            del self._buf[:HEADER_SIZE + length]
            frames.append(Frame(kind, src, tag, step, payload))
        return frames

    def close(self):
        """Signal end-of-stream; a buffered partial frame is an error."""
        if self._buf:
            raise WireError(f"stream truncated mid-frame "
                            f"({len(self._buf)} dangling bytes)")


# ------------------------------------------------------------- array payloads

_ARR_HEAD = struct.Struct("!BB")


def pack_array(arr) -> bytes:
    """numpy array -> self-describing bytes (dtype, shape, raw C-order)."""
    # asarray(order="C"), not ascontiguousarray: the latter silently
    # promotes 0-d arrays to shape (1,), breaking the round trip
    a = numpy.asarray(arr, order="C")
    if a.ndim > _MAX_NDIM:
        raise WireError(f"array rank {a.ndim} exceeds {_MAX_NDIM}")
    dt = a.dtype.str.encode("ascii")
    return (_ARR_HEAD.pack(len(dt), a.ndim) + dt
            + struct.pack(f"!{a.ndim}Q", *a.shape) + a.tobytes())


def unpack_array(data: bytes):
    """Inverse of pack_array; validates the length before reshaping."""
    if len(data) < _ARR_HEAD.size:
        raise WireError("array payload shorter than its header")
    dt_len, ndim = _ARR_HEAD.unpack_from(data)
    if ndim > _MAX_NDIM:
        raise WireError(f"array rank {ndim} exceeds {_MAX_NDIM}")
    off = _ARR_HEAD.size
    dtype = numpy.dtype(data[off:off + dt_len].decode("ascii"))
    off += dt_len
    shape = struct.unpack_from(f"!{ndim}Q", data, off)
    off += 8 * ndim
    count = 1
    for s in shape:
        count *= s
    if len(data) - off != count * dtype.itemsize:
        raise WireError(f"array payload carries {len(data) - off} data "
                        f"bytes; shape {shape} x {dtype} needs "
                        f"{count * dtype.itemsize}")
    return numpy.frombuffer(data, dtype=dtype, offset=off,
                            count=count).reshape(shape)


def share_payload(shares) -> bytes:
    """The one sink through which shares leave a process.

    Shamir/LCC shares sent over the runtime's links to the holder they
    are addressed to ARE the protocol (paper Phases 2/4); every other
    cross-process write of a share is a leak.  `shares` is a numpy array
    or a CPU tensor (callers copy device tensors to the host first)."""
    return pack_array(numpy.asarray(shares))
