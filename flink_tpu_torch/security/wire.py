"""Zero-copy binary columnar wire format for the dataplane exchange.

The legacy exchange wire pickles every record batch into a fresh buffer,
MACs it in a second full pass, sends it as one monolithic frame, and
restricted-unpickles it on the receiver — three or more full copies per hop
of data that is already columnar numpy. This module is the DCN analogue of
the reference's zero-copy Netty buffer transfer (NetworkBuffer /
BufferResponse carrying the buffer by reference): a batch payload travels
as

    [compact little-endian header] [restricted-pickle sidecar] [raw buffers]

where the header describes each raw column (name, dtype string, shape,
absolute byte offset, byte count) and the buffers are transmitted as
`memoryview`s over the producer's existing numpy arrays — NO copy for
contiguous numeric columns. Object-dtype columns (and any element that is
not a raw-encodable ndarray: scalars, strings, tags) ride the sidecar, a
restricted-pickle of the residual payload skeleton. The receiver reads the
whole frame body into ONE preallocated buffer with `recv_into` and maps
each column back as an `np.frombuffer` view — again no copy.

Authentication composes with security/framing.py unchanged: the per-frame
HMAC is computed incrementally over header, sidecar, and each buffer
(`FrameCodec.seal_parts`), and the receiver MAC-verifies the single
received body BEFORE the header is parsed or the sidecar is deserialized —
the same MAC-verify-before-deserialize guarantee as the legacy wire,
without the concatenated copy.

Frame discipline (security/transport.py `send_data_frame`/`recv_msg`): a
binary data frame is distinguished from legacy restricted-pickle frames by
the top bit of the 4-byte length prefix (`DATA_FLAG`), so both kinds can
interleave on one connection — control frames (`open`/`credit`/`eos`) and
non-batch payloads stay on the legacy codec, and a peer that never learned
the flag bit never sees it (the sender only emits binary frames after the
receiver advertises support on the `open` reply; see runtime/dataplane.py).

Wire layout of a frame body (everything little-endian; the outer length
prefix stays big-endian to match the legacy framing):

    offset  size  field
    0       2     magic "FB"
    2       1     wire version (1)
    3       1     flags (reserved, 0)
    4       4     header_len u32 — total header size in bytes
    8       8     seq u64 — per-channel batch sequence number
    16      2     channel_len u16, then channel id (utf-8)
    ..      2     ncols u16 — number of raw columns
    ..      4     sidecar_len u32
    then per column:
            2     name_len u16, then column name (utf-8)
            1     dtype_len u8, then numpy dtype string (ascii, e.g. "<f8")
            1     ndim u8
            8*nd  shape u64 × ndim
            8     offset u64 — ABSOLUTE offset of the column's bytes in the
                  frame body (64-byte aligned)
            8     nbytes u64

    [sidecar bytes]  at [header_len, header_len + sidecar_len)
    [column buffers] at their declared offsets, zero-padded to alignment

Counterpart of `flink_tpu/security/wire.py`, copied: for the same channel,
sequence number and columns the two packages' frames are byte-equal.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.security.framing import dumps, restricted_loads

__all__ = [
    "BUFFER_ALIGN",
    "DATA_FLAG",
    "WIRE_MAGIC",
    "WIRE_VERSION",
    "WireFormatError",
    "decode_frame",
    "encode_frame",
    "extract_columns",
]

WIRE_MAGIC = b"FB"
WIRE_VERSION = 1

# top bit of the outer big-endian length prefix marks a binary data frame;
# legacy frames keep bit 31 clear (their payloads are capped well below 2 GiB)
DATA_FLAG = 0x8000_0000

# column buffers land 64-byte aligned inside the receiver's single recv_into
# allocation, so np.frombuffer views are vector-load friendly
BUFFER_ALIGN = 64

# a payload tuple longer than this is not a record batch; refuse rather than
# let a crafted sidecar allocate an absurd skeleton (relevant with auth off)
_MAX_PAYLOAD_ITEMS = 4096


class WireFormatError(ConnectionError):
    """Binary data frame failed structural validation (truncated header,
    out-of-bounds buffer, dtype/shape mismatch, or malformed sidecar)."""


def alloc_body(n: int, lead: int = 0):
    """Receive buffer for one frame of n bytes: numpy uint8 (UNINITIALIZED
    — a bytearray would zero-fill n bytes before recv_into overwrites
    them), placed so that byte `lead` sits on a BUFFER_ALIGN memory
    address. The frame body starts at `lead` (MAC_LEN when auth is on, 0
    otherwise) and its column offsets are BUFFER_ALIGN-multiples, so the
    decoded frombuffer views land on truly aligned addresses — np.empty
    alone guarantees only malloc alignment, and the 32-byte MAC prefix
    would shift every column off the grid. Supports the buffer protocol
    for recv_into/hmac and serves as the base of the decoded views."""
    raw = np.empty(n + BUFFER_ALIGN, dtype=np.uint8)
    shift = (-(raw.ctypes.data + lead)) % BUFFER_ALIGN
    return raw[shift:shift + n]


def _raw_encodable(el: Any) -> bool:
    """True for arrays whose bytes can travel as a raw wire buffer: plain
    C-reconstructible ndarrays (subclasses like np.matrix keep their pickle
    path) of at least one dimension, with a fixed-size, object-free dtype —
    numeric, bool, datetime/timedelta, and fixed-width string/bytes all
    qualify; object and structured/void dtypes ride the sidecar."""
    return (
        type(el) is np.ndarray
        and el.ndim >= 1
        and not el.dtype.hasobject
        and el.dtype.kind != "V"
    )


def extract_columns(payload: Any) -> Optional[Tuple[List[Tuple[str, np.ndarray]], bytes]]:
    """Split a data payload into raw wire columns + a restricted-pickle
    sidecar.

    Payloads are positional: tuple element i becomes raw column "i" when it
    is a raw-encodable ndarray; everything else (tags, scalars, object /
    structured arrays) goes into the sidecar skeleton ``(n_items, {i:
    value})``. Returns None when the payload is not binary-eligible — not a
    tuple, too long, or holding no raw column — in which case it rides a
    legacy restricted-pickle frame unchanged (control messages like
    ``("w", wm)`` stay on the old codec by construction)."""
    if type(payload) is not tuple or len(payload) > _MAX_PAYLOAD_ITEMS:
        return None
    cols: List[Tuple[str, np.ndarray]] = []
    rest: Dict[int, Any] = {}
    for i, el in enumerate(payload):
        if _raw_encodable(el):
            cols.append((str(i), np.ascontiguousarray(el)))
        else:
            rest[i] = el
    if not cols:
        return None
    return cols, dumps((len(payload), rest))


def encode_frame(
    channel: str,
    seq: int,
    cols: List[Tuple[str, np.ndarray]],
    sidecar: bytes,
) -> Tuple[List[Any], int]:
    """Build the scatter-gather part list for one binary data frame body:
    ``[header, sidecar, pad?, buffer, pad?, buffer, ...]``. Returns
    ``(parts, body_len)``. Array bytes are NOT copied — each buffer part is
    a memoryview over the caller's array, ready for `socket.sendmsg` and
    for incremental MACing (`FrameCodec.seal_parts`)."""
    ch = channel.encode()
    entries = []
    fixed = 16 + 2 + len(ch) + 2 + 4
    hlen = fixed
    for name, arr in cols:
        nb = name.encode()
        dt = arr.dtype.str.encode("ascii")
        entries.append((nb, dt, arr))
        hlen += 2 + len(nb) + 1 + len(dt) + 1 + 8 * arr.ndim + 16

    head = bytearray()
    head += WIRE_MAGIC
    head.append(WIRE_VERSION)
    head.append(0)
    head += struct.pack("<IQ", hlen, seq)
    head += struct.pack("<H", len(ch)) + ch
    head += struct.pack("<HI", len(entries), len(sidecar))

    parts: List[Any] = [None, sidecar]  # header backpatched once complete
    off = hlen + len(sidecar)
    for nb, dt, arr in entries:
        pad = (-off) % BUFFER_ALIGN
        if pad:
            parts.append(b"\x00" * pad)
            off += pad
        head += struct.pack("<H", len(nb)) + nb
        head += struct.pack("<B", len(dt)) + dt
        head += struct.pack("<B", arr.ndim)
        head += struct.pack(f"<{arr.ndim}Q", *arr.shape)
        head += struct.pack("<QQ", off, arr.nbytes)
        try:
            parts.append(memoryview(arr).cast("B"))
        except (ValueError, TypeError):
            # datetime64/timedelta64 refuse the buffer protocol directly;
            # a u1 view of the same (contiguous) memory is still zero-copy
            parts.append(memoryview(arr.view("u1")).cast("B"))
        off += arr.nbytes
    if len(head) != hlen:
        raise WireFormatError(
            f"internal header-size mismatch ({len(head)} != {hlen})")
    parts[0] = bytes(head)
    return parts, off


def decode_frame(body, *, trusted_pickle: bool = False) -> Tuple[str, int, tuple]:
    """Parse one binary data frame body — AFTER MAC verification when auth
    is on — into ``(channel, seq, payload)``. Raw columns come back as
    `np.frombuffer` views into `body` (zero copy; the arrays keep `body`
    alive through their base reference). `trusted_pickle` selects plain
    pickle for the sidecar, matching the legacy wire's semantics when
    `security.transport.enabled: false`; with auth on the sidecar goes
    through the restricted allowlist like every other frame."""
    try:
        return _decode_frame(body, trusted_pickle)
    except WireFormatError:
        raise
    except (struct.error, UnicodeDecodeError, TypeError, ValueError,
            OverflowError, IndexError) as e:
        raise WireFormatError(f"malformed binary data frame: {e}") from e


def _decode_frame(body, trusted_pickle: bool) -> Tuple[str, int, tuple]:
    n = len(body)
    if n < 24 or bytes(body[0:2]) != WIRE_MAGIC:
        raise WireFormatError("bad binary frame magic")
    if body[2] != WIRE_VERSION:
        raise WireFormatError(f"unsupported wire version {body[2]}")
    hlen, seq = struct.unpack_from("<IQ", body, 4)
    pos = 16
    (clen,) = struct.unpack_from("<H", body, pos)
    pos += 2
    if pos + clen > n:
        raise WireFormatError("channel id overruns frame")
    channel = bytes(body[pos:pos + clen]).decode()
    pos += clen
    ncols, slen = struct.unpack_from("<HI", body, pos)
    pos += 6
    if hlen > n or hlen + slen > n:
        raise WireFormatError("header/sidecar overrun frame")

    cols = []
    for _ in range(ncols):
        if pos >= hlen:
            raise WireFormatError("column table overruns declared header")
        (nl,) = struct.unpack_from("<H", body, pos)
        pos += 2
        name = bytes(body[pos:pos + nl]).decode()
        pos += nl
        dl = body[pos]
        pos += 1
        dtype_s = bytes(body[pos:pos + dl]).decode("ascii")
        pos += dl
        ndim = body[pos]
        pos += 1
        shape = struct.unpack_from(f"<{ndim}Q", body, pos)
        pos += 8 * ndim
        off, nbytes = struct.unpack_from("<QQ", body, pos)
        pos += 16
        cols.append((name, dtype_s, shape, off, nbytes))
    if pos != hlen:
        raise WireFormatError("header length mismatch")

    sidecar = bytes(body[hlen:hlen + slen])
    if trusted_pickle:
        import pickle

        nitems, rest = pickle.loads(sidecar)
    else:
        nitems, rest = restricted_loads(sidecar)
    if not isinstance(nitems, int) or not isinstance(rest, dict) \
            or not 0 <= nitems <= _MAX_PAYLOAD_ITEMS:
        raise WireFormatError("malformed sidecar skeleton")

    missing = object()
    items: List[Any] = [missing] * nitems
    data_start = hlen + slen
    for name, dtype_s, shape, off, nbytes in cols:
        dt = np.dtype(dtype_s)
        if dt.hasobject:
            raise WireFormatError("raw column with object dtype")
        count = 1
        for d in shape:
            count *= d
        if dt.itemsize * count != nbytes:
            raise WireFormatError(
                f"column {name!r}: {nbytes} bytes != shape {shape} of {dtype_s}")
        if off < data_start or off + nbytes > n:
            raise WireFormatError(f"column {name!r} buffer out of bounds")
        idx = int(name)
        if not 0 <= idx < nitems or items[idx] is not missing:
            raise WireFormatError(f"column {name!r}: bad payload position")
        items[idx] = np.frombuffer(
            body, dtype=dt, count=count, offset=off).reshape(shape)
    for k, v in rest.items():
        idx = int(k)
        if not 0 <= idx < nitems or items[idx] is not missing:
            raise WireFormatError(f"sidecar item {k!r}: bad payload position")
        items[idx] = v
    if any(it is missing for it in items):
        raise WireFormatError("payload positions incomplete")
    return channel, seq, tuple(items)
