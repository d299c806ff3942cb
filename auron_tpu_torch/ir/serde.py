"""IR serialization: canonical JSON and the binary envelope (counterpart
of auron_tpu/ir/serde.py).

Envelope: magic "ATPU" + u8 version + u8 codec + body.  Raw and zlib
bodies are read and written always; a zstd body is read when the
`zstandard` module imports, and raises a clear error otherwise.
"""

from __future__ import annotations

import json
import struct
import zlib

from auron_tpu_torch.ir.node import Node

MAGIC = b"ATPU"
VERSION = 1
_CODEC_RAW, _CODEC_ZSTD, _CODEC_ZLIB = 0, 1, 2


def to_json(node: Node) -> str:
    return json.dumps(node.to_dict(), separators=(",", ":"), sort_keys=True)


def from_json(s: str) -> Node:
    return Node.from_dict(json.loads(s))


def serialize(node: Node, codec: str = "zlib") -> bytes:
    payload = to_json(node).encode("utf-8")
    if codec == "zlib":
        body, cid = zlib.compress(payload, 6), _CODEC_ZLIB
    elif codec == "raw":
        body, cid = payload, _CODEC_RAW
    else:
        raise ValueError(f"unknown codec {codec!r} (raw or zlib)")
    return MAGIC + struct.pack("<BB", VERSION, cid) + body


def deserialize(data: bytes) -> Node:
    if data[:4] != MAGIC:
        raise ValueError("bad IR envelope magic")
    version, cid = struct.unpack_from("<BB", data, 4)
    if version != VERSION:
        raise ValueError(f"unsupported IR version {version}")
    body = data[6:]
    if cid == _CODEC_ZLIB:
        payload = zlib.decompress(body)
    elif cid == _CODEC_RAW:
        payload = body
    elif cid == _CODEC_ZSTD:
        try:
            import zstandard
        except ImportError:
            raise RuntimeError(
                "zstd-compressed IR envelope, but the zstandard module is "
                "not installed; send raw or zlib envelopes") from None
        payload = zstandard.ZstdDecompressor().decompress(body)
    else:
        raise ValueError(f"unknown codec id {cid}")
    return from_json(payload.decode("utf-8"))
