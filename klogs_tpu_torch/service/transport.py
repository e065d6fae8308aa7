"""gRPC transport of the remote filter service.

Counterpart of ``klogs_tpu/service/transport.py``, byte for byte on the
wire: a collector of either package can use a filterd of either. The
log-collecting process sends line batches; the process that owns the
card (kernels built and loaded once) returns keep-masks, coalescing the
batches of every connected collector into shared device batches.

gRPC generic methods (no protoc codegen) with msgpack bodies
(``use_bin_type=True``):

  /klogs.Filter/Hello        {} or the collector's invocation ->
                             {"patterns", "exclude", "ignore_case",
                              "backend", "version", "framed", ...}
  /klogs.Filter/Match        {"lines": [bytes, ...]} -> {"mask": bytes}
  /klogs.Filter/MatchFramed  {"n", "offs": int32[n+1] bytes, "data"}
                             -> {"mask": one uint8 a line}
  /klogs.Filter/Register     a multi-set server's registration

Clients check Hello's patterns against their own ``--match`` set and
fail fast on a mismatched deployment. A request that does not decode
fails its own RPC: the decoders below check every field a shared
coalescer would otherwise trip over.
"""

from typing import TYPE_CHECKING, Any

import msgpack
import numpy as np

# TRACEPARENT_KEY ("klogs-traceparent"), the metadata key of the
# collector's trace context, is part of the wire contract too.
from klogs_tpu_torch.obs.trace import TRACEPARENT_KEY, TRACER  # noqa: F401

if TYPE_CHECKING:
    from klogs_tpu_torch.obs.trace import SpanContext

SERVICE = "klogs.Filter"
HELLO = f"/{SERVICE}/Hello"
MATCH = f"/{SERVICE}/Match"
MATCH_FRAMED = f"/{SERVICE}/MatchFramed"
# Sent only to a server whose Hello says multi_set; the port's server
# does not answer it (UNIMPLEMENTED).
REGISTER = f"/{SERVICE}/Register"
# Stable prefixes of a multi-set server's error details: the client
# keys on these tokens, never on the prose after them or on the bare
# status code.
# FAILED_PRECONDITION: the server does not hold the named set -> the
# client registers again and retries.
SET_NOT_REGISTERED = "set-not-registered"
# RESOURCE_EXHAUSTED: the set is over its quota -> ShedByServer.
OVER_QUOTA = "tenant-over-quota"


def trace_metadata() -> "tuple[tuple[str, str], ...]":
    """Metadata entries carrying the current span context (W3C
    traceparent under ``TRACEPARENT_KEY``; empty when nothing records),
    appended to each RPC."""
    return TRACER.inject()


def extract_trace(metadata: "Any") -> "SpanContext | None":
    """Invocation metadata -> the caller's span context, or None."""
    return TRACER.extract(metadata)


def pack(obj: object) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False)


def encode_match_request(lines: list[bytes],
                         set_id: "str | None" = None) -> bytes:
    doc: "dict[str, Any]" = {"lines": lines}
    if set_id is not None:
        doc["set"] = set_id
    return pack(doc)


def decode_match_request(data: bytes) -> "tuple[list[bytes], str | None]":
    doc = unpack(data)
    return doc["lines"], _set_id(doc)


def _set_id(doc: "dict[str, Any]") -> "str | None":
    """A match request's optional set id, which must be a string."""
    set_id = doc.get("set")
    if set_id is not None and not isinstance(set_id, str):
        raise ValueError(
            f"match request: set id must be a string, got "
            f"{type(set_id).__name__}")
    return set_id


# -- registration (multi-set servers) ---------------------------------

def encode_register_request(patterns: "list[str]",
                            exclude: "list[str] | None" = None,
                            ignore_case: bool = False,
                            weight: float = 1.0) -> bytes:
    return pack({"patterns": list(patterns),
                 "exclude": list(exclude or []),
                 "ignore_case": bool(ignore_case),
                 "weight": float(weight)})


def decode_register_request(data: bytes) -> "dict[str, Any]":
    doc = unpack(data)
    patterns = doc.get("patterns")
    exclude = doc.get("exclude", [])
    if not isinstance(patterns, list) or not all(
            isinstance(p, str) for p in patterns):
        raise ValueError("register request: patterns must be a list of "
                         "strings")
    if not isinstance(exclude, list) or not all(
            isinstance(p, str) for p in exclude):
        raise ValueError("register request: exclude must be a list of "
                         "strings")
    if not patterns and not exclude:
        raise ValueError("register request: need at least one pattern")
    weight = doc.get("weight", 1.0)
    if not isinstance(weight, (int, float)) or not (0 < float(weight)
                                                    <= 1024):
        raise ValueError(
            f"register request: weight must be in (0, 1024], got "
            f"{weight!r}")
    return {"patterns": patterns, "exclude": exclude,
            "ignore_case": bool(doc.get("ignore_case", False)),
            "weight": float(weight)}


def encode_register_response(set_id: str, shared: bool,
                             sets: int) -> bytes:
    return pack({"set": set_id, "shared": shared, "sets": sets})


def decode_register_response(data: bytes) -> "dict[str, Any]":
    doc = unpack(data)
    if not isinstance(doc.get("set"), str):
        raise ValueError("register response: missing set id")
    return doc


def encode_hello_request(patterns: "list[str] | None" = None,
                         exclude: "list[str] | None" = None,
                         ignore_case: bool = False) -> bytes:
    """Hello with the collector's invocation (a multi-set server answers
    for that set); no invocation -> the empty body of the plain
    handshake, which every server takes."""
    if patterns is None and not exclude:
        return b""
    return pack({"patterns": list(patterns or []),
                 "exclude": list(exclude or []),
                 "ignore_case": bool(ignore_case)})


def decode_hello_request(data: bytes) -> "dict[str, Any] | None":
    """-> the collector's invocation, or None for the empty Hello. A
    body that does not decode counts as empty: the handshake must not
    break on what an old client sends."""
    if not data:
        return None
    try:
        doc = unpack(data)
    except Exception:  # noqa: BLE001 - any malformed body is "empty"
        return None
    if not isinstance(doc, dict) or "patterns" not in doc:
        return None
    return {"patterns": [str(p) for p in doc.get("patterns") or []],
            "exclude": [str(p) for p in doc.get("exclude") or []],
            "ignore_case": bool(doc.get("ignore_case", False))}


def encode_match_response(mask: list[bool]) -> bytes:
    return pack({"mask": bytes(bytearray(mask))})


def decode_match_response(data: bytes) -> list[bool]:
    return [bool(b) for b in unpack(data)["mask"]]


# -- framed protocol --------------------------------------------------
# MatchFramed ships one contiguous payload and an int32[n+1] offsets
# array (three msgpack bin fields: O(1) to encode and decode a batch),
# and the mask comes back as raw uint8. Hello says {"framed": True};
# a client falls back to Match against a server without it.

def encode_framed_request(payload: bytes, offsets: np.ndarray,
                          set_id: "str | None" = None) -> bytes:
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    doc: "dict[str, Any]" = {"n": len(offs) - 1, "offs": offs.tobytes(),
                             "data": payload}
    if set_id is not None:
        doc["set"] = set_id
    return pack(doc)


def decode_framed_request(
        data: bytes) -> "tuple[bytes, np.ndarray, str | None]":
    """-> (payload, offsets int32[n+1], set id or None).

    Checks the offsets whole: the server feeds them into a coalescer
    shared by every connected collector, so one client's malformed
    request must fail its own RPC here, not the group batch."""
    doc = unpack(data)
    n = int(doc["n"])
    payload = doc["data"]
    if not isinstance(payload, (bytes, bytearray)):
        # A str payload passes every offset check below (len() works on
        # str) and would fail only inside the shared coalescer.
        raise ValueError(
            f"framed request: payload must be bytes, got "
            f"{type(payload).__name__}")
    if not isinstance(doc["offs"], (bytes, bytearray)):
        raise ValueError(
            f"framed request: offs must be bytes, got "
            f"{type(doc['offs']).__name__}")
    offsets = np.frombuffer(doc["offs"], dtype=np.int32)
    if n < 0 or len(offsets) != n + 1:
        raise ValueError(
            f"framed request: {len(offsets)} offsets for n={n}")
    if len(offsets) and (
            int(offsets[0]) != 0
            or int(offsets[-1]) != len(payload)
            or bool((np.diff(offsets) < 0).any())):
        raise ValueError("framed request: offsets must rise from 0 to "
                         "len(payload) monotonically")
    return payload, offsets, _set_id(doc)


def encode_framed_response(mask: np.ndarray) -> bytes:
    """A bool or uint8 verdict array -> the byte-per-line body."""
    return pack({"mask": np.ascontiguousarray(
        mask, dtype=np.uint8).tobytes()})


def decode_framed_response(data: bytes) -> np.ndarray:
    """-> a bool verdict array."""
    return np.frombuffer(unpack(data)["mask"], dtype=np.uint8).astype(bool)
