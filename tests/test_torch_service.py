"""The port's filterd and remote client against the JAX package's.

- The wire: the port's encoders give the JAX encoders' bytes on seeded
  inputs, and its decoders accept and reject the same bodies with the
  same exception types.
- Both ways across packages: a JAX client against the port's
  ``FilterServer(device="cpu")`` and a port client against a JAX
  ``FilterServer(backend="cpu")`` get masks equal to Python ``re``; the
  two Hellos carry the same keys; the port client registers its set
  with a JAX ``--multi-set`` server; a trace continues across the wire.
- The contracts of the JAX ``tests/test_service.py`` and of
  ``tests/test_chaos_resilience.py``'s RPC scenarios, run against the
  port's server, and ``--on-filter-error`` through the port's sink
  against the JAX sink on the same batches.
- ``FleetCapacity`` against the JAX one on one offered/admitted
  sequence under a fake clock.

The port's server runs the GPU engine on the CPU (the kernels' plain
versions); the JAX server runs its host engine. Verdicts are booleans,
so every comparison is exact.
"""

import asyncio
import os
import random
import re
import subprocess
import threading
import time

import grpc
import numpy as np
import pytest

from klogs_tpu import app as jax_app
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from klogs_tpu.filters import sink as jax_sink
from klogs_tpu.filters.base import FilterStats as JaxFilterStats
from klogs_tpu.obs import profiler as jax_profiler
from klogs_tpu.obs import trace as jax_trace
from klogs_tpu.resilience import FAULTS as JAX_FAULTS
from klogs_tpu.resilience import RetryPolicy as JaxRetryPolicy
from klogs_tpu.runtime.sink import FileSink as JaxFileSink
from klogs_tpu.service import client as jax_client
from klogs_tpu.service import server as jax_server
from klogs_tpu.service import transport as jax_transport
from klogs_tpu_torch import app, cli, obs
from klogs_tpu_torch.cluster.backend import ClusterError
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.filters import sink
from klogs_tpu_torch.filters.base import FilterStats, frame_lines
from klogs_tpu_torch.obs import profiler
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience import (
    FAULTS,
    BreakerOpen,
    CircuitBreaker,
    InjectedFault,
    RetryPolicy,
    Unavailable,
)
from klogs_tpu_torch.runtime.fanout import StreamJob
from klogs_tpu_torch.runtime.sink import FileSink
from klogs_tpu_torch.service import server as server_mod
from klogs_tpu_torch.service import transport
from klogs_tpu_torch.service.client import (
    PatternMismatch,
    RemoteFilterClient,
    ServiceConfigError,
)
from klogs_tpu_torch.service.server import FilterServer
from klogs_tpu_torch.ui import term

PATTERNS = ["ERROR", r"WARN.*\d"]
CLOCK = 1_753_800_000.0
FAST = RetryPolicy(max_attempts=4, base_s=0.005, max_s=0.02, jitter=0.0)


@pytest.fixture(autouse=True)
def _clean_process_state():
    """Both packages' tracers, profilers and fault scripts off around
    each test (each package has its own process-wide objects)."""
    def reset():
        for tr in (trace, jax_trace):
            tr.reset(None)
        for prof in (profiler.PROFILER, jax_profiler.PROFILER):
            prof.reset()
        for f in (FAULTS, JAX_FAULTS):
            f.clear()
            f.bind_registry(None)

    reset()
    term.set_colors(False)
    yield
    term.set_colors(None)
    reset()


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """One server and one client certificate for the module, each
    self-signed with a SAN for localhost and 127.0.0.1."""
    d = tmp_path_factory.mktemp("certs")
    out = {}
    for name in ("srv", "cli"):
        key, crt = d / f"{name}.key", d / f"{name}.crt"
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(crt), "-days", "2",
             "-subj", "/CN=localhost",
             "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
            check=True, capture_output=True)
        out[name] = (str(key), str(crt))
    return out


def run(coro, timeout: float = 60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def oracle(patterns, lines, exclude=(), flags=0) -> list:
    inc = [re.compile(p.encode(), flags) for p in patterns]
    exc = [re.compile(p.encode(), flags) for p in exclude]
    out = []
    for ln in lines:
        body = ln.rstrip(b"\n")
        keep = (not inc) or any(r.search(body) for r in inc)
        out.append(bool(keep and not any(r.search(body) for r in exc)))
    return out


def seeded_lines(seed: int, n: int) -> list:
    """Log-like lines, some with ERROR or WARN + a digit, and a few
    with trailing newlines, \\r and empty bodies."""
    rng = random.Random(seed)
    words = [b"ERROR", b"WARN", b"INFO", b"code", b"42", b"x", b"", b"\r"]
    out = []
    for _ in range(n):
        ln = b" ".join(rng.choice(words) for _ in range(rng.randrange(6)))
        out.append(ln + b"\n" * rng.randrange(3))
    return out


async def port_server(patterns=PATTERNS, **kw):
    server = FilterServer(patterns, port=0, device="cpu", **kw)
    return server, await server.start()


async def with_server(fn, patterns=PATTERNS, **kw):
    server, port = await port_server(patterns, **kw)
    client = RemoteFilterClient(f"127.0.0.1:{port}")
    try:
        return await fn(client, port)
    finally:
        await client.aclose()
        await server.stop()


async def dead_port() -> int:
    """A port where a server listened and no longer does."""
    server, port = await port_server()
    await server.stop()
    return port


async def http_get(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


# ---- the wire ------------------------------------------------------------

def _framed(n: int, seed: int = 7):
    lines = seeded_lines(seed, n)
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    return payload, offsets


ENCODE_CASES = {
    "match": lambda m: m.encode_match_request(seeded_lines(1, 50)),
    "match_set": lambda m: m.encode_match_request(seeded_lines(2, 3),
                                                  set_id="abc123"),
    "match_empty": lambda m: m.encode_match_request([]),
    "framed_n0": lambda m: m.encode_framed_request(*_framed(0)),
    "framed_n1": lambda m: m.encode_framed_request(*_framed(1)),
    "framed_n1000": lambda m: m.encode_framed_request(*_framed(1000)),
    "framed_set": lambda m: m.encode_framed_request(*_framed(5),
                                                    set_id="s1"),
    "register": lambda m: m.encode_register_request(
        PATTERNS, ["healthz"], True, weight=2.5),
    "register_default": lambda m: m.encode_register_request(["x"]),
    "register_response": lambda m: m.encode_register_response("s", True, 3),
    "hello_empty": lambda m: m.encode_hello_request(),
    "hello_invocation": lambda m: m.encode_hello_request(
        PATTERNS, ["noise"], True),
    "match_response": lambda m: m.encode_match_response(
        [True, False, True] * 7),
    "framed_response_bool": lambda m: m.encode_framed_response(
        np.random.default_rng(3).random(1000) < 0.3),
    "framed_response_uint8": lambda m: m.encode_framed_response(
        np.array([0, 1, 1, 0], dtype=np.uint8)),
    "framed_response_empty": lambda m: m.encode_framed_response(
        np.zeros(0, dtype=bool)),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encoders_give_the_jax_bytes(case):
    got = ENCODE_CASES[case](transport)
    assert isinstance(got, bytes)
    assert got == ENCODE_CASES[case](jax_transport)


def test_wire_names_equal_jax():
    for name in ("SERVICE", "HELLO", "MATCH", "MATCH_FRAMED", "REGISTER",
                 "SET_NOT_REGISTERED", "OVER_QUOTA", "TRACEPARENT_KEY"):
        assert getattr(transport, name) == getattr(jax_transport, name)
    assert transport.TRACEPARENT_KEY == "klogs-traceparent"


def _pk(obj) -> bytes:
    return jax_transport.pack(obj)


GOOD_OFFS = np.array([0, 2, 5], dtype=np.int32).tobytes()
DECODE_CASES = {
    "framed_ok": ("decode_framed_request",
                  _pk({"n": 2, "offs": GOOD_OFFS, "data": b"abcde"})),
    "framed_n0": ("decode_framed_request",
                  _pk({"n": 0, "offs": np.zeros(1, np.int32).tobytes(),
                       "data": b""})),
    "framed_str_payload": ("decode_framed_request",
                           _pk({"n": 2, "offs": GOOD_OFFS,
                                "data": "abcde"})),
    "framed_str_offs": ("decode_framed_request",
                        _pk({"n": 2, "offs": "xx", "data": b"abcde"})),
    "framed_offs_count": ("decode_framed_request",
                          _pk({"n": 3, "offs": GOOD_OFFS, "data": b"abcde"})),
    "framed_negative_n": ("decode_framed_request",
                          _pk({"n": -1, "offs": b"", "data": b""})),
    "framed_not_rising": ("decode_framed_request",
                          _pk({"n": 2, "offs": np.array(
                              [0, 4, 2], np.int32).tobytes(),
                              "data": b"abcd"[:2]})),
    "framed_not_from_zero": ("decode_framed_request",
                             _pk({"n": 2, "offs": np.array(
                                 [1, 2, 5], np.int32).tobytes(),
                                 "data": b"abcde"})),
    "framed_short_payload": ("decode_framed_request",
                             _pk({"n": 2, "offs": GOOD_OFFS,
                                  "data": b"abcdef"})),
    "framed_ragged_offs": ("decode_framed_request",
                           _pk({"n": 1, "offs": b"\x00\x00\x00",
                                "data": b""})),
    "framed_missing_n": ("decode_framed_request",
                         _pk({"offs": GOOD_OFFS, "data": b"abcde"})),
    "framed_set_int": ("decode_framed_request",
                       _pk({"n": 2, "offs": GOOD_OFFS, "data": b"abcde",
                            "set": 7})),
    "framed_set_ok": ("decode_framed_request",
                      _pk({"n": 2, "offs": GOOD_OFFS, "data": b"abcde",
                           "set": "s"})),
    "match_ok": ("decode_match_request", _pk({"lines": [b"a", b"b"]})),
    "match_no_lines": ("decode_match_request", _pk({"x": 1})),
    "match_set_list": ("decode_match_request",
                       _pk({"lines": [b"a"], "set": ["s"]})),
    "register_ok": ("decode_register_request",
                    _pk({"patterns": ["a"], "exclude": ["b"],
                         "ignore_case": 1, "weight": 3})),
    "register_bad_patterns": ("decode_register_request",
                              _pk({"patterns": "a"})),
    "register_bad_exclude": ("decode_register_request",
                             _pk({"patterns": ["a"], "exclude": [1]})),
    "register_empty": ("decode_register_request",
                       _pk({"patterns": [], "exclude": []})),
    "register_weight": ("decode_register_request",
                        _pk({"patterns": ["a"], "weight": 2000})),
    "register_response_ok": ("decode_register_response",
                             _pk({"set": "s", "shared": False, "sets": 1})),
    "register_response_no_set": ("decode_register_response",
                                 _pk({"shared": False})),
    "hello_empty": ("decode_hello_request", b""),
    "hello_garbage": ("decode_hello_request", b"\xc1\xff\x00"),
    "hello_no_patterns": ("decode_hello_request", _pk({"exclude": ["x"]})),
    "hello_invocation": ("decode_hello_request",
                         _pk({"patterns": ["a", 3], "ignore_case": 1})),
    "match_response": ("decode_match_response",
                       _pk({"mask": b"\x01\x00\x01"})),
    "framed_response": ("decode_framed_response",
                        _pk({"mask": b"\x00\x01\x01"})),
}


def _decode(mod, fn: str, body: bytes):
    try:
        out = getattr(mod, fn)(body)
    except Exception as e:  # noqa: BLE001 - the type is the result
        return ("raises", type(e).__name__)
    if isinstance(out, tuple):
        return tuple(o.tolist() if isinstance(o, np.ndarray) else o
                     for o in out)
    return out.tolist() if isinstance(out, np.ndarray) else out


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decoders_accept_and_reject_as_jax(case):
    fn, body = DECODE_CASES[case]
    got = _decode(transport, fn, body)
    assert got == _decode(jax_transport, fn, body)
    if case.endswith("_ok"):
        assert not (isinstance(got, tuple) and got[0] == "raises")


def test_decoders_reject_malformed_with_value_error():
    """The checks that keep a malformed request off the shared
    coalescer: each is a ValueError, which the server turns into
    INVALID_ARGUMENT for that RPC alone."""
    for case in ("framed_str_payload", "framed_str_offs",
                 "framed_offs_count", "framed_not_rising",
                 "framed_set_int", "match_set_list"):
        fn, body = DECODE_CASES[case]
        assert _decode(transport, fn, body) == ("raises", "ValueError")


# ---- across the packages -------------------------------------------------

def test_jax_client_against_the_port_server():
    lines = seeded_lines(11, 300)

    async def fn(_, port):
        c = jax_client.RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(PATTERNS)
            masks = [await c.match(lines)]
            payload, offsets, _ = frame_lines(lines, strip_nl=False)
            masks.append((await c.match_framed(payload, offsets)).tolist())
            return masks
        finally:
            await c.aclose()

    for mask in run(with_server(fn)):
        assert mask == oracle(PATTERNS, lines)


def test_port_client_against_the_jax_server():
    lines = seeded_lines(12, 300)

    async def scenario():
        server = jax_server.FilterServer(PATTERNS, backend="cpu", port=0)
        port = await server.start()
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(PATTERNS)
            payload, offsets, _ = frame_lines(lines, strip_nl=False)
            framed = await c.match_framed(payload, offsets)
            assert framed.dtype == bool
            return [await c.match(lines), framed.tolist()]
        finally:
            await c.aclose()
            await server.stop()

    for mask in run(scenario()):
        assert mask == oracle(PATTERNS, lines)


def test_hello_keys_equal_jax(monkeypatch):
    """Each package's client reads each package's Hello: the same keys
    and values but ``backend`` and ``version``, ``headroom`` included
    with an envelope set on both sides, ``device_sweep`` false on both
    (no sweep at two patterns), and the fleet counters after the same
    traffic."""
    monkeypatch.setenv("KLOGS_FLEET_CAPACITY_LPS", "1000000")
    lines = seeded_lines(13, 40)

    async def scenario():
        ps, pport = await port_server(metrics_port=0)
        js = jax_server.FilterServer(PATTERNS, backend="cpu", port=0,
                                     metrics_port=0)
        jport = await js.start()
        infos = {}
        try:
            for name, cls, port in (
                    ("port", RemoteFilterClient, pport),
                    ("jax", jax_client.RemoteFilterClient, jport)):
                c = cls(f"127.0.0.1:{port}")
                try:
                    await c.match(lines)
                    infos[name] = await c.hello()
                finally:
                    await c.aclose()
            return infos, ps.metrics_port, js.metrics_port
        finally:
            await ps.stop()
            await js.stop()

    infos, pm, jm = run(scenario())
    got, exp = infos["port"], infos["jax"]
    assert set(got) == set(exp) == {
        "patterns", "exclude", "ignore_case", "backend", "version",
        "framed", "metrics_port", "metrics_host", "device_sweep",
        "headroom", "fleet_offered_lines", "fleet_admitted_lines"}
    assert got["backend"] == "cuda" and exp["backend"] == "cpu"
    assert got["metrics_port"] == pm and exp["metrics_port"] == jm
    skip = {"backend", "version", "metrics_port", "headroom"}
    assert {k: got[k] for k in got if k not in skip} == {
        k: exp[k] for k in exp if k not in skip}
    assert got["fleet_offered_lines"] == got["fleet_admitted_lines"] == 40
    assert 0.99 < got["headroom"] <= 1.0 and 0.99 < exp["headroom"] <= 1.0


def test_device_sweep_advertised_under_the_sweep(monkeypatch):
    """Hello's device_sweep reads the port engine's own sweep tables: on
    under a forced sweep, off without it, also behind an exclude
    set."""
    pats = [f"svc{i:02d}-failure" for i in range(8)]

    async def hello(**kw):
        server, port = await port_server(pats, **kw)
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            return (await c.hello())["device_sweep"], server.device_sweep
        finally:
            await c.aclose()
            await server.stop()

    assert run(hello()) == (False, False)
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "1")
    assert run(hello()) == (True, True)
    assert run(hello(exclude=["healthz"])) == (True, True)


def test_port_client_registers_with_a_jax_multi_set_server():
    """The register/set-id path: against a JAX --multi-set filterd the
    port client registers its set (two clients of one set share it),
    tags its match RPCs with the id, and gets its own set's verdicts
    next to a collector of another set."""
    lines = seeded_lines(14, 120)
    other = ["INFO"]

    async def scenario():
        server = jax_server.FilterServer([], backend="cpu", port=0,
                                         multi_set=True)
        port = await server.start()
        a = RemoteFilterClient(f"127.0.0.1:{port}")
        b = RemoteFilterClient(f"127.0.0.1:{port}")
        o = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await a.verify_patterns(PATTERNS)
            await b.verify_patterns(PATTERNS)
            await o.verify_patterns(other)
            assert a._set_id is not None and a._set_id == b._set_id
            assert o._set_id != a._set_id
            payload, offsets, _ = frame_lines(lines, strip_nl=False)
            got = await asyncio.gather(a.match_framed(payload, offsets),
                                       b.match(lines),
                                       o.match_framed(payload, offsets))
            return [g if isinstance(g, list) else g.tolist()
                    for g in got], server.tenants.count
        finally:
            for c in (a, b, o):
                await c.aclose()
            await server.stop()

    (ma, mb, mo), sets = run(scenario())
    assert ma == mb == oracle(PATTERNS, lines)
    assert mo == oracle(other, lines)
    assert sets == 2


def test_register_is_unimplemented_on_the_port_server():
    async def fn(client, _):
        with pytest.raises(grpc.aio.AioRpcError) as ei:
            await client._register_rpc(
                transport.encode_register_request(PATTERNS))
        return ei.value.code()

    assert run(with_server(fn)) == grpc.StatusCode.UNIMPLEMENTED


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_trace_continues_across_the_wire(direction):
    """The collector's ``rpc.client`` span is the parent of the
    server's ``rpc.server`` span, across the two packages either
    way."""
    trace.reset(1.0)
    jax_trace.reset(1.0)
    if direction == "port_to_jax":
        make_server = lambda: jax_server.FilterServer(  # noqa: E731
            PATTERNS, backend="cpu", port=0)
        client_cls, client_tr, server_tr = (RemoteFilterClient, trace,
                                            jax_trace)
    else:
        make_server = lambda: FilterServer(  # noqa: E731
            PATTERNS, port=0, device="cpu")
        client_cls, client_tr, server_tr = (jax_client.RemoteFilterClient,
                                            jax_trace, trace)

    async def scenario():
        server = make_server()
        port = await server.start()
        c = client_cls(f"127.0.0.1:{port}")
        try:
            payload, offsets, _ = frame_lines([b"an ERROR", b"ok"])
            return (await c.match_framed(payload, offsets)).tolist()
        finally:
            await c.aclose()
            await server.stop()

    assert run(scenario()) == [True, False]
    clients = [s for s in client_tr.TRACER.finished_spans()
               if s["name"] == "rpc.client"]
    servers = [s for s in server_tr.TRACER.finished_spans()
               if s["name"] == "rpc.server"]
    assert [s["attrs"]["method"] for s in clients] == ["rpc.hello",
                                                      "rpc.match"]
    assert [s["attrs"]["method"] for s in servers] == ["Hello",
                                                      "MatchFramed"]
    for c, s in zip(clients, servers):
        assert s["trace_id"] == c["trace_id"]
        assert s["parent_id"] == c["span_id"]


# ---- the contracts of the JAX filterd's tests ----------------------------

def test_match_round_trip():
    lines = [b"an ERROR here", b"all good", b"WARN code 42", b"WARN none"]

    async def fn(client, _):
        await client.verify_patterns(PATTERNS)
        return await client.match(lines)

    assert run(with_server(fn)) == [True, False, True, False]


def test_hello_reports_config():
    info = run(with_server(lambda c, _: c.hello()))
    assert info["patterns"] == PATTERNS
    assert info["backend"] == "cuda"
    assert info["framed"] is True and info["exclude"] == []


def test_pattern_mismatch_fails_fast():
    async def fn(client, _):
        with pytest.raises(PatternMismatch):
            await client.verify_patterns(["different"])

    run(with_server(fn))


def test_verify_rejects_case_mode_mismatch():
    async def fn(client, _):
        with pytest.raises(PatternMismatch):
            await client.verify_patterns(PATTERNS, ignore_case=False)
        await client.verify_patterns(PATTERNS, ignore_case=True)
        return await client.match([b"an error", b"fine"])

    assert run(with_server(fn, ignore_case=True)) == [True, False]


def test_concurrent_clients_coalesce():
    async def fn(client, port):
        others = [RemoteFilterClient(f"127.0.0.1:{port}") for _ in range(3)]
        try:
            return await asyncio.gather(
                client.match([b"ERROR x"]),
                *[c.match([b"nope", b"WARN 1"]) for c in others])
        finally:
            for c in others:
                await c.aclose()

    res = run(with_server(fn))
    assert res[0] == [True]
    assert all(r == [False, True] for r in res[1:])


def test_empty_and_long_only_framed_batches_round_trip():
    """n = 0 comes back as an empty mask; a batch of only long lines
    (the carried-state path, 4 rows) as one byte a line."""
    longs = [b"x" * 6000 + b" ERROR " + b"y" * 100,
             b"z" * 9000, b"w" * 4097, b"WARN " + b"q" * 5000 + b" 7"]

    async def fn(client, _):
        payload, offsets, _ = frame_lines([])
        empty = await client.match_framed(payload, offsets)
        payload, offsets, _ = frame_lines(longs)
        return empty, await client.match_framed(payload, offsets)

    empty, mask = run(with_server(fn))
    assert empty.dtype == bool and empty.shape == (0,)
    assert mask.tolist() == [True, False, False, True]


def test_malformed_request_fails_only_its_own_rpc():
    """A str payload is INVALID_ARGUMENT for its sender; a concurrent
    good request from another client gets its verdicts."""
    async def fn(client, port):
        bad = transport.pack({"n": 1, "offs": np.array(
            [0, 3], np.int32).tobytes(), "data": "abc"})
        other = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            results = await asyncio.gather(
                client._match_framed_rpc(bad),
                other.match([b"ERROR 1", b"x"]), return_exceptions=True)
        finally:
            await other.aclose()
        return results

    err, good = run(with_server(fn))
    assert isinstance(err, grpc.aio.AioRpcError)
    assert err.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "payload must be bytes" in err.details()
    assert good == [True, False]


def test_jumbo_batch_over_default_grpc_cap():
    """A framed batch past gRPC's 4 MiB default message cap (1200 lines
    of 4 KiB, ~4.9 MB) round-trips: one verdict a line back, every line
    offered and admitted. The server serves the match-all set (the
    engine answers without a scan), so the test holds the message caps
    of both ends, not the plain kernels' speed on the CPU."""
    lines = [b"x" * 4096 for _ in range(1200)]
    lines[500] = b"y" * 2000 + b"ERROR" + b"y" * 2000

    async def scenario():
        server, port = await port_server([""])
        client = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            payload, offsets, _ = frame_lines(lines)
            assert len(payload) > 4 * 1024 * 1024
            got = await client.match_framed(payload, offsets)
            return got, server.capacity.offered, server.capacity.admitted
        finally:
            await client.aclose()
            await server.stop()

    got, offered, admitted = run(scenario())
    assert got.dtype == bool and got.shape == (1200,) and got.all()
    assert offered == admitted == 1200


async def _cli_through(tmp_path, side: str, args: list) -> dict:
    """The side's CLI through the side's filterd (one loop for both, as
    the JAX test runs them): the files it wrote."""
    pats = [a for i, a in enumerate(args) if i and args[i - 1] == "--match"]
    excl = [a for i, a in enumerate(args) if i and args[i - 1] == "--exclude"]
    ic = "-I" in args
    if side == "jax":
        server = jax_server.FilterServer(pats, backend="cpu", port=0,
                                         ignore_case=ic, exclude=excl)
    else:
        server = FilterServer(pats, port=0, device="cpu", ignore_case=ic,
                              exclude=excl)
    port = await server.start()
    out_dir = tmp_path / side
    argv = ["-n", "default", "-a", "-p", str(out_dir), *args,
            "--remote", f"127.0.0.1:{port}"]
    long_line = b"q" * 7000 + b" WARN deep 9 " + b"r" * 100 + b"\n"
    try:
        if side == "jax":
            fc = JaxFakeCluster.synthetic(n_pods=3, n_containers=1,
                                          lines_per_container=60,
                                          clock=lambda: CLOCK)
            coro = jax_app.run_async(jax_parse_args(argv), backend=fc)
        else:
            fc = FakeCluster.synthetic(n_pods=3, n_containers=1,
                                       lines_per_container=60,
                                       clock=lambda: CLOCK)
            # device=None: a --remote collector needs no card.
            coro = app.run_async(cli.parse_args(argv), backend=fc)
        fc.namespaces["default"]["pod-0001"].containers["c0"].lines.insert(
            7, (CLOCK - 70, long_line))
        assert await coro == 0
    finally:
        await server.stop()
    return {f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("args", [
    ["--match", "INFO", "--match", r"WARN.*\d"],
    ["--match", "error", "-I", "--exclude", "v2"],
], ids=["match", "ignore_case_exclude"])
def test_cli_through_remote_equals_jax_cli_through_jax_filterd(tmp_path,
                                                                args):
    outs = {side: run(_cli_through(tmp_path, side, args))
            for side in ("jax", "port")}
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == 3 and any(outs["port"].values())
    if "-I" not in args:
        assert b" WARN deep 9 " in outs["port"]["pod-0001__c0.log"]


def test_cli_remote_pattern_mismatch_aborts_with_one_line(tmp_path, capsys):
    async def scenario():
        server, port = await port_server(["OTHER"])
        try:
            opts = cli.parse_args(["-n", "default", "-a", "-p",
                                   str(tmp_path / "x"), "--match", "INFO",
                                   "--remote", f"127.0.0.1:{port}"])
            with pytest.raises(PatternMismatch):
                await app.run_async(opts,
                                    backend=FakeCluster.synthetic(n_pods=1))
        finally:
            await server.stop()

    run(scenario())
    assert not (tmp_path / "x").exists() or not os.listdir(tmp_path / "x")


def test_cli_main_maps_remote_errors_to_one_line(tmp_path, capsys,
                                                 monkeypatch):
    """``cli.main`` turns PatternMismatch and ServiceConfigError into
    one line and exit 1, as the JAX CLI does."""
    monkeypatch.setenv("KLOGS_FAKE_PODS", "1")
    loop = asyncio.new_event_loop()
    server, port = loop.run_until_complete(port_server(["OTHER"]))
    try:
        for argv, want in (
                (["--remote", f"127.0.0.1:{port}", "--match", "INFO"],
                 "serves patterns"),
                (["--remote", "127.0.0.1:notaport", "--match", "INFO"],
                 "malformed --remote endpoint")):
            box: dict = {}
            th = threading.Thread(target=lambda: box.update(rc=cli.main(
                ["-a", "--cluster", "fake", "-p", str(tmp_path / "o"),
                 *argv])))
            capsys.readouterr()
            th.start()
            while th.is_alive():
                loop.run_until_complete(asyncio.sleep(0.01))
            out = capsys.readouterr().out
            assert box["rc"] == 1
            errs = [ln for ln in out.splitlines() if "ERROR" in ln]
            assert len(errs) == 1 and want in errs[0], out
            assert "Traceback" not in out
    finally:
        loop.run_until_complete(server.stop())
        loop.close()


def test_clean_shutdown_no_destroyed_tasks():
    import warnings

    async def fn(client, _):
        await client.match([b"one ERROR", b"fine"])
        payload, offsets, _ = frame_lines([b"x ERROR"])
        await client.match_framed(payload, offsets)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loop = asyncio.new_event_loop()
        loop.set_debug(True)
        try:
            loop.run_until_complete(with_server(fn))
        finally:
            loop.close()
    msgs = [str(w.message) for w in caught]
    assert not any("Task was destroyed" in m for m in msgs), msgs


def test_bearer_auth_enforced():
    async def scenario():
        server, port = await port_server(auth_token="s3cret")
        good = RemoteFilterClient(f"127.0.0.1:{port}", auth_token="s3cret")
        bad = RemoteFilterClient(f"127.0.0.1:{port}")
        wrong = RemoteFilterClient(f"127.0.0.1:{port}", auth_token="nope")
        try:
            assert await good.match([b"an ERROR", b"fine"]) == [True, False]
            for c in (bad, wrong):
                with pytest.raises(ClusterError, match="UNAUTHENTICATED"):
                    await c.match([b"x"])
        finally:
            for c in (good, bad, wrong):
                await c.aclose()
            await server.stop()

    run(scenario())


def test_bearer_token_rotation_survives(tmp_path):
    tok = tmp_path / "token"
    tok.write_text("v1\n")

    async def scenario():
        server, port = await port_server(auth_token_file=str(tok))
        client = RemoteFilterClient(f"127.0.0.1:{port}",
                                    auth_token_file=str(tok))
        try:
            assert await client.match([b"ERROR"]) == [True]
            tok.write_text("v2\n")
            assert await client.match([b"ERROR again"]) == [True]
        finally:
            await client.aclose()
            await server.stop()

    run(scenario())


def test_tls_round_trip(certs):
    key, crt = certs["srv"]

    async def scenario():
        server = FilterServer(PATTERNS, port=0, device="cpu",
                              host="localhost", tls_cert=crt, tls_key=key)
        port = await server.start()
        tls = RemoteFilterClient(f"localhost:{port}", tls_ca=crt)
        plain = RemoteFilterClient(f"localhost:{port}")
        try:
            assert await tls.match([b"ERROR!", b"ok"]) == [True, False]
            assert (await tls.hello())["patterns"] == PATTERNS
            with pytest.raises(ClusterError):
                await asyncio.wait_for(plain.match([b"x"]), timeout=5)
        finally:
            await tls.aclose()
            await plain.aclose()
            await server.stop()

    run(scenario())


def test_mtls_requires_client_cert(certs):
    skey, scrt = certs["srv"]
    ckey, ccrt = certs["cli"]

    async def scenario():
        server = FilterServer(PATTERNS, port=0, device="cpu",
                              host="localhost", tls_cert=scrt, tls_key=skey,
                              tls_client_ca=ccrt)
        port = await server.start()
        with_cert = RemoteFilterClient(f"localhost:{port}", tls_ca=scrt,
                                       tls_cert=ccrt, tls_key=ckey)
        without = RemoteFilterClient(f"localhost:{port}", tls_ca=scrt)
        try:
            assert await with_cert.match([b"ERROR"]) == [True]
            with pytest.raises(ClusterError):
                await asyncio.wait_for(without.match([b"x"]), timeout=5)
        finally:
            await with_cert.aclose()
            await without.aclose()
            await server.stop()

    run(scenario())


def test_partial_tls_config_is_loud():
    with pytest.raises(ValueError, match="together"):
        FilterServer(PATTERNS, device="cpu", tls_cert="x.crt")
    with pytest.raises(ValueError, match="requires"):
        FilterServer(PATTERNS, device="cpu", tls_client_ca="ca.crt")
    with pytest.raises(ServiceConfigError, match="require tls_ca"):
        RemoteFilterClient("h:1", tls_cert="c.crt", tls_key="c.key")
    with pytest.raises(ServiceConfigError, match="together"):
        RemoteFilterClient("h:1", tls_ca="ca.crt", tls_cert="c.crt")
    with pytest.raises(ServiceConfigError, match="cannot read"):
        RemoteFilterClient("h:1", tls_ca="/nonexistent/ca.crt")
    with pytest.raises(ValueError, match="unknown filter backend"):
        FilterServer(PATTERNS, backend="tpu", device="cpu")


def test_exclude_patterns_over_service():
    async def fn(client, _):
        await client.verify_patterns(["ERROR"], exclude=["healthz"])
        got = await client.match([b"ERROR a", b"ERROR healthz", b"fine"])
        with pytest.raises(PatternMismatch, match="exclude"):
            await client.verify_patterns(["ERROR"], exclude=[])
        return got

    assert run(with_server(fn, ["ERROR"], exclude=["healthz"])) == [
        True, False, False]


def test_exclude_only_service():
    got = run(with_server(lambda c, _: c.match([b"debug x", b"keep me"]),
                          [], exclude=["debug"]))
    assert got == [False, True]


def test_metrics_scrape_on_live_coalesced_server():
    """/metrics on a live filterd serving coalesced framed batches, and
    /healthz against /readyz across the warmup batch."""
    reg = obs.Registry()

    async def scenario():
        server = FilterServer(PATTERNS, port=0, device="cpu",
                              metrics_port=0, registry=reg)
        release = threading.Event()
        engine = server._service._filter
        orig_fetch = engine.fetch_framed
        gated = [True]

        def gated_fetch(handle):
            if gated[0]:
                gated[0] = False
                release.wait(5)
            return orig_fetch(handle)

        engine.fetch_framed = gated_fetch
        port = await server.start()
        mport = server.metrics_port
        clients = []
        try:
            assert (await http_get(mport, "/healthz"))[0] == 200
            assert (await http_get(mport, "/readyz"))[0] == 503
            release.set()
            await asyncio.wait_for(server._warmup_task, 10)
            assert (await http_get(mport, "/readyz"))[0] == 200
            clients = [RemoteFilterClient(f"127.0.0.1:{port}")
                       for _ in range(3)]
            batches = [[b"an ERROR %d" % i, b"fine %d" % i]
                       for i in range(3)]
            results = await asyncio.gather(*[
                c.match_framed(*frame_lines(b)[:2])
                for c, b in zip(clients, batches)])
            for got in results:
                assert got.tolist() == [True, False]
            status, body = await http_get(mport, "/metrics")
            assert status == 200
            return body.decode()
        finally:
            for c in clients:
                await c.aclose()
            await server.stop()

    text = run(scenario())
    for layer in ("klogs_engine_", "klogs_coalescer_", "klogs_sink_",
                  "klogs_fanout_", "klogs_rpc_", "klogs_fleet_"):
        assert layer in text, f"{layer} missing from scrape"
    assert reg.family("klogs_rpc_requests_total").labels(
        method="MatchFramed").value == 3
    assert reg.family("klogs_coalescer_groups_total").value >= 1
    assert reg.family("klogs_engine_device_batch_seconds").count >= 2
    assert reg.family("klogs_fleet_offered_lines_total").value == 6
    assert reg.family("klogs_fleet_admitted_lines_total").value == 6
    assert 'klogs_rpc_requests_total{method="MatchFramed"} 3' in text
    assert "klogs_build_info" in text


class TestClientCloseTask:
    def test_aclose_settles_a_parked_sync_close(self):
        class _FakeChannel:
            def __init__(self):
                self.closes = 0

            async def close(self):
                self.closes += 1

        async def scenario():
            c = object.__new__(RemoteFilterClient)
            c._channel = _FakeChannel()
            c._close_task = None
            c.close()
            assert c._close_task is not None
            await c.aclose()
            assert c._close_task is None
            assert c._channel.closes == 2
            leftovers = [t for t in asyncio.all_tasks()
                         if t is not asyncio.current_task()
                         and not t.done()]
            assert leftovers == []

        asyncio.run(scenario())


class TestServeTeardown:
    """``serve`` stops the bound listener on every exit: a raise after
    ``start`` (the banner) and a cancellation in ``wait``."""

    class _FakeServer:
        def __init__(self, *a, **kw):
            self.stops = 0
            self.tls_cert = None
            self.tls_client_ca = None
            self.auth_enabled = False
            self.host = "127.0.0.1"
            self.metrics_host = "127.0.0.1"
            self.metrics_port = None
            self.backend = "cuda"
            self.patterns = ["x"]

        async def start(self):
            return 50051

        async def stop(self):
            self.stops += 1

        async def wait(self):
            await asyncio.Event().wait()

    def _patch(self, monkeypatch):
        made = []

        def factory(*a, **kw):
            s = self._FakeServer()
            made.append(s)
            return s

        monkeypatch.setattr(server_mod, "FilterServer", factory)
        return made

    def test_banner_raise_stops_server(self, monkeypatch):
        made = self._patch(monkeypatch)

        def boom(*a):
            raise RuntimeError("banner boom")

        monkeypatch.setattr(server_mod, "banner_line", boom)
        with pytest.raises(RuntimeError, match="banner boom"):
            asyncio.run(server_mod.serve(["x"], "cuda", "127.0.0.1", 0))
        assert [s.stops for s in made] == [1]

    def test_cancel_during_wait_stops_server(self, monkeypatch):
        made = self._patch(monkeypatch)

        async def scenario():
            task = asyncio.create_task(
                server_mod.serve(["x"], "cuda", "127.0.0.1", 0))
            await asyncio.sleep(0.05)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

        asyncio.run(asyncio.wait_for(scenario(), timeout=10))
        assert [s.stops for s in made] == [1]


@pytest.mark.parametrize("argv, want", [
    (["--match", "x", "--tls-cert", "a.crt"], "must be provided together"),
    (["--match", "x", "--tls-client-ca", "ca.crt"], "requires tls_cert"),
    ([], "need at least one --match or --exclude pattern"),
], ids=["partial_tls", "client_ca_alone", "no_patterns"])
def test_filterd_main_errors_equal_jax(argv, want, capsys, monkeypatch):
    """``python -m klogs_tpu_torch.service`` prints the JAX filterd's
    one line and exits 1 on a bad configuration (checked before the
    engine, so without a card too)."""
    import sys

    from klogs_tpu.service import __main__ as jax_main
    from klogs_tpu_torch.service import __main__ as port_main

    lines = []
    for main, args in ((port_main.main, (argv,)), (jax_main.main, ())):
        monkeypatch.setattr(sys, "argv", ["klogs-filterd", *argv])
        capsys.readouterr()
        with pytest.raises(SystemExit) as ei:
            main(*args)
        assert ei.value.code == 1
        lines.append(capsys.readouterr().err.strip())
    assert lines[0] == lines[1] and want in lines[0]


# ---- resilience ----------------------------------------------------------

def test_rpc_flake_retried_transparently_with_metrics():
    registry = obs.Registry()
    obs.register_all(registry)
    FAULTS.bind_registry(registry)
    lines = [b"an ERROR here", b"all good", b"ERROR again"]

    async def scenario():
        server, port = await port_server(["ERROR"])
        client = RemoteFilterClient(f"127.0.0.1:{port}", retry=FAST,
                                    registry=registry)
        try:
            FAULTS.arm("rpc.match", times=2, exc=InjectedFault("flake"))
            return await client.match(lines), port
        finally:
            await client.aclose()
            await server.stop()

    got, port = run(scenario(), 30)
    assert got == [True, False, True]
    text = obs.render(registry)
    assert (f'klogs_retry_attempts_total{{site="rpc@127.0.0.1:{port}"}} 2'
            in text), text
    assert 'klogs_faults_injected_total{point="rpc.match"} 2' in text


def test_fault_target_fires_only_for_its_endpoint():
    """``rpc.hello@host:port`` fires for that endpoint's client alone:
    a clause aimed elsewhere leaves the Hello alone, one aimed here is
    counted under its qualified name and retried."""
    registry = obs.Registry()
    obs.register_all(registry)
    FAULTS.bind_registry(registry)

    async def scenario():
        server, port = await port_server(["ERROR"])
        c = RemoteFilterClient(f"127.0.0.1:{port}", retry=FAST,
                               registry=registry)
        try:
            FAULTS.load_spec("rpc.hello@127.0.0.1:1:error*")
            await c.hello()
            assert FAULTS.counts == {}
            FAULTS.load_spec(f"rpc.hello@127.0.0.1:{port}:error*2")
            info = await c.hello()
            return port, dict(FAULTS.counts), info["patterns"]
        finally:
            await c.aclose()
            await server.stop()

    port, counts, pats = run(scenario(), 30)
    assert counts == {f"rpc.hello@127.0.0.1:{port}": 2}
    assert pats == ["ERROR"]
    assert registry.family("klogs_retry_attempts_total").labels(
        site=f"rpc@127.0.0.1:{port}").value == 2


def test_rpc_dead_filterd_trips_breaker_then_recovers():
    registry = obs.Registry()
    obs.register_all(registry)

    async def scenario():
        server, port = await port_server(["ERROR"])
        breaker = CircuitBreaker("rpc", failure_threshold=2,
                                 reset_timeout_s=0.05, registry=registry)
        client = RemoteFilterClient(
            f"127.0.0.1:{port}",
            retry=RetryPolicy(max_attempts=1, base_s=0.001, max_s=0.001,
                              jitter=0.0),
            breaker=breaker, rpc_timeout_s=5.0, registry=registry)
        try:
            await client.hello()
            FAULTS.arm("rpc.match", times=None, exc=InjectedFault("down"))
            for _ in range(2):
                with pytest.raises(Unavailable):
                    await client.match([b"x"])
            assert breaker.state_name == "open"
            with pytest.raises(BreakerOpen):
                await client.match([b"x"])
            FAULTS.clear()
            await asyncio.sleep(0.06)
            got = await client.match([b"an ERROR", b"fine"])
            assert breaker.state_name == "closed"
            return got
        finally:
            await client.aclose()
            await server.stop()

    assert run(scenario(), 30) == [True, False]


def test_exhausted_rpc_unavailable_is_one_line():
    async def scenario():
        port = await dead_port()
        client = RemoteFilterClient(
            f"127.0.0.1:{port}",
            retry=RetryPolicy(max_attempts=2, base_s=0.001, max_s=0.002,
                              jitter=0.0),
            rpc_timeout_s=5.0)
        try:
            with pytest.raises(Unavailable) as ei:
                await client.match([b"x"])
            msg = str(ei.value)
            assert "UNAVAILABLE" in msg and f"127.0.0.1:{port}" in msg
            assert "\n" not in msg and "debug_error_string" not in msg
        finally:
            await client.aclose()

    run(scenario(), 30)


# A first flush at 8192 lines (the port's BATCH_LINES), then the rest
# and an unterminated tail at close.
DEGRADE_CHUNKS = [
    b"".join(b"line %d %s\n" % (i, b"ERROR" if i % 5 == 0 else b"ok")
             for i in range(9000)),
    b"".join(b"more %d %s\n" % (i, b"ERROR" if i % 3 == 0 else b"ok")
             for i in range(40)) + b"tail ERROR",
]


def _degraded_counts(registry) -> dict:
    out = {}
    for fam in ("klogs_filter_degraded_batches_total",
                "klogs_filter_degraded_lines_total"):
        for action in ("pass", "drop", "abort"):
            out[(fam, action)] = registry.family(fam).labels(
                action=action).value
    return out


@pytest.mark.parametrize("action", ["pass", "drop", "abort"])
def test_on_filter_error_against_a_dead_endpoint_equals_jax(tmp_path,
                                                             action):
    """The port's FilteredSink and the JAX one, each with its own client
    of a dead filterd, on the same chunks: the same bytes written, the
    same degraded counts, and under ``abort`` the same error at the
    first flush with the file released."""
    async def drive(side, port):
        path = str(tmp_path / f"{side}.log")
        if side == "jax":
            stats = JaxFilterStats()
            c = jax_client.RemoteFilterClient(
                f"127.0.0.1:{port}", rpc_timeout_s=5.0,
                retry=JaxRetryPolicy(max_attempts=2, base_s=0.001,
                                     max_s=0.002, jitter=0.0))
            s = jax_sink.FilteredSink(JaxFileSink(path), None, stats,
                                      batch_lines=8192, deadline_s=60.0,
                                      service=c, on_filter_error=action)
        else:
            stats = FilterStats()
            c = RemoteFilterClient(
                f"127.0.0.1:{port}", rpc_timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_s=0.001,
                                  max_s=0.002, jitter=0.0))
            s = sink.FilteredSink(FileSink(path), c, stats, deadline_s=60.0,
                                  on_filter_error=action)
        errors = []
        try:
            for chunk in DEGRADE_CHUNKS:
                try:
                    await s.write(chunk)
                except Exception as e:  # noqa: BLE001 - each package's type
                    errors.append(type(e).__name__)
                    break
            try:
                await s.close()
            except Exception as e:  # noqa: BLE001 - the JAX type differs
                errors.append(type(e).__name__)
        finally:
            await c.aclose()
        with open(path, "rb") as f:
            return f.read(), _degraded_counts(stats.registry), errors

    async def scenario():
        port = await dead_port()
        return {side: await drive(side, port) for side in ("jax", "port")}

    got = run(scenario(), 60)
    assert got["port"][:2] == got["jax"][:2]
    data, counts, errors = got["port"]
    if action == "pass":
        assert data == b"".join(DEGRADE_CHUNKS)
        assert counts[("klogs_filter_degraded_lines_total", "pass")] == 9041
        assert counts[("klogs_filter_degraded_batches_total", "pass")] == 2
    elif action == "drop":
        assert data == b""
        assert counts[("klogs_filter_degraded_lines_total", "drop")] == 9041
    else:
        assert data == b"" and not any(counts.values())
        assert errors == got["jax"][2] == ["Unavailable"]


def test_degrade_pass_recovers_when_the_service_returns(tmp_path, capsys):
    """Against a live filterd with two injected fault stretches: the
    degraded batch is written unfiltered once, the warning and the
    recovery line print, and later batches are filtered again."""
    async def scenario():
        server, port = await port_server(["ERROR"])
        stats = FilterStats()
        c = RemoteFilterClient(f"127.0.0.1:{port}", retry=RetryPolicy(
            max_attempts=1, base_s=0.001, max_s=0.001, jitter=0.0))
        s = sink.FilteredSink(FileSink(str(tmp_path / "o.log")), c, stats,
                              deadline_s=0.0, on_filter_error="pass")
        try:
            await c.hello()
            FAULTS.arm("rpc.match", times=1, exc=InjectedFault("down"))
            await s.write(b"one ERROR a\ntwo ok b\n")
            await s.write(b"three ERROR c\nfour ok d\n")
            await s.close()
        finally:
            await c.aclose()
            await server.stop()
        return _degraded_counts(stats.registry)

    counts = run(scenario(), 30)
    data = (tmp_path / "o.log").read_bytes()
    assert data == b"one ERROR a\ntwo ok b\nthree ERROR c\n"
    assert counts[("klogs_filter_degraded_lines_total", "pass")] == 2
    out = capsys.readouterr().out
    assert "UNFILTERED" in out and "recovered" in out


def test_flusher_escalates_abort_and_sets_stop(tmp_path):
    """Follow mode: with ``--on-filter-error=abort`` an idle stream's
    stale flush against a dead filterd stops the run and raises."""
    async def scenario(action):
        port = await dead_port()
        c = RemoteFilterClient(f"127.0.0.1:{port}", retry=RetryPolicy(
            max_attempts=1, base_s=0.001, max_s=0.001, jitter=0.0))
        pipe = sink.FilterPipeline(log_filter=None, stats=FilterStats(),
                                   service=c, deadline_s=0.01,
                                   on_filter_error=action)
        s = pipe.sink_factory(StreamJob("p", "c", False,
                                        str(tmp_path / f"{action}.log")))
        stop = asyncio.Event()
        flusher = asyncio.create_task(pipe.run_deadline_flusher(stop))
        try:
            await s.write(b"pending line\n")
            if action == "abort":
                await asyncio.wait_for(stop.wait(), timeout=10)
                with pytest.raises(Unavailable):
                    await flusher
            else:
                for _ in range(500):
                    if pipe.stats.degraded_lines:
                        break
                    await asyncio.sleep(0.01)
                assert not stop.is_set()
                flusher.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await flusher
        finally:
            await s.close()
            await pipe.aclose()

    run(scenario("abort"), 30)
    run(scenario("pass"), 30)
    assert (tmp_path / "pass.log").read_bytes() == b"pending line\n"


def test_remote_timeout_env_rejects_nonpositive(monkeypatch):
    for bad in ("0", "-5", "abc"):
        monkeypatch.setenv("KLOGS_REMOTE_TIMEOUT_S", bad)
        with pytest.raises(ServiceConfigError,
                           match="KLOGS_REMOTE_TIMEOUT_S"):
            sink.make_pipeline(["x"], remote="127.0.0.1:1")


def test_make_pipeline_remote_builds_no_engine(capsys, monkeypatch):
    """A --remote pipeline is a client and no engine (``device`` None
    and no card here), warns about a fault clause aimed elsewhere, and
    refuses a list with the port's one line."""
    FAULTS.load_spec("rpc.match@127.0.0.1:2:error*")

    async def scenario():
        pipe = sink.make_pipeline(["x"], remote="127.0.0.1:1",
                                  on_filter_error="drop")
        try:
            assert pipe.log_filter is None
            assert isinstance(pipe.service, RemoteFilterClient)
            assert pipe.on_filter_error == "drop"
            assert pipe.patterns == ["x"]
        finally:
            await pipe.aclose()

    run(scenario())
    assert "127.0.0.1:2 not in the --remote list" in capsys.readouterr().out
    with pytest.raises(ServiceConfigError, match="not ported yet"):
        sink.make_pipeline(["x"], remote="127.0.0.1:1,127.0.0.1:2")
    with pytest.raises(ServiceConfigError, match="bad port"):
        sink.make_pipeline(["x"], remote="127.0.0.1:0")


# ---- FleetCapacity -------------------------------------------------------

def test_fleet_capacity_equals_jax(monkeypatch):
    """One offered/admitted sequence under one fake clock: the same doc
    at every read, with an envelope from the constructor and from
    ``KLOGS_FLEET_CAPACITY_LPS``, and with none (the port never reads
    the TPU's operating point: None where JAX has its file)."""
    import types

    now = [1000.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0],
                                  perf_counter=time.perf_counter,
                                  time=time.time)
    for mod in (profiler, jax_profiler):
        monkeypatch.setattr(mod, "time", clock)
    rng = random.Random(5)
    steps = [(rng.randrange(0, 5000), rng.randrange(0, 5000),
              rng.choice([0.1, 0.3, 0.6, 2.0, 7.5])) for _ in range(60)]

    def sequence(mod, **kw):
        cap = mod.FleetCapacity(profiler=mod.PipelineProfiler(), **kw)
        docs = []
        for off, adm, dt in steps:
            cap.note_offered(off)
            cap.note_admitted(min(adm, off))
            now[0] += dt
            docs.append(cap.doc())
        return docs

    now[0] = 1000.0
    got = sequence(profiler, envelope_lps=40000.0)
    now[0] = 1000.0
    assert got == sequence(jax_profiler, envelope_lps=40000.0)
    assert any(0 < d["headroom"] < 1 for d in got)
    monkeypatch.setenv("KLOGS_FLEET_CAPACITY_LPS", "25000")
    now[0] = 1000.0
    got = sequence(profiler)
    now[0] = 1000.0
    assert got == sequence(jax_profiler)
    monkeypatch.delenv("KLOGS_FLEET_CAPACITY_LPS")
    now[0] = 1000.0
    got = sequence(profiler)
    assert all(d["headroom"] is None for d in got)
    assert profiler._operating_point_lps() is None


def test_fleet_capacity_headroom_from_the_profiler():
    """Without an envelope the headroom is 1 - the profiler's peak stage
    utilization, as in JAX; the profiler's tick carries the attached
    capacity block."""
    prof = profiler.PipelineProfiler()
    prof.enable(1.0)
    try:
        cap = profiler.FleetCapacity(profiler=prof)
        assert cap.headroom() is None
        prof._util = {"rpc.server": 0.25, "device.fetch": 0.5}
        assert cap.headroom() == 0.5
        prof._util = {"coalescer.dispatch": 3.0}
        assert cap.headroom() == 0.0
        prof.attach_capacity(cap)
        cap.note_offered(10)
        cap.note_admitted(10)
        doc = prof.tick(io=False)
        assert doc["capacity"]["offered_lines"] == 10
        assert doc["capacity"]["admitted_lines"] == 10
    finally:
        prof.reset()
