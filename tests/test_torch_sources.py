"""The port's sources (``klogs_tpu_torch/sources/``) against the JAX
package's, on the same files and seeds: archive grouping and slab
streams, the named errors of damaged archives, zstd, the replay
lifecycle (batch, rotation, copytruncate, resume), the socket listener,
``make_source``, ``plan_source_jobs`` and ``ClusterSource``.

Where the JAX package breaks its own contract the port is held to the
contract instead: a truncated zstd frame raises ``SourceError`` (JAX's
reader ends quietly), and ``SocketSource.close()`` returns with a peer
still connected (JAX's waits for the peers first and hangs)."""

import asyncio
import gzip
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from klogs_tpu.cluster.types import LogOptions as JaxLogOptions
from klogs_tpu.runtime import fanout as jax_fanout
from klogs_tpu.sources import archive as jax_archive
from klogs_tpu.sources import base as jax_base
from klogs_tpu.sources import make_source as jax_make_source
from klogs_tpu.sources import replay as jax_replay
from klogs_tpu.sources import socket as jax_socket
from klogs_tpu.sources.cluster import ClusterSource as JaxClusterSource
from klogs_tpu_torch import cli
from klogs_tpu_torch.cluster.backend import LogStream, StreamError
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.runtime import fanout
from klogs_tpu_torch.sources import (
    SourceConfigError,
    SourceError,
    SourceStream,
    make_source,
)
from klogs_tpu_torch.sources import archive, base, replay, socket
from klogs_tpu_torch.sources.cluster import ClusterSource

SEED = 20261017

SIDES = {
    "jax": SimpleNamespace(archive=jax_archive, base=jax_base,
                           replay=jax_replay, socket=jax_socket,
                           fanout=jax_fanout, opts=JaxLogOptions,
                           metrics=lambda: {"metrics":
                                            jax_archive.ArchiveSource(
                                                []).metrics}),
    "torch": SimpleNamespace(archive=archive, base=base, replay=replay,
                             socket=socket, fanout=fanout, opts=LogOptions,
                             metrics=dict),
}


def run(coro, timeout=20):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _collect(stream) -> bytes:
    return b"".join(await _slabs(stream))


async def _slabs(stream) -> list:
    out = []
    async for chunk in stream:
        out.append(chunk)
    await stream.close()
    return out


def _archive_stream(side: str, paths: list, **kw):
    s = SIDES[side]
    ref = s.base.SourceRef(kind="archive", group="g", unit="archive")
    return s.archive.ArchiveStream(ref, paths, **s.metrics(), **kw)


def _lines(rng, n: int, tag: bytes = b"") -> list:
    lens = rng.integers(1, 90, size=n)
    return [tag + b"line %06d " % i + b"x" * int(k) + b"\n"
            for i, k in enumerate(lens)]


# ---- archive: grouping and slab streams --------------------------------


@pytest.mark.parametrize("files", [
    ["d/app.log", "d/app.log.1.gz", "d/app.log.10.gz", "d/app.log.2.gz",
     "d/other.log.1", "d/other.log"],
    ["x/a.log.3.zst", "x/a.log.1.zstd", "x/a.log", "x/b.log.2.gz",
     "x/c", "x/c.7"],
    ["only.log.5.gz", "only.log.12.gz", "only.log.5"],
    [],
], ids=["gz", "zstd_plain", "numbered_only", "empty"])
def test_group_archives_equal_jax(files):
    assert archive.group_archives(files) == jax_archive.group_archives(files)
    for f in files:
        assert archive.strip_compress_ext(f) == \
            jax_archive.strip_compress_ext(f)


def _rotated_set(d, rng, n: int, compress: bool) -> bytes:
    """app.log.2[.gz] (two gzip members), app.log.1[.gz], app.log; the
    bytes a live follow of the unrotated file would give."""
    lines = _lines(rng, n)
    lines[n // 2] = b"L" * 3000 + b"\n"  # carried across slabs
    third = n // 3
    parts = [b"".join(lines[:third]), b"".join(lines[third:2 * third]),
             b"".join(lines[2 * third:])]
    if compress:
        half = len(parts[0]) // 2
        (d / "app.log.2.gz").write_bytes(gzip.compress(parts[0][:half])
                                         + gzip.compress(parts[0][half:]))
        (d / "app.log.1.gz").write_bytes(gzip.compress(parts[1]))
    else:
        (d / "app.log.2").write_bytes(parts[0])
        (d / "app.log.1").write_bytes(parts[1])
    (d / "app.log").write_bytes(parts[2])
    return b"".join(parts)


@pytest.mark.parametrize("compress", [True, False], ids=["gzip", "plain"])
@pytest.mark.parametrize("slab", [1024, 1 << 20])
def test_archive_stream_slabs_equal_jax(tmp_path, compress, slab):
    """The same slabs, slab for slab, from a rotated set (multi-member
    gzip or plain): every slab but the last ends on a newline."""
    plain = _rotated_set(tmp_path, np.random.default_rng(SEED), 900,
                         compress)
    files = sorted(str(p) for p in tmp_path.iterdir())
    members = archive.group_archives(files)[str(tmp_path / "app.log")]
    got = {side: run(_slabs(_archive_stream(side, members,
                                            slab_bytes=slab)))
           for side in SIDES}
    assert got["torch"] == got["jax"]
    assert b"".join(got["torch"]) == plain
    assert all(s.endswith(b"\n") for s in got["torch"][:-1])


def test_multi_producer_streams_equal_jax(tmp_path):
    """Four sets read at once (four producer threads, small read-ahead
    queues) give each set's bytes, as JAX's do."""
    rng = np.random.default_rng(SEED + 1)
    sets = []
    for k in range(4):
        plain = b"".join(_lines(rng, 1500, b"set%d " % k))
        p = tmp_path / f"app{k}.log.1.gz"
        p.write_bytes(gzip.compress(plain[:4000]) + gzip.compress(plain[4000:]))
        sets.append((str(p), plain))

    async def scenario(side):
        return await asyncio.gather(*(_collect(_archive_stream(
            side, [p], slab_bytes=2048, readahead_slabs=2)) for p, _ in sets))

    for side in SIDES:
        assert run(scenario(side)) == [plain for _, plain in sets]


def _damaged(tmp_path, kind: str) -> str:
    whole = gzip.compress(b"".join(b"line %d\n" % i for i in range(20000)))
    p = tmp_path / f"{kind}.log.1.gz"
    if kind == "truncated":
        p.write_bytes(whole[: len(whole) // 2])
    elif kind == "truncated_second_member":
        second = gzip.compress(b"tail line\n" * 3000)
        p.write_bytes(whole + second[: len(second) // 2])
    else:
        blob = bytearray(whole)
        blob[len(blob) // 2] ^= 0xFF
        p.write_bytes(bytes(blob))
    return str(p)


@pytest.mark.parametrize("kind", ["truncated", "truncated_second_member",
                                  "corrupt"])
def test_damaged_gzip_raises_the_same_named_error(tmp_path, kind):
    path = _damaged(tmp_path, kind)
    errs = {}
    for side in SIDES:
        with pytest.raises(SIDES[side].base.SourceError) as ei:
            run(_collect(_archive_stream(side, [path], slab_bytes=4096)))
        errs[side] = (str(ei.value), ei.value.path, ei.value.offset)
    assert errs["torch"] == errs["jax"]
    assert errs["torch"][1] == path and isinstance(errs["torch"][2], int)
    if kind == "truncated_second_member":
        assert errs["torch"][2] > 0  # the second member's start


def test_zstd_multi_frame_equals_jax(tmp_path):
    zstandard = pytest.importorskip("zstandard")
    plain = b"".join(_lines(np.random.default_rng(SEED + 2), 3000))
    cctx = zstandard.ZstdCompressor()
    p = tmp_path / "app.log.1.zst"
    p.write_bytes(cctx.compress(plain[:5000]) + cctx.compress(plain[5000:9000])
                  + cctx.compress(plain[9000:]))
    got = {side: run(_collect(_archive_stream(side, [str(p)],
                                              slab_bytes=1024)))
           for side in SIDES}
    assert got["torch"] == got["jax"] == plain


@pytest.mark.parametrize("where", ["first_frame", "second_frame"])
def test_truncated_zstd_frame_raises_named_source_error(tmp_path, where):
    """The module's contract (JAX's reader ends quietly here): a frame
    cut short raises SourceError with the path and the offset where
    decoding stopped."""
    zstandard = pytest.importorskip("zstandard")
    cctx = zstandard.ZstdCompressor()
    first = cctx.compress(b"".join(b"line %d\n" % i for i in range(5000)))
    second = cctx.compress(b"".join(b"more %d\n" % i for i in range(5000)))
    p = tmp_path / "cut.log.1.zst"
    if where == "first_frame":
        p.write_bytes(first[: len(first) // 2])
    else:
        p.write_bytes(first + second[: len(second) // 2])
    with pytest.raises(SourceError) as ei:
        run(_collect(_archive_stream("torch", [str(p)])))
    assert ei.value.path == str(p)
    # As for gzip: the compressed byte where decoding stopped.
    assert ei.value.offset == p.stat().st_size
    assert "truncated zstd" in str(ei.value)


def test_zstd_refused_without_zstandard(tmp_path, monkeypatch):
    """With the package hidden, both refuse with SourceConfigError and
    the same message."""
    p = tmp_path / "app.log.1.zst"
    p.write_bytes(b"\x28\xb5\x2f\xfd")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    msgs = {}
    for side in SIDES:
        with pytest.raises(SIDES[side].base.SourceConfigError) as ei:
            run(_collect(_archive_stream(side, [str(p)])))
        msgs[side] = (str(ei.value), ei.value.path)
    assert msgs["torch"] == msgs["jax"]
    assert "zstandard" in msgs["torch"][0]


def test_archive_close_joins_producer_thread(tmp_path):
    p = tmp_path / "big.log.1.gz"
    p.write_bytes(gzip.compress(b"".join(b"line %d\n" % i
                                         for i in range(200000))))
    stream = _archive_stream("torch", [str(p)], slab_bytes=4096,
                             readahead_slabs=2)

    async def scenario():
        async for _ in stream:
            break  # one slab, then abandon the archive
        await stream.close()
        assert stream._thread is not None and not stream._thread.is_alive()

    run(scenario())


@pytest.mark.parametrize("side", list(SIDES))
def test_archive_discover_equals_jax(tmp_path, side):
    """Sets found under a directory: the same refs and members (the
    paths under the directory are the same on both sides)."""
    rng = np.random.default_rng(SEED + 3)
    for name in ("web.log", "db.log"):
        d = tmp_path / name
        d.mkdir()
        _rotated_set(d, rng, 60, compress=True)
    (tmp_path / "lone.log.3.gz").write_bytes(gzip.compress(b"x\n"))
    paths = [str(tmp_path / "web.log"), str(tmp_path / "db.log"),
             str(tmp_path / "*.gz")]

    async def refs(mod):
        src = mod.ArchiveSource(paths)
        got = await src.discover()
        return [(r.kind, r.group, r.unit, r.target, r.ephemeral)
                for r in got], src._members

    assert run(refs(archive)) == run(refs(SIDES[side].archive))
    with pytest.raises(SourceError, match="no archive files"):
        run(archive.ArchiveSource([str(tmp_path / "nothing")]).discover())


# ---- replay: batch, rotation, copytruncate, resume ---------------------


def _replay_source(side: str, paths: list, **kw):
    kw.setdefault("poll_interval_s", 0.01)
    return SIDES[side].replay.ReplaySource([str(p) for p in paths], **kw)


def test_replay_batch_chunks_equal_jax(tmp_path):
    p = tmp_path / "a.log"
    body = b"".join(_lines(np.random.default_rng(SEED + 4), 500)) + b"partial"
    p.write_bytes(body)

    async def scenario(side):
        src = _replay_source(side, [p], read_size=256)
        refs = await src.discover()
        return await _slabs(await src.open_stream(
            refs[0], SIDES[side].opts(follow=False)))

    got = {side: run(scenario(side)) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert b"".join(got["torch"]) == body
    assert all(c.endswith(b"\n") for c in got["torch"][:-1])


async def _rotation(side: str, d, copytruncate: bool) -> bytes:
    p = d / "app.log"
    p.write_bytes(b"".join(b"old %03d\n" % i for i in range(50)))
    src = _replay_source(side, [p], read_size=128)
    refs = await src.discover()
    stream = await src.open_stream(refs[0], SIDES[side].opts(follow=True))
    got = bytearray()
    it = stream.__aiter__()
    while b"old 049\n" not in got:
        got += await it.__anext__()
    if copytruncate:
        p.write_bytes(b"")  # same inode, size below the position
        with open(p, "ab") as f:
            f.write(b"".join(b"new %03d\n" % i for i in range(20)))
    else:
        # logrotate's move: a straggler the reader has not seen, the
        # rename, then the successor.
        with open(p, "ab") as f:
            f.write(b"straggler\n")
        os.rename(p, d / "app.log.1")
        p.write_bytes(b"".join(b"new %03d\n" % i for i in range(20)))
    while b"new 019\n" not in got:
        got += await it.__anext__()
    await stream.close()
    return bytes(got)


@pytest.mark.parametrize("copytruncate", [False, True],
                         ids=["rename", "copytruncate"])
def test_replay_rotation_equals_jax(tmp_path, copytruncate):
    got = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        got[side] = run(_rotation(side, d, copytruncate))
    assert got["torch"] == got["jax"]
    old = b"".join(b"old %03d\n" % i for i in range(50))
    new = b"".join(b"new %03d\n" % i for i in range(20))
    assert got["torch"] == old + (b"" if copytruncate else b"straggler\n") + new


def test_replay_resume_equals_jax(tmp_path):
    """A re-open resumes at the last delivered line: only the partial
    line in flight is served again."""
    async def scenario(side):
        p = tmp_path / f"{side}.log"
        p.write_bytes(b"alpha\nbeta\ngamma")
        src = _replay_source(side, [p])
        refs = await src.discover()
        opts = SIDES[side].opts(follow=False)
        first = await _collect(await src.open_stream(refs[0], opts))
        with open(p, "ab") as f:
            f.write(b"-cont\ndelta\n")
        second = await _collect(await src.open_stream(refs[0], opts))
        return first, second

    got = {side: run(scenario(side)) for side in SIDES}
    assert got["torch"] == got["jax"] == (b"alpha\nbeta\ngamma",
                                          b"gamma-cont\ndelta\n")


def test_replay_discover_and_missing_file_equal_jax(tmp_path):
    """Files, a directory (dot files skipped) and a glob, without
    repeats; two paths that sanitize alike keep distinct groups; a
    missing file outside follow mode is a SourceError."""
    (tmp_path / "d").mkdir()
    for name in ("d/b.log", "d/a.log", "d/.hidden", "x_y.log"):
        (tmp_path / name).write_bytes(b"z\n")
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "y.log").write_bytes(b"z\n")
    specs = [tmp_path / "d", tmp_path / "d" / "a.log", tmp_path / "*.log",
             tmp_path / "x" / "y.log", tmp_path / "missing.log"]

    async def scenario(side):
        src = _replay_source(side, specs)
        refs = await src.discover()
        gone = SIDES[side].base.SourceRef(kind="file", group="g", unit="log",
                                          target=str(tmp_path / "gone.log"))
        with pytest.raises(SIDES[side].base.SourceError) as ei:
            await src.open_stream(gone, SIDES[side].opts(follow=False))
        return [(r.group, r.unit, r.target) for r in refs], str(ei.value)

    got = {side: run(scenario(side)) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == 4


def test_replay_rate_paces_lines(tmp_path):
    p = tmp_path / "a.log"
    p.write_bytes(b"".join(b"l %d\n" % i for i in range(40)))

    async def scenario():
        src = _replay_source("torch", [p], rate_lps=200.0, read_size=64)
        refs = await src.discover()
        t0 = asyncio.get_running_loop().time()
        body = await _collect(await src.open_stream(
            refs[0], LogOptions(follow=False)))
        return body, asyncio.get_running_loop().time() - t0

    body, seconds = run(scenario())
    assert body == p.read_bytes()
    assert seconds >= 0.15  # 40 lines at 200/s, less the first slab's


def test_replay_open_failure_does_not_leak_fd(tmp_path, monkeypatch):
    import builtins

    path = tmp_path / "a.log"
    path.write_bytes(b"hello\n")
    ref = base.SourceRef(kind="file", group="g", unit="log",
                         target=str(path))
    stream = replay.ReplayStream(ref, False, offsets={})
    opened = []
    real_open = builtins.open

    def capture_open(*a, **kw):
        f = real_open(*a, **kw)
        opened.append(f)
        return f

    def raising_fstat(fd):
        raise OSError("injected fstat failure")

    monkeypatch.setattr(builtins, "open", capture_open)
    monkeypatch.setattr(replay.os, "fstat", raising_fstat)
    with pytest.raises(OSError, match="injected"):
        stream._open_file()
    assert len(opened) == 1 and opened[0].closed


# ---- socket: backpressure, UDS, the accept cap -------------------------


@pytest.mark.parametrize("side", list(SIDES))
def test_socket_backpressure_blocks_fast_peer(side):
    """With no reader, a peer pushing ~8 MB stalls in drain(); once the
    stream is read every byte arrives."""
    payload = b"y" * 4096 + b"\n"
    n_chunks = 2000

    async def scenario():
        src = SIDES[side].socket.SocketSource("127.0.0.1:0", max_conns=4)
        await src.start()
        port = src.bound_port()

        async def peer():
            _r, w = await asyncio.open_connection("127.0.0.1", port)
            for _ in range(n_chunks):
                w.write(payload)
                await w.drain()
            w.close()
            await w.wait_closed()

        peer_task = asyncio.create_task(peer())
        await asyncio.sleep(0.2)
        refs = await src.discover()
        assert len(refs) == 1 and refs[0].ephemeral
        assert not peer_task.done(), "the listener buffered without bound"
        got = 0
        async for chunk in await src.open_stream(
                refs[0], SIDES[side].opts(follow=True)):
            got += len(chunk)
        await peer_task
        await src.close()
        return got

    assert run(scenario(), timeout=30) == n_chunks * len(payload)


@pytest.mark.parametrize("side", list(SIDES))
def test_socket_unix_roundtrip(tmp_path, side):
    sock_path = str(tmp_path / f"{side}.sock")

    async def scenario():
        # A stale socket file from an earlier listener is replaced.
        stale = SIDES[side].socket.SocketSource(f"unix:{sock_path}")
        await stale.start()
        stale._server.close()
        await stale._server.wait_closed()
        src = SIDES[side].socket.SocketSource(f"unix:{sock_path}",
                                              max_conns=4)
        await src.start()
        _r, w = await asyncio.open_unix_connection(sock_path)
        w.write(b"hello over uds\n" * 3)
        await w.drain()
        w.close()
        await w.wait_closed()
        await asyncio.sleep(0.05)
        refs = await src.discover()
        assert [(r.group, r.unit, r.ephemeral) for r in refs] == [
            ("conn-0000", "peer", True)]
        data = await _collect(await src.open_stream(
            refs[0], SIDES[side].opts(follow=True)))
        await src.close()
        return data

    assert run(scenario()) == b"hello over uds\n" * 3
    assert not os.path.exists(sock_path)


def test_socket_conn_cap_and_close_with_peers_connected():
    """The over-cap peer reads EOF at once, and close() returns while
    the accepted peer is still connected (JAX's close waits for the
    server before it closes the peers, and never returns)."""
    async def scenario():
        src = socket.SocketSource("127.0.0.1:0", max_conns=1)
        await src.start()
        port = src.bound_port()
        r1, w1 = await asyncio.open_connection("127.0.0.1", port)
        await asyncio.sleep(0.05)
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        assert await r2.read() == b""
        assert len(await src.discover()) == 1
        await asyncio.wait_for(src.close(), 5)
        assert await r1.read() == b""  # the listener hung up on it
        for w in (w1, w2):
            w.close()

    run(scenario())


def test_socket_bad_spec_and_busy_address():
    async def scenario():
        with pytest.raises(SourceError, match="bad socket listen spec"):
            await socket.SocketSource("nohostport").start()
        first = socket.SocketSource("127.0.0.1:0")
        await first.start()
        busy = socket.SocketSource(f"127.0.0.1:{first.bound_port()}")
        with pytest.raises(SourceError, match="cannot listen"):
            await busy.start()
        await first.close()

    run(scenario())


# ---- make_source, plan_source_jobs, ClusterSource ----------------------


@pytest.mark.parametrize("argv", [
    ["--source", "replay:"], ["--source", "replay:,,"],
    ["-f", "--source", "socket:"], ["--source", "ftp://nope"],
], ids=["replay_empty", "replay_commas", "socket_empty", "unknown"])
def test_make_source_messages_equal_jax(argv):
    from klogs_tpu.cli import parse_args as jax_parse_args

    with pytest.raises(SourceConfigError) as mine:
        make_source(cli.parse_args(argv))
    with pytest.raises(jax_base.SourceConfigError) as theirs:
        jax_make_source(jax_parse_args(argv))
    assert str(mine.value) == str(theirs.value)


def test_make_source_kinds_and_knobs(monkeypatch, capsys, tmp_path):
    from klogs_tpu.cli import parse_args as jax_parse_args

    def both(argv):
        return make_source(cli.parse_args(argv)), jax_make_source(
            jax_parse_args(argv))

    assert both(["-a"]) == (None, None)
    monkeypatch.setenv("KLOGS_SOURCE_READAHEAD_MB", "3")
    a, ja = both(["--backfill", str(tmp_path), "x"])
    assert (type(a).__name__, a.paths, a.readahead_slabs) == (
        type(ja).__name__, ja.paths, ja.readahead_slabs) == (
        "ArchiveSource", [str(tmp_path), "x"], 3)
    monkeypatch.setenv("KLOGS_REPLAY_RATE", "250")
    r, jr = both(["--source", "replay:a.log,b.log"])
    assert (r.paths, r.rate_lps) == (jr.paths, jr.rate_lps) == (
        ["a.log", "b.log"], 250.0)
    r, jr = both(["--source", "replay:a.log", "--replay-rate", "5"])
    assert r.rate_lps == jr.rate_lps == 5.0
    monkeypatch.setenv("KLOGS_REPLAY_RATE", "0")
    assert both(["--source", "replay:a.log"])[0].rate_lps is None
    monkeypatch.setenv("KLOGS_REPLAY_RATE", "-1")
    with pytest.raises(ValueError, match="KLOGS_REPLAY_RATE"):
        make_source(cli.parse_args(["--source", "replay:a.log"]))
    capsys.readouterr()
    monkeypatch.setenv("KLOGS_SOCKET_MAX_CONNS", "lots")
    s = make_source(cli.parse_args(["-f", "--source", "socket:h:1"]))
    mine = capsys.readouterr().err
    js = jax_make_source(jax_parse_args(["-f", "--source", "socket:h:1"]))
    assert mine == capsys.readouterr().err != ""
    assert (s.target, s.max_conns) == (js.target, js.max_conns) == ("h:1", 64)


def test_plan_source_jobs_equals_jax(tmp_path):
    refs = [("file", "a_log", "log", "/a.log", False),
            ("file", "b_log", "log", "/b.log", False),
            ("file", "a_log", "log", "/a.log", False),
            ("socket", "conn-0001", "peer", "conn-0001", True),
            ("archive", "a_log", "archive", "/a", False)]
    mine = fanout.plan_source_jobs(
        [base.SourceRef(*r) for r in refs], str(tmp_path))
    theirs = jax_fanout.plan_source_jobs(
        [jax_base.SourceRef(*r) for r in refs], str(tmp_path))

    def key(jobs):
        return [(j.pod, j.container, j.init, j.path, j.ref.group,
                 j.ref.target, j.ref.ephemeral) for j in jobs]

    assert key(mine) == key(theirs)
    assert len(mine) == 4


def test_safe_group_name_equals_jax():
    for path in ("/var/log/app.log", "../x y/z", "///", "a/b.c-d_e", ".x."):
        assert base.safe_group_name(path) == jax_base.safe_group_name(path)


def test_cluster_source_conformance():
    """Over the port's FakeCluster: the adapter's refs and bytes are
    the backend's, as JAX's adapter over JAX's fake gives them."""
    def refs_and_bytes(fc_cls, src_cls, opts_cls):
        fc = fc_cls.synthetic(n_pods=2, n_containers=2,
                              lines_per_container=25,
                              clock=lambda: 1_753_800_000.0)
        src = src_cls(fc, "default")

        async def scenario():
            refs = await src.discover()
            out = {}
            for r in refs:
                opts = opts_cls(follow=False, container=r.unit)
                via = await _collect(await src.open_stream(r, opts))
                direct = await _collect(await fc.open_log_stream(
                    "default", r.group, opts))
                assert via == direct
                out[(r.kind, r.group, r.unit, r.target, r.ephemeral)] = via
            return out

        return run(scenario())

    mine = refs_and_bytes(FakeCluster, ClusterSource, LogOptions)
    assert mine == refs_and_bytes(JaxFakeCluster, JaxClusterSource,
                                  JaxLogOptions)
    assert len(mine) == 4 and all(mine.values())
    assert issubclass(LogStream, SourceStream)
    assert issubclass(StreamError, SourceError)


def test_runner_needs_a_backend_or_a_source():
    with pytest.raises(ValueError, match="backend or a source"):
        fanout.FanoutRunner(None, "local", LogOptions())


def test_ephemeral_peer_ends_without_reconnect(tmp_path, capsys):
    """A socket peer's EOF in follow mode ends its job: no reconnect,
    no premature end, its bytes in its file."""
    async def scenario():
        src = socket.SocketSource("127.0.0.1:0")
        await src.start()
        _r, w = await asyncio.open_connection("127.0.0.1", src.bound_port())
        w.write(b"one\ntwo\n")
        await w.drain()
        w.close()
        await w.wait_closed()
        await asyncio.sleep(0.05)
        jobs = fanout.plan_source_jobs(await src.discover(), str(tmp_path))
        runner = fanout.FanoutRunner(None, "local", LogOptions(follow=True),
                                     source=src)
        results = await runner.run(jobs)
        await src.close()
        return jobs, results

    jobs, results = run(scenario())
    assert len(results) == 1 and results[0].error is None
    assert not results[0].premature_end
    assert open(jobs[0].path, "rb").read() == b"one\ntwo\n"
    assert "reconnecting" not in capsys.readouterr().out


def test_replay_read_error_is_per_stream(tmp_path):
    """Without follow, a stream that fails to open is that job's error
    alone; its sibling's file is whole."""
    (tmp_path / "a.log").write_bytes(b"content\n" * 10)
    out = tmp_path / "out"

    async def scenario():
        src = replay.ReplaySource([str(tmp_path / "a.log")])
        refs = await src.discover()
        refs.append(base.SourceRef(kind="file", group="gone", unit="log",
                                   target=str(tmp_path / "gone.log")))
        jobs = fanout.plan_source_jobs(refs, str(out))
        runner = fanout.FanoutRunner(None, "local", LogOptions(), source=src)
        return await runner.run(jobs)

    results = run(scenario())
    assert [r.error for r in results] == [
        None, f"no such file: {tmp_path / 'gone.log'}"]
    assert open(results[0].job.path, "rb").read() == b"content\n" * 10


def test_gunzip_corrupt_offset_is_the_member_start(tmp_path):
    """Corrupt bytes in the third member: the offset counts the two whole
    members before it (decoding fails within the first read)."""
    m = [gzip.compress(b"m%d\n" % i * 4000) for i in range(3)]
    bad = bytearray(m[2])
    bad[10:14] = b"\xff\xff\xff\xff"
    p = tmp_path / "m.log.1.gz"
    p.write_bytes(m[0] + m[1] + bytes(bad))
    with pytest.raises(SourceError, match="corrupt gzip") as ei:
        run(_collect(_archive_stream("torch", [str(p)])))
    assert ei.value.offset == len(m[0]) + len(m[1])
