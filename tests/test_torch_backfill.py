"""The sources through the port's app, against the JAX app with
``--backend tpu`` (JAX on the CPU) on the same inputs: ``--backfill``
of rotated gzip and plain sets, ``--source replay:`` with and without
``-f`` (a rename rotation mid-run), ``-f --source socket:`` on a Unix
socket, the backfill summary, and the CLI's checks of the three flags.
Every run's files must be byte-identical to JAX's and to a ``re``
oracle's selection. The port runs on device "cpu" (the kernels' plain
versions); long-line batches stay at 8 rows or fewer."""

import asyncio
import gzip
import os
import re

import numpy as np
import pytest
import torch

from klogs_tpu import app as jax_app
from klogs_tpu.cli import main as jax_main
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu_torch import app, cli
from klogs_tpu_torch.ui import term


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEED = 20261017
PATTERNS = ["ERROR", r"code=50[34]", r"retry \d+/\d+", "panic:"]
WORDS = [b"INFO ok", b"ERROR boom", b"code=503", b"code=200", b"retry 2/5",
         b"DEBUG x", b"panic: nil", b"WARN slow"]


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    term.set_colors(False)
    monkeypatch.setenv("KLOGS_WATCH_INTERVAL_S", "0.2")
    yield
    term.set_colors(None)


def log_lines(rng, n: int, tag: str = "") -> list:
    picks = rng.integers(0, len(WORDS), size=n)
    pads = rng.integers(0, 40, size=n)
    return [f"{tag}seq={i:05d} ".encode() + WORDS[w] + b" " + b"p" * int(k)
            + b"\n" for i, (w, k) in enumerate(zip(picks, pads))]


def oracle(lines: list, patterns=PATTERNS) -> bytes:
    union = re.compile("|".join(f"(?:{p})" for p in patterns).encode())
    return b"".join(ln for ln in lines if union.search(ln.rstrip(b"\n")))


def write_set(d, name: str, lines: list, gz: bool) -> None:
    """``name``.2[.gz] (two gzip members), ``name``.1[.gz] and the live
    ``name``: three generations of ``lines``, oldest first."""
    third = len(lines) // 3
    gens = [b"".join(lines[:third]), b"".join(lines[third:2 * third]),
            b"".join(lines[2 * third:])]
    if gz:
        half = len(gens[0]) // 2
        (d / f"{name}.2.gz").write_bytes(
            gzip.compress(gens[0][:half], 1) + gzip.compress(gens[0][half:], 1))
        (d / f"{name}.1.gz").write_bytes(gzip.compress(gens[1], 1))
    else:
        (d / f"{name}.2").write_bytes(gens[0])
        (d / f"{name}.1").write_bytes(gens[1])
    (d / name).write_bytes(gens[2])


def read_all(out_dir) -> dict:
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir))}


async def _drive(side: str, argv: list, during=None):
    """One app run; ``during(stop)`` runs beside it and sets ``stop``
    (follow runs)."""
    stop = asyncio.Event() if during is not None else None
    task = (asyncio.create_task(during(stop)) if during is not None
            else None)
    try:
        if side == "jax":
            opts = jax_parse_args(argv + ["--backend", "tpu"])
            return await jax_app.run_async(opts, stop=stop)
        opts = cli.parse_args(argv + ["--backend", "cuda"])
        return await app.run_async(opts, stop=stop, device="cpu")
    finally:
        if task is not None:
            await task


def run_both(tmp_path, args: list) -> dict:
    """The same run on both sides, output under tmp_path/<side>; the
    inputs' paths are the same on both, so the file names are too."""
    outs = {}
    for side in ("jax", "torch"):
        out_dir = str(tmp_path / side)
        rc = asyncio.run(asyncio.wait_for(
            _drive(side, ["-p", out_dir, *args]), 60))
        assert rc == 0
        outs[side] = read_all(out_dir)
    return outs


def match_args(patterns=PATTERNS) -> list:
    return [a for p in patterns for a in ("--match", p)]


@pytest.fixture
def archive_dir(tmp_path, monkeypatch):
    """Two rotated sets, one gzip and one plain, under ``arch/`` (a
    relative path: the group names are the same on both sides)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(SEED)
    d = tmp_path / "arch"
    d.mkdir()
    sets = {"web.log": log_lines(rng, 900, "web "),
            "db.log": log_lines(rng, 600, "db ")}
    write_set(d, "web.log", sets["web.log"], gz=True)
    write_set(d, "db.log", sets["db.log"], gz=False)
    return sets


@pytest.mark.parametrize("args", [
    match_args(),
    ["--match", "error|PANIC", "-I", "--exclude", "seq=0000"],
    ["--exclude", "INFO|DEBUG"],
    [],
], ids=["match", "ignore_case_exclude", "exclude_only", "unfiltered"])
def test_backfill_files_equal_jax(tmp_path, archive_dir, args):
    outs = run_both(tmp_path, ["--backfill", "arch", *args])
    assert outs["torch"] == outs["jax"]
    assert sorted(outs["torch"]) == ["arch_db.log__archive.log",
                                     "arch_web.log__archive.log"]
    if args == match_args():
        for name, lines in archive_dir.items():
            got = outs["torch"][f"arch_{name}__archive.log"]
            assert got == oracle(lines) and got
    if not args:
        assert outs["torch"]["arch_web.log__archive.log"] == b"".join(
            archive_dir["web.log"])


def test_backfill_long_lines_equal_jax(tmp_path, monkeypatch):
    """Lines over 4 KiB in an archive go through the carried-state
    path on both sides (4 of them: one chunk batch of 4 rows)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(SEED + 1)
    lines = log_lines(rng, 300)
    for j, at in enumerate((20, 150, 151, 290)):
        body = bytes(rng.integers(97, 123, size=5000 + 900 * j,
                                  dtype=np.uint8))
        if j % 2:
            body = body[:2500] + b" code=504 " + body[2500:]
        lines.insert(at, body + b"\n")
    d = tmp_path / "arch"
    d.mkdir()
    write_set(d, "app.log", lines, gz=True)
    outs = run_both(tmp_path, ["--backfill", "arch", *match_args()])
    assert outs["torch"] == outs["jax"]
    got = outs["torch"]["arch_app.log__archive.log"]
    assert got == oracle(lines) and got.count(b"code=504 ") == 2


def summary_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines() if "Backfill" in ln]


@pytest.mark.parametrize("args", [match_args(), match_args() + ["--stats"],
                                  []], ids=["match", "stats", "unfiltered"])
def test_backfill_summary_equals_jax(tmp_path, archive_dir, capsys, args):
    said = {}
    for side in ("jax", "torch"):
        argv = ["-p", str(tmp_path / side), "--backfill", "arch", *args]
        capsys.readouterr()
        assert asyncio.run(_drive(side, argv)) == 0
        text = capsys.readouterr().out
        said[side] = summary_lines(text)
        assert "Found 2 archive stream(s), backfilling" in text
    assert said["torch"] == said["jax"] and len(said["torch"]) == 1


def test_replay_without_follow_equals_jax_and_backfill(tmp_path,
                                                        archive_dir):
    """``--source replay:`` over the live stream, pre-concatenated, writes
    what ``--backfill`` of its rotated set writes."""
    live = tmp_path / "live"
    live.mkdir()
    (live / "web.log").write_bytes(b"".join(archive_dir["web.log"]))
    (live / "db.log").write_bytes(b"".join(archive_dir["db.log"]))
    outs = run_both(tmp_path, ["--source", "replay:live", *match_args()])
    assert outs["torch"] == outs["jax"]
    back = run_both(tmp_path / "b", ["--backfill", "arch", *match_args()])
    assert outs["torch"]["live_web.log__log.log"] == \
        back["torch"]["arch_web.log__archive.log"]
    assert outs["torch"]["live_db.log__log.log"] == \
        back["torch"]["arch_db.log__archive.log"]


def _wait_for(out_dir: str, want: dict, limit: float = 20.0):
    """A coroutine that returns once every file in ``want`` holds its
    bytes (or ``limit`` seconds pass)."""
    async def wait() -> None:
        loop = asyncio.get_running_loop()
        end = loop.time() + limit
        while loop.time() < end:
            try:
                if all(open(os.path.join(out_dir, f), "rb").read() == b
                       for f, b in want.items()):
                    return
            except FileNotFoundError:
                pass
            await asyncio.sleep(0.02)
    return wait()


def test_follow_replay_with_rotation_equals_jax(tmp_path, monkeypatch):
    """``-f --source replay:app.log``: the file is renamed away mid-run
    (a straggler written first) and a new one takes its path; every
    line reaches the output once, then ``stop`` ends the run."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(SEED + 2)
    old, new = log_lines(rng, 400, "old "), log_lines(rng, 300, "new ")
    straggler = [b"straggler ERROR after the last read\n"]
    name = "app.log__log.log"

    async def during(stop, out_dir):
        await _wait_for(out_dir, {name: oracle(old)})
        with open("app.log", "ab") as f:
            f.writelines(straggler)
        os.rename("app.log", "app.log.1")
        with open("app.log", "wb") as f:
            f.writelines(new)
        await _wait_for(out_dir, {name: oracle(old + straggler + new)})
        stop.set()

    outs = {}
    for side in ("jax", "torch"):
        for f in ("app.log", "app.log.1"):
            if os.path.exists(f):
                os.unlink(f)
        (tmp_path / "app.log").write_bytes(b"".join(old))
        out_dir = str(tmp_path / "out" / side)
        argv = ["-p", out_dir, "-f", "--source", "replay:app.log",
                *match_args()]
        rc = asyncio.run(asyncio.wait_for(_drive(
            side, argv, lambda stop, o=out_dir: during(stop, o)), 60))
        assert rc == 0
        outs[side] = read_all(out_dir)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == {name: oracle(old + straggler + new)}


def test_follow_socket_equals_jax(tmp_path, monkeypatch):
    """``-f --source socket:unix:PATH``: three peers, one after another,
    each send their lines and hang up; each peer's file holds its
    selection, and the run ends on ``stop``."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(SEED + 3)
    peers = [log_lines(rng, 500, f"peer{k} ") for k in range(3)]
    want = {f"conn-{k:04d}__peer.log": oracle(p) for k, p in enumerate(peers)}

    def during_for(sock: str):
        async def during(stop, out_dir):
            while not os.path.exists(sock):
                await asyncio.sleep(0.01)
            for lines in peers:
                _r, w = await asyncio.open_unix_connection(sock)
                for i in range(0, len(lines), 64):
                    w.write(b"".join(lines[i:i + 64]))
                    await w.drain()
                w.close()
                await w.wait_closed()
                await asyncio.sleep(0.25)  # one discovery poll apart
            await _wait_for(out_dir, want)
            stop.set()
        return during

    outs = {}
    for side in ("jax", "torch"):
        sock = str(tmp_path / f"{side}.sock")
        out_dir = str(tmp_path / "out" / side)
        argv = ["-p", out_dir, "-f", "--source", f"socket:unix:{sock}",
                *match_args()]
        during = during_for(sock)
        rc = asyncio.run(asyncio.wait_for(_drive(
            side, argv, lambda stop, o=out_dir, d=during: d(stop, o)), 60))
        assert rc == 0
        outs[side] = read_all(out_dir)
        assert not os.path.exists(sock)
    assert outs["torch"] == outs["jax"] == want


@pytest.mark.parametrize("argv", [
    ["--source", "ftp://nope"],
    ["--source", "socket:127.0.0.1:9"],
    ["--source", "replay:x", "--backfill", "y"],
    ["--backfill", "y", "-f"],
    ["--source", "replay:x", "--replay-rate", "-2"],
    ["--source", "replay:x", "--replay-rate", "0"],
    ["--backfill", "no-such-dir"],
    ["--source", "replay:"],
    ["--source", "replay:no-such-file.log"],
    ["-a", "--cluster", "fake", "--replay-rate", "5", "-t", "1"],
], ids=["unknown_scheme", "socket_needs_follow", "exclusive",
        "backfill_follow", "rate_negative", "rate_zero", "backfill_missing",
        "replay_empty", "replay_missing_file", "rate_without_replay"])
def test_cli_source_checks_equal_jax(tmp_path, capsys, argv):
    """Exit codes and messages of ``cli.main`` equal the JAX CLI's."""
    said = {}
    for side, main in (("jax", jax_main), ("torch", cli.main)):
        capsys.readouterr()
        rc = main(argv + ["-p", str(tmp_path / side)])
        text = capsys.readouterr().out
        said[side] = (rc, [ln for ln in text.splitlines()
                           if "ERROR" in ln or "WARNING" in ln
                           or "Found" in ln])
    assert said["torch"] == said["jax"]
    if argv[1] in ("ftp://nope", "socket:127.0.0.1:9"):
        assert said["torch"][0] == 1
