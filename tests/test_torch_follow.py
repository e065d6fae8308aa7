"""Follow mode of the port against the JAX package: the FakeCluster's
live streams, the reconnect options FanoutRunner asks for, --watch-new,
the deadline flusher and whole follow runs stopped by ``stop``. The
port's filter runs on device "cpu" (the kernels' plain versions); the
JAX side runs its own modules as its tests do (``--backend cpu``, the
host regex engine, for the app runs: the files hold the same lines
whatever engine chose them)."""

import asyncio
import functools
import os
import time

import pytest

from klogs_tpu import app as jax_app
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu.cluster import fake as jax_fake
from klogs_tpu.cluster.backend import StreamError as JaxStreamError
from klogs_tpu.cluster.types import LogOptions as JaxLogOptions
from klogs_tpu.filters.sink import make_pipeline as jax_make_pipeline
from klogs_tpu.runtime import fanout as jax_fanout
from klogs_tpu.runtime.sink import FileSink as JaxFileSink
from klogs_tpu_torch import app, cli
from klogs_tpu_torch.cluster import fake
from klogs_tpu_torch.cluster.backend import StreamError
from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.filters.sink import make_pipeline
from klogs_tpu_torch.runtime import fanout
from klogs_tpu_torch.runtime.sink import FileSink
from klogs_tpu_torch.ui import term

CLOCK = 1_753_800_000.0

SIDES = {
    "jax": dict(fake=jax_fake, fanout=jax_fanout, app=jax_app,
                opts=JaxLogOptions, err=JaxStreamError),
    "torch": dict(fake=fake, fanout=fanout, app=app, opts=LogOptions,
                  err=StreamError),
}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    term.set_colors(False)
    monkeypatch.setattr(jax_fanout, "_BACKOFF_BASE_S", 0.0)
    monkeypatch.setattr(fanout, "_BACKOFF_BASE_S", 0.0)
    yield
    term.set_colors(None)


def read_all(out_dir) -> dict:
    out = {}
    for f in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, f), "rb") as fh:
            out[f] = fh.read()
    return out


# ---- the FakeCluster's follow streams ----------------------------------

STREAM_CASES = {
    "cut_in_history": (dict(cut_after_lines=4), {}),
    "cut_after_follow": (dict(cut_after_lines=9), {}),
    "error_in_history": (dict(error_after_lines=3), {}),
    "error_after_follow": (dict(error_after_lines=8), {}),
    "timestamps": (dict(cut_after_lines=8), dict(timestamps=True)),
    "since_time": (dict(cut_after_lines=5),
                   dict(since_time="2025-07-29T14:39:57Z")),
    "since_tail": (dict(cut_after_lines=6),
                   dict(since_seconds=4, tail_lines=2)),
    "previous": (dict(cut_after_lines=30), dict(previous=True)),
}


async def _drain(side: str, faults: dict, opts_kw: dict):
    s = SIDES[side]
    fc = s["fake"].FakeCluster.synthetic(
        n_pods=1, lines_per_container=6, clock=lambda: CLOCK,
        follow_interval_s=0.001, chunk_size=100)
    c = fc.namespaces["default"]["pod-0000"].containers["c0"]
    c.faults = s["fake"].Faults(**faults)
    c.previous_lines = [(CLOCK - 50 + i, b"prev %d\n" % i) for i in range(3)]
    stream = await fc.open_log_stream(
        "default", "pod-0000",
        s["opts"](container="c0", follow=True, **opts_kw))
    chunks, err = [], None
    try:
        async for chunk in stream:
            chunks.append(chunk)
    except s["err"] as e:
        err = str(e)
    await stream.close()
    return chunks, err, c.next_seq


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_fake_follow_stream_equals_jax(case):
    faults, opts_kw = STREAM_CASES[case]
    got = asyncio.run(_drain("torch", faults, opts_kw))
    exp = asyncio.run(_drain("jax", faults, opts_kw))
    assert got == exp
    assert got[0], "the stream yielded nothing"


# ---- the options FanoutRunner asks for across reconnects ---------------

RECONNECT_CASES = {
    "error_mid_stream": (dict(error_after_lines=7),
                         dict(tail_lines=3, since_seconds=600,
                              timestamps=True)),
    "past_since_time": (dict(error_after_lines=2),
                        dict(since_time="2001-01-01T00:00:00Z")),
    "future_since_time": (dict(error_after_lines=0),
                          dict(since_time="2099-01-01T00:00:00Z")),
    "failed_open": (dict(fail_open=True), dict(tail_lines=5)),
}


async def _record_reconnects(side: str, faults: dict, log_kw: dict,
                             tmp_path) -> tuple:
    s = SIDES[side]
    fc = s["fake"].FakeCluster.synthetic(
        n_pods=1, lines_per_container=6, clock=lambda: CLOCK,
        follow_interval_s=0.001)
    fc.namespaces["default"]["pod-0000"].containers["c0"].faults = \
        s["fake"].Faults(**faults)
    seen = []
    open_log_stream = fc.open_log_stream

    async def recording(namespace, pod, opts):
        seen.append(dict(vars(opts)))
        return await open_log_stream(namespace, pod, opts)

    fc.open_log_stream = recording
    jobs = s["fanout"].plan_jobs(await fc.list_pods("default"),
                                 str(tmp_path / side), False)
    runner = s["fanout"].FanoutRunner(
        fc, "default", s["opts"](follow=True, **log_kw), max_reconnects=3)
    results = await asyncio.wait_for(runner.run(jobs), timeout=30)
    with open(jobs[0].path, "rb") as f:
        data = f.read()
    return seen, results[0].premature_end, results[0].error, data


@pytest.mark.parametrize("case", list(RECONNECT_CASES))
def test_reconnect_options_equal_jax(tmp_path, case):
    faults, log_kw = RECONNECT_CASES[case]
    got = asyncio.run(_record_reconnects("torch", faults, log_kw, tmp_path))
    exp = asyncio.run(_record_reconnects("jax", faults, log_kw, tmp_path))
    assert got == exp
    seen = got[0]
    assert len(seen) == 4  # the first open and three reconnects
    if case == "failed_open":
        # No stream opened: every retry repeats the first request.
        assert seen == seen[:1] * 4
        return
    for opts in seen[1:]:
        assert opts["follow"] and opts["tail_lines"] is None
        assert (opts["since_seconds"] is None) == (
            opts["since_time"] is not None)


# ---- whole follow runs through the app ---------------------------------

def _cluster(side: str, n_pods: int, lines: int, quiet: set,
             cut: int | None = None):
    """Pods whose containers stream ``cut`` lines in all and end (the
    rest of the history and live lines), and ``quiet`` pods that send
    their history and then nothing until the stream is closed."""
    s = SIDES[side]
    fc = s["fake"].FakeCluster.synthetic(
        n_pods=n_pods, lines_per_container=lines, clock=lambda: CLOCK,
        follow_interval_s=0.002)
    for name, pod in fc.namespaces["default"].items():
        for c in pod.containers.values():
            if name in quiet:
                c.follow_interval_s = 3600.0
            elif cut is not None:
                c.faults = s["fake"].Faults(cut_after_lines=cut)
    return fc


async def _follow_run(side: str, argv: list, fc, stop_after: float,
                      during=None) -> int:
    s = SIDES[side]
    stop = asyncio.Event()

    async def stopper():
        if during is not None:
            await during(fc)
        await asyncio.sleep(stop_after)
        stop.set()

    task = asyncio.create_task(stopper())
    try:
        if side == "jax":
            opts = jax_parse_args(argv + ["--backend", "cpu"])
            return await s["app"].run_async(opts, backend=fc, stop=stop)
        opts = cli.parse_args(argv)
        return await app.run_async(opts, backend=fc, stop=stop,
                                   device="cpu")
    finally:
        task.cancel()


def _runner_without_reconnects(monkeypatch):
    for side in SIDES.values():
        monkeypatch.setattr(side["app"], "FanoutRunner", functools.partial(
            side["fanout"].FanoutRunner, max_reconnects=0))


@pytest.mark.parametrize("args", [
    ["--match", "ERROR|code=500"],
    ["--match", "seq=1[0-9]\\b", "--timestamps"],
    [],
], ids=["match", "timestamps", "unfiltered"])
def test_stopped_follow_run_equals_jax(tmp_path, monkeypatch, args):
    """Streams that end on their own (cut after their live lines, no
    reconnect) beside quiet streams that only ``stop`` ends: the same
    files, byte for byte."""
    _runner_without_reconnects(monkeypatch)
    outs = {}
    for side in SIDES:
        out_dir = tmp_path / side
        fc = _cluster(side, 5, 12, quiet={"pod-0001", "pod-0003"}, cut=30)
        argv = ["-n", "default", "-a", "-f", "-p", str(out_dir), *args]

        async def cut_streams_done(fc):
            # Stop only once every cut stream has sent its 30 lines.
            cs = [c for name, p in fc.namespaces["default"].items()
                  if name not in ("pod-0001", "pod-0003")
                  for c in p.containers.values()]
            while any(c.next_seq < 30 for c in cs):
                await asyncio.sleep(0.01)

        rc = asyncio.run(asyncio.wait_for(
            _follow_run(side, argv, fc, stop_after=0.2,
                        during=cut_streams_done), timeout=60))
        assert rc == 0
        outs[side] = read_all(out_dir)
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]) == 5
    full = [b for f, b in outs["torch"].items() if "0000" in f]
    if not args:
        assert full[0].count(b"\n") == 30


def test_watch_new_spawns_the_same_late_jobs(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("KLOGS_WATCH_INTERVAL_S", "0.2")
    outs, said = {}, {}
    for side in SIDES:
        out_dir = tmp_path / side
        fc = _cluster(side, 2, 8, quiet={"pod-0000", "pod-0001"})

        async def add_pods(fc, out_dir=out_dir):
            await asyncio.sleep(0.1)
            for name in ("late-a", "late-b"):
                fc.add_pod("default", name, containers=["main"],
                           lines_per_container=5, follow_interval_s=3600.0)
            # Stop once discovery has streamed both late pods' lines to
            # their files (the deadline flusher writes them).
            late = [out_dir / f"late-{x}__main.log" for x in "ab"]
            while not all(p.exists() and p.stat().st_size for p in late):
                await asyncio.sleep(0.01)

        argv = ["-n", "default", "-a", "-f", "--watch-new", "-p",
                str(out_dir), "--match", "ERROR|INFO"]
        capsys.readouterr()
        rc = asyncio.run(asyncio.wait_for(
            _follow_run(side, argv, fc, stop_after=0.1, during=add_pods),
            timeout=60))
        assert rc == 0
        outs[side] = read_all(out_dir)
        said[side] = [ln for ln in capsys.readouterr().out.splitlines()
                      if "Discovered" in ln]
    assert outs["torch"] == outs["jax"]
    assert said["torch"] == said["jax"]
    assert sorted(outs["torch"]) == ["late-a__main.log", "late-b__main.log",
                                     "pod-0000__c0.log", "pod-0001__c0.log"]
    assert outs["torch"]["late-a__main.log"].count(b"\n") == 3


@pytest.mark.parametrize("argv,warning", [
    (["-n", "default", "-l", "app=app-0", "--watch-new"],
     "--watch-new only applies with -f"),
], ids=["without_follow"])
def test_watch_new_warnings_equal_jax(tmp_path, capsys, argv, warning):
    texts = {}
    for side in SIDES:
        fc = _cluster(side, 2, 4, quiet=set())
        argv_s = argv + ["-p", str(tmp_path / side)]
        if side == "jax":
            rc = asyncio.run(jax_app.run_async(
                jax_parse_args(argv_s + ["--backend", "cpu"]), backend=fc))
        else:
            rc = asyncio.run(app.run_async(cli.parse_args(argv_s),
                                           backend=fc, device="cpu"))
        assert rc == 0
        texts[side] = [ln for ln in capsys.readouterr().out.splitlines()
                       if "WARNING" in ln]
    assert texts["torch"] == texts["jax"]
    assert any(warning in ln for ln in texts["torch"])


# ---- the deadline flusher ----------------------------------------------

async def _quiet_needle(side: str, path: str, deadline_s: float) -> dict:
    """A sink gets one chunk (a matching and a non-matching line) and
    then nothing: only the flusher can move the needle to its file."""
    if side == "jax":
        pipe = jax_make_pipeline(["needle"], "cpu", deadline_s=deadline_s)
        sink = pipe.sink_factory(jax_fanout.StreamJob("p", "c", False, path))
    else:
        pipe = make_pipeline(["needle"], device="cpu")
        pipe.deadline_s = deadline_s
        sink = pipe.sink_factory(fanout.StreamJob("p", "c", False, path))
    flusher = asyncio.create_task(pipe.run_deadline_flusher())
    try:
        await sink.write(b"a needle here\nnothing\n")
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            before = f.read()
        landed = None
        while time.perf_counter() - t0 < 10:
            with open(path, "rb") as f:
                if f.read():
                    landed = time.perf_counter() - t0
                    break
            await asyncio.sleep(0.005)
        await sink.close()
    finally:
        flusher.cancel()
        try:
            await flusher
        except asyncio.CancelledError:
            pass
        await pipe.aclose()
    with open(path, "rb") as f:
        after = f.read()
    return dict(before=before, landed=landed, after=after)


@pytest.mark.parametrize("side", list(SIDES))
def test_quiet_stream_needle_reaches_its_file(tmp_path, side):
    deadline_s = 0.05
    r = asyncio.run(_quiet_needle(side, str(tmp_path / "f.log"), deadline_s))
    assert r["before"] == b""
    assert r["landed"] is not None and r["landed"] < 40 * deadline_s
    assert r["after"] == b"a needle here\n"


def test_deadline_flush_is_counted(tmp_path):
    async def go():
        pipe = make_pipeline(["x"], device="cpu")
        pipe.deadline_s = 0.3  # wide: "not stale yet" must hold under load
        sink = pipe.sink_factory(fanout.StreamJob(
            "p", "c", False, str(tmp_path / "f.log")))
        await sink.write(b"x1\n")
        await sink.flush_if_stale()  # not stale yet
        n0 = pipe.stats.deadline_flushes
        await asyncio.sleep(pipe.deadline_s)
        await sink.flush_if_stale()
        n1 = pipe.stats.deadline_flushes
        await sink.close()
        await pipe.aclose()
        return n0, n1, pipe.stats.lines_in

    assert asyncio.run(go()) == (0, 1, 1)


@pytest.mark.parametrize("sink_cls", [FileSink, JaxFileSink],
                         ids=["torch", "jax"])
def test_file_sink_flush_reaches_disk(tmp_path, sink_cls):
    path = str(tmp_path / "f.log")

    async def go():
        s = sink_cls(path)
        await s.write(b"abc\n")
        with open(path, "rb") as f:
            before = f.read()
        await s.flush()
        with open(path, "rb") as f:
            after = f.read()
        await s.close()
        await s.flush()  # a closed sink's flush is a no-op
        return before, after

    assert asyncio.run(go()) == (b"", b"abc\n")


# ---- the retry policy fan-out and kube share ---------------------------

def test_retry_policy_and_deadline_equal_jax():
    from klogs_tpu.resilience import policy as jax_policy
    from klogs_tpu_torch.resilience import policy

    for mod in (policy, jax_policy):
        assert mod.RetryPolicy().max_attempts == 5
    for kw in (dict(), dict(max_attempts=3, base_s=0.25, max_s=2.0),
               dict(base_s=1.0, multiplier=3.0, max_s=20.0)):
        a = policy.RetryPolicy(jitter=0.0, **kw)
        b = jax_policy.RetryPolicy(jitter=0.0, **kw)
        assert ([(a.delay_s(i), a.retries_left(i)) for i in range(8)]
                == [(b.delay_s(i), b.retries_left(i)) for i in range(8)])
    t = [0.0]
    d, jd = (policy.Deadline(2.0, clock=lambda: t[0]),
             jax_policy.Deadline(2.0, clock=lambda: t[0]))
    for now in (0.0, 1.5, 2.0, 3.0):
        t[0] = now
        assert (d.remaining(), d.expired) == (jd.remaining(), jd.expired)


BREAKER_SCRIPT = ["f", "f", "a", "f", "a", "t5", "a", "a", "f", "a", "t5",
                  "a", "s", "a", "f", "r", "a"]


def _breaker_trace(mod) -> list:
    t = [0.0]
    b = mod.CircuitBreaker("x", failure_threshold=3, reset_timeout_s=5.0,
                           clock=lambda: t[0])
    out = []
    for step in BREAKER_SCRIPT:
        if step == "f":
            b.record_failure()
        elif step == "s":
            b.record_success()
        elif step == "r":
            b.release_probe()
        elif step == "a":
            out.append(b.allow())
        else:
            t[0] += float(step[1:])
        out.append(b.state_name)
    return out


def test_circuit_breaker_equals_jax():
    from klogs_tpu.resilience import policy as jax_policy
    from klogs_tpu_torch.resilience import policy

    got = _breaker_trace(policy)
    assert got == _breaker_trace(jax_policy)
    assert "open" in got and "half-open" in got


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_call_equals_jax(fails):
    from klogs_tpu.resilience import policy as jax_policy
    from klogs_tpu_torch.resilience import policy

    async def run_side(mod):
        calls = []

        async def fn(deadline):
            calls.append(deadline is not None)
            if len(calls) <= fails:
                raise OSError(f"flake {len(calls)}")
            return "ok"

        try:
            got = await mod.retry_call(
                fn, policy=mod.RetryPolicy(max_attempts=4, base_s=0.0,
                                           jitter=0.0),
                retryable=lambda e: isinstance(e, OSError), site="t",
                deadline_s=1.0)
        except mod.Unavailable as e:
            got = str(e)
        return got, calls

    got = asyncio.run(run_side(policy))
    assert got == asyncio.run(run_side(jax_policy))
    assert got[0] == ("ok" if fails < 4 else
                      "t: flake 4 (after 4 attempts)")


# ---- q-to-quit and Ctrl-C through a real pty ----------------------------

def _pty_follow(module: str, action: str, out_dir) -> tuple:
    """``python -m module -a -f --cluster fake`` in a fresh interpreter
    on a pty; once it says "to stop streaming", press q (repeatedly:
    cbreak mode discards input typed before it) or send one SIGINT.
    Returns (exit code, output, log files)."""
    import pty
    import select
    import signal
    import sys

    pid, master = pty.fork()
    if pid == 0:
        os.environ.update(NO_COLOR="1", KLOGS_FAKE_PODS="2",
                          KLOGS_FAKE_CONTAINERS="1")
        os.execv(sys.executable, [sys.executable, "-m", module, "-n",
                                  "default", "-a", "-f", "--cluster", "fake",
                                  "-p", str(out_dir)])
        os._exit(97)

    out = b""

    def pump(timeout: float) -> bool:
        r, _, _ = select.select([master], [], [], timeout)
        if r:
            try:
                chunk = os.read(master, 65536)
            except OSError:
                return False
            nonlocal out
            out += chunk
            return bool(chunk)
        return False

    try:
        end = time.time() + 90
        while time.time() < end and b"to stop streaming" not in out:
            pump(0.3)
        assert b"to stop streaming" in out, out[-500:]
        time.sleep(0.5)
        if action == "sigint":
            os.kill(pid, signal.SIGINT)
        status = None
        end = time.time() + 30
        while time.time() < end:
            if action == "q":
                try:
                    os.write(master, b"q")
                except OSError:
                    pass
            pump(0.3)
            done, st = os.waitpid(pid, os.WNOHANG)
            if done:
                status = st
                break
        assert status is not None, out[-500:]
        while pump(0.2):
            pass
    finally:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
        os.close(master)
    files = sorted(p.name for p in out_dir.glob("*__*.log")
                   if p.stat().st_size > 0)
    return os.waitstatus_to_exitcode(status), out, files


@pytest.mark.parametrize("action,code", [("q", 0), ("sigint", 130)])
def test_follow_tty_quit_equals_jax(tmp_path, action, code):
    """q on /dev/tty stops the run with exit 0, the first Ctrl-C stops
    it gracefully with 130; either way the sinks are flushed and the
    size table printed, as in the JAX CLI."""
    got = _pty_follow("klogs_tpu_torch.cli", action, tmp_path / "torch")
    exp = _pty_follow("klogs_tpu.cli", action, tmp_path / "jax")
    assert got[0] == exp[0] == code, got[1][-800:]
    assert got[2] == exp[2] == ["pod-0000__c0.log", "pod-0001__c0.log"]
    for out in (got[1], exp[1]):
        assert b"Logs saved to" in out
        assert (b"Interrupt: stopping streams" in out) == (action == "sigint")
