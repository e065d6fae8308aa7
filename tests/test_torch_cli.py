"""The port's app writes the same files, byte for byte, as the JAX app
with ``--backend tpu`` (JAX on the CPU), both over a fixed-clock
FakeCluster; the port runs on device "cpu" (the kernels' plain
versions). With ``--backend cpu`` (the host engines) each side runs its
own ``--backend cpu``."""

import asyncio
import io
import os

import pytest

from klogs_tpu import app as jax_app
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from klogs_tpu_torch import app, cli
from klogs_tpu_torch.cluster.fake import FakeCluster, synthetic_line
from klogs_tpu_torch.ui import term

CLOCK = 1_753_800_000.0


@pytest.fixture(autouse=True)
def _no_colors():
    term.set_colors(False)
    yield
    term.set_colors(None)


def read_all(out_dir) -> dict:
    out = {}
    for f in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, f), "rb") as fh:
            out[f] = fh.read()
    return out


def run_both(tmp_path, args, n_pods=3, n_containers=1, lines=80,
             long_line: bytes | None = None, backend: str = "device"):
    """``backend="device"``: JAX's tpu against the port's cuda (on
    device "cpu"); ``"cpu"``: each package's host engines."""
    outs = {}
    for side in ("jax", "torch"):
        out_dir = str(tmp_path / side)
        argv = ["-n", "default", "-p", out_dir, *args]
        if side == "jax":
            fc = JaxFakeCluster.synthetic(n_pods=n_pods,
                                          n_containers=n_containers,
                                          lines_per_container=lines,
                                          clock=lambda: CLOCK)
            opts = jax_parse_args(argv + [
                "--backend", "cpu" if backend == "cpu" else "tpu"])
            run = jax_app.run_async(opts, backend=fc)
        else:
            fc = FakeCluster.synthetic(n_pods=n_pods,
                                       n_containers=n_containers,
                                       lines_per_container=lines,
                                       clock=lambda: CLOCK)
            opts = cli.parse_args(argv + [
                "--backend", "cpu" if backend == "cpu" else "cuda"])
            run = app.run_async(opts, backend=fc,
                                device=None if backend == "cpu" else "cpu")
        if long_line is not None:
            pod = fc.namespaces["default"]["pod-0001"].containers["c0"]
            pod.lines.insert(10, (CLOCK - 70, long_line))
        assert asyncio.run(run) == 0
        outs[side] = read_all(out_dir)
    return outs


@pytest.mark.parametrize("args", [
    ["-a", "--match", r"(?:ERROR|WARN).*\d"],
    ["-a", "--match", "ERROR", "--match", "latency=4[0-9]ms"],
    ["-a", "--exclude", "INFO|DEBUG"],
    ["-a", "--match", "error", "-I", "--exclude", "v2"],
    ["-l", "app=app-1", "-l", "app=app-2", "--match", "seq=1[0-9]\\b"],
    ["-a", "-t", "25", "-s", "40s", "--match", "code=[45]00"],
    ["-a", "-c", "c1", "--match", "WARN"],
], ids=["match", "union", "exclude_only", "ignore_case_exclude", "labels",
        "since_tail", "container_re"])
def test_files_byte_identical_to_jax(tmp_path, args):
    outs = run_both(tmp_path, args, n_pods=5, n_containers=2)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"], "no files written"
    assert any(outs["torch"].values()), "every file empty"


def index_patterns(k: int) -> "list[str]":
    """k patterns for the indexed engine: literal families whose members
    the synthetic lines hold, and a few regexes."""
    fam = [lambda i: f"seq={i}\\b", lambda i: f"pod-{i:04d} ",
           lambda i: rf"latency={i}ms", lambda i: f"user=u{i:05d}"]
    return [r"(?:ERROR|WARN).*\d", r"code=50[34]"] + [
        fam[i % 4](i) for i in range(k - 2)]


@pytest.mark.parametrize("args", [
    ["-a", "--match", r"(?:ERROR|WARN).*\d"],
    ["-a", "--match", "ERROR", "--match", "latency=4[0-9]ms"],
    ["-a", "--exclude", "INFO|DEBUG"],
    ["-a", "--match", "error", "-I", "--exclude", "v2"],
    ["-a", "--match", r"(seq)=1\1?", "--match", "WARN"],
    ["-a", "-c", "c1", "--match", "WARN"],
    ["-a", *sum((["--match", p] for p in index_patterns(64)), [])],
    ["-a", "-I", "--exclude", "debug", *sum(
        (["--match", p.upper()] for p in index_patterns(96)), [])],
], ids=["match", "union", "exclude_only", "ignore_case_exclude", "backref",
        "container_re", "indexed_64", "indexed_96_I_exclude"])
def test_backend_cpu_files_equal_jax_cpu(tmp_path, args, monkeypatch):
    """``--backend cpu``: the port's host engines write the JAX CLI's
    ``--backend cpu`` files, byte for byte (DFA, the group-reference
    rule, and the indexed engine from 64 patterns)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    outs = run_both(tmp_path, args, n_pods=5, n_containers=2, lines=120,
                    backend="cpu")
    assert outs["torch"] == outs["jax"]
    assert any(outs["torch"].values()), "every file empty"


def test_backend_cpu_long_lines_equal_jax_cpu(tmp_path, monkeypatch):
    """Lines over 4 KiB through the host engines, DFA and indexed."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    long_line = (b"x" * 6000 + b" ERROR tail seq=3 " + b"y" * 3000 + b"\n")
    for args in (["--match", "ERROR tail"],
                 sum((["--match", p] for p in index_patterns(64)), [])):
        d = tmp_path / str(len(args))
        d.mkdir()
        outs = run_both(d, ["-a", *args], long_line=long_line,
                        backend="cpu")
        assert outs["torch"] == outs["jax"]
        assert long_line in outs["torch"]["pod-0001__c0.log"]


def test_backend_cpu_stats_print_the_indexed_engine(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=30,
                               clock=lambda: CLOCK)
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(tmp_path / "o"),
                           "--backend", "cpu", "--stats", *sum(
                               (["--match", p]
                                for p in index_patterns(64)), [])])
    assert asyncio.run(app.run_async(opts, backend=fc)) == 0
    out = capsys.readouterr().out
    assert "Filter stats: 60 lines in" in out
    assert "indexed engine: " in out and "'dfa':" in out
    assert "narrowing ratio" in out


def test_long_line_through_chunk_path(tmp_path):
    """A line longer than chunk_bytes goes through the carried-state
    path on both sides and lands in the same place in the file."""
    long_line = (b"x" * 6000 + b" ERROR tail " + b"y" * 3000 + b"\n")
    outs = run_both(tmp_path, ["-a", "--match", "ERROR tail"],
                    long_line=long_line)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["pod-0001__c0.log"] == long_line


def test_unfiltered_run_copies_streams(tmp_path):
    outs = run_both(tmp_path, ["-a"], lines=20)
    assert outs["torch"] == outs["jax"]
    exp = b"".join(synthetic_line("pod-0000", "c0", i, CLOCK - (19 - i))
                   for i in range(20))
    assert outs["torch"]["pod-0000__c0.log"] == exp


def test_stats_summary_printed(tmp_path, capsys):
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=30,
                               clock=lambda: CLOCK)
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(tmp_path),
                           "--match", "INFO", "--stats"])
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    out = capsys.readouterr().out
    assert "Filter stats: 60 lines in, 16 matched" in out
    assert "lines/sec" in out


def test_cli_main_errors_are_one_line(tmp_path, capsys):
    """A bad -c pattern and a missing kubeconfig under the default
    ``--cluster kube``: exit 1 and the JAX CLI's one line each."""
    from klogs_tpu.cli import main as jax_main

    missing = str(tmp_path / "no-such-kubeconfig")
    for argv in (["-a", "-c", "(", "-p", str(tmp_path)],
                 ["-a", "--cluster", "kube", "--kubeconfig", missing, "-p",
                  str(tmp_path)]):
        capsys.readouterr()
        assert cli.main(argv, device="cpu") == 1
        got = capsys.readouterr().out
        assert jax_main(argv) == 1
        exp = capsys.readouterr().out
        lines = [ln for ln in got.splitlines() if "ERROR" in ln or "FATAL" in ln]
        assert lines == [ln for ln in exp.splitlines()
                         if "ERROR" in ln or "FATAL" in ln]
        assert len(lines) == 1 and "Traceback" not in got
    assert f"no kubeconfig found at {missing}" in lines[0]


def test_cli_main_fake_cluster_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("KLOGS_FAKE_PODS", "2")
    monkeypatch.setenv("KLOGS_FAKE_CONTAINERS", "1")
    monkeypatch.setenv("KLOGS_FAKE_LINES", "12")
    out = tmp_path / "out"
    assert cli.main(["-a", "--cluster", "fake", "--match", "ERROR", "-p",
                     str(out)], device="cpu") == 0
    files = read_all(out)
    assert sorted(files) == ["pod-0000__c0.log", "pod-0001__c0.log"]
    for body in files.values():
        lines = body.splitlines()
        assert len(lines) == 3 and all(b" ERROR " in ln for ln in lines)


def test_missing_namespace_and_picker_are_fatal(tmp_path, capsys,
                                                monkeypatch):
    """A missing namespace warns and falls into the namespace picker,
    and no -a/-l falls into the pod picker; with no terminal each picker
    fails as JAX's does (``NotInteractive``, one line from cli.main)."""
    from klogs_tpu.ui.interactive import NotInteractive as JaxNotInteractive
    from klogs_tpu_torch.ui.interactive import NotInteractive

    monkeypatch.setattr("sys.stdin", io.StringIO())
    for argv in (["-n", "nope", "-a"], ["-n", "default"]):
        msgs = []
        for side, exc in (("jax", JaxNotInteractive),
                          ("torch", NotInteractive)):
            argv_s = argv + ["-p", str(tmp_path / side), "--match", "x"]
            if side == "jax":
                fc = JaxFakeCluster.synthetic(n_pods=1, lines_per_container=1,
                                              clock=lambda: CLOCK)
                run = jax_app.run_async(jax_parse_args(argv_s), backend=fc)
            else:
                fc = FakeCluster.synthetic(n_pods=1, lines_per_container=1,
                                           clock=lambda: CLOCK)
                run = app.run_async(cli.parse_args(argv_s), backend=fc,
                                    device="cpu")
            capsys.readouterr()
            with pytest.raises(exc) as ei:
                asyncio.run(run)
            warned = [ln for ln in capsys.readouterr().out.splitlines()
                      if "WARNING" in ln]
            msgs.append((str(ei.value), warned))
        assert msgs[0] == msgs[1]
        assert "requires a terminal" in msgs[1][0]
        assert bool(msgs[1][1]) == (argv[1] == "nope")


@pytest.mark.parametrize("env,expect", [
    ({"KLOGS_TPU_SWEEP": "1"}, "prefilter: "),
    ({"KLOGS_TPU_PREFILTER": "1"}, "prefilter: "),
], ids=["sweep", "prefilter"])
def test_stats_prints_prefilter_line_under_a_gate(tmp_path, capsys, monkeypatch,
                                                  env, expect):
    """The gated path behind the user's entry point: the same files as
    the ungated run, and --stats says what the gate let through."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=40,
                               clock=lambda: CLOCK)
    out = tmp_path / "gated"
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(out), "--match",
                           "ERROR", "--match", "latency=4[0-9]ms",
                           "--stats"])
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    text = capsys.readouterr().out
    assert expect in text and "tiles skipped" in text
    for k in env:
        monkeypatch.delenv(k)
    plain = tmp_path / "plain"
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(plain), "--match",
                           "ERROR", "--match", "latency=4[0-9]ms"])
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=40,
                               clock=lambda: CLOCK)
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    assert read_all(out) == read_all(plain)
    assert any(read_all(out).values())


def test_stats_says_why_prefilter_is_off(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KLOGS_TPU_PREFILTER", "1")
    fc = FakeCluster.synthetic(n_pods=1, lines_per_container=10,
                               clock=lambda: CLOCK)
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(tmp_path),
                           "--match", "E.*", "--stats"])
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    assert "  prefilter disabled: no mandatory byte pairs" in \
        capsys.readouterr().out


# ---- the follow-mode flags and the pickers ------------------------------

NEW_FLAGS = [
    ["-f"], ["--follow"], ["-v"], ["--version"], ["-o", "stdout"],
    ["--output", "both"], ["-o", "files", "--format", "json"],
    ["--previous"], ["--since-time", "2026-07-31T06:00:00Z"],
    ["--timestamps"], ["--kubeconfig", "/k/config"], ["--watch-new", "-f",
                                                      "-a"],
    ["-f", "-t", "10", "-s", "5m", "--timestamps", "-o", "stdout",
     "--format", "json", "--kubeconfig", "kc"],
]


@pytest.mark.parametrize("argv", NEW_FLAGS, ids=lambda a: " ".join(a))
def test_new_flags_parse_as_jax(argv):
    got = vars(cli.parse_args(argv + ["-p", "x"]))
    exp = vars(jax_parse_args(argv + ["-p", "x"]))
    assert {k: v for k, v in got.items() if k != "backend"} == {
        k: exp[k] for k in got if k != "backend"}


@pytest.mark.parametrize("argv", [
    ["-o", "nope"], ["--format", "xml"], ["--previous", "-f"],
    ["-s", "5m", "--since-time", "2026-07-31T06:00:00Z"],
    ["--since-time", "2026-07-31"], ["--since-time", "2026-07-31T06:00:00"],
    ["--since-time", "yesterday"],
], ids=["bad_output", "bad_format", "previous_follow", "since_both",
        "date_only", "naive", "garbage"])
def test_flag_errors_equal_jax(argv, capsys):
    from klogs_tpu.cli import main as jax_main

    codes = []
    for main in (cli.main, jax_main):
        capsys.readouterr()
        try:
            codes.append(main(argv + ["-a", "-p", "x"]))
        except SystemExit as e:  # argparse rejects a bad choice
            codes.append(("exit", e.code))
        cap = capsys.readouterr()
        codes.append([ln.replace("klogs-torch", "klogs")
                      for ln in (cap.out + cap.err).splitlines()
                      if "ERROR" in ln or "error:" in ln])
    assert codes[0:2] == codes[2:4]
    assert codes[0] in (1, ("exit", 2)) and len(codes[1]) == 1


def test_version_prints_and_exits(capsys, monkeypatch):
    assert cli.main(["-v"]) == 0
    assert "Version: development" in capsys.readouterr().out


PICKS = [
    ([], 0), (["down"], 1), (["down", "down", "down", "up"], 2),
    (["down", "enter", "down"], 1), (["up", "up"], 0),
    (["down"] * 40 + ["enter"], 29),
]


@pytest.mark.parametrize("keys,chosen", PICKS,
                         ids=["none", "down", "up", "enter", "top", "scroll"])
def test_pickers_choose_as_jax(keys, chosen):
    from klogs_tpu.ui import interactive as jax_interactive
    from klogs_tpu_torch.ui import interactive

    names = [f"ns-{i:02d}" for i in range(30)]
    outs = []
    for mod in (interactive, jax_interactive):
        buf = io.StringIO()
        one = mod.interactive_select(names, "Select a Namespace", keys=keys,
                                     out=buf)
        many = mod.interactive_multiselect(
            names, "Select Pods", keys=[k if k != "up" else "space"
                                        for k in keys] + ["space"], out=buf)
        outs.append((one, many, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == names[chosen]


def test_pickers_drive_the_app_as_jax(tmp_path):
    """A missing namespace and no -a: the injected keys pick the
    namespace and the pods, as in the JAX app."""
    files = []
    for side in ("jax", "torch"):
        out = tmp_path / side
        argv = ["-n", "nope", "-p", str(out), "--match", "ERROR"]
        # One iterator: the pod picker goes on where the namespace picker
        # stopped.
        keys = iter(["down", "enter", "down", "space", "down", "down",
                     "space", "enter"])
        if side == "jax":
            fc = JaxFakeCluster.synthetic(n_pods=4, lines_per_container=20,
                                          clock=lambda: CLOCK)
            fc.add_namespace("a-first")
            rc = asyncio.run(jax_app.run_async(
                jax_parse_args(argv + ["--backend", "cpu"]), backend=fc,
                select_keys=keys))
        else:
            fc = FakeCluster.synthetic(n_pods=4, lines_per_container=20,
                                       clock=lambda: CLOCK)
            fc.add_namespace("a-first")
            rc = asyncio.run(app.run_async(cli.parse_args(argv), backend=fc,
                                           select_keys=keys, device="cpu"))
        assert rc == 0
        files.append(read_all(out))
    assert files[0] == files[1]
    assert sorted(files[1]) == ["pod-0001__c0.log", "pod-0003__c0.log"]


@pytest.mark.parametrize("argv", [
    ["--remote", "filterd:50051"], ["--remote", "unix:/run/f.sock"],
    ["--on-filter-error", "pass"], ["--on-filter-error", "drop"],
    ["--on-filter-error", "abort", "--remote", "h:1", "--match", "x"],
    ["--remote", "a:1,b:2,unix:/run/f.sock"],
    ["--remote", "a:1,b:2", "--shard-mode", "hash"],
    ["--shard-mode", "round-robin"],
    ["--resolver", "static:a:1,b:2"],
    ["--resolver", "file:/etc/klogs/fleet", "--remote", "a:1"],
    ["--resolver", "dns:filterd.svc:50051", "--shard-mode", "hash"],
    ["--resolver", "kube:logging/filterd:50051"],
], ids=lambda a: " ".join(a))
def test_remote_flags_parse_as_jax(argv):
    got = vars(cli.parse_args(argv + ["-p", "x"]))
    exp = vars(jax_parse_args(argv + ["-p", "x"]))
    assert (got["remote"], got["on_filter_error"]) == (
        exp["remote"], exp["on_filter_error"])
    assert {k: v for k, v in got.items() if k != "backend"} == {
        k: exp[k] for k in got if k != "backend"}


def test_remote_flag_errors_equal_jax(capsys):
    """A bad --on-filter-error choice is argparse's exit 2 on both; a
    malformed --remote endpoint is one line and exit 1 on both."""
    from klogs_tpu.cli import main as jax_main

    for argv in (["--on-filter-error", "retry"],
                 ["--remote", "127.0.0.1:notaport", "--match", "x",
                  "--cluster", "fake"]):
        codes = []
        for main in (cli.main, jax_main):
            capsys.readouterr()
            try:
                codes.append(main(argv + ["-a", "-p", "x"]))
            except SystemExit as e:
                codes.append(("exit", e.code))
            cap = capsys.readouterr()
            codes.append([ln.replace("klogs-torch", "klogs")
                          for ln in (cap.out + cap.err).splitlines()
                          if "ERROR" in ln or "error:" in ln])
        assert codes[0:2] == codes[2:4]
        assert codes[0] in (1, ("exit", 2)) and len(codes[1]) == 1


@pytest.fixture
def one_torch_thread():
    """One intra-op thread while the port's filterds run the plain
    kernel versions in this process (test workers side by side would
    oversubscribe the cores)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_remote_list_runs_the_fleet_as_jax(tmp_path, capsys,
                                           one_torch_thread):
    """``--remote A,B`` (and ``--shard-mode hash``) through the port's
    CLI against two port filterds on the CPU writes the files the JAX
    CLI writes against two JAX filterds, byte for byte; a malformed
    list and a bad ``--resolver`` spec are one line and exit 1 on both
    CLIs."""
    from klogs_tpu.cli import main as jax_main
    from klogs_tpu.service.server import FilterServer as JaxFilterServer
    from klogs_tpu_torch.service.server import FilterServer

    args = ["--match", "INFO", "--match", r"WARN.*\d"]
    long_line = b"q" * 7000 + b" WARN deep 9 " + b"r" * 100 + b"\n"

    async def through(side: str, extra: list) -> dict:
        servers = [JaxFilterServer(args[1::2], backend="cpu", port=0)
                   if side == "jax" else
                   FilterServer(args[1::2], port=0, device="cpu")
                   for _ in range(2)]
        ports = [await s.start() for s in servers]
        out_dir = tmp_path / f"{side}{len(extra)}"
        argv = ["-n", "default", "-a", "-p", str(out_dir), *args, *extra,
                "--remote", ",".join(f"127.0.0.1:{p}" for p in ports)]
        try:
            if side == "jax":
                fc = JaxFakeCluster.synthetic(n_pods=4, n_containers=1,
                                              lines_per_container=60,
                                              clock=lambda: CLOCK)
                coro = jax_app.run_async(jax_parse_args(argv), backend=fc)
            else:
                fc = FakeCluster.synthetic(n_pods=4, n_containers=1,
                                           lines_per_container=60,
                                           clock=lambda: CLOCK)
                # device=None: a collector of a fleet needs no card.
                coro = app.run_async(cli.parse_args(argv), backend=fc)
            fc.namespaces["default"]["pod-0001"].containers["c0"].lines.insert(
                7, (CLOCK - 70, long_line))
            assert await coro == 0
        finally:
            for s in servers:
                await s.stop()
        return read_all(out_dir)

    for extra in ([], ["--shard-mode", "hash"]):
        outs = {side: asyncio.run(through(side, extra))
                for side in ("jax", "torch")}
        assert outs["torch"] == outs["jax"]
        assert len(outs["torch"]) == 4
        assert b" WARN deep 9 " in outs["torch"]["pod-0001__c0.log"]
    for bad in (["--remote", "127.0.0.1:1,,127.0.0.1:2"],
                ["--remote", "127.0.0.1:1,127.0.0.1:1"],
                ["--resolver", "consul:x"]):
        got = []
        for main in (cli.main, jax_main):
            capsys.readouterr()
            rc = main(["-a", "--cluster", "fake", "--match", "x", "-p",
                       str(tmp_path / "o"), *bad])
            errs = [ln for ln in capsys.readouterr().out.splitlines()
                    if "ERROR" in ln]
            got.append((rc, errs))
        assert got[0] == got[1] and got[0][0] == 1 and len(got[0][1]) == 1
    assert not (tmp_path / "o").exists()
