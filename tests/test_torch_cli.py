"""The port's app writes the same files, byte for byte, as the JAX app
with ``--backend tpu`` (JAX on the CPU), both over a fixed-clock
FakeCluster; the port runs on device "cpu" (the kernels' plain
versions)."""

import asyncio
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
             long_line: bytes | None = None):
    outs = {}
    for side in ("jax", "torch"):
        out_dir = str(tmp_path / side)
        argv = ["-n", "default", "-p", out_dir, *args]
        if side == "jax":
            fc = JaxFakeCluster.synthetic(n_pods=n_pods,
                                          n_containers=n_containers,
                                          lines_per_container=lines,
                                          clock=lambda: CLOCK)
            opts = jax_parse_args(argv + ["--backend", "tpu"])
            run = jax_app.run_async(opts, backend=fc)
        else:
            fc = FakeCluster.synthetic(n_pods=n_pods,
                                       n_containers=n_containers,
                                       lines_per_container=lines,
                                       clock=lambda: CLOCK)
            opts = cli.parse_args(argv + ["--backend", "cuda"])
            run = app.run_async(opts, backend=fc, device="cpu")
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
    assert cli.main(["-a", "-c", "(", "-p", str(tmp_path)]) == 1
    assert cli.main(["-a", "--cluster", "kube", "-p", str(tmp_path)],
                    device="cpu") == 1
    err = capsys.readouterr().out
    assert "invalid -c/--container pattern" in err
    assert "kube backend is not ported yet" in err


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


def test_missing_namespace_and_picker_are_fatal(tmp_path):
    fc = FakeCluster.synthetic(n_pods=1, lines_per_container=1,
                               clock=lambda: CLOCK)
    for argv in (["-n", "nope", "-a"], ["-n", "default"]):
        opts = cli.parse_args(argv + ["-p", str(tmp_path), "--match", "x"])
        with pytest.raises(term.FatalError):
            asyncio.run(app.run_async(opts, backend=fc, device="cpu"))


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
