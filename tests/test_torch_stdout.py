"""The port's console sinks (``-o stdout|both``, ``--format json``)
render the same bytes as the JAX package's on the same chunks, and
``-o stdout`` / ``-o both`` app runs give JAX's stdout and files."""

import asyncio
import io
import json
import os

import pytest

from klogs_tpu import app as jax_app
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from klogs_tpu.runtime import stdout as jax_stdout
from klogs_tpu.runtime.sink import FileSink as JaxFileSink
from klogs_tpu.ui import term as jax_term
from klogs_tpu_torch import app, cli
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.runtime import stdout
from klogs_tpu_torch.runtime.sink import FileSink
from klogs_tpu_torch.ui import term

CLOCK = 1_753_800_000.0

CHUNKS = [b"alpha ERROR one\nbe", b"ta\n", b"", b"gamma code=500 x\xffy\n",
          b"\xe2\x9c\x93 ok\nERROR ERROR overlap\nno newline at end"]


@pytest.fixture(params=[False, True], ids=["plain", "colors"])
def colors(request):
    term.set_colors(request.param)
    jax_term.set_colors(request.param)
    yield request.param
    term.set_colors(None)
    jax_term.set_colors(None)


def _render(mod, kind: str, highlight: list) -> bytes:
    out = io.BytesIO()
    if kind == "json":
        sink = mod.JsonStdoutSink("pod-7", "main", out=out)
    else:
        sink = mod.StdoutSink("pod-7", "main", out=out, highlight=(
            mod.compile_highlights(highlight, ignore_case=True)))

    async def go():
        for c in CHUNKS:
            await sink.write(c)
        await sink.flush()
        await sink.close()
        await sink.close()  # idempotent

    asyncio.run(go())
    return out.getvalue(), sink.bytes_written


@pytest.mark.parametrize("kind,highlight", [
    ("text", []),
    ("text", ["error", "or e", "code=5[0-9]+", "a*", "("]),
    ("json", []),
], ids=["text", "highlight", "json"])
def test_console_sinks_render_jax_bytes(colors, kind, highlight):
    got = _render(stdout, kind, highlight)
    assert got == _render(jax_stdout, kind, highlight)
    assert got[0].count(b"\n") == 6
    if colors and highlight:
        assert b"\x1b[1;31m" in got[0]


def test_pod_colors_equal_jax():
    pods = [f"pod-{i:04d}" for i in range(64)] + ["api-1", "db"]
    assert ([stdout.pod_color_code(p) for p in pods]
            == [jax_stdout.pod_color_code(p) for p in pods])


def test_tee_sink_equals_jax(tmp_path):
    def run_side(mod, file_sink, side):
        out = io.BytesIO()
        path = str(tmp_path / f"{side}.log")
        tee = mod.TeeSink(file_sink(path), mod.StdoutSink("p", "c", out=out))

        async def go():
            for c in CHUNKS:
                await tee.write(c)
            await tee.flush()
            await tee.close()

        asyncio.run(go())
        with open(path, "rb") as f:
            return out.getvalue(), f.read(), tee.bytes_written

    got = run_side(stdout, FileSink, "torch")
    assert got == run_side(jax_stdout, JaxFileSink, "jax")
    assert got[1] == b"".join(CHUNKS) and got[2] == len(got[1])
    with pytest.raises(ValueError):
        stdout.TeeSink()


def _app_run(side: str, argv: list, capsysbinary):
    if side == "jax":
        fc = JaxFakeCluster.synthetic(n_pods=3, n_containers=2,
                                      lines_per_container=40,
                                      clock=lambda: CLOCK)
        run = jax_app.run_async(jax_parse_args(argv + ["--backend", "cpu"]),
                                backend=fc)
    else:
        fc = FakeCluster.synthetic(n_pods=3, n_containers=2,
                                   lines_per_container=40,
                                   clock=lambda: CLOCK)
        run = app.run_async(cli.parse_args(argv), backend=fc, device="cpu")
    capsysbinary.readouterr()
    assert asyncio.run(run) == 0
    cap = capsysbinary.readouterr()
    return cap.out, cap.err


def _by_stream(out: bytes) -> dict:
    """stdout's lines grouped by their ``pod container`` prefix, each
    group in its order (streams interleave by scheduling)."""
    groups: dict = {}
    for ln in out.splitlines(keepends=True):
        if ln.startswith(b"{"):
            doc = json.loads(ln)
            key = f"{doc['pod']} {doc['container']}".encode()
        else:
            key = b" ".join(ln.split(b" ", 2)[:2])
        groups.setdefault(key, []).append(ln)
    return groups


@pytest.mark.parametrize("args", [
    ["-o", "stdout"],
    ["-o", "stdout", "--match", "ERROR|code=500"],
    ["-o", "both", "--match", "WARN"],
    ["-o", "stdout", "--format", "json", "--match", "seq=1[0-9]\\b"],
    ["--format", "json", "--match", "INFO"],
], ids=["stdout", "stdout_match", "both", "json", "json_ignored"])
def test_output_modes_equal_jax(tmp_path, capsysbinary, args):
    outs = {}
    for side in ("jax", "torch"):
        out_dir = tmp_path / side
        argv = ["-n", "default", "-a", "-p", str(out_dir), *args]
        out, err = _app_run(side, argv, capsysbinary)
        files = {}
        if os.path.isdir(out_dir):
            for f in sorted(os.listdir(out_dir)):
                with open(out_dir / f, "rb") as fh:
                    files[f] = fh.read()
        ui = err if "-o" in args else out
        outs[side] = dict(
            stdout=_by_stream(out) if "-o" in args else None, files=files,
            table=[ln for ln in ui.splitlines() if ln.startswith(b"\xe2\x94\x82")],
            warnings=[ln for ln in ui.splitlines() if b"WARNING" in ln])
    assert outs["torch"] == outs["jax"]
    mode = args[1] if args[0] == "-o" else "files"
    if mode == "stdout":
        assert outs["torch"]["files"] == {} and outs["torch"]["table"] == []
        assert len(outs["torch"]["stdout"]) == 6
    else:
        assert len(outs["torch"]["files"]) == 6
    if mode == "both":
        for f, body in outs["torch"]["files"].items():
            pod, c = f[:-4].split("__")
            key = f"{pod} {c}".encode()
            assert b"".join(ln[len(key) + 1:] for ln in
                            outs["torch"]["stdout"].get(key, [])) == body
