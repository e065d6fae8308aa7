"""The plain reference and its control: the joined-text scan equals a
search line by line, its control (a guarantee broken) fails the
comparison on every seed, and the byte roofline is the hand count."""

import re

import numpy as np
import pytest

from portbench import check, reference, spec
from portbench.metrics import _roofline

from test_portbench_frames import SMALL_LONG, _cell


@pytest.mark.parametrize("config", ["ops32", "alerts1024"])
def test_joined_scan_equals_a_search_line_by_line(config):
    cell, gen = _cell(config, SMALL_LONG)
    patterns = cell.config["patterns"]
    if config == "alerts1024":
        patterns = patterns[:40] + patterns[-40:]
    payload, offs = gen.frame_at(cell.config, cell.mix, 2**31 + 3, 0, 0)
    lines = reference.lines_of(payload, offs, np.arange(len(offs) - 1))
    lines += [b"", b"\n", b"panic:\n\n", b"x FATAL y code=7",
              b"svc-0008 unreachable"]
    got = reference.judge(reference.compile_rules(patterns),
                          *reference.joined(lines))
    rules = [re.compile(p.encode()) for p in patterns]
    want = [any(r.search(ln.rstrip(b"\n")) for r in rules) for ln in lines]
    assert got.tolist() == want
    assert 0 < sum(want) < len(want)


def test_parallel_workers_equal_one_process(tmp_path):
    cell, gen = _cell("alerts1024", SMALL_LONG)
    payload, offs = gen.frame_at(cell.config, cell.mix, 5, 0, 0)
    lines = reference.lines_of(payload, offs, np.arange(len(offs) - 1))
    pats = cell.config["patterns"][:64]
    one = reference.judge_parallel(pats, False, lines, 1)
    many = reference.judge_parallel(pats, False, lines, 3, str(tmp_path))
    assert one.any() and np.array_equal(one, many)


def test_reference_refuses_what_a_joined_text_would_judge_wrong():
    with pytest.raises(ValueError):
        reference.compile_rules([r"\Afoo"])
    with pytest.raises(ValueError):
        reference.judge(reference.compile_rules([r"a\sb"]),
                        *reference.joined([b"xa", b"b"]))


@pytest.mark.parametrize("config,mix", [
    ("ops32", dict(SMALL_LONG, frame_lines=1024, collectors=2,
                   check_short_lines="all", check_long_lines="all")),
    ("alerts1024", dict(SMALL_LONG, frame_lines=4096, collectors=2,
                        long_every=0, check_short_lines="all",
                        check_long_lines=0)),
])
@pytest.mark.parametrize("seed", [1, 2**31 + 11, 987654321])
def test_control_fails_the_comparison(config, mix, seed):
    cell, gen = _cell(config, mix)
    out = check.control(cell, gen, seed, workers=1)
    assert out["reference_kept"] > 0
    assert out["mismatched_lines"] > 0


def test_roofline_bytes_are_the_hand_count():
    # Two lines of 10 and 7 bytes, one batch, patterns "ab" and "cde".
    pattern_bytes = len("ab") + len("cde")
    assert _roofline.least_bytes(17, 2, 1, pattern_bytes) == 17 + 5 + 1
    # 9 lines need two bytes of verdict bits; two batches read the set twice.
    assert _roofline.least_bytes(90, 9, 2, 5) == 90 + 10 + 2
    assert _roofline.least_time_s(17, 2, 1, 5, 3.35e12) == 23 / 3.35e12


def test_roofline_reader_on_a_tiny_window():
    from portbench import tracing
    from portbench.peaks import peaks

    kernels_roofline = spec.reader(spec.BENCH_DIR, "kernels_roofline")
    tr = tracing.Trace(
        t0=0.0, t1=1.0, pattern_bytes=5, peaks=peaks("NVIDIA H100 80GB HBM3"),
        has_device_trace=True,
        spans=[{"name": "device.frame", "start_unix": 0.1, "duration_s": 0.01,
                "attrs": {"rows": 2, "bytes": 17, "staged": True}}],
        device=[("kernel", "k", 0.2, 0.2 + 1e-6),
                ("memcpy", "Memcpy HtoD", 0.3, 0.4)])
    want = (17 + 5 + 1) / 3.35e12 / 1e-6 * 100
    assert kernels_roofline.read(tr) == pytest.approx(want)
    idle = spec.reader(spec.BENCH_DIR, "device_idle_pct").read(tr)
    assert idle == pytest.approx((1 - (1e-6 + 0.1)) * 100)
