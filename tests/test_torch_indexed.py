"""The port's IndexedFilter (``filters/indexed.py``) against the JAX
package's on the same seeded corpora, K = 64 to 1024: verdicts (exact),
the narrowing counters, ``engine_kinds``, the metric families, scan-all
(``narrow=False``), the adaptive bypass and re-guard (triggered with
small ``*_LINES``), the pipelined slab schedule, a line over 4 KiB, and
``sweep="device"`` on ``device="cpu"`` (the plain versions of
``pack_rows`` and the torch sweep) against the host sweep. The DFA
table cache lives under ``tmp_path``."""

import numpy as np
import pytest
import torch

from klogs_tpu.filters import indexed as jidx
from klogs_tpu.filters.base import frame_lines
from klogs_tpu.obs.metrics import Registry as JRegistry
from klogs_tpu_torch.filters import indexed as pidx
from klogs_tpu_torch.obs.metrics import Registry as PRegistry


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEED = 20261019
FAMILIES = [
    lambda i: f"svc-{i:04d} unreachable",
    lambda i: rf"errcode={i:05d}\b",
    lambda i: rf"CRIT{i:05d}",
    lambda i: f"deploy/rel-{i:04d} failed",
    lambda i: rf"(?:FATAL|PANIC) job-{i:05d}",
    lambda i: rf"user=u{i:06d} denied",
]
HEAD = [r"ERROR \d+", "abc+d", r"(x|y)z?q", r"(a)b\1", r"latency=4\dms",
        "timed out", r"code=50[34]"]


def patterns(k: int) -> "list[str]":
    """k patterns: a few regexes (one with a backreference: its group
    runs on `re`) and minted literal families."""
    return HEAD + [FAMILIES[i % len(FAMILIES)](i) for i in range(k - len(HEAD))]


def needle(i: int) -> str:
    return [f"svc-{i:04d} unreachable", f"errcode={i:05d}", f"CRIT{i:05d}",
            f"deploy/rel-{i:04d} failed", f"PANIC job-{i:05d}",
            f"user=u{i:06d} denied"][i % len(FAMILIES)]


def corpus(n: int, k: int, seed: int = SEED, long_every: int = 0,
           dense: float = 0.0) -> "list[bytes]":
    """Seeded log lines, ~5% with a needle (some just past the set: near
    misses), a few regex hits, optional long lines and an optional
    omnipresent guard literal (``dense``: share of lines holding
    ``timed out``)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        parts = [f"2026-10-18T00:00:{j % 60:02d}Z", "INFO",
                 f"req={int(rng.integers(0, 1 << 20))}"]
        r = rng.random()
        if r < 0.05:
            parts.append(needle(int(rng.integers(0, k + 40))))
        elif r < 0.08:
            parts.append(["ERROR 42", "abccd", "xzq", "abb", "latency=47ms",
                          "code=503"][int(rng.integers(0, 6))])
        if rng.random() < dense:
            parts.append("timed out")
        line = " ".join(parts)
        if long_every and j % long_every == 7:
            line += " " + "y" * int(rng.integers(4097, 9000)) + needle(3)
        out.append(line.encode() + b"\n" * int(rng.integers(0, 2)))
    return out


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    for k in ("KLOGS_INDEX_BYPASS_RATIO", "KLOGS_INDEX_BYPASS_LINES",
              "KLOGS_INDEX_DENSE_RATIO", "KLOGS_INDEX_DENSE_LINES",
              "KLOGS_SWEEP_PIPELINE", "KLOGS_SWEEP_BUCKETS",
              "KLOGS_NATIVE_SIMD", "KLOGS_NATIVE_GROUPSCAN",
              "KLOGS_TPU_SWEEP"):
        monkeypatch.delenv(k, raising=False)


def both(pats, **kw):
    return (pidx.IndexedFilter(pats, registry=PRegistry(), sweep="host", **kw),
            jidx.IndexedFilter(pats, registry=JRegistry(), sweep="host", **kw))


def run(f, lines, batch: int = 512) -> np.ndarray:
    """The sink's framed calls, ``batch`` lines at a time."""
    out = []
    for i in range(0, len(lines), batch):
        payload, off, _ = frame_lines(lines[i:i + batch])
        out.append(np.asarray(f.fetch_framed(f.dispatch_framed(payload, off))))
    return np.concatenate(out)


def counters(f) -> dict:
    return {"swept_lines": f.swept_lines, "swept_cells": f.swept_cells,
            "candidate_cells": f.candidate_cells,
            "candidate_lines": f.candidate_lines, "bypassed": f.bypassed,
            "banned": f.banned_factors, "kinds": f.engine_kinds,
            "groups": [g.members for g in f.groups],
            "group_scan_impl": f.group_scan_impl,
            "stages": sorted(f.stage_s)}


FAMILY_NAMES = (
    "klogs_prefilter_groups", "klogs_sweep_batches_total",
    "klogs_sweep_lines_total", "klogs_sweep_candidate_lines_total",
    "klogs_sweep_impl_batches_total", "klogs_sweep_bypass_total",
    "klogs_groupscan_batches_total", "klogs_groupscan_rows_total",
    "klogs_groupscan_cells_total", "klogs_prefilter_reguard_total",
    "klogs_prefilter_table_cache_events_total")


def family_values(reg, names=FAMILY_NAMES) -> dict:
    """{family: {labels: value}} of counters and gauges."""
    out = {}
    for name in names:
        fam = reg.family(name)
        out[name] = {tuple(sorted(labels.items())): v
                     for labels, v in _samples(fam)}
    return out


def _samples(fam):
    for labelvalues, child in fam.children():
        yield dict(zip(fam.labelnames, labelvalues)), child.value


@pytest.fixture(scope="module")
def k1024(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("XDG_CACHE_HOME", str(tmp_path_factory.mktemp("xdg1024")))
    pats = patterns(1024)
    p, j = (pidx.IndexedFilter(pats, sweep="host"),
            jidx.IndexedFilter(pats, sweep="host"))
    mp.undo()
    return pats, p, j


def test_k1024_verdicts_counters_and_oracle(k1024):
    import re

    pats, p, j = k1024
    lines = corpus(3000, 1024)
    got = run(p, lines)
    assert np.array_equal(got, run(j, lines))
    assert counters(p) == counters(j)
    assert p.engine_kinds == {"dfa": len(p.groups) - 1, "re": 1}
    oracle = re.compile("|".join(f"(?:{x})" for x in pats).encode())
    want = [oracle.search(ln.rstrip(b"\n")) is not None for ln in lines]
    assert got.tolist() == want
    assert 0 < p.narrowing_ratio < 0.2
    assert p.index.last_impl == "native"


def test_k1024_device_sweep_on_cpu_equals_host(k1024):
    """sweep="device" on device "cpu": pack_rows and the torch sweep's
    plain versions give the host sweep's candidate matrix bit for bit,
    and the same verdicts; a slab with a line past SWEEP_MAX_WIDTH
    sweeps on the host (a route, counted under path=host)."""
    pats, p, _ = k1024
    d = pidx.IndexedFilter(pats, sweep="device", device="cpu",
                           registry=PRegistry())
    assert d._sweep_path == "device"
    lines = corpus(1500, 1024, seed=SEED + 1)
    payload, off, _ = frame_lines(lines)
    gm = d._device_candidates(payload, off)
    assert np.array_equal(gm, p.index.group_candidates(payload, off))
    assert np.array_equal(gm, p.index.group_candidates(payload, off,
                                                       impl="numpy"))
    assert np.array_equal(run(d, lines), run(p, lines))
    long_lines = corpus(300, 1024, seed=SEED + 2, long_every=100)
    assert np.array_equal(run(d, long_lines, batch=100),
                          run(p, long_lines, batch=100))
    batches = {tuple(labels.items()): v for labels, v in _samples(
        d.registry.family("klogs_sweep_batches_total"))}
    assert batches == {(("path", "device"),): 3.0, (("path", "host"),): 3.0}


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("ignore_case", [False, True], ids=["case", "I"])
def test_verdicts_counters_and_families_equal_jax(k, ignore_case):
    pats = patterns(k)
    p, j = both(pats, ignore_case=ignore_case)
    lines = corpus(2500, k, seed=SEED + k)
    if ignore_case:
        lines = [ln.upper() if i % 3 == 0 else ln
                 for i, ln in enumerate(lines)]
    assert np.array_equal(run(p, lines), run(j, lines))
    assert counters(p) == counters(j)
    assert family_values(p.registry) == family_values(j.registry)


def test_scan_all_equals_jax():
    pats = patterns(64)
    p, j = both(pats, narrow=False)
    lines = corpus(1500, 64, seed=SEED + 3)
    assert np.array_equal(run(p, lines), run(j, lines))
    assert counters(p) == counters(j)
    assert p.candidate_cells == p.swept_cells


def test_bypass_equals_jax(monkeypatch):
    """A stream the index does not narrow (the bypass ratio forced to
    0) switches to scan-all after KLOGS_INDEX_BYPASS_LINES lines."""
    monkeypatch.setenv("KLOGS_INDEX_BYPASS_LINES", "1000")
    monkeypatch.setenv("KLOGS_INDEX_BYPASS_RATIO", "0")
    pats = patterns(64)
    p, j = both(pats)
    lines = corpus(3000, 64, seed=SEED + 4)
    assert np.array_equal(run(p, lines), run(j, lines))
    assert p.bypassed and j.bypassed
    assert counters(p) == counters(j)
    assert family_values(p.registry) == family_values(j.registry)


def test_reguard_equals_jax(monkeypatch):
    """A guard literal in most lines ("timed out") is banned after
    KLOGS_INDEX_DENSE_LINES, the index re-guarded and re-anchored; the
    verdicts do not change."""
    monkeypatch.setenv("KLOGS_INDEX_DENSE_LINES", "1024")
    pats = patterns(64)
    p, j = both(pats)
    lines = corpus(4000, 64, seed=SEED + 5, dense=0.9)
    assert np.array_equal(run(p, lines, batch=2048),
                          run(j, lines, batch=2048))
    assert p.banned_factors == j.banned_factors == (b"timed out",)
    assert counters(p) == counters(j)
    assert family_values(p.registry) == family_values(j.registry)


def test_reguard_rebuilds_the_device_tables(monkeypatch):
    monkeypatch.setenv("KLOGS_INDEX_DENSE_LINES", "1024")
    pats = patterns(64)
    d = pidx.IndexedFilter(pats, sweep="device", device="cpu")
    h = pidx.IndexedFilter(pats, sweep="host")
    lines = corpus(3000, 64, seed=SEED + 6, dense=0.9)
    before = d._sweep_tables
    assert np.array_equal(run(d, lines, batch=2048),
                          run(h, lines, batch=2048))
    assert d.banned_factors == (b"timed out",)
    assert d._sweep_tables is not before
    assert d._sweep_path == "device"


@pytest.mark.parametrize("depth", ["2", "3"])
def test_pipelined_slabs_equal_serial_and_jax(monkeypatch, depth):
    """KLOGS_SWEEP_PIPELINE: with slabs cut small, the pipelined
    schedule gives the serial schedule's verdicts and counters, and
    JAX's."""
    monkeypatch.setattr(pidx, "NATIVE_SLAB_LINES", 700)
    monkeypatch.setattr(jidx, "NATIVE_SLAB_LINES", 700)
    pats = patterns(64)
    lines = corpus(5000, 64, seed=SEED + 7)
    monkeypatch.setenv("KLOGS_SWEEP_PIPELINE", "off")
    serial = pidx.IndexedFilter(pats, sweep="host")
    want = run(serial, lines, batch=5000)
    monkeypatch.setenv("KLOGS_SWEEP_PIPELINE", depth)
    p, j = both(pats)
    assert p._pipe_depth == int(depth)
    assert np.array_equal(run(p, lines, batch=5000), want)
    assert np.array_equal(run(j, lines, batch=5000), want)
    assert counters(p) == counters(serial) == counters(j)


def test_plain_group_scan_equals_the_c(monkeypatch):
    """The per-group loop (the plain version of group_scan) gives the
    C's verdicts on the same candidate matrix, packed and unpacked."""
    pats = patterns(256)
    p = pidx.IndexedFilter(pats, sweep="host")
    payload, off, _ = frame_lines(corpus(2000, 256, seed=SEED + 8))
    gm = p.index.group_candidates(payload, off)
    packed = p.index.group_candidates_packed(payload, off)
    c1 = p._scan_candidates(payload, off, gm)
    c2 = p._scan_candidates(payload, off, None, packed=packed)
    plain = p._scan_candidates(payload, off, gm, plain=True)
    assert np.array_equal(c1, plain) and np.array_equal(c2, plain)


def test_sweep_rule_and_knobs(monkeypatch):
    """auto never sweeps on the card in a process without CUDA
    initialised; the knobs that select a plain version raise naming
    the knob; a bad pipeline depth raises."""
    pats = patterns(64)
    assert not torch.cuda.is_initialized()
    f = pidx.IndexedFilter(pats)
    assert f._sweep_path == "host" and f._sweep_tables is None
    lines = corpus(200, 64)
    for knob in ("KLOGS_NATIVE_SIMD", "KLOGS_NATIVE_GROUPSCAN"):
        monkeypatch.setenv(knob, "off")
        with pytest.raises(ValueError, match=knob):
            run(f, lines)
        monkeypatch.delenv(knob)
    monkeypatch.setenv("KLOGS_NATIVE_GROUPSCAN", "native")
    monkeypatch.setenv("KLOGS_NATIVE_SIMD", "scalar")
    assert np.array_equal(run(f, lines), run(pidx.IndexedFilter(pats), lines))
    monkeypatch.setenv("KLOGS_SWEEP_PIPELINE", "deep")
    with pytest.raises(ValueError, match="KLOGS_SWEEP_PIPELINE"):
        pidx.IndexedFilter(pats)
    with pytest.raises(ValueError, match="sweep"):
        pidx.IndexedFilter(pats, sweep="gpu")


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "scan_all"])
def test_spans_equal_jax(narrow):
    """Each slab is a ``device.sweep`` span (path) when it narrows and a
    ``device.groupscan`` span (impl, rows, cells) in both packages, with
    the same names, attributes and values but the timings."""
    from klogs_tpu.obs import trace as jtrace
    from klogs_tpu_torch.obs import trace as ptrace

    pats = patterns(64)
    p, j = both(pats, narrow=narrow)
    lines = corpus(1500, 64, seed=SEED + 9)
    got = {}
    for name, tr, f in (("port", ptrace, p), ("jax", jtrace, j)):
        docs: list = []
        tr.reset(1.0)
        tr.TRACER.add_sink(docs.append)
        try:
            run(f, lines)
        finally:
            tr.TRACER.remove_sink(docs.append)
            tr.reset(None)
        got[name] = [(d["name"], {k: v for k, v in d["attrs"].items()})
                     for d in docs]
    assert got["port"] == got["jax"]
    names = {n for n, _ in got["port"]}
    assert names == ({"device.sweep", "device.groupscan"} if narrow
                     else {"device.groupscan"})
