"""The port's own C (``native/_hostops.c``): the collector's four framing
functions and their numpy plain versions, each equal byte for byte to
the JAX package's C functions (``klogs_tpu.native.hostops``, built by
its own loader), errors included; ``FramedBatcher`` against the JAX one
at every chunk split; the host engines' three scans (``dfa_scan``,
``sweep_candidates`` at every stage-1 tier this host has and with 8 and
16 buckets, ``group_scan``) against their plain versions and JAX's C,
with the sweep and MultiDFA blobs equal to JAX's byte for byte and the
knobs that select a plain version raising; and the loader's build,
which raises where it cannot build."""

import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from klogs_tpu.filters import framer as jframer
from klogs_tpu.native import hostops as jax_hostops
from klogs_tpu_torch import native
from klogs_tpu_torch.filters import base, framer

C = native.hostops()
INT32_MAX = 2**31 - 1

CHUNKS = [
    b"",
    b"no newline at all",
    b"\n",
    b"\n\n\n\n",
    b"a\r\nb\r\n\rc\r",
    b"one\ntwo\n\nthree",
    b"tail only\n" + b"x" * 300,
    bytes(range(256)) * 3,
]


def seeded_chunks(seed: int, n: int) -> list[bytes]:
    """Chunks of seeded lines cut at random points (mid-line, on a
    newline, runs of newlines, carriage returns)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n):
        body = rng.integers(0, 256, size=int(rng.integers(0, 90)),
                            dtype=np.uint8).tobytes().replace(b"\n", b"")
        parts.append(body + b"\r" * int(i % 5 == 2) + b"\n" * int(
            rng.integers(0, 4)))
    data = b"".join(parts)
    cuts = sorted(set(rng.integers(0, len(data), size=12).tolist()))
    return [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]


def lines_of(data: bytes) -> list[bytes]:
    return data.splitlines(keepends=True)


def offsets_of(lines: list[bytes]) -> np.ndarray:
    out = np.zeros(len(lines) + 1, dtype=np.int32)
    out[1:] = np.cumsum([len(ln) for ln in lines])
    return out


@pytest.mark.parametrize("chunk", CHUNKS + seeded_chunks(1, 40),
                         ids=lambda c: f"{len(c)}B")
@pytest.mark.parametrize("base_off", [0, 7, 1 << 20])
def test_find_newlines_equals_jax(chunk, base_off):
    exp = jax_hostops.find_newlines(chunk, base_off)
    assert C.find_newlines(chunk, base_off) == exp
    assert framer.find_newlines_plain(chunk, base_off) == exp


@pytest.mark.parametrize("base_off,data", [(INT32_MAX - 2, b"abcd"),
                                           (-1, b"a\n")])
def test_find_newlines_int32_guard(base_off, data):
    """The 2 GiB guard: a framed buffer past int32 raises OverflowError
    in all three, without allocating it."""
    for fn in (jax_hostops.find_newlines, C.find_newlines,
               framer.find_newlines_plain):
        with pytest.raises(OverflowError, match="int32"):
            fn(data, base_off)


@pytest.mark.parametrize("strip_nl", [0, 1])
@pytest.mark.parametrize("seed", [2, 3, 4])
def test_frame_lines_equals_jax(strip_nl, seed):
    lines = [b"", b"\n", b"\r\n", b"x\n\n\n", b"no newline"]
    for ch in seeded_chunks(seed, 50):
        lines += lines_of(ch)
    jp, jo, jraw = jax_hostops.frame_lines(lines, strip_nl)
    cp, co, craw = C.frame_lines(lines, strip_nl)
    assert (cp, co, craw) == (jp, jo, jraw)
    pp, po, praw = base.frame_lines_plain(lines, bool(strip_nl))
    assert (pp, po.tobytes(), praw) == (jp, jo, jraw)
    bp, bo, braw = base.frame_lines(lines, bool(strip_nl))
    assert (bp, bo.tobytes(), braw) == (jp, jo, jraw)
    assert bo.dtype == np.int32


def test_frame_lines_rejects_what_jax_rejects():
    for fn in (jax_hostops.frame_lines, C.frame_lines):
        with pytest.raises(TypeError):
            fn((b"a",), 1)
        with pytest.raises(TypeError):
            fn([b"a", "str"], 1)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_split_frame_equals_jax(seed):
    lines = []
    for ch in seeded_chunks(seed, 40):
        lines += lines_of(ch)
    payload, offs, _ = jax_hostops.frame_lines(lines, 0)
    o = np.frombuffer(offs, dtype=np.int32)
    exp = jax_hostops.split_frame(payload, o, len(o) - 1)
    assert exp == lines
    assert C.split_frame(payload, o, len(o) - 1) == exp
    assert base.split_frame(payload, o) == exp
    assert base.split_frame_plain(payload, o) == exp
    # A memoryview slab splits the same.
    assert base.split_frame(memoryview(payload), o) == exp


@pytest.mark.parametrize("bad", [[0, 3, 2], [0, 9], [-1, 2]])
def test_split_frame_offsets_out_of_range(bad):
    o = np.asarray(bad, dtype=np.int32)
    for fn in (lambda: jax_hostops.split_frame(b"abcd", o, len(o) - 1),
               lambda: C.split_frame(b"abcd", o, len(o) - 1),
               lambda: base.split_frame(b"abcd", o),
               lambda: base.split_frame_plain(b"abcd", o)):
        with pytest.raises(ValueError, match="split_frame"):
            fn()


def join_cases():
    rng = np.random.default_rng(8)
    for seed in (9, 10, 11):
        lines = []
        for ch in seeded_chunks(seed, 30):
            lines += lines_of(ch)
        n = len(lines)
        for mask in (rng.random(n) < 0.5, np.ones(n, bool),
                     np.zeros(n, bool), np.arange(n) % 3 == 0):
            yield lines, mask


@pytest.mark.parametrize("case", list(range(12)))
def test_join_kept_framed_equals_jax(case):
    lines, mask = list(join_cases())[case]
    payload, o = b"".join(lines), offsets_of(lines)
    n = len(lines)
    exp = jax_hostops.join_kept_framed(payload, o, n,
                                       mask.astype(np.uint8).tobytes())
    assert exp == b"".join(ln for ln, k in zip(lines, mask) if k)
    assert C.join_kept_framed(payload, o, n,
                              mask.astype(np.uint8).tobytes()) == exp
    assert framer.join_kept_framed(payload, o, mask) == exp
    assert framer.join_kept_framed_plain(payload, o, mask) == exp


def test_join_kept_framed_short_mask_and_bad_offsets_raise():
    """A mask shorter than the lines, and offsets out of range, raise
    ValueError in the JAX C, the port's C and its plain version."""
    payload, o = b"aa\nbb\ncc\n", np.array([0, 3, 6, 9], dtype=np.int32)
    short = np.array([1, 0], dtype=bool)
    for fn in (lambda: jax_hostops.join_kept_framed(payload, o, 3, b"\x01\x00"),
               lambda: C.join_kept_framed(payload, o, 3, b"\x01\x00"),
               lambda: framer.join_kept_framed(payload, o, short),
               lambda: framer.join_kept_framed_plain(payload, o, short)):
        with pytest.raises(ValueError, match="join_kept_framed"):
            fn()
    bad = np.array([0, 3, 2, 9], dtype=np.int32)
    mask = np.ones(3, dtype=bool)
    for fn in (lambda: jax_hostops.join_kept_framed(payload, bad, 3,
                                                    b"\x01" * 3),
               lambda: C.join_kept_framed(payload, bad, 3, b"\x01" * 3),
               lambda: framer.join_kept_framed(payload, bad, mask),
               lambda: framer.join_kept_framed_plain(payload, bad, mask)):
        with pytest.raises(ValueError, match="out of range"):
            fn()


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=400).map(
    lambda b: b.replace(b"a", b"\n").replace(b"b", b"\r")),
    base_off=st.integers(0, 1 << 24))
def test_find_newlines_hypothesis(data, base_off):
    exp = jax_hostops.find_newlines(data, base_off)
    assert C.find_newlines(data, base_off) == exp
    assert framer.find_newlines_plain(data, base_off) == exp


@settings(max_examples=60, deadline=None)
@given(lines=st.lists(st.binary(max_size=40).map(
    lambda b: b.replace(b"a", b"\n")), max_size=30),
    strip_nl=st.integers(0, 1), data=st.data())
def test_frame_join_split_hypothesis(lines, strip_nl, data):
    jp, jo, jraw = jax_hostops.frame_lines(lines, strip_nl)
    assert C.frame_lines(lines, strip_nl) == (jp, jo, jraw)
    o = np.frombuffer(jo, dtype=np.int32)
    n = len(lines)
    assert C.split_frame(jp, o, n) == jax_hostops.split_frame(jp, o, n)
    assert base.split_frame_plain(jp, o) == jax_hostops.split_frame(jp, o, n)
    mask = np.array(data.draw(st.lists(st.booleans(), min_size=n,
                                       max_size=n)), dtype=bool)
    exp = jax_hostops.join_kept_framed(jp, o, n,
                                       mask.astype(np.uint8).tobytes())
    assert framer.join_kept_framed(jp, o, mask) == exp
    assert framer.join_kept_framed_plain(jp, o, mask) == exp


def stream(seed: int) -> bytes:
    return b"".join(seeded_chunks(seed, 60)) + b"an unterminated tail"


@pytest.mark.parametrize("plain", [False, True], ids=["c", "plain"])
def test_framed_batcher_equals_jax_at_every_split(plain):
    """The stream cut in two at every byte, fed and taken (and taken
    final): the port's batcher (on its C sweep, and on the plain one)
    hands out what the JAX batcher does."""
    data = stream(12)[:1500]
    kw = {"find_newlines": framer.find_newlines_plain} if plain else {}
    for cut in range(len(data) + 1):
        mine, ref = framer.FramedBatcher(**kw), jframer.FramedBatcher()
        for ch in (data[:cut], data[cut:]):
            assert mine.feed(ch) == ref.feed(ch)
            if cut % 97 == 0:
                got, exp = mine.take(), ref.take()
                assert (got[0], got[1].tobytes(), got[2]) == \
                    (exp[0], exp[1].tobytes(), exp[2])
        got, exp = mine.take(final=True), ref.take(final=True)
        assert (got[0], got[1].tobytes(), got[2]) == \
            (exp[0], exp[1].tobytes(), exp[2])


def test_filtered_sink_writes_through_the_c_join(tmp_path):
    """The sink's kept-line join is the C one: an engine-free filter
    keeps every other line, and the file holds exactly those."""
    import asyncio

    from klogs_tpu_torch.filters.base import FilterStats
    from klogs_tpu_torch.filters.sink import FilteredSink
    from klogs_tpu_torch.runtime.sink import FileSink

    class EveryOther:
        async def match_framed(self, payload, offsets):
            return np.arange(len(offsets) - 1) % 2 == 0

    lines = [f"line {i}\n".encode() for i in range(50)]
    calls = []
    real = framer.hostops

    def counting():
        mod = real()

        class Spy:
            def __getattr__(self, name):
                if name == "join_kept_framed":
                    calls.append(name)
                return getattr(mod, name)
        return Spy()

    path = tmp_path / "out.log"

    async def go():
        inner = FileSink(str(path))
        sink = FilteredSink(inner, EveryOther(), FilterStats())
        for i in range(0, 50, 7):
            await sink.write(b"".join(lines[i:i + 7]))
        await sink.close()

    framer.hostops = counting
    try:
        asyncio.run(go())
    finally:
        framer.hostops = real
    assert path.read_bytes() == b"".join(lines[0::2])
    assert calls


# ---- the loader --------------------------------------------------------

def test_library_is_keyed_by_source_and_flags():
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR)
    assert native.build() == path
    assert native.hostops().__file__ == path


def test_build_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", "no-such-cc-anywhere")
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.build()


def test_build_raises_when_the_compiler_refuses(tmp_path, monkeypatch):
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(native.NativeBuildError, match="exit"):
        native.build()
    assert not [p for p in (tmp_path / "build").iterdir()
                if p.name.endswith(".tmp")]


def test_concurrent_builds_land_one_library(tmp_path, monkeypatch):
    """Builders started at once (as test workers are) each write a
    temporary file and rename it: one library, no temporary left, and it
    loads."""
    import importlib.machinery
    import importlib.util

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        paths[0].rsplit("/", 1)[1]]
    loader = importlib.machinery.ExtensionFileLoader(
        "klogs_tpu_torch.native._hostops", paths[0])
    spec = importlib.util.spec_from_loader(loader.name, loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    assert mod.find_newlines(b"a\nb\n", 0) == C.find_newlines(b"a\nb\n", 0)


# -- the host engines' scans (dfa_scan, sweep_candidates, group_scan) ---

def engine_corpus(seed: int, n: int) -> "list[bytes]":
    """Seeded log lines holding the literals of ENGINE_PATTERNS now and
    then, random bytes elsewhere (newlines stripped)."""
    rng = np.random.default_rng(seed)
    hits = [b"svc-0042 unreachable", b"errcode=00017", b"CRIT00099",
            b"ERROR 7", b"abccd", b"timed out", b"job-00003", b"xzq"]
    out = []
    for _ in range(n):
        body = rng.integers(32, 127, size=int(rng.integers(0, 120)),
                            dtype=np.uint8).tobytes()
        if rng.random() < 0.2:
            h = hits[int(rng.integers(0, len(hits)))]
            at = int(rng.integers(0, len(body) + 1))
            body = body[:at] + h + body[at:]
        out.append(body)
    return out


ENGINE_PATTERNS = (
    [r"ERROR \d+", "abc+d", "(x|y)z?q", "timed out", r"(?:FATAL|PANIC) "
     r"job-\d{5}"]
    + [f"svc-{i:04d} unreachable" for i in range(40)]
    + [rf"errcode={i:05d}\b" for i in range(40)]
    + [rf"CRIT{i:05d}" for i in range(40)])


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The port's and JAX's IndexedFilter over ENGINE_PATTERNS (host
    sweep), built once."""
    from klogs_tpu.filters.indexed import IndexedFilter as JIndexed
    from klogs_tpu_torch.filters.indexed import IndexedFilter as PIndexed

    mp = pytest.MonkeyPatch()
    mp.setenv("XDG_CACHE_HOME", str(tmp_path_factory.mktemp("xdg")))
    try:
        return (PIndexed(ENGINE_PATTERNS, sweep="host"),
                JIndexed(ENGINE_PATTERNS, sweep="host"))
    finally:
        mp.undo()


@pytest.mark.parametrize("threads", ["1", "3"])
@pytest.mark.parametrize("pats", [["ERROR", r"code=50[34]"],
                                  ["(ab|ba)+q", "^x", "y$"],
                                  ENGINE_PATTERNS[:20]],
                         ids=["two", "anchors", "twenty"])
def test_dfa_scan_equals_scan_python_and_jax(pats, threads, monkeypatch):
    """dfa_scan over 9000 lines (past the row-parallel threshold of 8192
    when KLOGS_HOST_THREADS > 1) equals scan_python and JAX's C; u16
    and u32 tables."""
    from klogs_tpu_torch.filters.compiler.dfa import build_dfa, scan_python
    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns

    monkeypatch.setenv("KLOGS_HOST_THREADS", threads)
    lines = [ln + b"\n" * (i % 3) for i, ln in
             enumerate(engine_corpus(11, 9000))]
    payload, off, _ = base.frame_lines_plain(lines, strip_nl=False)
    t = build_dfa(compile_patterns(pats))
    for table in (t.table, t.table.astype(np.uint32)):
        args = (payload, off, len(lines), table.tobytes(), t.n_classes,
                t.accept.tobytes(), t.byte_class.tobytes(), t.start,
                t.end_class, 1 if table.dtype == np.uint32 else 0)
        got = C.dfa_scan(*args)
        assert got == jax_hostops.dfa_scan(*args)
        assert (np.frombuffer(got, dtype=np.uint8).astype(bool).tolist()
                == scan_python(t, lines))
    with pytest.raises(ValueError, match="dfa_scan"):
        C.dfa_scan(payload, off[:-1], len(lines), t.table.tobytes(),
                   t.n_classes, t.accept.tobytes(), t.byte_class.tobytes(),
                   t.start, t.end_class, 0)


def simd_levels() -> "list[int]":
    """Every stage-1 tier this host's CPU has (0 scalar .. 3 avx512)."""
    return list(range(C.sweep_simd_level(-1) + 1))


@pytest.mark.parametrize("buckets", ["8", "16"])
def test_sweep_blob_and_candidates_equal_plain_and_jax(indexes, buckets,
                                                       monkeypatch):
    """The sweep blob equals JAX's byte for byte; sweep_candidates at
    every tier this host has gives the numpy sweep's mask and JAX's C's
    bits, survivors and column sums."""
    monkeypatch.setenv("KLOGS_SWEEP_BUCKETS", buckets)
    p, j = (f.index for f in indexes)
    blob = p.native_sweep_blob()
    assert blob == j.native_sweep_blob()
    assert np.frombuffer(blob, dtype="<i4")[32] == int(buckets)
    payload, off, _ = base.frame_lines_plain(engine_corpus(12, 3000))
    want = p.group_candidates(payload, off, impl="numpy")
    W = (p.n_groups + 31) // 32
    for level in simd_levels():
        stats, jstats = (np.zeros(3 + 32 * W, dtype=np.uint64)
                         for _ in range(2))
        raw = C.sweep_candidates(blob, payload, off, len(off) - 1, level,
                                 stats)
        assert raw == jax_hostops.sweep_candidates(
            blob, payload, off, len(off) - 1, level, jstats)
        assert np.array_equal(stats, jstats)
        bits = np.frombuffer(raw, dtype="<u4").reshape(len(off) - 1, W)
        gm = np.unpackbits(bits.view(np.uint8), axis=1, bitorder="little",
                           count=p.n_groups).view(bool)
        assert np.array_equal(gm, want), level
        assert np.array_equal(stats[3:3 + p.n_groups],
                              want.sum(axis=0))
    assert C.sweep_simd_level(3) == jax_hostops.sweep_simd_level(3)


def test_group_candidates_default_is_the_c(indexes, monkeypatch):
    """The index's own entry points run the C (last_impl "native") at
    each pinned tier, and equal the numpy sweep and JAX's."""
    p, j = (f.index for f in indexes)
    payload, off, _ = base.frame_lines_plain(engine_corpus(13, 2000))
    want = j.group_candidates(payload, off, impl="numpy")
    for pin in ("auto", "scalar", "ssse3", "sse2", "avx2", "avx512"):
        monkeypatch.setenv("KLOGS_NATIVE_SIMD", pin)
        assert np.array_equal(p.group_candidates(payload, off), want)
        assert p.last_impl == "native"
        assert p.last_stats.candidate_cells == int(want.sum())


def test_multidfa_blob_and_group_scan_equal_plain_and_jax(indexes):
    """multidfa_blob equals JAX's byte for byte; group_scan over the
    bool and the packed candidate matrix equals JAX's C and the
    per-group loop."""
    from klogs_tpu.filters.compiler.index import multidfa_blob as jblob
    from klogs_tpu_torch.filters.compiler.index import multidfa_blob

    pf, jf = indexes
    tables = [pf.groups[g].filt.tables for g in pf._dfa_cols]
    assert multidfa_blob(tables) == jblob(
        [jf.groups[g].filt.tables for g in jf._dfa_cols])
    payload, off, _ = base.frame_lines_plain(engine_corpus(14, 3000))
    gm = np.ascontiguousarray(pf.index.group_candidates(payload, off))
    packed = pf.index.group_candidates_packed(payload, off)
    dsum = gm.sum(axis=0)[pf._dfa_cols_arr]
    order = np.ascontiguousarray(
        np.argsort(dsum, kind="stable").astype(np.int32))
    plain = pf._scan_candidates(payload, off, gm, plain=True)
    blob = multidfa_blob(tables)
    for cand, is_packed in ((gm, 0), (packed, 1)):
        outs = []
        for mod in (C, jax_hostops):
            out = np.zeros(len(off) - 1, dtype=bool)
            n = mod.group_scan(blob, payload, off, len(off) - 1, cand,
                               cand.shape[1], pf._dfa_cols_arr, order, out,
                               is_packed)
            outs.append((n, out))
        assert outs[0][0] == outs[1][0]
        assert np.array_equal(outs[0][1], outs[1][1])
        rest = np.zeros_like(plain)
        for g in pf._rest_cols:
            rest |= gm[:, g]
        assert np.array_equal(outs[0][1] | (plain & rest), plain)
    with pytest.raises(ValueError):
        C.group_scan(b"bad blob", payload, off, len(off) - 1, gm,
                     gm.shape[1], pf._dfa_cols_arr, order,
                     np.zeros(len(off) - 1, dtype=bool), 0)


@pytest.mark.parametrize("knob,value", [
    ("KLOGS_NATIVE_SIMD", "off"), ("KLOGS_NATIVE_SIMD", "OFF"),
    ("KLOGS_NATIVE_GROUPSCAN", "off"), ("KLOGS_NATIVE_SIMD", "avx9"),
    ("KLOGS_NATIVE_GROUPSCAN", "maybe"), ("KLOGS_SWEEP_BUCKETS", "12")])
def test_plain_version_knobs_raise(indexes, knob, value, monkeypatch):
    """The knobs that select the numpy sweep or the per-group loop in
    the JAX package raise here, naming the knob, as malformed values
    do."""
    from klogs_tpu_torch.filters.compiler import index

    monkeypatch.setenv(knob, value)
    payload, off, _ = base.frame_lines_plain(engine_corpus(15, 50))
    with pytest.raises(ValueError, match=knob):
        indexes[0].fetch_framed(indexes[0].dispatch_framed(payload, off))
    if knob == "KLOGS_NATIVE_GROUPSCAN":
        with pytest.raises(ValueError, match=knob):
            index.native_groupscan_mode()
    monkeypatch.setenv("KLOGS_NATIVE_GROUPSCAN", "native")
    if knob != "KLOGS_NATIVE_GROUPSCAN":
        assert index.native_groupscan_mode() == "auto"


def test_library_builds_with_pthread_and_no_march():
    """The flags carry -pthread (the row-parallel scans) and no -march:
    the wide stage-1 tiers compile under target attributes."""
    assert "-pthread" in native.CFLAGS
    assert not any(f.startswith("-march") for f in native.CFLAGS)
    with open(native.SOURCE) as f:
        src = f.read()
    assert '__attribute__((target("avx512f,avx512bw")))' in src
    assert "__builtin_cpu_supports" in src
