"""The port's numpy framing helpers equal the JAX package's (native where
built), and its AsyncFilterService coalesces concurrent callers while
handing each its own verdicts."""

import asyncio

import numpy as np
import pytest

from klogs_tpu.filters import base as jbase
from klogs_tpu.filters import framer as jframer
from klogs_tpu_torch.filters import base, framer
from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.gpu import GpuEngineFilter, strip_newlines


def seeded_lines(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = rng.integers(32, 127, size=int(rng.integers(0, 40)),
                            dtype=np.uint8).tobytes()
        out.append(body + b"\n" * int(i % 4 == 1) + b"\n\n" * int(i % 7 == 3))
    return out + [b"", b"\n", b"x"]


@pytest.mark.parametrize("strip_nl", [True, False])
def test_frame_lines_equals_jax(strip_nl):
    lines = seeded_lines(1, 60)
    p, o, raw = base.frame_lines(lines, strip_nl=strip_nl)
    jp, jo, jraw = jbase.frame_lines(lines, strip_nl=strip_nl)
    assert (p, raw) == (jp, jraw)
    assert o.dtype == np.int32 and np.array_equal(o, jo)
    assert base.split_frame(p, o) == jbase.split_frame(jp, jo)


def test_pack_framed_rows_equals_jax():
    lines = seeded_lines(2, 50)
    p, o, _ = base.frame_lines(lines)
    sel = np.array([3, 0, 7, 11, 40])
    lens = np.diff(o)[sel] - 1
    lens[lens < 0] = 0
    for kw in ({}, {"rows": 64}, {"rows": 8, "sel": sel},
               {"rows": 8, "sel": sel, "lens": lens}):
        got = base.pack_framed_rows(p, o, 48, **kw)
        exp = jbase.pack_framed_rows(p, o, 48, **kw)
        assert np.array_equal(got[0], exp[0]) and np.array_equal(got[1], exp[1])


def test_strip_newlines_is_rstrip():
    lines = seeded_lines(3, 40)
    p, o, _ = base.frame_lines(lines, strip_nl=False)
    starts, ends = strip_newlines(p, o)
    assert [p[s:e] for s, e in zip(starts, ends)] == \
        [ln.rstrip(b"\n") for ln in lines]


def chunked(data: bytes, size: int) -> list[bytes]:
    return [data[i:i + size] for i in range(0, len(data), size)]


@pytest.mark.parametrize("size", [1, 7, 64, 10_000])
def test_framed_batcher_equals_jax(size):
    data = b"".join(seeded_lines(4, 30)) + b"tail without newline"
    mine, ref = framer.FramedBatcher(), jframer.FramedBatcher()
    for i, ch in enumerate(chunked(data, size)):
        assert mine.feed(ch) == ref.feed(ch)
        if i % 5 == 4:
            got, exp = mine.take(), ref.take()
            assert got[0] == exp[0] and got[2] == exp[2]
            assert np.array_equal(got[1], exp[1])
    got, exp = mine.take(final=True), ref.take(final=True)
    assert got[0] == exp[0] and got[2] == exp[2]
    assert np.array_equal(got[1], exp[1])
    assert mine.take(final=True)[2] == 0


def test_join_kept_framed_equals_native():
    lines = seeded_lines(5, 33)
    p, o, _ = base.frame_lines(lines, strip_nl=False)
    rng = np.random.default_rng(5)
    for mask in (rng.random(len(lines)) < 0.5, np.ones(len(lines), bool),
                 np.zeros(len(lines), bool)):
        exp = b"".join(ln for ln, k in zip(lines, mask) if k)
        assert framer.join_kept_framed(p, o, mask) == exp


def test_async_service_coalesces_and_splits_verdicts():
    eng = GpuEngineFilter(["ERROR", r"code=5\d\d"], device="cpu")
    svc = AsyncFilterService(eng)
    batches = [[f"{i} ERROR".encode(), b"ok", f"code={500 + i}".encode()]
               for i in range(6)] + [[b"nothing"] * 5]

    async def go():
        framed = [base.frame_lines(b)[:2] for b in batches[:3]]
        res = await asyncio.gather(
            *[svc.match_framed(p, o) for p, o in framed],
            *[svc.match(b) for b in batches[3:]])
        await svc.aclose()
        return res

    res = asyncio.run(go())
    assert svc.batches_dispatched == 1
    for got, lines in zip(res, batches):
        exp = [b"ERROR" in ln or b"code=5" in ln for ln in lines]
        assert list(got) == exp
    with pytest.raises(RuntimeError, match="closed"):
        asyncio.run(svc.match([b"late"]))
