"""The traffic generator of kind ``frames``: collectors' framed batches.

A collector flushes a frame of ``frame_lines`` log lines at a time and
sends it as one MatchFramed RPC. Each collector holds a pool of
``pool_frames`` frames, each built from ``(seed, collector, pool
index)`` before the window opens; send ``s`` of a collector sends pool
frame ``s % pool_frames`` with a counter field rewritten in every line,
so no frame repeats within a run, the flows of a collector have
different frames in flight, and any frame sent can be made again from
``(seed, collector, s)``.

A short line is the port's FakeCluster kubelet-style line (a frozen copy
of ``klogs_tpu_torch/cluster/fake.py`` ``synthetic_line``, so the
yardstick does not move with the program) ending in the counter field
`` n=<12 digits>``. The field is the last one of every line, after a
space, so no pattern of the configurations can read it: each of their
patterns needs some literal other than `` n=`` right before any digit it
reads, or text after it. ``needle_share`` of the short lines carry one of
the configuration's needles, written over the line from byte
``needle_at`` (lengths unchanged).

With ``long_every`` > 0 every such line is long: a short line's head, a
printable body and the counter field, ``long_min_bytes`` to
``long_max_bytes`` bytes in all (the body a window into a printable
block drawn for the frame), ``long_needle_share`` of them with one
needle in their body at an offset drawn for the line. Every frame holds
the same set of long sizes (the log-uniform distribution's quantiles,
``long_sizes``), so every frame asks for the same bytes; their order,
heads, bodies, needles and needle offsets are drawn for the frame. The
chunk kernels' time rests on where each long line first matches (a
matched line's state is absorbing) and on the lines' order (the engine
gives the chunk kernel's warps the long lines in frame order), so one
frame's time depends on its draw: a run sends
``collectors * pool_frames`` such frames and its rate averages over
them.
"""

import time
from dataclasses import dataclass

import numpy as np

LEVELS = ("INFO", "DEBUG", "WARN", "ERROR")
CTR_DIGITS = 12
CTR_FIELD = b" n="
_POW10 = 10 ** np.arange(CTR_DIGITS - 1, -1, -1, dtype=np.int64)


def synthetic_line(pod: str, container: str, seq: int, ts: float) -> bytes:
    """One kubelet-style log line without its newline (a frozen copy of
    the port's FakeCluster line)."""
    level = LEVELS[seq % len(LEVELS)]
    tstr = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts))
    return (
        f"{tstr} {level} pod={pod} container={container} seq={seq} "
        f"latency={(seq * 7) % 500}ms code={200 + (seq % 5) * 100} "
        f"msg=\"request {'failed' if level == 'ERROR' else 'handled'} "
        f"path=/api/v{seq % 3}/items\""
    ).encode()


@dataclass
class Frame:
    """One pool frame: the payload (every line ending in a newline), its
    int32 offsets, where each line's counter digits start, and which
    lines are long."""

    payload: np.ndarray  # uint8 [P], written in place by ``stamp``
    offsets: np.ndarray  # int32 [n + 1]
    ctr_pos: np.ndarray  # int64 [n]
    long_lines: np.ndarray  # int64 indices of the long lines

    @property
    def n_lines(self) -> int:
        return len(self.offsets) - 1


def _rng(seed: int, collector: int, pool_index: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, collector, pool_index])


def long_sizes(mix: dict) -> np.ndarray:
    """The long lines' sizes of one frame, smallest first: the quantiles
    of a log-uniform distribution over [long_min_bytes, long_max_bytes]."""
    n = mix["frame_lines"] // mix["long_every"]
    lo, hi = mix["long_min_bytes"], mix["long_max_bytes"]
    q = (np.arange(n) + 0.5) / n
    return np.round(lo * (hi / lo) ** q).astype(np.int64)


def build_frame(config: dict, mix: dict, seed: int, collector: int,
                pool_index: int) -> Frame:
    rng = _rng(seed, collector, pool_index)
    n = mix["frame_lines"]
    lines_cfg = config["lines"]
    needles = [x.encode() for x in config["needles"]]
    is_long = np.zeros(n, dtype=bool)
    if mix.get("long_every"):
        is_long[mix["long_every"] - 1::mix["long_every"]] = True
    pods = rng.integers(0, config["pods"], n)
    conts = rng.integers(0, lines_cfg["containers"], n)
    seqs = rng.integers(0, lines_cfg["seq_max"], n)
    short_idx = np.nonzero(~is_long)[0]
    n_needle = int(round(config["needle_share"] * len(short_idx)))
    needle_lines = set(rng.choice(short_idx, n_needle, replace=False).tolist())
    needle_pick = rng.integers(0, len(needles), n)
    long_idx = np.nonzero(is_long)[0]
    longs = {}
    if len(long_idx):
        sizes = rng.permutation(long_sizes(mix))
        n_long = len(long_idx)
        with_needle = np.zeros(n_long, dtype=bool)
        with_needle[rng.choice(n_long, int(round(
            mix["long_needle_share"] * n_long)), replace=False)] = True
        where = rng.random(n_long)
        # Each body is a window at a drawn start into one printable block
        # of the frame's, twice the longest line.
        block = (np.frombuffer(rng.bytes(2 * mix["long_max_bytes"]),
                               dtype=np.uint8) % 95 + 0x20).tobytes()
        body_at = rng.integers(0, mix["long_max_bytes"], n_long)
        longs = {int(i): j for j, i in enumerate(long_idx)}
    tail = CTR_FIELD + b"0" * CTR_DIGITS + b"\n"
    at = lines_cfg["needle_at"]
    clock = lines_cfg["clock_unix"]
    out = []
    for i in range(n):
        seq = int(seqs[i])
        head = synthetic_line(f"pod-{int(pods[i]):04d}", f"c{int(conts[i])}",
                              seq, clock + seq)
        if i in longs:
            j = longs[i]
            head += b" body="
            body_len = int(sizes[j]) - len(head) - len(tail)
            body = block[body_at[j]:body_at[j] + body_len]
            if with_needle[j]:
                nd = needles[int(needle_pick[i])]
                o = int(where[j] * (body_len - len(nd)))
                body = body[:o] + nd + body[o + len(nd):]
            line = head + body
        elif i in needle_lines:
            nd = needles[int(needle_pick[i])]
            line = head[:at] + nd + head[at + len(nd):]
        else:
            line = head
        out.append(line + tail)
    lens = np.fromiter((len(x) for x in out), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    payload = np.frombuffer(b"".join(out), dtype=np.uint8).copy()
    return Frame(payload=payload, offsets=offsets.astype(np.int32),
                 ctr_pos=offsets[1:] - 1 - CTR_DIGITS, long_lines=long_idx)


def build_pool(config: dict, mix: dict, seed: int,
               collector: int) -> "list[Frame]":
    return [build_frame(config, mix, seed, collector, p)
            for p in range(mix["pool_frames"])]


def pool_index(mix: dict, send_index: int) -> int:
    return send_index % mix["pool_frames"]


def stamp(frame: Frame, mix: dict, collector: int, send_index: int) -> bytes:
    """The bytes sent at ``send_index``: the pool frame with every
    line's counter set to a number no other line of the run carries."""
    n = frame.n_lines
    base = (send_index * mix["collectors"] + collector) * n
    vals = (base + np.arange(n, dtype=np.int64)) % 10**CTR_DIGITS
    digits = ((vals[:, None] // _POW10[None, :]) % 10 + 48).astype(np.uint8)
    frame.payload[frame.ctr_pos[:, None] + np.arange(CTR_DIGITS)] = digits
    return frame.payload.tobytes()


def frame_at(config: dict, mix: dict, seed: int, collector: int,
             send_index: int) -> "tuple[bytes, np.ndarray]":
    """(payload, offsets) of what ``collector`` sent at ``send_index``."""
    frame = build_frame(config, mix, seed, collector,
                        pool_index(mix, send_index))
    return stamp(frame, mix, collector, send_index), frame.offsets


def check_lines(frame: Frame, mix: dict, rng: np.random.Generator,
                with_longest: bool) -> np.ndarray:
    """The lines of a frame the reference judges, drawn from ``rng``:
    ``check_short_lines`` of the short ones and ``check_long_lines`` of
    the long ones (each a count, or "all"), and the frame's longest line
    where ``with_longest``."""
    def draw(idx: np.ndarray, want) -> np.ndarray:
        if want == "all" or want >= len(idx):
            return idx
        return rng.choice(idx, int(want), replace=False)

    is_long = np.zeros(frame.n_lines, dtype=bool)
    is_long[frame.long_lines] = True
    picked = [draw(np.nonzero(~is_long)[0], mix["check_short_lines"])]
    if len(frame.long_lines):
        picked.append(draw(frame.long_lines, mix["check_long_lines"]))
        if with_longest:
            lens = np.diff(frame.offsets.astype(np.int64))[frame.long_lines]
            picked.append(frame.long_lines[[int(np.argmax(lens))]])
    return np.unique(np.concatenate(picked))
