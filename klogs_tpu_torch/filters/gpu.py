"""GpuEngineFilter: the ``--backend cuda`` LogFilter.

Counterpart of ``klogs_tpu/filters/tpu.py`` (``NFAEngineFilter``). The
host frames lines into width-bucketed ``[rows, width]`` uint8 batches
(numpy), copies them to the device, classifies bytes into class ids
there (``ops/nfa.py:classify_chunk``) and runs the grouped NFA kernel
(``ops/nfa_kernels.py:match_cls_grouped``); the per-line verdicts gate
the file writes.

- Widths and batch sizes are padded to power-of-two buckets, exactly as
  the JAX engine buckets them (the width clamps to ``chunk_bytes``).
- Lines longer than ``chunk_bytes`` run the carried-state chunk kernel
  (``_match_long``), chunk by chunk with the state carried on the
  device. Lines over ``SEQ_SCAN_BYTES``, which the JAX engine sends to
  its sequence-parallel scan, take the same chunk path here; the
  verdicts are the same.
- Trailing newlines are stripped before matching, so ``$`` sees the
  logical end of the line; a ``match_all`` pattern set skips the device.

``dispatch``/``dispatch_framed`` enqueue the device work on the calling
thread's current stream, start the copies of the verdicts into pinned
host memory and record a CUDA event; ``fetch``/``fetch_framed`` wait on
that event only, so they may run on any thread (AsyncFilterService
fetches from its executor threads, whose current stream differs). On a
CPU device everything runs synchronously through the kernels' plain
versions.
"""

import numpy as np
import torch

from klogs_tpu_torch.filters.base import LogFilter, frame_lines, pack_framed_rows
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.ops import nfa, nfa_kernels

# Smallest pad width; also the bucket floor.
MIN_BUCKET = 128
# Smallest batch-dimension bucket.
MIN_BATCH_BUCKET = 8


def _bucket_len(n: int, chunk_bytes: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, chunk_bytes)


def _bucket_batch(n: int) -> int:
    b = MIN_BATCH_BUCKET
    while b < n:
        b *= 2
    return b


def strip_newlines(payload: bytes, offsets) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) int64 of each framed line with its trailing newline
    run removed (the ``rstrip(b"\\n")`` rule, vectorized)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    starts = offsets[:-1]
    ends = offsets[1:].copy()
    if len(payload):
        arr = np.frombuffer(payload, dtype=np.uint8)
        while True:
            # One pass per byte of the longest newline run (almost
            # always one).
            m = (ends > starts) & (arr[np.maximum(ends, 1) - 1] == 0x0A)
            if not bool(m.any()):
                break
            ends[m] -= 1
    return starts, ends


class GpuEngineFilter(LogFilter):
    """Batch-NFA filter on the port's CUDA kernels (``device=None`` means
    ``"cuda"``; a CPU device runs the kernels' plain versions)."""

    SEQ_SCAN_BYTES = 128 * 1024

    def __init__(self, patterns: list[str], ignore_case: bool = False,
                 chunk_bytes: int = 4096, device=None):
        self.device = nfa.resolve_device(device)
        self._chunk_bytes = chunk_bytes
        prog = compile_patterns(patterns, ignore_case=ignore_case)
        self._match_all = prog.match_all
        # Full-line batches: patterns binned into automata of <= 128
        # states over one shared classifier.
        self._grouped, self._g_live, self._g_acc = nfa.compile_grouped(
            patterns, ignore_case=ignore_case, device=self.device)
        # Long-line chunks: the single augmented union automaton (one
        # state space to carry across chunks).
        self._aug = nfa.pack_program(nfa.augment(prog), device=self.device)
        self._live, self._acc = prog.n_states, prog.n_states + 1

    def match_lines(self, lines: list[bytes]) -> list[bool]:
        return self.fetch(self.dispatch(lines))

    def dispatch(self, lines: list[bytes]):
        payload, offsets, _ = frame_lines(lines)
        return self.dispatch_framed(payload, offsets)

    def fetch(self, handle) -> list[bool]:
        return self.fetch_framed(handle).tolist()

    def _width_buckets(self, lens: np.ndarray, short: np.ndarray,
                       n: int) -> np.ndarray:
        """Power-of-two width bucket per row, clamped to chunk_bytes like
        _bucket_len."""
        chunk = self._chunk_bytes
        width_of = np.full(n, min(MIN_BUCKET, chunk), dtype=np.int64)
        w = MIN_BUCKET
        while w < chunk and bool((short & (lens > w)).any()):
            w *= 2
            width_of[lens > w // 2] = min(w, chunk)
        return width_of

    def dispatch_framed(self, payload: bytes, offsets):
        """Enqueue the device work for a framed batch; returns a handle
        for fetch_framed."""
        n = len(offsets) - 1
        if n == 0:
            return (0, [], None)
        if self._match_all:
            return (n, None, None)
        starts, ends = strip_newlines(payload, offsets)
        lens = ends - starts
        short = lens <= self._chunk_bytes
        parts = []
        if bool(short.any()):
            width_of = self._width_buckets(lens, short, n)
            for w in np.unique(width_of[short]):
                sel = np.nonzero(short & (width_of == w))[0]
                rows = _bucket_batch(len(sel))
                batch, sub_lens = pack_framed_rows(
                    payload, offsets, int(w), rows=rows, sel=sel,
                    lens=lens[sel])
                lengths = np.zeros(rows, dtype=np.int32)
                lengths[:len(sel)] = sub_lens
                parts.append((sel, self._match_short(batch, lengths)))
        if not bool(short.all()):
            rest = np.nonzero(~short)[0]
            bodies = [payload[int(starts[i]):int(ends[i])] for i in rest]
            parts.append((rest, self._match_long(bodies)))
        return self._start_fetch(n, parts)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _match_short(self, batch: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """[rows, width] bytes + lengths -> [rows] bool on the device: the
        main path (device classify, then the grouped kernel)."""
        cls = nfa.classify_chunk(self._grouped, self._to_device(batch),
                                 self._to_device(lengths), first=True,
                                 final=True)
        return nfa_kernels.match_cls_grouped(self._grouped, self._g_live,
                                             self._g_acc, cls)

    def _match_long(self, bodies: list[bytes]) -> torch.Tensor:
        """Carried-state chunked matching: every long line advances in
        lockstep, the state carried across chunks on the device."""
        L = self._chunk_bytes
        B = _bucket_batch(len(bodies))
        total = np.zeros(B, dtype=np.int64)
        total[:len(bodies)] = [len(b) for b in bodies]
        pad = [b""] * (B - len(bodies))
        n_chunks = int(-(-int(total.max()) // L))
        v = nfa_kernels.initial_state(self._aug, self._live, B)
        matched = None
        for k in range(n_chunks):
            seg = b"".join(b[k * L:(k + 1) * L].ljust(L, b"\0")
                           for b in list(bodies) + pad)
            chunk = np.frombuffer(bytearray(seg), dtype=np.uint8).reshape(B, L)
            rem = (total - k * L).astype(np.int32)
            final = k == n_chunks - 1
            cls = nfa.classify_chunk(self._aug, self._to_device(chunk),
                                     self._to_device(rem), first=k == 0,
                                     final=final)
            v, matched = nfa_kernels.match_chunk_cls(self._aug, self._acc,
                                                     cls, v, final=final)
        return matched

    def _start_fetch(self, n: int, parts: list):
        """Start the verdict copies to the host; on CUDA, record the event
        fetch waits on."""
        if self.device.type != "cuda":
            return (n, [(idx, m[:len(idx)]) for idx, m in parts], None)
        host = []
        for idx, m in parts:
            h = torch.empty(len(idx), dtype=torch.bool, pin_memory=True)
            h.copy_(m[:len(idx)], non_blocking=True)
            host.append((idx, h))
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return (n, host, done)

    def fetch_framed(self, handle) -> np.ndarray:
        n, parts, done = handle
        if parts is None:
            return np.ones(n, dtype=bool)
        if done is not None:
            done.synchronize()
        out = np.zeros(n, dtype=bool)
        for idx, h in parts:
            out[idx] = h.numpy()
        return out
