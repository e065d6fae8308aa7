"""GpuEngineFilter: the ``--backend cuda`` LogFilter.

Counterpart of ``klogs_tpu/filters/tpu.py`` (``NFAEngineFilter``). A
framed batch crosses to the device once: the host sorts the lines into
width buckets and writes the payload and every bucket's starts and
lengths into one pinned buffer, copied with one non-blocking H2D. On the
device one kernel a bucket (``ops/pack.py:pack_classify_rows``) strips
each line's trailing newlines and cuts and classifies its row out of the
payload into class ids, and the grouped NFA kernel
(``ops/nfa_kernels.py:match_cls_grouped``) gives the per-line verdicts
that gate the file writes. (The JAX engine packs, strips and classifies
on the host instead, in ``klogs_tpu/native/_hostops.c``.)

- Widths and batch sizes are padded to power-of-two buckets, exactly as
  the JAX engine buckets them (the width clamps to ``chunk_bytes``). As
  in the JAX engine's cls path, the buckets, the split into short and
  long lines and the stats' bytes go by raw lengths, trailing newlines
  included; on the bytes path (the literal sweep) the host strips the
  newlines first, as the JAX engine's bytes path does.
- Lines longer than ``chunk_bytes`` run a carried-state chunk kernel
  (``_match_long``), chunk by chunk with the state carried on the
  device, each chunk cut and classified from the payload already there
  (``pack_classify_rows`` with ``skip = k * chunk_bytes``): K2
  (``match_chunk_cls``) over the augmented union automaton, or, for a
  set whose union is wider than ``GROUPED_LONG_STATES`` (K2's register
  kernel), K2g (``match_chunk_cls_grouped``) over the grouped program,
  a carry per (line, group); the union is then never built on the
  device. That holds at every group width: K2g's register kernel up to
  1024 states a group, its wide kernel up to ``nfa_kernels.WIDE_WORDS``
  (5120 states), its shared-memory kernel past that (a group is that
  wide only under ``KLOGS_MAX_PATTERN_POSITIONS`` raised past 4096).
  Lines over
  ``SEQ_SCAN_BYTES``, which the JAX engine sends to its
  sequence-parallel scan, take the same chunk path here, with the same
  verdicts: the port's scan (``ops/seqscan.py``) lost to K2 at every
  point measured on the H100 (S = 128 to 512; one line of 192 KiB or
  1 MiB, eight of 128-192 KiB; ``PERF.md`` §6), so no line is routed to
  it.
- Trailing newlines are stripped before matching, so ``$`` sees the
  logical end of the line (on the card, by ``pack_classify_rows``); a
  ``match_all`` pattern set skips the device.
- The thousand-pattern path: when the gate policy (``filters/cpu.py``)
  picks the device literal sweep (auto: K >= ``KLOGS_INDEX_MIN_K`` on
  ``cuda``), or ``KLOGS_TPU_PREFILTER=1`` asks for the pair-CNF gate,
  short lines get per-(line, group) candidate bits on the device (the
  sweep over the packed rows, or the pair-CNF over the class ids) and
  run the gated kernel K3 (``match_cls_grouped_gated``) instead of K1.
  A gate that reads bytes (the sweep, the byte-domain pair-CNF) gets the
  rows' bytes from the same ``pack_classify_rows`` launch.
  Long lines stay on K2 or K2g, ungated, as in the JAX engine. A
  failed table build or launch raises; nothing falls back to K1.
- ``KLOGS_TPU_FUSED_GROUPS=1`` (``ops/tune.py`` ``chain_selection``)
  runs the fused-groups kernel K4 (``match_cls_grouped_fused``) on
  short lines instead of K1. K4 has no gated variant: an auto sweep
  stays off, a forced gate raises (``check_fused_gates``), both when
  the engine is built. Long lines stay on K2 or K2g.

So short lines run K1 by default, K3 under a gate, K4 under
``KLOGS_TPU_FUSED_GROUPS=1``; long lines run K2, or K2g past
``GROUPED_LONG_STATES`` union states.

The short lines' half (the grouped program, the kernel choice and the
gate) is ``ShortLines``. With ``engine=`` a ``parallel.mesh.MeshEngine``
(the engine factory builds one on a host of several cards), the filter
keeps only the long lines, on the mesh's first device: it lays a batch
out once, with each width bucket's rows padded to a multiple of the
mesh's data shards, stages it once on each distinct device of the mesh,
and hands each bucket to the mesh, whose pattern shards are each a
``ShortLines`` of their own (``parallel/mesh.py``). The stats count a
sub-batch once, not once a shard, and (as in the JAX engine) record no
gate counts from a mesh.

``dispatch``/``dispatch_framed`` enqueue the device work on the calling
thread's current stream, start the copies of the verdicts into pinned
host memory and record a CUDA event; ``fetch``/``fetch_framed`` wait on
that event only, so they may run on any thread (AsyncFilterService
fetches from its executor threads, whose current stream differs). The
pinned staging buffer comes from torch's caching host allocator, which
records the copy's stream and reuses the buffer only once the copy has
finished, however many batches are in flight. On a CPU device the same
code runs synchronously, with the kernels' plain versions and an
ordinary host buffer. With a ``FilterStats``, the gate's per-batch
counts ride back with the verdicts (same pinned copy, same event) and
are recorded at fetch.

Trace spans (``obs/trace.py``), as the JAX engine's mean them: a
``device.frame`` span is host framing (the width buckets, the newline
strip on the bytes path, and the staging copy, with one child a width
bucket for its slice of the metadata: ``width``, ``rows``, ``path``); a
``device.kernel`` span is one sub-batch's enqueue
(``pack_classify_rows``, the gate, the kernel; ``swept=True`` under the
sweep gate), not its run on the card. No span, counter or probe here
waits on the card.

The card's own time is in ``card.*`` spans, the port's (the JAX engine
has none): when a batch's outer ``device.frame`` span is sampled, the
batch records CUDA timing events on its stream (``CardTimer``: before
and after the staging copy, after each sub-batch's
``pack_classify_rows``, gate and kernel, after the long lines' whole
chunk loop, and the ``done`` event), and ``fetch_framed``, once ``done``
has completed, turns them into finished spans on the host's real-time
clock (``CardClock``): ``card.batch`` (from the stream reaching the
batch's first op to its last; ``queued_s``, ``rows``, ``sub_batches``,
``launches``), parented under the span current at dispatch (the
coalescer's ``coalescer.dispatch`` in filterd), and one child a stage
(``card.copy``, ``card.pack``, ``card.gate``, ``card.match``,
``card.long``, ``card.verdicts``), each from the event before it to its
own. A stage's span holds any wait of the stream on the host's enqueue
of that stage. Under a mesh engine, and on a CPU device, no ``card.*``
span is recorded; unsampled, no timing event is made.
"""

import copy
import dataclasses
import time

import numpy as np
import torch

from klogs_tpu_torch.filters.base import LogFilter, frame_lines
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
from klogs_tpu_torch.filters.compiler.index import FactorIndex
from klogs_tpu_torch.filters.compiler.prefilter import compile_prefilter
from klogs_tpu_torch.filters.cpu import (
    check_fused_gates,
    device_gate_choice,
    note_sweep_supersedes,
)
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.ops import (
    _build,
    nfa,
    nfa_kernels,
    pack,
    prefilter,
    sweep,
    tune,
)
from klogs_tpu_torch.ops.bits import pack_bits
from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.env import read as env_read

# Smallest pad width; also the bucket floor.
MIN_BUCKET = 128
# Smallest batch-dimension bucket.
MIN_BATCH_BUCKET = 8
# Long lines of a set whose augmented union runs at more states than
# this (``kernel_states``: past K2's register widths) take K2g over the
# grouped program instead of K2 over the union.
GROUPED_LONG_STATES = 1024


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


def _moved(x, device: torch.device):
    """A copy of a tensor, a tuple or a dataclass of them (a program, a
    gate's tables) on ``device``; a program's ``cache`` of bit layouts
    starts empty there."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_moved(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: {} if f.name == "cache" else _moved(getattr(x, f.name),
                                                       device)
            for f in dataclasses.fields(x) if f.init})
    return x


def stage(payload: bytes, meta: np.ndarray, devices,
          timer: "CardTimer | None" = None) -> dict:
    """{device: (metadata [M] int64, payload [P] uint8)} for each distinct
    device of ``devices``, from one host buffer (pinned when a card is
    among them) holding both: one host memcpy of the payload and one
    non-blocking H2D copy a card. A ``timer`` starts at the copies and
    marks their end."""
    devices = list(dict.fromkeys(devices))
    head = meta.nbytes
    host = torch.empty(head + len(payload), dtype=torch.uint8,
                       pin_memory=any(d.type == "cuda" for d in devices))
    buf = host.numpy()
    buf[:head] = meta.view(np.uint8)
    buf[head:] = np.frombuffer(payload, dtype=np.uint8)
    out = {}
    if timer is not None:
        timer.start()
    for dev in devices:
        t = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
        out[dev] = (t[:head].view(torch.int64), t[head:])
    if timer is not None:
        timer.mark("copy")
    return out


# A card's clock anchor is replaced once it is older than this, at the
# next sampled batch: an event's elapsed time is a float32 of
# milliseconds, whose step grows with the anchor's age (3.9 us at 60 s),
# and the card's timer drifts from the host's clock (on an H100, about
# 3 us a second, with steps of up to 70 us: PERF.md section 7).
REANCHOR_S = 1.0


class CardClock:
    """One card's CUDA events on the host's real-time clock
    (``time.time()``, the clock of a span's ``start_unix``). An anchor is
    a timing event recorded on a stream of its own, which no batch's work
    is queued ahead of, beside the host time at which its record
    returned; an event's host time is the anchor's plus
    ``anchor.elapsed_time(event)``. ``current()`` is the anchor a batch's
    events are placed by, taken anew past ``REANCHOR_S``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = torch.cuda.Stream(device)
        self._anchor: "tuple[torch.cuda.Event, float, float] | None" = None

    def anchor(self) -> "tuple[torch.cuda.Event, float, float]":
        """A new anchor: (event, its host time, the monotonic time)."""
        e = torch.cuda.Event(enable_timing=True)
        e.record(self._stream)
        self._anchor = (e, time.time(), time.monotonic())
        return self._anchor

    def current(self) -> "tuple[torch.cuda.Event, float, float]":
        a = self._anchor
        if a is None or time.monotonic() - a[2] > REANCHOR_S:
            a = self.anchor()
        return a


_CLOCKS: "dict[torch.device, CardClock]" = {}


def card_clock(device: torch.device) -> CardClock:
    """The process's clock of a card, made at its first use."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    clock = _CLOCKS.get(device)
    if clock is None:
        clock = _CLOCKS[device] = CardClock(device)
    return clock


def anchor_card_clock(device: torch.device) -> None:
    """Anchor a card's clock while it is idle: filterd's start, before any
    batch."""
    torch.cuda.synchronize(device)
    card_clock(device).anchor()


class CardTimer:
    """One sampled batch's timing events on the card. ``start`` records
    the event before its first op and the host time of that op's enqueue;
    ``mark(stage)`` an event after a stage's work on the current stream;
    ``finish(done, rows)``, once ``done`` has completed, records
    ``card.batch`` under ``parent`` and one child a stage, each from the
    event before it to its own (``card.verdicts`` ends at ``done``)."""

    def __init__(self, device: torch.device, parent):
        self.device = device
        self.parent = parent
        self.anchor = card_clock(device).current()
        self.marks: "list[tuple[str, torch.cuda.Event, dict]]" = []
        self.enqueued_unix = 0.0
        self.sub_batches = 0
        self.launches = 0

    def start(self) -> None:
        self.mark("start")
        self.enqueued_unix = time.time()

    def mark(self, stage: str, **attrs: object) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        self.marks.append((stage, e, attrs))

    def finish(self, done: "torch.cuda.Event", rows: int) -> None:
        anchor, unix, _ = self.anchor
        anchor.synchronize()
        at = [unix + anchor.elapsed_time(e) / 1e3
              for e in [e for _, e, _ in self.marks] + [done]]
        tr = trace.TRACER
        batch = tr.record_span(
            "card.batch", self.parent, at[0], at[-1] - at[0],
            queued_s=at[0] - self.enqueued_unix, rows=rows,
            sub_batches=self.sub_batches, launches=self.launches)
        stages = [(s, a) for s, _, a in self.marks[1:]] + [("verdicts", {})]
        for (stage, attrs), t0, t1 in zip(stages, at, at[1:]):
            tr.record_span("card." + stage, batch, t0, t1 - t0, **attrs)


class ShortLines:
    """The short lines' half of the engine: one pattern set's grouped
    automata on one device, the kernel that runs them (K1; K4 when
    ``fused``) and, once built, the gate of K3 (the pair-CNF tables or the
    literal sweep's). ``GpuEngineFilter`` is one; a mesh engine
    (``parallel/mesh.py``) holds one a pattern shard and device."""

    def __init__(self, patterns: list[str], ignore_case: bool = False,
                 device=None, stats=None, fused: bool = False):
        self.device = nfa.resolve_device(device)
        self._stats = stats
        self._fused = fused
        self._grouped, self._g_live, self._g_acc = nfa.compile_grouped(
            patterns, ignore_case=ignore_case, device=self.device)
        self._n_patterns = len(patterns)
        self._pf_tables = self._sweep_tables = self._onehot = None

    def _build_gate(self, patterns: list[str], ignore_case: bool) -> None:
        """The pair-CNF tables when asked for, then the sweep's when the
        policy picks it (a forced sweep supersedes the prefilter)."""
        if env_read("KLOGS_TPU_PREFILTER", "0") == "1":
            self._pf_tables = self._build_prefilter(patterns, ignore_case)
        if device_gate_choice(len(patterns), self._pf_tables is not None,
                              self.device) == "sweep":
            self._sweep_tables = self._build_sweep(patterns, ignore_case)
            if self._pf_tables is not None:
                note_sweep_supersedes()
                self._pf_tables = None

    def _build_prefilter(self, patterns: list[str], ignore_case: bool):
        """The pair-CNF tables, or None with the reason said (and kept in
        the stats) when the set is not ``usable``."""
        pf = compile_prefilter(patterns, ignore_case=ignore_case)
        if not pf.usable:
            self._note_prefilter_off(pf, patterns)
            return None
        return self._prefilter_tables(pf)

    def _note_prefilter_off(self, pf, patterns: list[str]) -> None:
        """Say why the pair-CNF gate is off for a set whose program is
        not ``usable`` (the patterns without a mandatory byte pair, or
        the clause slots running out), and keep it in the stats."""
        culprits = [p for p, n in zip(patterns, pf.clause_counts or [])
                    if n == 0]
        if culprits:
            reason = ("prefilter disabled: no mandatory byte pairs for "
                      "pattern(s) %s" % ", ".join(repr(p)
                                                  for p in culprits[:4]))
        else:
            reason = ("prefilter disabled: clause slot table exhausted "
                      "(pattern set too diverse)")
        term.info("%s", reason)
        if self._stats is not None:
            self._stats.pf_disabled_reason = reason

    def _prefilter_tables(self, pf):
        """A usable program's tables (class domain, else byte domain),
        with the pattern -> group one-hot they reduce through."""
        g = self._grouped
        self._onehot = prefilter.pattern_group_onehot(
            g.pattern_group, g.follow.shape[0], device=self.device)
        return (prefilter.class_tables(pf, g.byte_class.cpu().numpy(),
                                       g.n_classes, device=self.device)
                or prefilter.device_tables(pf, device=self.device))

    def _build_sweep(self, patterns: list[str], ignore_case: bool):
        """The literal sweep's tables, packed against the grouped
        program's pattern -> group map."""
        infos = analyze(patterns, ignore_case=ignore_case)
        g = self._grouped
        prog = FactorIndex(infos, plan_groups(infos)).sweep_program(
            group_of=np.asarray(g.pattern_group, dtype=np.int32),
            n_groups=int(g.follow.shape[0]))
        return sweep.device_sweep_tables(prog, device=self.device)

    def to(self, device) -> "ShortLines":
        """This program and its gate's tables copied to ``device``."""
        new = copy.copy(self)
        new.device = torch.device(device)
        for name in ("_grouped", "_pf_tables", "_sweep_tables", "_onehot"):
            setattr(new, name, _moved(getattr(self, name), new.device))
        return new

    def _match_short(self, payload: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor, width: int, rows: int,
                     timer: "CardTimer | None" = None):
        """One width bucket's lines (``starts`` and raw ``lens`` into
        ``payload``, zero-padded to ``rows``), on the device -> ([rows]
        bool, gate stats [3] or None): the main path
        (``pack_classify_rows``, then K1 or K4, or the gate and K3). A
        ``timer`` marks each stage's end."""
        g = self._grouped
        cls, lengths, batch = pack.pack_classify_rows(
            payload, starts, lens, width, rows, g,
            want_bytes=self._gate_reads_bytes())
        if timer is not None:
            timer.mark("pack", width=width)
        gate = self._gate_bits(batch, lengths, cls)
        if gate is None:
            kernel = (nfa_kernels.match_cls_grouped_fused if self._fused
                      else nfa_kernels.match_cls_grouped)
            out = kernel(g, self._g_live, self._g_acc, cls), None
        else:
            # The pair builder ends the gate's stage on the card.
            marks = ({} if timer is None else
                     {"on_pairs": lambda: timer.mark("gate", width=width)})
            out = nfa_kernels.match_cls_grouped_gated(
                g, self._g_live, self._g_acc, cls, gate,
                want_stats=self._stats is not None, **marks)
        if timer is not None:
            timer.mark("match", width=width)
            timer.launches += 1
        return out

    def _gate_reads_bytes(self) -> bool:
        """Whether the active gate reads the rows' bytes: the sweep, or a
        pair-CNF with no class-domain tables."""
        return self._sweep_tables is not None or (
            self._pf_tables is not None and len(self._pf_tables) != 4)

    def _gate_bits(self, batch: "torch.Tensor | None", lengths: torch.Tensor,
                   cls: torch.Tensor) -> "torch.Tensor | None":
        """[rows, GW] group words of the active gate, or None."""
        if self._sweep_tables is not None:
            return sweep.sweep_group_bits(self._sweep_tables, batch, lengths)
        if self._pf_tables is None:
            return None
        if len(self._pf_tables) == 4:
            pm = prefilter.candidate_matrix_from_cls(self._pf_tables, cls)
        else:
            pm = prefilter.candidate_matrix(self._pf_tables, batch, lengths)
        return pack_bits(prefilter.group_candidates(pm, self._onehot,
                                                    self._n_patterns))


class GpuEngineFilter(ShortLines, LogFilter):
    """Batch-NFA filter on the port's CUDA kernels (``device=None`` means
    ``"cuda"``; a CPU device runs the kernels' plain versions). With
    ``engine`` (a ``parallel.mesh.MeshEngine``) the short lines run on
    the mesh and the long lines on its first device, which is the
    filter's."""

    SEQ_SCAN_BYTES = 128 * 1024

    def __init__(self, patterns: list[str], ignore_case: bool = False,
                 chunk_bytes: int = 4096, device=None, stats=None,
                 engine=None):
        self._engine = engine
        self._chunk_bytes = chunk_bytes
        prog = compile_patterns(patterns, ignore_case=ignore_case)
        self._match_all = prog.match_all
        if engine is None:
            dev = nfa.resolve_device(device)
            # The short-line kernel: K4 under KLOGS_TPU_FUSED_GROUPS=1 (no
            # gate: checked before anything is built), else K1 or K3.
            fused = bool(tune.chain_selection().get("fused"))
            if fused:
                check_fused_gates(len(patterns), dev)
            super().__init__(patterns, ignore_case, dev, stats, fused)
            # The gate of the grouped kernel: at most one of the two, and
            # none with K4.
            if not fused:
                self._build_gate(patterns, ignore_case)
        else:
            self._use_engine(engine, device, stats, patterns, ignore_case)
        self._long = self._long_program(prog, patterns, ignore_case)
        # Otherwise long-line chunks run the single augmented union
        # automaton (one state space to carry across chunks).
        self._aug = None
        if self._long is None:
            self._aug = nfa.pack_program(nfa.augment(prog),
                                         device=self.device)
        self._live, self._acc = prog.n_states, prog.n_states + 1
        # Sampled batches time the card (no mesh: its shards' streams).
        self._card_timing = engine is None and self.device.type == "cuda"

    def _long_program(self, prog, patterns: list[str], ignore_case: bool):
        """(grouped program, live, acc) for K2g when the union is wider
        than ``GROUPED_LONG_STATES``, else None (the union on K2). K2g
        runs every group width. A mesh's filter compiles the whole set's
        grouped program on its device for this."""
        union = nfa_kernels.kernel_states(nfa.padded_states(prog.n_states
                                                            + 2))
        if union <= GROUPED_LONG_STATES:
            return None
        if self._grouped is not None:
            return self._grouped, self._g_live, self._g_acc
        return nfa.compile_grouped(patterns, ignore_case=ignore_case,
                                   device=self.device)

    def _use_engine(self, engine, device, stats, patterns: list[str],
                    ignore_case: bool) -> None:
        """The short lines go to ``engine``, which holds their programs
        and gate; the filter keeps the long lines, on the engine's first
        device, and says (as the single engine does) when the whole set
        admits no pair-CNF gate."""
        self.device = engine.devices[0]
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"device {device} is not the engine's first "
                             f"device, {self.device}")
        self._stats = stats
        self._fused = False
        self._n_patterns = len(patterns)
        self._grouped = self._pf_tables = self._sweep_tables = None
        self._onehot = None
        if env_read("KLOGS_TPU_PREFILTER", "0") == "1":
            pf = compile_prefilter(patterns, ignore_case=ignore_case)
            if not pf.usable:
                self._note_prefilter_off(pf, patterns)

    def close(self) -> None:
        """Drop the device tables (the programs with their cached bit
        layouts, the gate's tables, a mesh engine's), so their memory
        goes back to the card even while something still holds the
        engine; it takes no batch after. A multi-set filterd closes an
        evicted set's engine so."""
        self._grouped = self._aug = self._long = None
        self._pf_tables = self._sweep_tables = self._onehot = None
        if self._engine is not None:
            self._engine.close()

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
            return (0, [], None, None)
        if self._match_all:
            return (n, None, None, None)
        tr = trace.TRACER
        path = self._path()
        eng = self._engine
        loaded = _build.loaded_count()
        timer = None
        with tr.span("device.frame", rows=n, bytes=len(payload), path=path,
                     staged=True) as frame:
            layout, meta = self._layout(payload, offsets, path)
            if frame.sampled and self._card_timing:
                timer = CardTimer(self.device, self._card_parent(frame))
                timer.sub_batches = len(layout)
            staged = stage(payload, meta, eng.local_devices if eng is not None
                           else [self.device], timer=timer)
        meta_d, payload_d = staged[self.device]
        parts, at = [], 0
        for idx, width, rows, longest in layout:
            starts_d = meta_d[at:at + rows]
            lens_d = meta_d[at + rows:at + 2 * rows]
            n_bytes = int(meta[at + rows:at + 2 * rows].sum())
            if width is None:
                chunks = -(-longest // self._chunk_bytes)
                with tr.span("device.kernel", width=self._chunk_bytes,
                             rows=rows, chunks=chunks):
                    parts.append((idx, self._match_long(
                        payload_d, starts_d, lens_d, longest), None))
                if timer is not None:
                    timer.mark("long", chunks=chunks)
                    timer.launches += chunks
            else:
                bucket = _bucket_batch(len(idx))
                self._record_sub_batch(width, bucket, n_bytes)
                with tr.span("device.kernel", width=width, rows=bucket,
                             **({"swept": True} if path == "bytes" else {})):
                    if eng is not None:
                        parts.append((idx, eng.dispatch_rows(
                            staged, at, rows, len(idx), width), None))
                    else:
                        parts.append((idx, *self._match_short(
                            payload_d, starts_d, lens_d, width, rows,
                            timer)))
            at += 2 * rows
        if self._stats is not None and _build.loaded_count() > loaded:
            self._stats.record_compile(_build.loaded_count() - loaded)
        return self._start_fetch(n, parts, timer)

    @staticmethod
    def _card_parent(frame):
        """Where a batch's ``card.batch`` span parents: the span current
        at dispatch (``frame``'s parent; the group's
        ``coalescer.dispatch`` in filterd), else ``frame``."""
        if frame.parent_id is None:
            return frame
        return trace.SpanContext(frame.trace_id, frame.parent_id, True)

    def _path(self) -> str:
        """The JAX engine's name for the short lines' path: ``bytes``
        when the literal sweep reads the rows' bytes (a mesh engine's
        included), else ``cls``."""
        swept = (self._engine.swept if self._engine is not None
                 else self._sweep_tables is not None)
        return "bytes" if swept else "cls"

    def _record_sub_batch(self, width: int, rows: int,
                          payload_bytes: int) -> None:
        """A width bucket's geometry and padding (no-op without
        stats)."""
        if self._stats is not None:
            self._stats.record_engine_batch(width, rows, payload_bytes)

    def _layout(self, payload: bytes, offsets, path: str = "cls"):
        """The host's share of a framed batch, per-line work only: a list
        of (line indices, width or None for the long lines, rows, longest
        length) per sub-batch, the int64 metadata the device reads, each
        sub-batch's starts then lengths, zero-padded to its rows. On the
        cls path the lengths are raw (the card strips the newlines); on
        the bytes path they are stripped here, as the JAX engine's two
        paths have them. A width bucket's rows are its batch bucket,
        rounded up to a multiple of a mesh engine's data shards
        (the padding rows hold no line). Each sub-batch's slice is a
        ``device.frame`` span (``path`` is its attribute; the long
        lines' is ``long``)."""
        if path == "bytes":
            starts, ends = strip_newlines(payload, offsets)
        else:
            offsets = np.asarray(offsets, dtype=np.int64)
            starts, ends = offsets[:-1], offsets[1:]
        lens = ends - starts
        short = lens <= self._chunk_bytes
        buckets = []
        if bool(short.any()):
            width_of = self._width_buckets(lens, short, len(lens))
            buckets = [(short & (width_of == w), int(w), path)
                       for w in np.unique(width_of[short])]
        if not bool(short.all()):
            buckets.append((~short, None, "long"))
        d = self._engine.data_parallelism if self._engine is not None else 1
        layout, parts = [], []
        for mask, w, p in buckets:
            sel = np.nonzero(mask)[0]
            rows = _bucket_batch(len(sel))
            with trace.TRACER.span("device.frame", width=w, rows=rows,
                                   path=p):
                if w is not None:
                    rows = -(-rows // d) * d
                part = np.zeros(2 * rows, dtype=np.int64)
                part[:len(sel)] = starts[sel]
                part[rows:rows + len(sel)] = lens[sel]
            layout.append((sel, w, rows, int(lens[sel].max())))
            parts.append(part)
        meta = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return layout, meta

    def _stage(self, payload: bytes, meta: np.ndarray):
        """(metadata [M] int64, payload [P] uint8) on the filter's device:
        ``stage`` for it alone."""
        return stage(payload, meta, [self.device])[self.device]

    def _match_long(self, payload: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, longest: int) -> torch.Tensor:
        """Carried-state chunked matching of the lines at ``starts`` with
        ``lens`` (zero-padded to a batch bucket; raw or stripped, the
        longest ``longest``) in ``payload``, on the device: every line
        advances in lockstep, each chunk cut, stripped and classified
        from the payload in one launch, the state carried across chunks
        (K2g's per (line, group) on the grouped route, else K2's on the
        union). A last chunk that a line's stripped newlines leave all
        PAD changes no verdict: ``acc`` is absorbing."""
        L = self._chunk_bytes
        B = starts.shape[0]
        n_chunks = -(-longest // L)
        if self._long is not None:
            prog, live, acc = self._long
            v = nfa_kernels.initial_state_grouped(prog, live, B)
        else:
            prog = self._aug
            v = nfa_kernels.initial_state(prog, self._live, B)
        matched = None
        for k in range(n_chunks):
            final = k == n_chunks - 1
            cls, _, _ = pack.pack_classify_rows(
                payload, starts, lens, L, B, prog, skip=k * L,
                first=k == 0, final=final)
            if self._long is not None:
                v, matched = nfa_kernels.match_chunk_cls_grouped(
                    prog, live, acc, cls, v, final=final)
            else:
                v, matched = nfa_kernels.match_chunk_cls(
                    prog, self._acc, cls, v, final=final)
        return matched

    def _start_fetch(self, n: int, parts: list,
                     timer: "CardTimer | None" = None):
        """Start the copies of the verdicts (and gate stats) to the host;
        on CUDA, record the event fetch waits on (a timing event under a
        ``timer``)."""
        if self.device.type != "cuda":
            return (n, [(idx, m[:len(idx)], st) for idx, m, st in parts],
                    None, None)
        host = []
        for idx, m, st in parts:
            h = torch.empty(len(idx), dtype=torch.bool, pin_memory=True)
            h.copy_(m[:len(idx)], non_blocking=True)
            hs = None
            if st is not None:
                hs = torch.empty(st.shape, dtype=st.dtype, pin_memory=True)
                hs.copy_(st, non_blocking=True)
            host.append((idx, h, hs))
        done = torch.cuda.Event(enable_timing=timer is not None)
        done.record(torch.cuda.current_stream(self.device))
        return (n, host, done, timer)

    def fetch_framed(self, handle) -> np.ndarray:
        n, parts, done, timer = handle
        if parts is None:
            return np.ones(n, dtype=bool)
        if done is not None:
            done.synchronize()
            if timer is not None:
                timer.finish(done, n)
        out = np.zeros(n, dtype=bool)
        for idx, h, st in parts:
            out[idx] = h.numpy()
            if st is not None and self._stats is not None:
                self._record_gate(len(idx), *st.tolist())
        return out

    def _record_gate(self, n_lines: int, n_cand: int, n_live: int,
                     n_tiles: int) -> None:
        """One gated sub-batch's counts (padding rows can count as
        candidates, hence the clamp)."""
        n_cand = min(n_cand, n_lines)
        self._stats.record_prefilter(n_lines, n_cand, n_tiles, n_live)
        if self._sweep_tables is not None:
            self._stats.record_sweep("device", n_lines, n_cand)
