"""NFA programs as tensors, and classification of bytes into class ids.

Counterpart of ``klogs_tpu/ops/nfa.py``. The automaton comes from the
Glushkov compiler (``filters/compiler/glushkov.py``); a program is a
dataclass of tensors on one explicit device:

- ``pack_program`` pads a compiled union automaton (S to a multiple of
  128 states, C to a multiple of 8 classes) — the long-line program
  after ``augment``;
- ``compile_grouped`` bins K patterns into G automata of at most 126
  positions plus the ``live``/``acc`` states at S-2/S-1, over one
  shared byte classifier — the full-line hot-path program;
- ``classify_chunk`` turns a byte chunk into the class-id layout both
  kernels consume: BEGIN, body, END, then PAD (with the accept-latch
  column on the final chunk);
- ``program_from_jax`` carries a JAX ``DeviceProgram``'s arrays across,
  so tests run both packages on the same tables.

The scan itself lives in ``ops/nfa_kernels.py``.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from klogs_tpu_torch.filters.compiler.glushkov import NFAProgram, compile_patterns

# State-axis padding. Any multiple of 32 would do for the bitset
# kernels; 128 keeps the tables shape-identical to the JAX package's.
STATE_PAD = 128


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """The port's device rule: None means ``cuda``. A CUDA device with no
    card raises here instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain versions)")
    return dev


@dataclass
class TorchProgram:
    """A padded automaton (single: [C, S]/[S, S] tables; grouped: a
    leading [G] axis) as int8 0/1 tensors on one device."""

    char_mask: torch.Tensor  # [(G,) C, S] int8 — class -> member states
    follow: torch.Tensor  # [(G,) S, S] int8 — follow[s, j]: j follows s
    inject: torch.Tensor  # [(G,) S] int8
    accept: torch.Tensor  # [(G,) S] int8
    byte_class: torch.Tensor  # [256] int32
    begin_class: int
    end_class: int
    pad_class: int
    n_classes: int  # padded C
    n_states: int  # padded S
    match_all: bool
    # Grouped programs only: pattern index (input order) -> group id.
    pattern_group: tuple = ()
    # Per-layout bitset tables built by the kernel wrappers.
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.follow.device


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_states(n: int) -> int:
    """The state count ``pack_program`` pads an n-state automaton to."""
    return max(STATE_PAD, _pad_to(n, STATE_PAD))


def _tensors(device, char_mask, follow, inject, accept, byte_class) -> dict:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int8)).to(device)

    return dict(char_mask=t(char_mask), follow=t(follow), inject=t(inject),
                accept=t(accept),
                byte_class=torch.from_numpy(
                    np.array(byte_class, dtype=np.int32)).to(device))


def pack_program(prog: NFAProgram, device=None) -> TorchProgram:
    """Pad the compiler's dense arrays (``nfa.pack_program``): padded
    states have all-zero rows/cols, padded classes all-zero mask rows.
    ``device`` follows ``resolve_device`` (None means ``cuda``)."""
    device = resolve_device(device)
    S = padded_states(prog.n_states)
    C = _pad_to(prog.n_classes, 8)
    char_mask = np.zeros((C, S), dtype=np.int8)
    char_mask[: prog.n_classes, : prog.n_states] = prog.char_mask
    follow = np.zeros((S, S), dtype=np.int8)
    follow[: prog.n_states, : prog.n_states] = prog.follow
    inject = np.zeros(S, dtype=np.int8)
    inject[: prog.n_states] = prog.inject
    accept = np.zeros(S, dtype=np.int8)
    accept[: prog.n_states] = prog.accept
    return TorchProgram(
        **_tensors(device, char_mask, follow, inject, accept, prog.byte_class),
        begin_class=prog.begin_class, end_class=prog.end_class,
        pad_class=prog.pad_class, n_classes=C, n_states=S,
        match_all=prog.match_all)


def augment(prog: NFAProgram) -> NFAProgram:
    """Fold inject+accept into two extra states (``nfa.augment``), so the
    step is just v' = reach(v) & B[c]:

    - ``live`` (index n): member of every class; follow(live) =
      inject ∪ {live}, so starting from {live} re-injects every step;
    - ``acc`` (index n+1): absorbing; follow(a) ∋ acc for accepting a,
      member of every class including pad, so "matched" is v[acc] —
      one step after END latches it (the latch column).
    """
    n = prog.n_states
    live, acc = n, n + 1
    char_mask = np.zeros((prog.n_classes, n + 2), dtype=bool)
    char_mask[:, :n] = prog.char_mask
    char_mask[:, live] = True
    char_mask[:, acc] = True
    follow = np.zeros((n + 2, n + 2), dtype=bool)
    follow[:n, :n] = prog.follow
    follow[live, :n] = prog.inject
    follow[live, live] = True
    follow[:n, acc] = prog.accept
    follow[acc, acc] = True
    inject = np.zeros(n + 2, dtype=bool)
    inject[live] = True
    accept = np.zeros(n + 2, dtype=bool)
    accept[acc] = True
    return NFAProgram(
        n_states=n + 2, n_classes=prog.n_classes, byte_class=prog.byte_class,
        begin_class=prog.begin_class, end_class=prog.end_class,
        pad_class=prog.pad_class, char_mask=char_mask, follow=follow,
        inject=inject, accept=accept, match_all=prog.match_all,
        patterns=prog.patterns)


def compile_grouped(patterns: list[str], ignore_case: bool = False,
                    max_positions: int = 126, device=None):
    """K patterns -> G augmented automata over one shared byte
    classifier (``nfa.compile_grouped``). Returns (program with [G, ...]
    tables, live, acc); live/acc sit at S-2/S-1 and BEGIN/END/PAD at
    C-3/C-2/C-1 in every group. Bins are first-fit-decreasing by
    position count, so any-match over groups == any-match over
    patterns, and ``pattern_group`` reports each pattern's bin.
    ``device`` follows ``resolve_device`` (None means ``cuda``)."""
    device = resolve_device(device)
    if not patterns:
        raise ValueError("compile_grouped needs at least one pattern")
    sized = [(compile_patterns([p], ignore_case=ignore_case).n_states, i)
             for i, p in enumerate(patterns)]
    sized.sort(key=lambda t: (-t[0], t[1]))
    bins: list[tuple[int, list[int]]] = []
    for n, pi in sized:
        for i, (load, ids) in enumerate(bins):
            if load + n <= max_positions:
                bins[i] = (load + n, ids + [pi])
                break
        else:
            bins.append((n, [pi]))
    pattern_group = [0] * len(patterns)
    for g, (_, ids) in enumerate(bins):
        for pi in ids:
            pattern_group[pi] = g
    progs = [compile_patterns([patterns[i] for i in ids],
                              ignore_case=ignore_case) for _, ids in bins]
    G = len(progs)

    # Shared byte classifier: bytes equivalent in EVERY group collapse.
    sig = np.stack([p.byte_class for p in progs], axis=1)  # [256, G]
    uniq, byte_class = np.unique(sig, axis=0, return_inverse=True)
    byte_class = byte_class.reshape(-1).astype(np.int32)
    n_glob = uniq.shape[0]
    C = _pad_to(n_glob + 3, 8)
    begin_c, end_c, pad_c = C - 3, C - 2, C - 1
    S = max(STATE_PAD, _pad_to(max(p.n_states for p in progs) + 2, STATE_PAD))
    live, acc = S - 2, S - 1

    char_mask = np.zeros((G, C, S), dtype=np.int8)
    follow = np.zeros((G, S, S), dtype=np.int8)
    inject = np.zeros((G, S), dtype=np.int8)
    accept = np.zeros((G, S), dtype=np.int8)
    for g, p in enumerate(progs):
        n = p.n_states
        # Global class c has per-group local id uniq[c][g].
        char_mask[g, :n_glob, :n] = p.char_mask[uniq[:, g], :n]
        char_mask[g, begin_c, :n] = p.char_mask[p.begin_class, :n]
        char_mask[g, end_c, :n] = p.char_mask[p.end_class, :n]
        char_mask[g, :, live] = 1  # live/acc: members of every class
        char_mask[g, :, acc] = 1
        follow[g, :n, :n] = p.follow
        follow[g, live, :n] = p.inject
        follow[g, live, live] = 1
        follow[g, :n, acc] = p.accept
        follow[g, acc, acc] = 1
        inject[g, live] = 1
        accept[g, acc] = 1

    dp = TorchProgram(
        **_tensors(device, char_mask, follow, inject, accept, byte_class),
        begin_class=begin_c, end_class=end_c, pad_class=pad_c,
        n_classes=C, n_states=S,
        match_all=any(p.match_all for p in progs),
        pattern_group=tuple(pattern_group))
    return dp, live, acc


def program_from_jax(leaves: "dict[str, np.ndarray]", meta: dict,
                     device=None) -> TorchProgram:
    """A JAX ``DeviceProgram`` carried across: ``leaves`` holds
    ``np.asarray`` of its array leaves (char_mask, follow, inject,
    accept, byte_class), ``meta`` its static fields (begin_class,
    end_class, pad_class, n_classes, n_states, match_all and, for
    grouped programs, pattern_group). 0/1 tables of any dtype become
    int8. ``device`` follows ``resolve_device`` (None means ``cuda``)."""
    device = resolve_device(device)
    return TorchProgram(
        **_tensors(device, *(np.asarray(leaves[k]) != 0 for k in
                             ("char_mask", "follow", "inject", "accept")),
                   leaves["byte_class"]),
        begin_class=int(meta["begin_class"]), end_class=int(meta["end_class"]),
        pad_class=int(meta["pad_class"]), n_classes=int(meta["n_classes"]),
        n_states=int(meta["n_states"]), match_all=bool(meta["match_all"]),
        pattern_group=tuple(meta.get("pattern_group", ())))


def classify_chunk(prog: TorchProgram, chunk: torch.Tensor, rem: torch.Tensor,
                   first: bool, final: bool) -> torch.Tensor:
    """bytes [B, L] uint8 + remaining lengths [B] -> class ids [B, T]
    int16, T = L + first + 2*final, on the chunk's device.

    ``rem`` is each line's byte count from this chunk's start: negative
    once the line has ended (all PAD), ``> L`` while it continues. END
    lands at chunk-local position ``rem`` when that falls inside the
    window — the final chunk's window has one extra column so END can
    land at L; on a non-final chunk ``rem == L`` defers END to the next
    chunk (rem' == 0), so it is fed exactly once. Positions past END are
    PAD. ``first`` prepends the BEGIN column; ``final`` appends the
    accept-latch PAD column (the JAX kernels' callers append it; the
    host mirror ``tpu.classify_chunk_host`` includes it too).
    """
    B, L = chunk.shape
    off = 1 if first else 0
    Lb = L + (1 if final else 0)  # END window: L+1 columns on the final chunk
    cls = torch.full((B, off + Lb + (1 if final else 0)), prog.pad_class,
                     dtype=torch.int16, device=chunk.device)
    if first:
        cls[:, 0] = prog.begin_class
    body = cls[:, off:off + L]
    body.copy_(prog.byte_class.to(torch.int16)
               .index_select(0, chunk.reshape(-1).to(torch.int32)).view(B, L))
    r = rem.to(device=chunk.device, dtype=torch.int64)[:, None]
    pos = torch.arange(Lb, device=chunk.device, dtype=torch.int64)[None, :]
    body.masked_fill_(pos[:, :L] >= r, prog.pad_class)
    # END lands at chunk-local position rem when that falls inside this
    # chunk's window (never for rem < 0 or rem >= Lb).
    cls[:, off:off + Lb].masked_fill_(pos == r, prog.end_class)
    return cls
