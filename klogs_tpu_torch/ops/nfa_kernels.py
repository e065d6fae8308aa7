"""The NFA scan kernels: wrappers, plain versions, launch counts.

Counterpart of ``klogs_tpu/ops/pallas_nfa.py``. The kernels run the
augmented step ``v' = reach(v) & mask[cls[t]]`` (ops/nfa.py) over class
ids laid out BEGIN, body, END, PAD latch:

- ``match_cls_grouped`` (K1, ``grouped_nfa_kernel``, replacing
  ``_grouped_kernel``): a ``compile_grouped`` program of G automata,
  each started at ``{live}``; the verdict is state ``acc`` ORed over the
  groups, then ``match_all``. K1 and K4 run the step split as
  ``shift_constants`` describes (a shift, a self-loop mask, live's row,
  and the rows of the few "exception" states);
- ``match_cls_grouped_gated`` (K3, ``grouped_nfa_gated_kernel``,
  replacing ``_grouped_kernel_gated``): K1 under a per-(line, group)
  gate, ``out[b] = match_all or OR_g (gate[b, g] and acc_g(b))``; the
  thousand-pattern path feeds it the literal sweep's or the pair-CNF's
  group candidates. ``gate_pairs`` compacts the gate into a list of
  candidate (line, group) pairs on the device, and ``launch_gated``
  (the kernel alone) runs one thread per listed pair;
- ``match_cls_grouped_fused`` (K4, ``grouped_nfa_fused_kernel``,
  replacing ``_grouped_kernel_fused``): K1's function and schedule (one
  thread per (line, group) pair), with the chunks of groups that a
  block's shared memory holds spread over blocks instead of walked in
  turn; the engine runs it under ``KLOGS_TPU_FUSED_GROUPS=1``
  (``ops/tune.py``);
- ``match_chunk_cls`` (K2, ``chunk_nfa_kernel``, replacing ``_kernel``):
  the single augmented union automaton with the [B, S] int8 state
  carried across the chunks of long lines;
- ``match_chunk_cls_grouped`` (K2g, ``grouped_chunk_kernel``, also in
  place of ``_kernel``): the chunks of long lines through a
  ``compile_grouped`` program, each (line, group) state carried as
  words, the verdict ``acc`` ORed over the groups (the union's verdict:
  the groups partition the patterns). The engine runs it for sets whose
  union is wider than K2's register kernel.

The route by width of a group (``kernel_states(S) / 32`` words). At a
register width (``REGISTER_WORDS``) each kernel above runs as named.
From 33 to ``WIDE_WORDS`` (160) words, K1, K2g, K3 and K4 run the same
shift-and-exceptions step spread over a warp a (line, group), its state
in registers: ``grouped_shift_wide_kernel`` (K1, counted under
``GROUPED_WIDE``), ``grouped_chunk_wide_kernel`` (K2g, under
``GROUPED_CHUNK_WIDE``), ``grouped_gated_wide_kernel`` (K3, a warp a
listed pair, under ``GATED_WIDE``) and ``grouped_fused_wide_kernel``
(K4, under ``FUSED_WIDE``). Past 160 words (5120 states, past the
compiler's default cap of 4096 positions a set) they run that step with
a warp's state in two buffers of shared memory, at any width:
``grouped_shift_smem_kernel`` (under ``GROUPED_SMEM``),
``grouped_chunk_smem_kernel`` (``GROUPED_CHUNK_SMEM``),
``grouped_gated_smem_kernel`` (``GATED_SMEM``) and
``grouped_fused_smem_kernel`` (``FUSED_SMEM``); a group whose two
buffers do not fit a block's shared memory raises
``GroupTooWideError``. K2 runs its generic wide kernel
(``chunk_nfa_wide``) at any width past 32 words.

A tensor on the CPU runs the plain PyTorch version (a Python loop over
the steps); a CUDA tensor launches the kernel from
``ops/csrc/nfa_kernels.cu`` or raises. ``LAUNCHES`` counts kernel
launches by kernel name (``ops/pack.py``'s too), so a run can show that
it went through them.
"""

import ctypes
import threading
from typing import Callable

import torch
import torch.nn.functional as F

from klogs_tpu_torch.ops.bits import pack_bits, to_int32, unpack_bits
from klogs_tpu_torch.ops.nfa import TorchProgram

GROUPED = "grouped_nfa_kernel"
GATED = "grouped_nfa_gated_kernel"
CHUNK = "chunk_nfa_kernel"
FUSED = "grouped_nfa_fused_kernel"
GROUPED_CHUNK = "grouped_chunk_kernel"
# K1, K2g, K3 and K4 past 32 words: the wide shift-and-exceptions kernels.
GROUPED_WIDE = "grouped_shift_wide_kernel"
GROUPED_CHUNK_WIDE = "grouped_chunk_wide_kernel"
GATED_WIDE = "grouped_gated_wide_kernel"
FUSED_WIDE = "grouped_fused_wide_kernel"
# ... and past WIDE_WORDS, the same step with the state in shared memory.
GROUPED_SMEM = "grouped_shift_smem_kernel"
GROUPED_CHUNK_SMEM = "grouped_chunk_smem_kernel"
GATED_SMEM = "grouped_gated_smem_kernel"
FUSED_SMEM = "grouped_fused_smem_kernel"
# K3's pair builder (gate_pairs_count, gate_pairs_scan and
# gate_pairs_scatter, launched together: counted once per list built).
PAIRS = "gate_pairs"
# The kernels of ops/pack.py: the fused pack-strip-classify, which cuts
# and classifies the rows these kernels read out of a batch's payload on
# the device, and the byte-rows pack.
PACK_CLS = "pack_classify_rows"
PACK = "pack_rows"

LAUNCHES = {GROUPED: 0, GATED: 0, CHUNK: 0, FUSED: 0, GROUPED_CHUNK: 0,
            GROUPED_WIDE: 0, GROUPED_CHUNK_WIDE: 0, GATED_WIDE: 0,
            FUSED_WIDE: 0, GROUPED_SMEM: 0, GROUPED_CHUNK_SMEM: 0,
            GATED_SMEM: 0, FUSED_SMEM: 0, PAIRS: 0, PACK_CLS: 0, PACK: 0}
# Each grouped kernel's count name by route (``_route``).
_NAMES = {"register": {"k1": GROUPED, "k2g": GROUPED_CHUNK, "k3": GATED,
                       "k4": FUSED},
          "wide": {"k1": GROUPED_WIDE, "k2g": GROUPED_CHUNK_WIDE,
                   "k3": GATED_WIDE, "k4": FUSED_WIDE},
          "smem": {"k1": GROUPED_SMEM, "k2g": GROUPED_CHUNK_SMEM,
                   "k3": GATED_SMEM, "k4": FUSED_SMEM}}

# Lines per tile of the gate's stats: the JAX engine counts candidate
# lines clustered into tiles of its kernel's width, and the --stats
# line reports live tiles of this many lines.
GATE_TILE = 128
# Lines per block of the pair builder (PAIR_SLAB in the CUDA source).
PAIR_SLAB = 256

# State words per line that the register kernels are built for; a
# program of another width up to 32 words runs at the next of them.
REGISTER_WORDS = (4, 8, 16, 32)
# The widest width the wide shift kernels of K1, K2g, K3 and K4 are
# built for (5 words a lane of a warp).
WIDE_WORDS = 160
# Bytes of shared memory a block may use (MAX_SMEM in the CUDA source).
MAX_SMEM = 232448
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


_lib = None
_lib_lock = threading.Lock()


def _library():
    """The built kernel library, with its C signatures declared."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from klogs_tpu_torch.ops import _build

            lib = _build.load("nfa_kernels")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.klogs_grouped_nfa.argtypes = [p, i, i, p, p, i, i, i, i, i,
                                              p, p, i]
            lib.klogs_grouped_nfa.restype = i
            lib.klogs_grouped_nfa_gated.argtypes = [p, i, i, p, p, i, i, i,
                                                    i, i, p, p, p, p, i]
            lib.klogs_grouped_nfa_gated.restype = i
            lib.klogs_gate_pairs.argtypes = [p, i, i, i, i, p, i, p, p, p, i]
            lib.klogs_gate_pairs.restype = i
            lib.klogs_grouped_nfa_fused.argtypes = [p, i, i, p, p, i, i, i, i,
                                                    i, p, p, i]
            lib.klogs_grouped_nfa_fused.restype = i
            lib.klogs_chunk_nfa.argtypes = [p, i, i, p, p, i, i, i, p, p, p,
                                            p, i]
            lib.klogs_chunk_nfa.restype = i
            lib.klogs_grouped_chunk_nfa.argtypes = [p, i, i, p, p, i, i, i,
                                                    i, i, p, p, p, p, i]
            lib.klogs_grouped_chunk_nfa.restype = i
            lib.klogs_error_string.argtypes = [i]
            lib.klogs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _library().klogs_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def _or_match_all(prog: TorchProgram, matched: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(matched) if prog.match_all else matched


def bit_table(table: torch.Tensor) -> torch.Tensor:
    """[..., S] 0/1 -> [..., S/32] int32 words holding the bit pattern of
    uint32 words: bit b of word w is column 32w+b."""
    return to_int32(pack_bits(table != 0)).contiguous()


def kernel_states(S: int) -> int:
    """The state count a kernel runs an S-state program at: S/32 words
    rounded up to a register width, or S itself past 32 words (the wide
    kernels). The added states are dead: no follow edge reaches them and
    no class admits them."""
    words = S // 32
    return 32 * next((w for w in REGISTER_WORDS if w >= words), words)


class GroupTooWideError(ValueError):
    """A group so wide that one warp's two state buffers (2 x W words)
    do not fit a block's shared memory: no kernel runs it."""


def _route(words: int) -> str:
    """The route of K1, K2g, K3 and K4 at ``words`` state words (a
    ``kernel_states`` width): "register" (``REGISTER_WORDS``), "wide"
    (33 to ``WIDE_WORDS``: the state in a warp's registers) or "smem"
    (past them: the state in shared memory)."""
    if words in REGISTER_WORDS:
        return "register"
    return "wide" if words <= WIDE_WORDS else "smem"


def _check_width(words: int) -> None:
    """Raises ``GroupTooWideError`` where one warp's two buffers of
    ``words`` state words exceed a block's shared memory (the CUDA
    launcher picks the warps a block and where the tables are read)."""
    if 8 * words > MAX_SMEM:
        raise GroupTooWideError(
            f"a group of {32 * words} states needs {8 * words} bytes of "
            f"shared memory a warp, past the {MAX_SMEM} a block may use")


def _bit_tables(prog: TorchProgram):
    """(follow bits [.., Sk, Sk/32], mask bits [.., C, Sk/32]) of
    ``prog`` padded to ``Sk = kernel_states(S)``, built once on its
    device."""
    tabs = prog.cache.get("bits")
    if tabs is None:
        pad = kernel_states(prog.n_states) - prog.n_states
        tabs = (bit_table(F.pad(prog.follow, (0, pad, 0, pad))),
                bit_table(F.pad(prog.char_mask, (0, pad))))
        prog.cache["bits"] = tabs
    return tabs


def shift_masks(follow: torch.Tensor, live: int):
    """(SH, SELF, RL, EX), [..., S] bool each, of a [..., S, S] 0/1
    follow table, which split reach exactly:

        reach(v) = shl1(v & SH) | (v & SELF) | (live in v ? RL : 0)
                   | OR of follow[s] over s in v & EX

    SH[s]: s+1 follows s; SELF[s]: s follows s; RL: the row of
    ``live``; EX[s]: s is not ``live`` and its row holds another edge
    (an "exception" state)."""
    f = follow != 0
    S = f.shape[-1]
    s = torch.arange(S, device=f.device)
    self_loop = f[..., s, s]
    shift = torch.zeros_like(self_loop)
    shift[..., :-1] = f[..., s[:-1], s[1:]]
    other = f.clone()
    other[..., s, s] = False
    other[..., s[:-1], s[1:]] = False
    exc = other.any(dim=-1)
    exc[..., live] = False
    return shift, self_loop, f[..., live, :], exc


def shift_constants(follow_bits: torch.Tensor, live: int) -> torch.Tensor:
    """[G, Sk, W] padded follow bit words -> the [G, W, 4] int32 words
    (SH, SELF, RL, EX of ``shift_masks``, word j of each) that K1 and K4
    step with; bit b of word j is state 32j+b."""
    masks = shift_masks(unpack_bits(follow_bits, follow_bits.shape[-2]), live)
    return to_int32(torch.stack([pack_bits(m) for m in masks],
                                dim=-1)).contiguous()


def _shift_tables(prog: TorchProgram, live: int):
    """K1's and K4's operands (follow, mask): the follow bit table [G,
    Sk, Sk/32] followed, in one buffer, by ``shift_constants`` [G,
    Sk/32, 4], and the mask bit table. Built once per ``live`` on the
    program's device."""
    follow_bits, mask_bits = _bit_tables(prog)
    key = ("shift", live)
    buf = prog.cache.get(key)
    if buf is None:
        buf = torch.cat([follow_bits.reshape(-1),
                         shift_constants(follow_bits, live).reshape(-1)])
        prog.cache[key] = buf
    return buf, mask_bits


def _cls16(prog: TorchProgram, cls: torch.Tensor) -> torch.Tensor:
    if cls.dim() != 2:
        raise ValueError(f"cls must be [B, T], got shape {tuple(cls.shape)}")
    if cls.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"cls must be int16 or int32, got {cls.dtype}")
    if cls.device != prog.device:
        raise ValueError(f"cls on {cls.device}, program on {prog.device}")
    return cls.to(torch.int16).contiguous()


def _check_states(prog: TorchProgram) -> None:
    if prog.n_states % 128:
        raise ValueError(f"n_states={prog.n_states} is not a multiple of 128")


# ---- K1 and K4: grouped full-line match ---------------------------------


def match_cls_grouped(prog: TorchProgram, live: int, acc: int,
                      cls: torch.Tensor) -> torch.Tensor:
    """[B, T] class ids -> [B] bool: any group's automaton, started at
    ``{live}``, holds ``acc`` after the last step; or ``match_all``."""
    return _match_grouped(prog, live, acc, cls, fused=False)


def match_cls_grouped_fused(prog: TorchProgram, live: int, acc: int,
                            cls: torch.Tensor) -> torch.Tensor:
    """``match_cls_grouped``'s function through K4, which steps the
    groups side by side rather than one after another."""
    return _match_grouped(prog, live, acc, cls, fused=True)


def _match_grouped(prog: TorchProgram, live: int, acc: int,
                   cls: torch.Tensor, fused: bool) -> torch.Tensor:
    if prog.follow.dim() != 3:
        name = FUSED if fused else GROUPED
        raise ValueError(f"{name} needs a compile_grouped program")
    if cls.device.type == "cpu":
        return match_cls_grouped_plain(prog, live, acc, cls)
    if cls.device.type != "cuda":
        raise ValueError(f"unsupported device {cls.device}")
    _check_states(prog)
    cls = _cls16(prog, cls)
    B, T = cls.shape
    G, C, S = prog.char_mask.shape
    words = kernel_states(S) // 32
    route = _route(words)
    if route == "smem":
        _check_width(words)
    follow, mask_bits = _shift_tables(prog, live)
    lib = _library()
    stream = torch.cuda.current_stream(cls.device).cuda_stream
    if fused:
        # K4's blocks (group chunks, or past 32 words groups) OR into a
        # zeroed word per line.
        name = _NAMES[route]["k4"]
        entry = lib.klogs_grouped_nfa_fused
        out = torch.zeros(B, dtype=torch.int32, device=cls.device)
    else:
        # A verdict byte per line; past 32 words the groups' warps set it
        # in place through its 32-bit word.
        name = _NAMES[route]["k1"]
        entry = lib.klogs_grouped_nfa
        out = torch.empty(-(-B // 4) * 4, dtype=torch.uint8,
                          device=cls.device)
    err = entry(cls.data_ptr(), B, T, follow.data_ptr(),
                mask_bits.data_ptr(), G, 32 * words, C, live, acc,
                out.data_ptr(), stream, cls.device.index or 0)
    _count(name)
    _check(err, name)
    return _or_match_all(prog, out[:B].bool())


def _mask_table(char_mask: torch.Tensor, cls: torch.Tensor):
    """(char_mask as bool with one all-zero row appended at index C,
    [B, T] row indices): an id outside [0, C) selects the zero row, which
    kills every state, like the one-hot product of the JAX kernels."""
    C = char_mask.shape[-2]
    zero = torch.zeros_like(char_mask.narrow(-2, 0, 1))
    table = torch.cat([char_mask, zero], dim=-2).bool()
    c = cls.long()
    return table, torch.where((c >= 0) & (c < C), c, C)


def _group_steps_plain(prog: TorchProgram, live: int, cls: torch.Tensor,
                       v: torch.Tensor, work: "dict | None",
                       cells: "torch.Tensor | None" = None,
                       group: "int | None" = None) -> torch.Tensor:
    """The [G, B, S] bool state ``v`` of every group's automaton stepped
    over the [B, T] class ids — a loop over T of the boolean step; with
    ``group``, the [1, B, S] state of that group alone. ``work``, when
    given, receives under "active" the number of state bits the steps
    read (summed over groups, lines and steps; only over the [G, B]
    ``cells`` when given), and under "exc" those of exception states
    (``shift_masks``): the follow rows K1, K2g, K3 and K4 read."""
    T = cls.shape[1]
    keep = slice(None) if group is None else slice(group, group + 1)
    follow = prog.follow[keep].float()  # [G, S, S]
    table, idx = _mask_table(prog.char_mask[keep], cls)  # [G, C+1, S]
    active = torch.zeros((), dtype=torch.int64, device=cls.device)
    exc = torch.zeros((), dtype=torch.int64, device=cls.device)
    if work is not None:
        ex = shift_masks(prog.follow[keep], live)[3][:, None, :]  # [G, 1, S]
        if cells is not None:
            ex = ex & cells[:, :, None]
    for t in range(T):
        if work is not None:
            active += (v if cells is None else v & cells[:, :, None]).sum()
            exc += (v & ex).sum()
        reach = torch.bmm(v.float(), follow) > 0
        v = reach & table.index_select(1, idx[:, t])
    if work is not None:
        work["active"] = work.get("active", 0) + int(active)
        work["exc"] = work.get("exc", 0) + int(exc)
    return v


def _group_accepts_plain(prog: TorchProgram, live: int, acc: int,
                         cls: torch.Tensor, work: "dict | None",
                         cells: "torch.Tensor | None" = None) -> torch.Tensor:
    """[G, B] bool: group g's automaton, started at ``{live}``, holds
    ``acc`` after the last step; with ``cells`` ([G, B] bool) only on
    those (line, group) cells, the others False; ``work`` as in
    ``_group_steps_plain``. Up to the register widths every group steps
    every line, one product a step; past them (a [S, S] product of 1152
    states or more a group) only the cells' lines are stepped, a group
    at a time."""
    G, C, S = prog.char_mask.shape
    if cells is None or S <= 32 * REGISTER_WORDS[-1]:
        v = torch.zeros((G, cls.shape[0], S), dtype=torch.bool,
                        device=cls.device)
        v[:, :, live] = True
        accepts = _group_steps_plain(prog, live, cls, v, work,
                                     cells)[:, :, acc]
        return accepts if cells is None else accepts & cells
    out = torch.zeros((G, cls.shape[0]), dtype=torch.bool, device=cls.device)
    if work is not None:  # an empty gate steps nothing and reads nothing
        work.setdefault("active", 0)
        work.setdefault("exc", 0)
    for g in range(G):
        lines = torch.nonzero(cells[g]).reshape(-1)
        if len(lines) == 0:
            continue
        v = torch.zeros((1, len(lines), S), dtype=torch.bool,
                        device=cls.device)
        v[:, :, live] = True
        out[g, lines] = _group_steps_plain(prog, live, cls[lines], v, work,
                                           group=g)[0, :, acc]
    return out


def match_cls_grouped_plain(prog: TorchProgram, live: int, acc: int,
                            cls: torch.Tensor, work: dict | None = None
                            ) -> torch.Tensor:
    """Plain version of ``match_cls_grouped``; ``work`` as in
    ``_group_accepts_plain``."""
    return _or_match_all(
        prog, _group_accepts_plain(prog, live, acc, cls, work).any(dim=0))


# K4 computes K1's function, and the plain version already steps all G
# groups together on one [G, B, S] state off one class index per step:
# K4's own formulation.
match_cls_grouped_fused_plain = match_cls_grouped_plain


# ---- K3: gated grouped full-line match -----------------------------------


def _gate_words(G: int, rows: int, device: torch.device,
                gate_bits: torch.Tensor) -> torch.Tensor:
    if gate_bits.shape != (rows, (G + 31) // 32):
        raise ValueError(f"gate_bits must be [{rows}, {(G + 31) // 32}] "
                         f"words, got {tuple(gate_bits.shape)}")
    if gate_bits.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gate_bits must be int32 or int64 words, got "
                        f"{gate_bits.dtype}")
    if gate_bits.device != device:
        raise ValueError(f"gate_bits on {gate_bits.device}, expected "
                         f"{device}")
    return gate_bits


def _gate_stats(n_cand: torch.Tensor, B: int) -> torch.Tensor:
    """[3] int64: candidate lines, the GATE_TILE tiles they fill once
    clustered, and the batch's tiles."""
    n_cand = n_cand.reshape(()).to(torch.int64)
    return torch.stack([n_cand, (n_cand + GATE_TILE - 1) // GATE_TILE,
                        torch.full_like(n_cand, -(-B // GATE_TILE))])


def gate_pairs(gate_bits: torch.Tensor, G: int):
    """K3's pair list of a [B, GW] gate over G groups (bit g % 32 of word
    g // 32: group g may match line b; bits at or past G are ignored;
    GW = ceil(G / 32)) -> (pairs [B * G] int32, n_pairs [1] int32, stats
    [3] int64), on the gate's device. ``pairs[:n_pairs]`` holds
    ``g * B + b`` for every set bit, group-major with lines ascending (a
    warp's pairs share one group's tables); the entries past it are
    unspecified. ``stats`` is ``_gate_stats`` of the lines with any
    bit. A CUDA gate is compacted by three kernels (count, scan,
    scatter), and nothing waits on the host: the capacity is B * G, and
    the count stays on the device."""
    B = gate_bits.shape[0]
    _gate_words(G, B, gate_bits.device, gate_bits)
    if gate_bits.device.type == "cpu":
        return gate_pairs_plain(gate_bits, G)
    if gate_bits.device.type != "cuda":
        raise ValueError(f"unsupported device {gate_bits.device}")
    if B * G >= 2**30:
        raise ValueError(f"{B} lines x {G} groups: too many pairs to list")
    dev = gate_bits.device
    pairs = torch.empty(B * G, dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    if B == 0:
        return pairs, torch.zeros(1, dtype=torch.int32, device=dev), \
            stats.zero_()
    gate = gate_bits.contiguous()
    stride = 2 if gate.dtype == torch.int64 else 1  # the low half of each
    slabs = -(-B // PAIR_SLAB)
    # Each group's bits per slab of lines (scanned in place), then the
    # pair count.
    counts = torch.empty((G + 1) * slabs + 1, dtype=torch.int32, device=dev)
    err = _library().klogs_gate_pairs(
        gate.data_ptr(), B, gate.shape[1], stride, G, counts.data_ptr(),
        GATE_TILE, pairs.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    _count(PAIRS)
    _check(err, PAIRS)
    return pairs, counts[(G + 1) * slabs:], stats


def gate_pairs_plain(gate_bits: torch.Tensor, G: int):
    """Plain version of ``gate_pairs`` (the entries past the count are
    zeros)."""
    B = gate_bits.shape[0]
    cells = unpack_bits(gate_bits.long(), G)  # [B, G]
    hits = torch.nonzero(cells.T.reshape(-1)).reshape(-1)
    pairs = torch.zeros(B * G, dtype=torch.int32, device=gate_bits.device)
    pairs[:len(hits)] = hits.to(torch.int32)
    n_pairs = torch.full((1,), len(hits), dtype=torch.int32,
                         device=gate_bits.device)
    return pairs, n_pairs, _gate_stats(cells.any(dim=1).sum(), B)


def _gated_tables(prog: TorchProgram, live: int):
    """K3's and K2g's operands (follow, mask): K1's follow buffer, and
    the mask bit table with an all-zero row appended to each group ([G,
    C+1, Sk/32]: the row an id outside [0, C) reads), at every width."""
    follow, mask_bits = _shift_tables(prog, live)
    padded = prog.cache.get("mask_zero_row")
    if padded is None:
        padded = F.pad(mask_bits, (0, 0, 0, 1)).contiguous()
        prog.cache["mask_zero_row"] = padded
    return follow, padded


def launch_gated(prog: TorchProgram, live: int, acc: int, cls: torch.Tensor,
                 pairs: torch.Tensor, n_pairs: torch.Tensor) -> torch.Tensor:
    """K3 alone on ``gate_pairs``'s list -> [B] bool: some listed pair
    (line b, group g) accepts, ``match_all`` not applied. A CPU tensor
    runs ``launch_gated_plain``."""
    if cls.device.type == "cpu":
        return launch_gated_plain(prog, live, acc, cls, pairs, n_pairs)
    if cls.device.type != "cuda":
        raise ValueError(f"unsupported device {cls.device}")
    _check_states(prog)
    cls = _cls16(prog, cls)
    B, T = cls.shape
    G, C, S = prog.char_mask.shape
    route = _route(kernel_states(S) // 32)
    if route == "smem":
        _check_width(kernel_states(S) // 32)
    name = _NAMES[route]["k3"]
    if (pairs.shape != (B * G,)
            or {pairs.dtype, n_pairs.dtype} != {torch.int32}
            or not pairs.device == n_pairs.device == cls.device):
        raise ValueError("pairs and n_pairs must be gate_pairs' list for "
                         "these lines")
    follow, mask = _gated_tables(prog, live)
    # A verdict byte per line, zeroed by the call and set in place
    # through its 32-bit word.
    out = torch.empty(-(-B // 4) * 4, dtype=torch.uint8, device=cls.device)
    stream = torch.cuda.current_stream(cls.device).cuda_stream
    err = _library().klogs_grouped_nfa_gated(
        cls.data_ptr(), B, T, follow.data_ptr(), mask.data_ptr(), G,
        kernel_states(S), C, live, acc, pairs.data_ptr(), n_pairs.data_ptr(),
        out.data_ptr(), stream, cls.device.index or 0)
    _count(name)
    _check(err, name)
    return out[:B].view(torch.bool)


def launch_gated_plain(prog: TorchProgram, live: int, acc: int,
                       cls: torch.Tensor, pairs: torch.Tensor,
                       n_pairs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``launch_gated``: the plain K1 step, kept on the
    listed (line, group) pairs."""
    B, G = cls.shape[0], prog.follow.shape[0]
    cells = torch.zeros(G * B, dtype=torch.bool, device=cls.device)
    cells[pairs[:int(n_pairs)].long()] = True
    return _group_accepts_plain(prog, live, acc, cls, None,
                                cells.reshape(G, B)).any(dim=0)


def match_cls_grouped_gated(prog: TorchProgram, live: int, acc: int,
                            cls: torch.Tensor, gate_bits: torch.Tensor,
                            want_stats: bool = False,
                            on_pairs: "Callable[[], None] | None" = None):
    """[B, T] class ids + [B, GW] group words (bit g % 32 of word g // 32:
    group g may match line b) -> (matched [B] bool, stats or None), with
    ``matched[b] = match_all or OR_g (gate[b, g] and acc_g(b))``: for a
    necessary gate, K1's verdict. ``stats`` is ``gate_pairs``' [3]
    int64 tensor on the device, read with the verdicts. Nothing waits
    on the host. ``on_pairs`` is called once the pair builder is
    enqueued, before the kernel (the engine's card timing)."""
    if prog.follow.dim() != 3:
        raise ValueError(
            "match_cls_grouped_gated needs a compile_grouped program")
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cls.device}")
    cls = _cls16(prog, cls)
    G = prog.follow.shape[0]
    _gate_words(G, cls.shape[0], cls.device, gate_bits)
    pairs, n_pairs, stats = gate_pairs(gate_bits, G)
    if on_pairs is not None:
        on_pairs()
    matched = _or_match_all(prog, launch_gated(prog, live, acc, cls, pairs,
                                               n_pairs))
    return matched, (stats if want_stats else None)


def match_cls_grouped_gated_plain(prog: TorchProgram, live: int, acc: int,
                                  cls: torch.Tensor, gate_bits: torch.Tensor,
                                  work: dict | None = None) -> torch.Tensor:
    """Plain version of ``match_cls_grouped_gated``: the plain K1 step,
    kept on the gated (line, group) cells. ``work`` counts the state
    bits read on the gated cells only."""
    gate_bits = _gate_words(prog.follow.shape[0], cls.shape[0], cls.device,
                            gate_bits)
    cells = unpack_bits(gate_bits.long(), prog.follow.shape[0]).T  # [G, B]
    accepts = _group_accepts_plain(prog, live, acc, cls, work, cells)
    return _or_match_all(prog, accepts.any(dim=0))


# ---- K2: carried-state chunk match ---------------------------------------


def initial_state(prog: TorchProgram, live: int, batch_size: int) -> torch.Tensor:
    """[B, S] int8 one-hot on ``live``: the augmented start state."""
    v = torch.zeros((batch_size, prog.n_states), dtype=torch.int8,
                    device=prog.device)
    v[:, live] = 1
    return v


def match_chunk_cls(prog: TorchProgram, acc: int, cls: torch.Tensor,
                    v0: torch.Tensor, final: bool = True):
    """One chunk of carried-state matching over an augmented union
    program: [B, T] class ids (``classify_chunk`` layout, latch column on
    the final chunk) and the [B, S] int8 carry -> (v [B, S] int8,
    matched [B] bool); ``match_all`` is ORed in on the final chunk."""
    if prog.follow.dim() != 2:
        raise ValueError("match_chunk_cls needs a single (union) program")
    if cls.device.type == "cpu":
        v, matched = match_chunk_cls_plain(prog, acc, cls, v0)
    elif cls.device.type == "cuda":
        v, matched = _launch_chunk(prog, acc, cls, v0)
    else:
        raise ValueError(f"unsupported device {cls.device}")
    return v, (_or_match_all(prog, matched) if final else matched)


def _launch_chunk(prog: TorchProgram, acc: int, cls: torch.Tensor,
                  v0: torch.Tensor):
    _check_states(prog)
    cls = _cls16(prog, cls)
    B, T = cls.shape
    C, S = prog.char_mask.shape
    if v0.shape != (B, S) or v0.device != cls.device:
        raise ValueError(f"v0 must be [{B}, {S}] on {cls.device}, got "
                         f"{tuple(v0.shape)} on {v0.device}")
    Sk = kernel_states(S)
    v0 = F.pad(v0.to(torch.int8), (0, Sk - S)).contiguous()
    follow_bits, mask_bits = _bit_tables(prog)
    vout = torch.empty((B, Sk), dtype=torch.int8, device=cls.device)
    matched = torch.empty(B, dtype=torch.uint8, device=cls.device)
    stream = torch.cuda.current_stream(cls.device).cuda_stream
    err = _library().klogs_chunk_nfa(
        cls.data_ptr(), B, T, follow_bits.data_ptr(), mask_bits.data_ptr(),
        Sk, C, acc, v0.data_ptr(), vout.data_ptr(), matched.data_ptr(),
        stream, cls.device.index or 0)
    _count(CHUNK)
    _check(err, CHUNK)
    if Sk != S:
        vout = vout[:, :S].contiguous()
    return vout, matched.bool()


def match_chunk_cls_plain(prog: TorchProgram, acc: int, cls: torch.Tensor,
                          v0: torch.Tensor, work: dict | None = None):
    """Plain version of the chunk kernel: a loop over T of the boolean
    step on a [B, S] state. Returns (v [B, S] int8, v[:, acc]); ``work``
    as in ``match_cls_grouped_plain``."""
    follow = prog.follow.float()  # [S, S]
    table, idx = _mask_table(prog.char_mask, cls)  # [C+1, S], [B, T]
    v = v0 != 0
    active = torch.zeros((), dtype=torch.int64, device=cls.device)
    for t in range(cls.shape[1]):
        if work is not None:
            active += v.sum()
        reach = (v.float() @ follow) > 0
        v = reach & table.index_select(0, idx[:, t])
    if work is not None:
        work["active"] = work.get("active", 0) + int(active)
    return v.to(torch.int8), v[:, acc].clone()


# ---- K2g: carried-state chunk match over the grouped automata --------------


def grouped_state_words(prog: TorchProgram) -> int:
    """Words of one (line, group) state in K2g's carry: the group's
    states padded to ``kernel_states``."""
    return kernel_states(prog.n_states) // 32


def initial_state_grouped(prog: TorchProgram, live: int,
                          batch_size: int) -> torch.Tensor:
    """[B, G, W] int32 words, ``{live}`` in every (line, group): the
    start of K2g's carry (bit b of word j is state 32j+b)."""
    G = prog.follow.shape[0]
    v = torch.zeros((batch_size, G, grouped_state_words(prog)),
                    dtype=torch.int32, device=prog.device)
    bit = 1 << (live % 32)
    v[:, :, live // 32] = bit - (1 << 32 if bit >= 1 << 31 else 0)
    return v


def _check_carry(prog: TorchProgram, cls: torch.Tensor,
                 v0: torch.Tensor) -> None:
    want = (cls.shape[0], prog.follow.shape[0], grouped_state_words(prog))
    if (tuple(v0.shape) != want or v0.dtype != torch.int32
            or v0.device != cls.device):
        raise ValueError(f"v0 must be {list(want)} int32 words on "
                         f"{cls.device}, got {tuple(v0.shape)} {v0.dtype} "
                         f"on {v0.device}")


def match_chunk_cls_grouped(prog: TorchProgram, live: int, acc: int,
                            cls: torch.Tensor, v0: torch.Tensor,
                            final: bool = True):
    """One chunk of carried-state matching over a ``compile_grouped``
    program: [B, T] class ids (``classify_chunk`` layout, latch column on
    the final chunk) and the [B, G, W] carry (``initial_state_grouped``)
    -> (carry, matched [B] bool: some group holds ``acc``); ``match_all``
    is ORed in on the final chunk. Any group width runs (past
    ``WIDE_WORDS``, the state in shared memory; ``GroupTooWideError``
    where a warp's two buffers do not fit)."""
    if prog.follow.dim() != 3:
        raise ValueError(f"{GROUPED_CHUNK} needs a compile_grouped program")
    if cls.device.type == "cpu":
        v, matched = match_chunk_cls_grouped_plain(prog, live, acc, cls, v0)
    elif cls.device.type == "cuda":
        v, matched = _launch_grouped_chunk(prog, live, acc, cls, v0)
    else:
        raise ValueError(f"unsupported device {cls.device}")
    return v, (_or_match_all(prog, matched) if final else matched)


def _launch_grouped_chunk(prog: TorchProgram, live: int, acc: int,
                          cls: torch.Tensor, v0: torch.Tensor):
    _check_states(prog)
    words = grouped_state_words(prog)
    route = _route(words)
    cls = _cls16(prog, cls)
    _check_carry(prog, cls, v0)
    B, T = cls.shape
    G, C, S = prog.char_mask.shape
    if route == "smem":
        _check_width(words)
    name = _NAMES[route]["k2g"]
    v0 = v0.contiguous()
    follow, mask = _gated_tables(prog, live)
    vout = torch.empty_like(v0)
    # A verdict byte per line, zeroed by the call and set in place
    # through its 32-bit word.
    out = torch.empty(-(-B // 4) * 4, dtype=torch.uint8, device=cls.device)
    stream = torch.cuda.current_stream(cls.device).cuda_stream
    err = _library().klogs_grouped_chunk_nfa(
        cls.data_ptr(), B, T, follow.data_ptr(), mask.data_ptr(), G,
        kernel_states(S), C, live, acc, v0.data_ptr(), vout.data_ptr(),
        out.data_ptr(), stream, cls.device.index or 0)
    _count(name)
    _check(err, name)
    return vout, out[:B].view(torch.bool)


def match_chunk_cls_grouped_plain(prog: TorchProgram, live: int, acc: int,
                                  cls: torch.Tensor, v0: torch.Tensor,
                                  work: dict | None = None):
    """Plain version of K2g: the carry unpacked to a [G, B, S] state,
    stepped by ``_group_steps_plain``, packed back. Returns (carry [B, G,
    W] int32, [B] bool: some group holds ``acc``); ``work`` as in
    ``_group_steps_plain``."""
    _check_carry(prog, cls, v0)
    S = prog.n_states
    v = unpack_bits(v0, S).permute(1, 0, 2)  # [G, B, S]
    v = _group_steps_plain(prog, live, cls, v, work)
    words = to_int32(pack_bits(v.permute(1, 0, 2)))  # [B, G, S/32]
    words = F.pad(words, (0, v0.shape[-1] - words.shape[-1]))
    return words.contiguous(), v[:, :, acc].any(dim=0)
