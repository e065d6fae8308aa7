"""The two NFA scan kernels: wrappers, plain versions, launch counts.

Counterpart of ``klogs_tpu/ops/pallas_nfa.py``. Both kernels run the
augmented step ``v' = reach(v) & mask[cls[t]]`` (ops/nfa.py) over class
ids laid out BEGIN, body, END, PAD latch:

- ``match_cls_grouped`` (K1, ``grouped_nfa_kernel``, replacing
  ``_grouped_kernel``): a ``compile_grouped`` program of G automata,
  each started at ``{live}``; the verdict is state ``acc`` ORed over the
  groups, then ``match_all``;
- ``match_chunk_cls`` (K2, ``chunk_nfa_kernel``, replacing ``_kernel``):
  the single augmented union automaton with the [B, S] int8 state
  carried across the chunks of long lines.

A tensor on the CPU runs the plain PyTorch version (a Python loop over
the steps); a CUDA tensor launches the kernel from
``ops/csrc/nfa_kernels.cu`` or raises. ``LAUNCHES`` counts kernel
launches by kernel name, so a run can show that it went through them.
"""

import ctypes
import threading

import torch
import torch.nn.functional as F

from klogs_tpu_torch.ops.nfa import TorchProgram

GROUPED = "grouped_nfa_kernel"
CHUNK = "chunk_nfa_kernel"

LAUNCHES = {GROUPED: 0, CHUNK: 0}

# State words per line that the register kernels are built for; a
# program of another width up to 32 words runs at the next of them.
REGISTER_WORDS = (4, 8, 16, 32)
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
            lib.klogs_chunk_nfa.argtypes = [p, i, i, p, p, i, i, i, p, p, p,
                                            p, i]
            lib.klogs_chunk_nfa.restype = i
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
    *lead, S = table.shape
    t = (table != 0).reshape(*lead, S // 32, 32).to(torch.int64)
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                           device=table.device)
    words = (t * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words) \
        .to(torch.int32).contiguous()


def kernel_states(S: int) -> int:
    """The state count a kernel runs an S-state program at: S/32 words
    rounded up to a register width, or S itself past 32 words (the wide
    kernels). The added states are dead: no follow edge reaches them and
    no class admits them."""
    words = S // 32
    return 32 * next((w for w in REGISTER_WORDS if w >= words), words)


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


# ---- K1: grouped full-line match ----------------------------------------


def match_cls_grouped(prog: TorchProgram, live: int, acc: int,
                      cls: torch.Tensor) -> torch.Tensor:
    """[B, T] class ids -> [B] bool: any group's automaton, started at
    ``{live}``, holds ``acc`` after the last step; or ``match_all``."""
    if prog.follow.dim() != 3:
        raise ValueError("match_cls_grouped needs a compile_grouped program")
    if cls.device.type == "cpu":
        return match_cls_grouped_plain(prog, live, acc, cls)
    if cls.device.type != "cuda":
        raise ValueError(f"unsupported device {cls.device}")
    _check_states(prog)
    cls = _cls16(prog, cls)
    B, T = cls.shape
    G, C, S = prog.char_mask.shape
    follow_bits, mask_bits = _bit_tables(prog)
    out = torch.empty(B, dtype=torch.uint8, device=cls.device)
    stream = torch.cuda.current_stream(cls.device).cuda_stream
    err = _library().klogs_grouped_nfa(
        cls.data_ptr(), B, T, follow_bits.data_ptr(), mask_bits.data_ptr(),
        G, kernel_states(S), C, live, acc, out.data_ptr(), stream, cls.device.index or 0)
    _count(GROUPED)
    _check(err, GROUPED)
    return _or_match_all(prog, out.bool())


def _mask_table(char_mask: torch.Tensor, cls: torch.Tensor):
    """(char_mask as bool with one all-zero row appended at index C,
    [B, T] row indices): an id outside [0, C) selects the zero row, which
    kills every state, like the one-hot product of the JAX kernels."""
    C = char_mask.shape[-2]
    zero = torch.zeros_like(char_mask.narrow(-2, 0, 1))
    table = torch.cat([char_mask, zero], dim=-2).bool()
    c = cls.long()
    return table, torch.where((c >= 0) & (c < C), c, C)


def match_cls_grouped_plain(prog: TorchProgram, live: int, acc: int,
                            cls: torch.Tensor, work: dict | None = None
                            ) -> torch.Tensor:
    """Plain version of ``match_cls_grouped``: a loop over T of the
    boolean step on a [G, B, S] state. ``work``, when given, receives
    under "active" the number of state bits the steps read (summed over
    groups, lines and steps): the follow rows the bitset kernel ORs."""
    B, T = cls.shape
    G, C, S = prog.char_mask.shape
    follow = prog.follow.float()  # [G, S, S]
    table, idx = _mask_table(prog.char_mask, cls)  # [G, C+1, S], [B, T]
    v = torch.zeros((G, B, S), dtype=torch.bool, device=cls.device)
    v[:, :, live] = True
    active = torch.zeros((), dtype=torch.int64, device=cls.device)
    for t in range(T):
        if work is not None:
            active += v.sum()
        reach = torch.bmm(v.float(), follow) > 0
        v = reach & table.index_select(1, idx[:, t])
    if work is not None:
        work["active"] = work.get("active", 0) + int(active)
    return _or_match_all(prog, v[:, :, acc].any(dim=0))


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
