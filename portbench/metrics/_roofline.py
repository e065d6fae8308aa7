"""The byte roofline of the matching work: a frozen function of the
inputs alone.

Whatever implements the match (a DFA, a literal sweep, a shift-and
step), it reads every line byte once, the pattern set once a device
batch, and writes one verdict bit a line. Those bytes over the card's
HBM bandwidth are the least time any implementation can take; an
operation count would depend on the implementation and could be beaten.
The pattern set counts as its own text (UTF-8 of every pattern), the
least a table of it can hold.
"""


def least_bytes(line_bytes: int, n_lines: int, n_batches: int,
                pattern_bytes: int) -> int:
    return line_bytes + n_batches * pattern_bytes + -(-n_lines // 8)


def least_time_s(line_bytes: int, n_lines: int, n_batches: int,
                 pattern_bytes: int, hbm_bytes_s: float) -> float:
    return least_bytes(line_bytes, n_lines, n_batches,
                       pattern_bytes) / hbm_bytes_s
