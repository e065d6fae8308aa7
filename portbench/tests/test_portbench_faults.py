"""The check has teeth: a run whose timed path is broken underneath
comes out not correct, once for each fault a cell of this benchmark can
have. (The cells run on one card: there is no exchange between chips to
leave out.) On the CPU, the chip's look skipped, a small cell."""

import numpy as np
import pytest

from conftest import TINY_SHORT, add_cell, last_json

from klogs_tpu_torch.filters.gpu import GpuEngineFilter
from portbench import run


def _unchanged(out: np.ndarray) -> np.ndarray:
    # The matching step returns its state unchanged: no line ever matches.
    return np.zeros_like(out)


def _half(out: np.ndarray) -> np.ndarray:
    # Half of the batch left out: its lines get no verdict of their own.
    out = out.copy()
    out[len(out) // 2:] = False
    return out


def _altered(out: np.ndarray) -> np.ndarray:
    # One answer altered where it is produced.
    out = out.copy()
    out[len(out) // 3] = ~out[len(out) // 3]
    return out


class _Previous:
    """Each RPC handed the verdicts of the batch before it."""

    def __init__(self):
        self.last = None

    def __call__(self, out: np.ndarray) -> np.ndarray:
        prev, self.last = self.last, out
        return out if prev is None or len(prev) != len(out) else prev


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, _Previous()],
                         ids=["unchanged", "half", "altered", "previous"])
def test_a_broken_timed_path_is_not_correct(fault, bench_copy, capsys,
                                            monkeypatch):
    root, bench_dir = bench_copy
    add_cell(root, "ops32.tinyshort", "ops32", TINY_SHORT)
    fetch = GpuEngineFilter.fetch_framed
    monkeypatch.setattr(GpuEngineFilter, "fetch_framed",
                        lambda self, handle: fault(fetch(self, handle)))
    assert run.main(["--workload", "ops32.tinyshort", "--seed", "4000000001",
                     "--seconds", "2", "--trace", "0"], root=root,
                    bench_dir=bench_dir, device="cpu") == 0
    out = capsys.readouterr()
    line = last_json(out.out)
    assert line["correct"] is False
    assert line["check"]["mismatched_lines"]["value"] > 0
    assert out.err.strip().splitlines()[-2].startswith(
        "check mismatched_lines ")


def test_the_unbroken_path_is_correct(bench_copy, capsys):
    root, bench_dir = bench_copy
    add_cell(root, "ops32.tinyshort", "ops32", TINY_SHORT)
    assert run.main(["--workload", "ops32.tinyshort", "--seed", "4000000001",
                     "--seconds", "2", "--trace", "0"], root=root,
                    bench_dir=bench_dir, device="cpu") == 0
    line = last_json(capsys.readouterr().out)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
