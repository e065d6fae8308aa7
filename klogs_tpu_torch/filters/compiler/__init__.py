"""--match pattern compiler: regex subset → Glushkov bit-parallel NFA
arrays (a copy of ``klogs_tpu.filters.compiler``'s parser and
Glushkov builder)."""

from klogs_tpu_torch.filters.compiler.glushkov import (
    NFAProgram,
    compile_patterns,
    reference_match,
)
from klogs_tpu_torch.filters.compiler.parser import RegexSyntaxError, parse

__all__ = [
    "NFAProgram",
    "RegexSyntaxError",
    "compile_patterns",
    "parse",
    "reference_match",
]
