"""Go-style duration parsing.

Reference parity: ``--since`` is parsed with Go's ``time.ParseDuration``
(cmd/root.go:206) which accepts decimal numbers with optional fraction
and a unit suffix, concatenated: "300ms", "-1.5h", "2h45m". Valid units:
ns, us (µs/μs), ms, s, m, h. A bare number with no unit is an error, as
is an empty string.
"""

import re

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "μs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_TOKEN = re.compile(r"(\d+(?:\.\d*)?|\.\d+)(ns|us|µs|μs|ms|s|m|h)")


class DurationError(ValueError):
    pass


def parse_duration(text: str) -> float:
    """Parse a Go duration string into seconds (float)."""
    s = text
    if not s:
        raise DurationError(f"time: invalid duration {text!r}")
    sign = 1.0
    if s[0] in "+-":
        sign = -1.0 if s[0] == "-" else 1.0
        s = s[1:]
    if not s:  # bare "+" / "-" is invalid, like Go
        raise DurationError(f"time: invalid duration {text!r}")
    if s == "0":
        return 0.0
    total = 0.0
    pos = 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            raise DurationError(f"time: invalid duration {text!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    return sign * total
