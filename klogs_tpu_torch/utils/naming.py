"""Log file naming and default paths.

Reference parity: file name ``<pod>__<container>.log`` with separator
"__" (cmd/root.go:51-53,341-342); default log path
``logs/<YYYY-MM-DDTHH-MM>`` computed once at startup (cmd/root.go:47);
the size table parses names back via the separator (cmd/root.go:295-296).
"""

import os
import time

FILE_NAME_SEPARATOR = "__"


def default_log_path(now: float | None = None) -> str:
    t = time.localtime(now if now is not None else time.time())
    return os.path.join("logs", time.strftime("%Y-%m-%dT%H-%M", t))


def log_file_name(pod: str, container: str) -> str:
    return f"{pod}{FILE_NAME_SEPARATOR}{container}.log"


def split_log_file_name(file_name: str) -> tuple[str, str]:
    """Invert log_file_name: basename -> (pod, container)."""
    base = os.path.basename(file_name)
    parts = base.split(FILE_NAME_SEPARATOR)
    if len(parts) < 2:
        raise ValueError(f"not a klogs log file name: {base!r}")
    pod, container = parts[0], parts[1]
    container = container.removesuffix(".log")
    return pod, container
