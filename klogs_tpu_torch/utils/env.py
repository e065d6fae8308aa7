"""The port's access point for ``KLOGS_*`` environment variables.

The port reads only names the JAX package already documents
(``KLOGS_FAKE_PODS``/``_CONTAINERS``/``_LINES`` for ``--cluster fake``,
``KLOGS_MAX_PATTERN_POSITIONS`` in the compiler, ``KLOGS_WATCH_INTERVAL_S``
for ``--watch-new`` and ``KLOGS_BUILD_VERSION`` for ``-v``) and adds
none.
"""

import os


def read(name: str, default: "str | None" = None) -> "str | None":
    """The raw environment read; every KLOGS_* name flows through here."""
    return os.environ.get(name, default)
