"""The port's cache directory (counterpart of ``klogs_tpu/utils/cache.py``).

``XDG_CACHE_HOME``, else ``~/.cache``, as in the JAX package, but under
a namespace of the port's own, ``klogs-tpu-torch``, not the JAX
package's ``klogs-tpu``. The DFA table cache's LRU
(``filters/compiler/dfa.py`` ``_evict_lru``) sweeps every ``dfa-*.npz``
in its directory against one size cap: in a shared directory one
package would evict the other's tables, and each would count the
other's files against its cap.
"""

import os


def cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "klogs-tpu-torch")
