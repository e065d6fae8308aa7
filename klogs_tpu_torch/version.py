"""Build version stamping (counterpart of ``klogs_tpu/version.py``).

The reference stamps ``cmd.BuildVersion`` at link time and defaults to
"development"; here ``KLOGS_BUILD_VERSION`` overrides it at import.
"""

from klogs_tpu_torch.utils.env import read as _env_read

BUILD_VERSION = _env_read("KLOGS_BUILD_VERSION", "development")
