from klogs_tpu_torch.utils.bytesize import convert_bytes
from klogs_tpu_torch.utils.duration import parse_duration
from klogs_tpu_torch.utils.naming import (
    FILE_NAME_SEPARATOR,
    default_log_path,
    log_file_name,
    split_log_file_name,
)

__all__ = [
    "convert_bytes",
    "parse_duration",
    "FILE_NAME_SEPARATOR",
    "default_log_path",
    "log_file_name",
    "split_log_file_name",
]
