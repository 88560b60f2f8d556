"""Record formats: pluggable encoders and decoders for the file source and sink.

Counterpart of `flink_tpu/formats/`, copied: CSV, JSON lines and Avro
binary (a self-contained reader and writer for the core type subset).
Parquet needs pyarrow; where it is missing the format raises a clear error
instead of failing at import.
"""

from flink_tpu_torch.formats.registry import FORMATS, get_format  # noqa: F401
