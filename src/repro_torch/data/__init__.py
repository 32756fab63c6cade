"""Bebop-paged data pipeline: records, sharded loaders, device decode."""
from .pipeline import (BufferSource, DataConfig, FileSource,  # noqa: F401
                       HedgedReader, Pipeline, device_batches)
from .records import (example_layout, iter_example_batches,  # noqa: F401
                      pack_examples, synthetic_corpus, train_example_struct,
                      write_example_pages)
