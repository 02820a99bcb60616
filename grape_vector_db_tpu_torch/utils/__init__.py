"""Small host-side utilities shared across the framework."""

from grape_vector_db_tpu_torch.utils.buckets import next_bucket, pad_rows, pad_to

__all__ = ["next_bucket", "pad_rows", "pad_to"]
