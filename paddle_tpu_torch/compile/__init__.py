"""Shape buckets for prefill."""
