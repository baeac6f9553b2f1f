"""Int8 serving: per-out-channel linear weights (``weights``) and paged KV
pools with per-row scales (``kv``)."""
