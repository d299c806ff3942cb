"""Device-resident columnar batches (counterpart of auron_tpu/columnar)."""
