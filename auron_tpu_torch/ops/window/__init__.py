"""Window operator (counterpart of auron_tpu/ops/window)."""
