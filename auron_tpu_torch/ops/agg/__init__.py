"""Sort-based two-phase aggregation."""
