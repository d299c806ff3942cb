"""Hash repartitioning and the in-process shuffle service."""
