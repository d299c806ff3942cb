"""The single-device stage executor."""
