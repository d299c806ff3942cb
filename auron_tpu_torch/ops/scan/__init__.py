"""Scan operators: the FFI reader and the shuffle-read IPC reader."""
