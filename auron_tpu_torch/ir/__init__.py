"""Plan/expression IR — the wire format shared with auron_tpu/ir.

Frozen dataclasses with the JAX package's `kind` tags and JSON form, so a
`TaskDefinition` serialized by either engine deserializes in the other.
"""
