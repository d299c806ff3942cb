"""Expression evaluation and Spark hashing on torch tensors."""
