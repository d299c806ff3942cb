"""The part of the TPC-DS harness (auron_tpu/it/) that builds foreign
plans without the JAX package or pyarrow: the catalog's table
definitions and the builders of the queries the card runs from their
foreign plans."""
