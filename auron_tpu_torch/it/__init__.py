"""The TPC-DS harness (counterpart of auron_tpu/it/) without the JAX
package or pyarrow: a numpy generator of the star schema
(`datagen.generate`) and the foreign engine that serves its scans
(`datagen.TableEngine`), the 103 query builders (`queries`), the
comparator (`compare`), the runner (`runner.QueryRunner`) and the CLI
(`python -m auron_tpu_torch.it`).  The expected results come from the
JAX package's oracle (`tools/torch_expected.py`)."""
