"""Data-parallel training across cards (port of cips_tpu/parallel): `mesh` holds
the topology, the batch split, DDP and the device prefetch; `dryrun` starts N
ranks and runs one sharded train step."""
