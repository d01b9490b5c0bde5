"""Training across cards (port of cips_tpu/parallel): `mesh` holds the topology
(a data × space grid of ranks), the batch split, DDP and the device prefetch;
`spatial` the depth-sharded primitives of the space axis (halo convs, norm
statistics, K/V and volume gathers); `dryrun` starts N ranks and runs one
sharded train step."""
