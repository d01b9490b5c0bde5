"""The port's host runtime (port of cips_tpu/runtime): `native` builds and binds
the C++ NIfTI decode and its prefetch pool, which the datasets and
``--streaming`` decode through."""
