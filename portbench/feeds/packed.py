"""The packed feed: the port's `BatchLoader` over its packed float16 store
(the arrays `PackedDataset` would map, held in memory) through
`device_prefetch`, epoch after epoch, as `train_unet` and `train_causal` feed
their steps."""

from __future__ import annotations

import itertools
from typing import Iterator, List, Mapping

from portbench import data


def make_store(traffic: Mapping, cfg: Mapping, seed: int, device) -> dict:
    return data.make_store(traffic, cfg["volume"], cfg["covariates"], seed, device)


def packed_store(store: Mapping, need_values) -> object:
    """The port's packed store over arrays held in memory (``PackedDataset`` maps
    ``volumes.npy`` from disk; the arrays are what it would map)."""
    from cips_tpu_torch.data.dataset import PackedDataset

    packed = PackedDataset.__new__(PackedDataset)
    packed.volumes, packed.covariates = store["volumes"], store["covariates"]
    packed.need_values, packed.index = list(need_values), []
    return packed


def program_batches(store: Mapping, traffic: Mapping, cfg: Mapping, mesh, seed: int) -> Iterator[dict]:
    """This rank's rows of each node batch on its device, the shuffled epochs one after another."""
    from cips_tpu_torch.data.dataset import BatchLoader
    from cips_tpu_torch.parallel.mesh import device_prefetch

    loader = BatchLoader(packed_store(store, range(cfg["covariates"])), int(traffic["batch"]), seed=seed,
                         process_index=mesh.node_index, process_count=mesh.node_count,
                         shard_index=mesh.local_data_index, shard_count=mesh.local_data_count)
    return itertools.chain.from_iterable(device_prefetch(loader.epoch(e), mesh) for e in itertools.count())


def reference_samples(store: Mapping, traffic: Mapping, seed: int, steps: int, device) -> List[list]:
    """The samples of the first ``steps`` node batches, in the loader's order."""
    rows = data.batch_rows(seed, 0, int(traffic["subjects"]), int(traffic["batch"]))[:steps]
    return [data.samples(store, r, device) for r in rows]
