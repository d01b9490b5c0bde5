"""Train the sMCI/pMCI converter classifier (port of cips_tpu/cli/train_classifier.py).

The JAX CLI's flags and ablation layout: --use_PET / --no_PET and --use_T1
select the input channels, --use_tabular_info the covariate cross-attention,
--no_attention the attention-free config; the run lives in
``{exp_dir}/{pet_t1_tab_noattn}`` (`exp_subdir`). --test_fake_pet with
--fake_pet_dir evaluates on synthesized PET (``rec.nii.gz``), the paper's
synthesize-then-classify path. The sessions are packed once to float16
stores (``{run}/packed_{train,eval|eval_fake}`` or --packed_dir /
--eval_packed_dir, reused when they hold a store whose PET source matches the
run) unless --streaming. Every epoch the training and eval metrics are printed
and logged, a confusion-matrix image is written, and every --save_every epochs a
checkpoint, ranked by 1 - eval AUC. Dropout draws from torch's generator,
seeded with --seed + 1. Runs on the card unless ``--device cpu``.

Data-parallel across cards under torchrun, as train_unet: ``--batch_size`` is a
node's batch, split over its ranks, and the classifier trains under DDP (the
weighted cross entropy normalised over the global batch); the eval sessions
are dealt out over the ranks; every metric is computed from the logits of all
ranks, gathered; only rank 0 logs and writes checkpoints. Each rank's dropout
draws from torch's generator seeded with --seed + 1 + its rank.

  python -m cips_tpu_torch.cli.train_classifier --exp_dir /tmp/cls \\
      --training_info_csv train.csv --eval_info_csv test.csv --converter_csv mci.csv \\
      --PET_dir ... --T1_dir ... --use_T1 --use_tabular_info --min_and_max stats.json
  python -m torch.distributed.run --nproc_per_node 8 -m cips_tpu_torch.cli.train_classifier ...
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from cips_tpu_torch.cli import common
from cips_tpu_torch.data.dataset import MCIBatchLoader, MCIClassificationDataset, PackedMCIDataset, pack_mci
from cips_tpu_torch.eval.classification import classification_metrics, metrics_row, save_confusion_matrix_figure
from cips_tpu_torch.parallel.mesh import Mesh, barrier, device_prefetch, gather, make_mesh, shard_rows
from cips_tpu_torch.training import classifier_task
from cips_tpu_torch.training.common import CheckpointManager, MetricWriter


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The flags that pick the classifier's inputs and config (shared with test_mci)."""
    p.add_argument("--converter_csv", required=True, help="Subject,MCI_converter,Converter_date CSV")
    p.add_argument("--config", default=None, help="model config JSON (default: bundled training_atten.json, "
                                                  "or training_no_atten.json with --no_attention)")
    p.add_argument("--use_PET", action="store_true", default=True)
    p.add_argument("--no_PET", dest="use_PET", action="store_false")
    p.add_argument("--use_T1", action="store_true")
    p.add_argument("--use_tabular_info", action="store_true")
    p.add_argument("--no_attention", action="store_true")
    p.add_argument("--test_fake_pet", action="store_true", help="evaluate on synthesized PET (rec.nii.gz)")
    p.add_argument("--fake_pet_dir", default=None, help="tree of synthesized PET {dir}/{Subject}/{date}/rec.nii.gz")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])


def exp_subdir(args) -> str:
    """The run's directory: {exp_dir}/ joined with pet, t1, tab and noattn as flagged."""
    parts = [name for name, on in (("pet", args.use_PET), ("t1", args.use_T1), ("tab", args.use_tabular_info),
                                   ("noattn", args.no_attention)) if on]
    return os.path.join(args.exp_dir, "_".join(parts) or "none")


def build_dataset(args, need_values, train: bool, fake_pet: bool = False) -> MCIClassificationDataset:
    return MCIClassificationDataset(
        args.training_info_csv if train else args.eval_info_csv, converter_csv=args.converter_csv,
        pet_dir=args.fake_pet_dir if fake_pet else args.PET_dir, t1_dir=args.T1_dir,
        crop_size=tuple(args.crop_size), need_values=need_values, min_and_max=common.load_stats(args.min_and_max),
        use_pet=args.use_PET, use_t1=args.use_T1, pet_name="rec.nii.gz" if fake_pet else None,
    )


def build_model(args, cfg: dict, n_covariates: int, device: torch.device) -> classifier_task.DiffusionModelEncoder:
    return classifier_task.build_model(
        cfg, in_channels=int(args.use_PET) + int(args.use_T1), input_shape=args.crop_size, n_covariates=n_covariates,
        dtype=common.dtype_arg(args.dtype), device=device, seed=args.seed,
    )


def load_model_config(args) -> dict:
    return common.load_config(args.config, "training_no_atten.json" if args.no_attention else "training_atten.json")


def iter_batches(ds: MCIClassificationDataset, batch_size: int, shuffle: bool, seed: int,
                 epoch: int, process_index: int = 0, process_count: int = 1, shard_index: int = 0,
                 shard_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Batches decoded as they go (--streaming, and test_mci): shuffled by
    ``np.random.default_rng(seed + epoch)``, node ``process_index`` of
    ``process_count`` taking every ``process_count``-th; at a batch size above 1
    a short last batch is dropped; this rank decodes its share of each batch
    (``shard_index`` of ``shard_count``, `parallel.mesh.shard_rows`)."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    order = order[process_index::process_count]
    for b in range(0, len(order), batch_size):
        idx = order[b : b + batch_size]
        if len(idx) < batch_size and batch_size > 1:
            break
        idx = idx[shard_rows(len(idx), shard_index, shard_count)]
        samples = [ds[int(i)] for i in idx]
        yield {"imgs": np.stack([s[0] for s in samples]), "info": np.stack([s[1] for s in samples])[:, None, :],
               "labels": np.asarray([s[2] for s in samples], np.int32)}


def _places(mesh: Mesh) -> tuple:
    """The loaders' keyword arguments: the training batches' (node slice, rank
    share) and the eval sessions', dealt out over every rank."""
    return (dict(process_index=mesh.node_index, process_count=mesh.node_count, shard_index=mesh.local_rank,
                 shard_count=mesh.local_world_size), dict(process_index=mesh.rank, process_count=mesh.world_size))


def make_mci_loaders(args, train_ds: MCIClassificationDataset, eval_ds: MCIClassificationDataset,
                     exp: str, mesh: Optional[Mesh] = None) -> tuple:
    """(train, eval) `MCIBatchLoader`s over packed stores: the training sessions
    shuffled at --batch_size dropping a short last batch, the eval sessions in
    order at --batch_size keeping all (across ranks, as `_places` deals them).
    A given store must have been packed from the PET this run reads (real, or
    synthesized with --test_fake_pet): else SystemExit; a store without a
    recorded source is taken. Rank 0 packs a missing store while the others wait."""
    mesh = mesh or Mesh()

    def ensure(ds: MCIClassificationDataset, packed_dir, tag: str) -> PackedMCIDataset:
        want = "fake" if ds.pet_name else "real"
        if packed_dir and os.path.exists(os.path.join(packed_dir, "volumes.npy")):
            packed = PackedMCIDataset(packed_dir)
            if packed.pet_source is not None and packed.pet_source != want:
                raise SystemExit(f"packed dir {packed_dir} was built from {packed.pet_source} PET but this run "
                                 f"expects {want} PET: repack or pass a matching dir")
            return packed
        out = packed_dir or os.path.join(exp, f"packed_{tag}")
        missing = not os.path.exists(os.path.join(out, "volumes.npy"))
        barrier(mesh)  # every rank has looked before rank 0 writes
        if missing and mesh.is_lead:
            pack_mci(ds, out)
        barrier(mesh)
        return PackedMCIDataset(out)

    train_place, eval_place = _places(mesh)
    train = MCIBatchLoader(ensure(train_ds, args.packed_dir, "train"), args.batch_size, seed=args.seed,
                           **train_place)
    eval_tag = "eval_fake" if args.test_fake_pet else "eval"
    evaluate = MCIBatchLoader(ensure(eval_ds, args.eval_packed_dir, eval_tag), args.batch_size, shuffle=False,
                              drop_last=False, **eval_place)
    return train, evaluate


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def evaluate_logits(predict: Callable, batches, device: torch.device) -> tuple:
    """(labels, logits) of every eval batch, as numpy."""
    labels, logits = [], []
    for batch in batches:
        logits.append(predict(to_device(batch, device)).cpu().numpy())
        labels.append(np.asarray(batch["labels"]))
    return (np.concatenate(labels), np.concatenate(logits)) if labels else (None, None)


def main(argv=None) -> classifier_task.ClassifierState:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_data_args(p)
    add_model_args(p)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--save_every", type=int, default=5)
    p.add_argument("--max_steps", type=int, default=0, help="debug: stop after N steps")
    args = p.parse_args(argv)

    mesh = make_mesh(args.device)
    device = mesh.device
    cfg = load_model_config(args)
    need_values = common.covariates_for(args.pet_kind, args.use_tabular_info)
    exp = exp_subdir(args)
    for d in ("log", "ckpt"):
        os.makedirs(os.path.join(exp, d), exist_ok=True)

    state = classifier_task.init_state(build_model(args, cfg, len(need_values), device),
                                       cfg.get("training", {}).get("base_lr", 1e-4), mesh=mesh)
    ckpt = CheckpointManager(os.path.join(exp, "ckpt"))
    writer = MetricWriter(os.path.join(exp, "log"), enabled=mesh.is_lead)
    step_fn = classifier_task.make_train_step(args.use_tabular_info, mesh=mesh)
    predict = classifier_task.make_predict_fn(state.model, args.use_tabular_info)
    torch.manual_seed(args.seed + 1 + mesh.rank)

    train_ds = build_dataset(args, need_values, train=True)
    eval_ds = build_dataset(args, need_values, train=False, fake_pet=args.test_fake_pet)
    if mesh.is_lead:
        print(f"train {len(train_ds)} sessions, eval {len(eval_ds)} sessions")
    if args.streaming:
        train_place, eval_place = _places(mesh)
        train_batches = lambda epoch: iter_batches(train_ds, args.batch_size, True, args.seed, epoch,  # noqa: E731
                                                   **train_place)
        eval_batches = lambda: iter_batches(eval_ds, args.batch_size, False, 0, 0, **eval_place)  # noqa: E731
    else:
        train_loader, eval_loader = make_mci_loaders(args, train_ds, eval_ds, exp, mesh)
        train_batches, eval_batches = train_loader.epoch, lambda: eval_loader.epoch(0)

    def gathered(labels: list, logits: list) -> tuple:
        """Every rank's (labels, logits), concatenated; (None, None) when there are none."""
        pairs = gather(mesh, list(zip(labels, logits)))
        if not pairs:
            return None, None
        return np.concatenate([a for a, _ in pairs]), np.concatenate([b for _, b in pairs])

    global_step = 0
    try:
        for epoch in range(args.epochs):
            logits_all, labels_all = [], []
            for batch in device_prefetch(train_batches(epoch), mesh):
                metrics = step_fn(state, batch)
                if mesh.owns_rows(args.batch_size):  # a replicated batch is counted once
                    logits_all.append(metrics["logits"].cpu().numpy())
                    labels_all.append(batch["labels"].cpu().numpy())
                global_step += 1
                if args.max_steps and global_step >= args.max_steps:
                    break
            labels_np, logits_np = gathered(labels_all, logits_all)
            if labels_np is not None:
                m = classification_metrics(labels_np, logits_np)
                writer.scalars("training", m, epoch)
                if mesh.is_lead:
                    print(f"epoch {epoch} train: {metrics_row(m)} (f1&auc&acc&prec&rec)")

            labels_np, logits_np = evaluate_logits(predict, eval_batches(), device)
            labels_np, logits_np = gathered([] if labels_np is None else [labels_np],
                                            [] if logits_np is None else [logits_np])
            if labels_np is not None and mesh.is_lead:
                m = classification_metrics(labels_np, logits_np)
                writer.scalars("eval", m, epoch)
                print(f"epoch {epoch} eval:  {metrics_row(m)}")
                save_confusion_matrix_figure(labels_np, logits_np.argmax(-1),
                                             os.path.join(exp, "log", f"cm_epoch{epoch}.jpg"))
                if epoch % args.save_every == 0:
                    ckpt.save({"model": state.model.state_dict(), "optimizer": state.opt.state_dict(),
                               "step": state.step, "epoch": epoch}, epoch, eval_metric=1.0 - m["auc"])
            if args.max_steps and global_step >= args.max_steps:
                break
    finally:
        writer.close()
        mesh.close()
    return state


if __name__ == "__main__":
    main()
