"""The port's data-parallel training (`cips_tpu_torch.parallel`) on the CPU.

Ranks run over gloo, each a spawned process with one torch thread. What is
held:

  * the loaders: at 2 ranks on one node the ranks' rows of every batch make up
    the JAX package's one-process batch, values and random draws exactly; at
    2 nodes of 1 rank each node's batches are JAX's at that process index;
  * one spawn of 2 ranks runs two tiny fp32 flagship steps from shared weights,
    one with ``split_d`` and ``exact_d_fake``, one causal step (the noise drawn
    for the global batch and sliced) and one classifier step at global batch
    2, then a flagship step with a NaN in one rank's rows: the replicas stay bit-identical, agree with the port's
    one-process steps on the global batch within 1e-5 of each tensor's
    max|value| (`dryrun.compare_params`), the flagship with the JAX step within
    tests/test_torch_port_train.py's limit, and both ranks skip the NaN step;
  * `train_unet` under torchrun (2 ranks, ``--device cpu``): one writer, a
    checkpoint as a one-process run's, and ``--resume`` at 1 rank from it;
  * the prefetch, the profiling module and the mesh's arithmetic.

The module imports nothing of JAX at its top: the spawned ranks import it to
find their function. The JAX package is imported inside the tests.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cips_tpu_torch.cli import train_unet
from cips_tpu_torch.data import dataset, nifti
from cips_tpu_torch.parallel import dryrun
from cips_tpu_torch.parallel.mesh import (
    Mesh,
    data_parallel,
    device_prefetch,
    initialize_distributed,
    make_mesh,
    shard_batch,
    shard_rows,
)
from cips_tpu_torch.training import causal_task, classifier_task, profiling, unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager, StepTimer, mean_over_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]
TINY_CLS = {
    "atten_encoder_def": {
        "spatial_dims": 3, "in_channels": 1, "out_channels": 2, "num_channels": [8, 8], "num_res_blocks": 1,
        "attention_levels": [False, True], "norm_num_groups": 8, "resblock_updown": True, "num_head_channels": [0, 4],
    },
    "training": {"base_lr": 1e-3},
}
SMALL = (8, 16, 8)  # the causal trio's and the classifier's crop (the JAX dry run's)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module: its tensors are tiny, and a full
    intra-op pool in each of the suite's parallel workers oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# --- the mesh's arithmetic -------------------------------------------------


@pytest.mark.parametrize("n,count,want", [
    (4, 2, [slice(0, 2), slice(2, 4)]),  # a node batch split over its ranks
    (3, 2, [slice(0, 3), slice(0, 3)]),  # not divisible: every rank takes it whole, as JAX replicates it
    (1, 4, [slice(0, 1)] * 4),  # the eval batch of 1
    (6, 1, [slice(0, 6)]),
])
def test_shard_rows_splits_or_replicates(n, count, want):
    assert [shard_rows(n, i, count) for i in range(count)] == want


def test_mesh_places_ranks_on_nodes_and_in_the_global_batch():
    # 2 nodes of 2 ranks; node batch 4: the global batch holds node 0's 4 rows, then node 1's
    meshes = [Mesh(rank=r, world_size=4, local_rank=r % 2, local_world_size=2) for r in range(4)]
    assert [(m.node_index, m.node_count, m.is_lead) for m in meshes] == [
        (0, 2, True), (0, 2, False), (1, 2, False), (1, 2, False)]
    assert [m.global_rows(4) for m in meshes] == [(8, slice(0, 2)), (8, slice(2, 4)), (8, slice(4, 6)),
                                                  (8, slice(6, 8))]
    # a node batch of 3 is replicated on the node's ranks: each takes the node's rows whole,
    # and a gather over ranks counts them once (the node's first rank)
    assert [m.global_rows(3) for m in meshes] == [(6, slice(0, 3))] * 2 + [(6, slice(3, 6))] * 2
    assert [m.owns_rows(3) for m in meshes] == [True, False, True, False]
    assert all(m.owns_rows(4) for m in meshes)
    batch = {"t1": np.arange(8).reshape(4, 2), "info": torch.arange(4)}
    got = shard_batch(meshes[1], batch)
    assert got["t1"].tolist() == [[4, 5], [6, 7]] and got["info"].tolist() == [2, 3]


def test_make_mesh_without_torchrun_is_one_process(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed("cpu") is False
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.node_count, mesh.distributed, mesh.owns_group) == (0, 1, 1, False, False)
    assert mesh.device == torch.device("cpu")
    model = torch.nn.Linear(2, 2)
    assert data_parallel(model, mesh) is model  # one process: the network itself, no wrapper
    metrics = {"a": torch.tensor(1.5), "b": torch.tensor(2.0)}
    assert mean_over_ranks(metrics, mesh) == {"a": 1.5, "b": 2.0}
    mesh.close()


# --- the loaders: each rank's share of JAX's one-process batches -----------


def _write_packed(path, n=9, shape=(6, 8, 6), k=5, seed=0):
    """A packed pair store written directly: volumes (N, 2, D, H, W) float16, covariates, index."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "volumes.npy"), (rng.random((n, 2, *shape)) + 0.05).astype(np.float16))
    np.save(os.path.join(path, "covariates.npy"), rng.random((n, k)).astype(np.float32))
    rows = [{"subject": f"s{i}", "t1_date": "2012-01-01", "pet_date": "2012-01-15"} for i in range(n)]
    with open(os.path.join(path, "index.json"), "w", encoding="utf-8") as f:
        json.dump({"need_values": AV45[:k], "rows": rows}, f)
    return str(path)


def _write_packed_mci(path, n=9, shape=(6, 8, 6), k=5, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "volumes.npy"), rng.random((n, *shape, 2)).astype(np.float16))
    np.save(os.path.join(path, "covariates.npy"), rng.random((n, k)).astype(np.float32))
    np.save(os.path.join(path, "labels.npy"), (np.arange(n) % 2).astype(np.int32))
    rows = [{"subject": f"s{i}", "pet_date": "2012-01-15", "t1_date": "2012-01-01"} for i in range(n)]
    with open(os.path.join(path, "index.json"), "w", encoding="utf-8") as f:
        json.dump({"need_values": AV45[:k], "pet_source": "real", "rows": rows}, f)
    return str(path)


@pytest.fixture(scope="module")
def nifti_tree(tmp_path_factory):
    """Six subjects of (10, 12, 10) and their manifest with AV45 covariates."""
    root = tmp_path_factory.mktemp("ddp_tree")
    rng = np.random.default_rng(3)
    rows = []
    for i in range(6):
        subj = f"s{i:03d}"
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            nifti.write(str(root / kind / subj / date / "img.nii.gz"),
                        (rng.random((10, 12, 10)) * (1.0 + i) + 0.01).astype(np.float32))
        rows.append(f"{subj},2012-01-01,2012-01-15,{500 + 150 * i},{70 + i},{'Female' if i % 2 else 'Male'},"
                    f"{i % 3},{12 + i}")
    (root / "train.csv").write_text("\n".join(["Subject,T1_date,PET_date," + ",".join(AV45)] + rows) + "\n")
    (root / "stats.json").write_text(json.dumps({"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}))
    return root


def _loaders(kind, root, batch_size, tmp_path, place):
    """(port loader at ``place``, JAX loader at ``place``'s process index and count),
    fresh (a streaming dataset's crop generator is stateful)."""
    from cips_tpu.data import dataset as jax_dataset

    jax_place = {k: place[k] for k in ("process_index", "process_count") if k in place}
    if kind == "packed":
        path = str(tmp_path / "packed")
        if not os.path.exists(os.path.join(path, "volumes.npy")):
            _write_packed(path)
        kw = dict(seed=4, random_crop_size=(4, 6, 4))
        return (dataset.BatchLoader(dataset.PackedDataset(path), batch_size, **kw, **place),
                jax_dataset.BatchLoader(jax_dataset.PackedDataset(path), batch_size, **kw, **jax_place))
    if kind == "mci":
        path = str(tmp_path / "packed_mci")
        if not os.path.exists(os.path.join(path, "volumes.npy")):
            _write_packed_mci(path)
        return (dataset.MCIBatchLoader(dataset.PackedMCIDataset(path), batch_size, seed=5, **place),
                jax_dataset.MCIBatchLoader(jax_dataset.PackedMCIDataset(path), batch_size, seed=5, **jax_place))
    stats = json.loads((root / "stats.json").read_text())
    kw = dict(pet_dir=str(root / "pet"), t1_dir=str(root / "t1"), crop_size=(8, 10, 8), need_values=AV45,
              min_and_max=stats, random_crop_size=(5, 6, 5), seed=6)
    return (dataset.StreamingLoader(dataset.PairedVolumeDataset(str(root / "train.csv"), **kw), batch_size, seed=7,
                                    **place),
            jax_dataset.StreamingLoader(jax_dataset.PairedVolumeDataset(str(root / "train.csv"), **kw), batch_size,
                                        seed=7, **jax_place))


@pytest.mark.parametrize("kind", ["packed", "streaming", "mci"])
@pytest.mark.parametrize("batch_size", [2, 3])
def test_rank_shares_make_up_the_jax_loaders_batches(kind, batch_size, nifti_tree, tmp_path, monkeypatch):
    # The JAX streaming loader's synchronous path (no native prefetch pool) is the one ported.
    from cips_tpu.data import dataset as jax_dataset

    monkeypatch.setattr(jax_dataset, "_native", lambda: None)
    for epoch in (0, 1):
        # 2 ranks on one node: their rows of each batch, stacked, are JAX's one-process batch
        # (batch 3 does not divide: both ranks take it whole, as JAX replicates it)
        shares = [list(_loaders(kind, nifti_tree, batch_size, tmp_path,
                                dict(shard_index=r, shard_count=2))[0].epoch(epoch)) for r in range(2)]
        want = list(_loaders(kind, nifti_tree, batch_size, tmp_path, {})[1].epoch(epoch))
        assert len(want) > 1 and all(len(s) == len(want) for s in shares)
        for step, batch in enumerate(want):
            for key, value in batch.items():
                got = [np.asarray(s[step][key]) for s in shares]
                if batch_size % 2 == 0:
                    got = [np.concatenate(got)]
                for g in got:
                    np.testing.assert_array_equal(g, value, err_msg=f"{kind} epoch {epoch} step {step} {key}")
        # 2 nodes of 1 rank: node n's batches are JAX's at process n of 2
        for node in range(2):
            place = dict(process_index=node, process_count=2)
            port, jax_loader = _loaders(kind, nifti_tree, batch_size, tmp_path, place)
            got, want = list(port.epoch(epoch)), list(jax_loader.epoch(epoch))
            assert len(got) == len(want)
            if kind != "streaming":  # JAX's streaming loader has no steps_per_epoch
                assert len(got) == port.steps_per_epoch() == jax_loader.steps_per_epoch()
            for a, b in zip(got, want):
                for key in b:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=f"{kind} node {node} {key}")


# --- one spawn: flagship, causal and classifier steps at 2 ranks -----------


def _flagship_state(spec, mesh):
    g, d, _ = unet_synthesis.build_models(spec["cfg"], spec["k"], dtype=torch.float32, device="cpu")
    g.load_state_dict({k: torch.from_numpy(v) for k, v in spec["g"].items()})
    d.load_state_dict({k: torch.from_numpy(v) for k, v in spec["d"].items()})
    return unet_synthesis.init_state(g, d, spec["cfg"]["training"], mesh=mesh)


def _causal_state(mesh):
    models = causal_task.build_models(dryrun.TINY_CAUSAL, dryrun.N_COVARIATES, dtype=torch.float32, device="cpu")
    dryrun.randomize_(models[:4], seed=1)
    return causal_task.init_state(*models, dryrun.TINY_CAUSAL["training"], mesh=mesh)


def _classifier_state(mesh):
    model = classifier_task.build_model(TINY_CLS, in_channels=2, input_shape=SMALL, n_covariates=5,
                                        dtype=torch.float32, device="cpu", seed=0)
    dryrun.randomize_([model], seed=2)
    return classifier_task.init_state(model, TINY_CLS["training"]["base_lr"], mesh=mesh)


def _classifier_batch():
    rng = np.random.default_rng(8)
    # labels 0 and 1: the ranks' rows carry different class weights (1 and 4)
    return {"imgs": rng.random((2, *SMALL, 2), dtype=np.float32), "info": rng.random((2, 1, 5), dtype=np.float32),
            "labels": np.array([0, 1], np.int32)}


def _params(nets):
    return {f"{net}.{k}": v.detach().clone() for net, m in nets.items() for k, v in m.state_dict().items()}


def _grads(nets):
    return {f"{net}.{k}": p.grad.detach().clone() for net, m in nets.items() for k, p in m.named_parameters()
            if p.grad is not None}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _run_tasks(spec, mesh):
    """The tasks' steps, at ``mesh`` (None: one process on the whole global batch):
    {task: (params, per-step gradients, per-step metrics)}."""

    def rows(batch):
        return _torch(shard_batch(mesh, batch) if mesh is not None else batch)

    out = {}
    state = _flagship_state(spec, mesh)
    step = unet_synthesis.make_train_step(spec["cfg"]["training"], mesh=mesh)
    nets, grads, metrics = {"generator": state.g, "discriminator": state.d}, [], []
    for batch in spec["flagship_batches"]:
        metrics.append(mean_over_ranks(step(state, rows(batch)), mesh))
        grads.append(_grads(nets))
    out["flagship"] = (_params(nets), grads, metrics)

    # D's two forwards (split_d) before its one backward, and the updated G's fake (exact_d_fake)
    state = _flagship_state(spec, mesh)
    step = unet_synthesis.make_train_step(spec["cfg"]["training"], exact_d_fake=True, split_d=True, mesh=mesh)
    metrics = mean_over_ranks(step(state, rows(spec["flagship_batches"][0])), mesh)
    nets = {"generator": state.g, "discriminator": state.d}
    out["flagship_split_exact"] = (_params(nets), [_grads(nets)], [metrics])

    state = _causal_state(mesh)
    step = causal_task.make_train_step(dryrun.TINY_CAUSAL["training"], mesh=mesh, batch_size=2)
    metrics = mean_over_ranks(step(state, rows(dryrun.global_batch(2, SMALL, seed=9)), torch.Generator().manual_seed(1)),
                              mesh)
    nets = {"generator": state.gen, "discriminator": state.d}
    out["causal"] = (_params(nets), [_grads(nets)], [metrics])

    state = _classifier_state(mesh)
    metrics = classifier_task.make_train_step(True, dropout=False, mesh=mesh)(state, rows(_classifier_batch()))
    nets = {"classifier": state.model}
    out["classifier"] = (_params(nets), [_grads(nets)], [mean_over_ranks({"ce_loss": metrics["ce_loss"]}, mesh)])
    return out


def _rank_worker(mesh, spec):
    out = _run_tasks(spec, mesh)
    # a NaN in rank 1's rows only: the guard is decided on the all-reduced count, so both ranks skip
    state = _flagship_state(spec, mesh)
    before = _params({"g": state.g, "d": state.d})
    batch = {k: v.copy() for k, v in spec["flagship_batches"][0].items()}
    batch["t1"][1, 0, 0, 0, 0] = np.nan
    metrics = unet_synthesis.make_train_step(spec["cfg"]["training"], nan_guard=True, mesh=mesh)(
        state, _torch(shard_batch(mesh, batch)))
    after = _params({"g": state.g, "d": state.d})
    out["nan_guard"] = (float(metrics["skipped_nonfinite"]), state.step,
                        all(torch.equal(before[k], after[k]) for k in before), bool(np.isfinite(float(metrics["g_loss"]))))
    return out


@pytest.fixture(scope="module")
def flagship_spec():
    """tests/test_torch_port_train.py's tiny GAN: JAX params drawn non-zero everywhere, carried to the port,
    and two global batches of 2."""
    import jax

    from cips_tpu.training import unet_synthesis as jax_synthesis
    from cips_tpu_torch.data.jax_params import discriminator_from_jax_params, from_jax_params
    from test_torch_port_train import CFG, CROP, K, LEVELS, _batch, _random_tree

    g, d, _ = jax_synthesis.build_models(CFG, n_covariates=K, dtype=jax.numpy.float32, remat=False, s2d=False)
    rng = np.random.default_rng(0)
    x, ctx = jax.numpy.zeros((1, *CROP, 1)), jax.numpy.zeros((1, 1, K))
    g_params = _random_tree(jax.eval_shape(g.init, jax.random.key(0), x, ctx), rng)
    d_params = _random_tree(jax.eval_shape(d.init, jax.random.key(1), x), rng)
    batch_rng = np.random.default_rng(2)
    return {"cfg": CFG, "k": K, "jax": (g, d, g_params, d_params),
            "g": {k: v.numpy() for k, v in from_jax_params(g_params, LEVELS).items()},
            "d": {k: v.numpy() for k, v in discriminator_from_jax_params(d_params, 2).items()},
            "flagship_batches": [_batch(batch_rng) for _ in range(2)]}


def test_two_ranks_match_one_process_and_jax_and_skip_a_nan_together(flagship_spec):
    import jax
    import jax.numpy as jnp

    from cips_tpu.training import unet_synthesis as jax_synthesis
    from cips_tpu.training.common import TrainState
    from cips_tpu.training.common import adam as jax_adam
    from cips_tpu_torch.data.jax_params import discriminator_from_jax_params, from_jax_params
    from test_torch_port_train import LEVELS

    spec = {k: v for k, v in flagship_spec.items() if k != "jax"}
    started = dryrun.start(_rank_worker, 2, spec, device="cpu")
    one = _run_tasks(spec, None)  # while the ranks run
    # the JAX step on the same global batches, while the ranks run
    g, d, g_params, d_params = flagship_spec["jax"]
    train_cfg = spec["cfg"]["training"]
    jax_state = jax_synthesis.GANState(g=TrainState.create(g_params, jax_adam(train_cfg["base_lr"])),
                                       d=TrainState.create(d_params, jax_adam(train_cfg["disc_lr"])),
                                       p_params=None, step=jnp.zeros((), jnp.int32))
    jax_step = jax.jit(jax_synthesis.make_train_step(g, d, None, train_cfg))
    jax_metrics = []
    for batch in spec["flagship_batches"]:
        jax_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_metrics.append({k: float(v) for k, v in want.items()})
    ranks = started.join()

    lrs = {"flagship": {"generator": train_cfg["base_lr"], "discriminator": train_cfg["disc_lr"]},
           "flagship_split_exact": {"generator": train_cfg["base_lr"], "discriminator": train_cfg["disc_lr"]},
           "causal": {"generator": 1e-4, "discriminator": 1e-3},  # causal_task's defaults
           "classifier": {"classifier": TINY_CLS["training"]["base_lr"]}}
    for task in ("flagship", "flagship_split_exact", "causal", "classifier"):
        params = [r[task][0] for r in ranks]
        assert all(torch.equal(params[0][k], params[1][k]) for k in params[0]), f"{task}: replicas differ"
        want, grads, metrics = one[task]
        verdict = dryrun.compare_params(params[0], want, grads, lrs[task])
        assert verdict["ok"], f"{task}: 2 ranks vs one process {verdict}"
        for got_m, want_m in zip(ranks[0][task][2], metrics):
            for key, value in want_m.items():
                np.testing.assert_allclose(got_m[key], value, rtol=1e-5, atol=1e-7, err_msg=f"{task} {key}")

    for i, want in enumerate(jax_metrics):
        for key, value in want.items():
            np.testing.assert_allclose(ranks[0]["flagship"][2][i][key], value, rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    got = ranks[0]["flagship"][0]
    for prefix, params, convert, lr in (
        ("generator", jax_state.g.params, lambda t: from_jax_params(t, LEVELS), train_cfg["base_lr"]),
        ("discriminator", jax_state.d.params, lambda t: discriminator_from_jax_params(t, 2), train_cfg["disc_lr"]),
    ):
        for name, value in convert(jax.tree_util.tree_map(np.asarray, params)).items():
            np.testing.assert_allclose(got[f"{prefix}.{name}"].numpy(), value.numpy(), atol=6 * lr, rtol=0,
                                       err_msg=name)

    # the NaN in one rank's rows: both ranks skip both updates and keep the step count
    # (rank 0's own loss is finite: a rank-local test would have let it step alone)
    assert [r["nan_guard"] for r in ranks] == [(1.0, 0, True, True), (1.0, 0, True, False)]


# --- train_unet under torchrun ---------------------------------------------


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """tests/test_torch_port_train.py's five subjects, manifests and tiny config."""
    from test_torch_port_train import CFG

    root = tmp_path_factory.mktemp("ddp_train_tree")
    rng = np.random.default_rng(0)
    grids = np.meshgrid(*(np.linspace(-1, 1, s) for s in (14, 18, 14)), indexing="ij")
    rows = []
    for i in range(5):
        subj = f"s{i:03d}"
        blob = np.clip(1.0 - sum(g**2 for g in grids) / (0.7 + 0.05 * i) ** 2, 0.0, None)
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            vol = blob * (1.0 + 0.2 * rng.standard_normal(blob.shape)) + 0.02 * rng.random(blob.shape)
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), vol.astype(np.float32))
        rows.append(f"{subj},2012-01-01,2012-01-15,{500 + 150 * i},{70 + i},{'Female' if i % 2 else 'Male'},"
                    f"{i % 3},{12 + i}")
    header = "Subject,T1_date,PET_date," + ",".join(AV45)
    (root / "train.csv").write_text("\n".join([header] + rows) + "\n")
    (root / "test.csv").write_text("\n".join([header] + rows[:2]) + "\n")
    (root / "stats.json").write_text(json.dumps({"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}))
    (root / "cfg.json").write_text(json.dumps(CFG))
    return root


def _cli_args(root, exp_dir, *extra):
    return ["--exp_dir", str(exp_dir), "--config", str(root / "cfg.json"), "--training_info_csv",
            str(root / "train.csv"), "--eval_info_csv", str(root / "test.csv"), "--PET_dir", str(root / "pet"),
            "--T1_dir", str(root / "t1"), "--min_and_max", str(root / "stats.json"), "--crop_size", "12", "16", "12",
            "--batch_size", "2", "--use_condition", "--dtype", "f32", "--device", "cpu", "--save_every", "1", *extra]


def test_train_unet_under_torchrun_writes_once_and_resumes_at_one_rank(train_tree, tmp_path):
    ranks_dir = tmp_path / "ranks"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "cips_tpu_torch.cli.train_unet", *_cli_args(train_tree, ranks_dir, "--epochs", "1")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count(" eval g_loss ") == 1  # rank 0 alone prints
    base = ranks_dir / "conditional" / "AV45"
    records = [json.loads(line) for line in (base / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["prefix"] for r in records] == ["eval"]  # one writer
    meta = json.loads((base / "ckpt" / "meta.json").read_text())
    assert meta["last_epoch"] == 0 and np.isfinite(meta["best_metric"])

    one_dir = tmp_path / "one"
    state = train_unet.main(_cli_args(train_tree, one_dir, "--epochs", "1"))
    assert state.step == 2  # 5 subjects at batch 2, drop_last
    got = CheckpointManager(str(base / "ckpt")).restore()
    want = CheckpointManager(str(one_dir / "conditional" / "AV45" / "ckpt")).restore()
    assert got["step"] == want["step"] == 2 and set(got) == set(want)
    assert set(got["unet"]) == set(state.g.state_dict())  # the plain networks' names, no "module."
    one_meta = json.loads((one_dir / "conditional" / "AV45" / "ckpt" / "meta.json").read_text())
    # the eval mean over both subjects (one a rank, summed over the ranks); the weights differ
    # by the noise above (measured 1.2e-5 relative)
    np.testing.assert_allclose(meta["best_metric"], one_meta["best_metric"], rtol=1e-4)
    # The checkpoints after 2 steps, each tensor within 1e-5 of its max|value|, or 2 lr a step
    # where Adam moved rounding noise: its update has the size of lr whatever the gradient's,
    # and the trainer's init leaves noise gradients (a conv bias ahead of an instance norm;
    # the zero-initialised convs' first moves). Measured: 1.2 lr at most, in D's conv_1 bias.
    # The steps' gradients and parameters, noise told apart, are held in
    # test_two_ranks_match_one_process_and_jax_and_skip_a_nan_together.
    train_cfg = json.loads((train_tree / "cfg.json").read_text())["training"]
    for key, lr in (("unet", train_cfg["base_lr"]), ("discriminator", train_cfg["disc_lr"])):
        for name, value in want[key].items():
            diff = (got[key][name] - value).abs().max().item()
            assert diff <= max(1e-5 * value.abs().max().item(), 2 * lr * 2), f"{key}.{name}: {diff}"

    resumed = train_unet.main(_cli_args(train_tree, ranks_dir, "--epochs", "2", "--resume"))
    assert resumed.step == 4 and resumed.opt_g.state_dict()["state"][0]["step"].item() == 4
    assert json.loads((base / "ckpt" / "meta.json").read_text())["last_epoch"] == 1


# --- the prefetch and the profiling module ---------------------------------


def test_device_prefetch_keeps_order_and_values_on_the_cpu():
    batches = [{"t1": np.full((2, 3), i, np.float32), "labels": np.array([i, -i], np.int32)} for i in range(5)]
    got = list(device_prefetch(iter(batches), Mesh(), depth=2))
    assert len(got) == 5
    for i, batch in enumerate(got):
        assert isinstance(batch["t1"], torch.Tensor) and batch["t1"].dtype == torch.float32
        assert batch["t1"].eq(i).all() and batch["labels"].tolist() == [i, -i]


@pytest.mark.cuda
def test_device_prefetch_side_stream_matches_a_synchronous_copy_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side-stream copy runs only there")
    rng = np.random.default_rng(0)
    batches = [{"x": rng.random((2, 64, 64, 64), dtype=np.float32)} for _ in range(6)]
    mesh = Mesh(device=torch.device("cuda", torch.cuda.current_device()))
    for batch, got in zip(batches, device_prefetch(iter(batches), mesh, depth=2)):
        y = got["x"] * 2.0  # on the compute stream, after its wait on the copy
        assert torch.equal(y.cpu(), torch.from_numpy(batch["x"]).cuda().mul(2.0).cpu())


def test_timed_steps_report_and_step_timer_history():
    timed = profiling.timed_steps(range(5), warmup=2)
    assert list(timed) == [0, 1, 2, 3, 4]
    report = timed.report()
    assert report["steps"] == 5 and 0 <= report["min_s"] <= report["mean_s"] <= report["max_s"]
    assert profiling.timed_steps([]).report() == {"steps": 0}
    timer = StepTimer()
    laps = [timer.lap() for _ in range(3)]
    assert timer.history == laps and timer.mean(skip=1) == pytest.approx(sum(laps[1:]) / 2)
    assert timer.mean(skip=10) == pytest.approx(sum(laps) / 3)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.nn.functional.conv3d(torch.ones(1, 1, 4, 4, 4), torch.ones(2, 1, 3, 3, 3))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "aten::conv3d" for e in trace["traceEvents"])


def test_device_memory_report_has_jax_keys(monkeypatch):
    assert profiling.device_memory_report() == [] or torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.current": 10 + i,
                                                              "allocated_bytes.all.peak": 20 + i})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (70, 80))
    report = profiling.device_memory_report()
    assert [r["device"] for r in report] == ["cuda:0", "cuda:1"]
    for i, r in enumerate(report):
        assert {"bytes_in_use", "bytes_limit", "peak_bytes_in_use"} <= set(r)  # cips_tpu/training/profiling.py's
        assert (r["bytes_in_use"], r["peak_bytes_in_use"], r["bytes_limit"], r["bytes_free"]) == (10 + i, 20 + i, 80, 70)
