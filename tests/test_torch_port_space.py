"""The port's depth-sharded training (the mesh's ``space`` axis,
`cips_tpu_torch.parallel.spatial`) on the CPU.

Ranks run over gloo, each a spawned process with one torch thread, every
process group and join bounded by ``TIMEOUT`` seconds (a mismatched collective
fails the test instead of hanging the suite). What is held:

  * the slab arithmetic, the (data, space) layout of the ranks and the batch
    split, and the refusal of a space count that does not divide the ranks;
  * with ``n_space`` 1: no group and no collective, the step as before;
  * one spawn of 4 ranks (a (data 2, space 2) mesh): `halo_conv` (k3 s1, k3
    s2, k4 s2, k4 s1 p1; uneven outputs; ranks with no plane), the sharded
    GroupNorm / InstanceNorm and the K/V-gathered attentions, forward and
    gradients, on groups of 2, 3 and 4 ranks, against the unsharded modules;
    then the tiny flagship step at data 2 x space 2, plain and with
    ``split_d`` / ``exact_d_fake``;
  * one spawn of 2 ranks (data 1 x space 2): the tiny flagship step, with
    ``perceptual_weight`` > 0, with ``split_d`` / ``exact_d_fake``, and with
    remat and ``d_remat`` as well as LPIPS (the recomputed blocks exchange their
    halos and K/V again in the backward, in the same order on both ranks), and a
    NaN in one rank's slab (both skip);
  * every flagship step against the port's one-process step on the global
    batch (`dryrun.compare_grads` within ``TOL_GRADS``, `dryrun.compare_params`
    within ``TOL_ONE_PROCESS``), the plain one also against the JAX step on its
    own (n_data, space 2) mesh (tests/test_spmd_equivalence.py's way, on the
    virtual CPU devices of tests/conftest.py) within
    tests/test_torch_port_train.py's limits; replicas bit-identical;
  * `train_unet --n_space 2` under torchrun: one writer, and ``--resume`` at 1
    rank from its checkpoint.

The module imports nothing of JAX at its top: the spawned ranks import it to
find their functions. The JAX package is imported inside the tests.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cips_tpu_torch.cli import train_unet
from cips_tpu_torch.data import nifti
from cips_tpu_torch.models.blocks import AttentionBlock, GroupNorm, SpatialTransformer
from cips_tpu_torch.models.discriminator import InstanceNorm
from cips_tpu_torch.parallel import dryrun, spatial
from cips_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from cips_tpu_torch import profiling
from cips_tpu_torch.training import unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager, mean_over_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60  # seconds a spawn's collectives and join may take
CFG = dryrun.TINY_FLAGSHIP  # channels (8, 8), 2 levels, num_layers_d 1
CROP = dryrun.TINY_CROP  # (8, 16, 8): D's depths 8 -> 4 -> 3 -> 2
K = dryrun.N_COVARIATES
LEVELS = 2
AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]
PERCEPTUAL_CFG = {**CFG, "training": {**CFG["training"], "perceptual_weight": 0.5}}
REMAT_CFG = {**PERCEPTUAL_CFG, "atten_unet_def": {**CFG["atten_unet_def"], "remat": True},
             "training": {**PERCEPTUAL_CFG["training"], "d_remat": True}}
# A sharded module against the unsharded one, fp32, relative to max|value| of the
# unsharded output or gradient: the same sums in other orders (a slab's partial sums,
# then the all-reduce or the owner's sum of halo gradients).
TOL_MODULE = 1e-5
# conv cases: (kernel, stride, padding, depth); every group size runs each
CONV_CASES = ((3, 1, 1, 8), (3, 2, 1, 8), (4, 2, 1, 8), (4, 1, 1, 4), (4, 1, 1, 3), (4, 1, 1, 11))
GROUP_SIZES = (2, 3, 4)


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


# --- the slab arithmetic and the mesh's layout -----------------------------


@pytest.mark.parametrize("n,k,s,p,count,planes", [
    (12, 4, 1, 1, 2, [5, 6]),  # the full volume's D after its third k4 s2 conv: 12 -> 11
    (11, 4, 1, 1, 2, [5, 5]),  # and its logits: 11 -> 10
    (4, 4, 1, 1, 2, [1, 2]),  # the (8, 16, 8) crop's D: 4 -> 3
    (3, 4, 1, 1, 2, [1, 1]),  # 3 -> 2
    (3, 4, 1, 1, 4, [0, 1, 0, 1]),  # ranks with no output plane
    (8, 3, 2, 1, 3, [1, 1, 2]),
    (96, 3, 1, 1, 2, [48, 48]),
])
def test_conv_windows_part_the_output_depth_into_slabs(n, k, s, p, count, planes):
    windows = spatial.conv_windows(n, k, s, p, count)
    n_out = spatial.conv_output_size(n, k, s, p)
    assert [w[2] for w in windows] == planes and sum(planes) == n_out
    for i, (lo, hi, keep) in enumerate(windows):
        o0, o1 = spatial.slab(n_out, i, count)
        assert keep == o1 - o0
        computed = max(keep, 1)  # a rank without a plane computes one and keeps none
        assert (hi - lo - k) // s + 1 == computed and lo == o0 * s - p


def test_mesh_lays_ranks_out_as_data_by_space():
    # 4 ranks of one node at space 2: rank = data index * 2 + space index
    meshes = [Mesh(rank=r, world_size=4, local_rank=r, local_world_size=4, space_count=2) for r in range(4)]
    assert [(m.data_index, m.space_index, m.data_count) for m in meshes] == [(0, 0, 2), (0, 1, 2), (1, 0, 2),
                                                                             (1, 1, 2)]
    assert [m.rows(4) for m in meshes] == [slice(0, 2), slice(0, 2), slice(2, 4), slice(2, 4)]
    assert [m.global_rows(4) for m in meshes] == [(4, slice(0, 2))] * 2 + [(4, slice(2, 4))] * 2
    # a gather over ranks counts each row once: the first rank of each space group
    assert [m.owns_rows(4) for m in meshes] == [True, False, True, False]
    assert [m.owns_rows(3) for m in meshes] == [True, False, False, False]  # replicated rows
    batch = {"t1": np.arange(4 * 8).reshape(4, 8, 1), "info": np.arange(4 * 3).reshape(4, 1, 3)}
    got = shard_batch(meshes[3], batch, spatial_axis=1)
    assert got["t1"][..., 0].tolist() == [[20, 21, 22, 23], [28, 29, 30, 31]]  # rows 2-3, planes 4-7
    assert got["info"].shape == (2, 1, 3)  # (B, 1, K): 1 does not split over 2, so it stays whole
    assert shard_batch(meshes[3], batch)["t1"].shape == (2, 8, 1)  # no spatial axis: whole volumes


def test_make_mesh_refuses_a_space_count_that_does_not_divide_the_ranks(monkeypatch):
    for name in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="--n_space 2 does not divide the 3 rank"):
        make_mesh("cpu", n_space=2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="--n_space 2 does not divide the 1 rank"):
        make_mesh("cpu", n_space=2)


@pytest.mark.parametrize("n,task,full,data,want", [
    # JAX's tiny mesh
    (2, "flagship", False, None, 2), (3, "flagship", False, None, 1), (4, "flagship", False, None, 2),
    # JAX's full volume: data 2 (1 when odd) x the rest
    (8, "flagship", True, None, 4), (3, "flagship", True, None, 3),
    (4, "causal", False, None, 2),  # JAX's _run_causal: space 2 at an even count, as the flagship's
    (8, "causal", True, "4", 2),  # the causal trio's full volume: data CIPS_DRYRUN_DATA x space the rest
])
def test_dry_run_takes_jax_mesh_for_both_tasks(n, task, full, data, want, monkeypatch):
    if data is None:
        monkeypatch.delenv("CIPS_DRYRUN_DATA", raising=False)
    else:
        monkeypatch.setenv("CIPS_DRYRUN_DATA", data)
    assert dryrun.default_n_space(n, task, full) == want


def test_n_space_one_builds_no_group_and_runs_no_collective(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    mesh = make_mesh("cpu", n_space=1)
    assert (mesh.space, mesh.data_group, mesh.space_count, mesh.data_count) == (None, None, 1, 1)

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran at n_space 1")

    for name in ("all_reduce", "batch_isend_irecv", "new_group", "broadcast"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    spec = _spec_numpy()
    states = [_state(spec, CFG, m) for m in (mesh, None)]
    assert states[0].space is None
    metrics = [unet_synthesis.make_train_step(CFG["training"], mesh=m)(s, _torch(spec["batches"][0]))
               for s, m in zip(states, (mesh, None))]
    assert {k: float(v) for k, v in metrics[0].items()} == {k: float(v) for k, v in metrics[1].items()}
    for a, b in zip(*(_params(_nets(s)).values() for s in states)):
        assert torch.equal(a, b)
    mesh.close()


# --- shared pieces of the spawned ranks ------------------------------------


def _spec_numpy(seed: int = 0):
    """Seeded non-zero weights for the tiny flagship (`dryrun.randomize_`) and
    two global batches of 2, as numpy (they pickle into the spawned ranks)."""
    g, d, _ = unet_synthesis.build_models(CFG, K, dtype=torch.float32, device="cpu")
    dryrun.randomize_((g, d), seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    batches = []
    for _ in range(2):
        t1 = rng.random((2, *CROP, 1), np.float32)
        pet = np.clip(t1 * 0.8 + 0.1 * rng.random((2, *CROP, 1), np.float32), 0, 1).astype(np.float32)
        batches.append({"t1": t1, "pet": pet, "info": rng.random((2, 1, K), np.float32)})
    return {"g": {k: v.numpy() for k, v in g.state_dict().items()},
            "d": {k: v.numpy() for k, v in d.state_dict().items()}, "batches": batches}


def _state(spec, cfg, mesh):
    g, d, p = unet_synthesis.build_models(cfg, K, dtype=torch.float32, device="cpu")
    g.load_state_dict({k: torch.from_numpy(v) for k, v in spec["g"].items()})
    d.load_state_dict({k: torch.from_numpy(v) for k, v in spec["d"].items()})
    return unet_synthesis.init_state(g, d, cfg["training"], p, mesh=mesh)


def _nets(state):
    return {"generator": state.g, "discriminator": state.d}


def _params(nets):
    return {f"{net}.{k}": v.detach().clone() for net, m in nets.items() for k, v in m.state_dict().items()}


def _grads(nets):
    return {f"{net}.{k}": p.grad.detach().clone() for net, m in nets.items() for k, p in m.named_parameters()
            if p.grad is not None}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flagship_runs(spec, mesh, cases):
    """Each case's steps, at ``mesh`` (None: one process on the global batch):
    {case: (params after the steps, each step's gradients, each step's metrics,
    each step's exchanged bytes by kind)}."""
    out = {}
    for case in cases:
        cfg = {"perceptual": PERCEPTUAL_CFG, "remat": REMAT_CFG}.get(case, CFG)
        kw = dict(split_d=True, exact_d_fake=True) if case == "split_exact" else {}
        state = _state(spec, cfg, mesh)
        step = unet_synthesis.make_train_step(cfg["training"], mesh=mesh, **kw)
        grads, metrics, exchanged = [], [], []
        for batch in spec["batches"][: 2 if case == "plain" else 1]:
            if state.space is not None:
                profiling.reset("space.exchanged.")
            rows = shard_batch(mesh, batch, spatial_axis=1) if mesh is not None else batch
            metrics.append(mean_over_ranks(step(state, _torch(rows)), mesh))
            exchanged.append(spatial.exchanged() if state.space is not None else {})
            grads.append(_grads(_nets(state)))
        out[case] = (_params(_nets(state)), grads, metrics, exchanged)
    return out


def _rank_modules(mesh, spec):
    """(a) and (b) on groups of 2, 3 and 4 ranks, then the flagship at (data 2, space 2)."""
    groups = {s: spatial.new_group(range(s), timeout=datetime.timedelta(seconds=TIMEOUT)) for s in GROUP_SIZES}
    out = {"modules": {}}
    for s, space in groups.items():
        if space is None:
            continue
        for case in CONV_CASES:
            out["modules"][("conv", s, case)] = _conv_case(space, *case)
        for name in ("group_norm", "instance_norm", "attention_block", "transformer"):
            out["modules"][(name, s)] = _module_case(space, name)
    out["flagship"] = _flagship_runs(spec, mesh, ("plain", "split_exact"))
    return out


def _rank_flagship(mesh, spec):
    """Data 1 x space 2: the flagship cases, then a NaN in rank 1's slab only."""
    out = {"flagship": _flagship_runs(spec, mesh, ("plain", "perceptual", "split_exact", "remat"))}
    state = _state(spec, CFG, mesh)
    before = _params(_nets(state))
    batch = {k: v.copy() for k, v in spec["batches"][0].items()}
    batch["t1"][0, -1, 0, 0, 0] = np.nan  # the last plane: rank 1's slab
    metrics = unet_synthesis.make_train_step(CFG["training"], nan_guard=True, mesh=mesh)(
        state, _torch(shard_batch(mesh, batch, spatial_axis=1)))
    after = _params(_nets(state))
    out["nan_guard"] = (float(metrics["skipped_nonfinite"]), state.step,
                        all(torch.equal(before[k], after[k]) for k in before))
    return out


def _conv_inputs(k, n):
    g = torch.Generator().manual_seed(10 * k + n)
    x = torch.randn(2, 3, n, 5, 4, generator=g)
    w = torch.randn(4, 3, k, k, k, generator=g) / (3 * k**3) ** 0.5
    return x, w, torch.randn(4, generator=g), g


def _conv_case(space, k, s, p, n):
    """This rank's slab of a sharded conv's output and the gradients of a seeded
    linear loss: its input slab's and the weight's and bias's partial."""
    x, w, b, g = _conv_inputs(k, n)
    n_out = spatial.conv_output_size(n, k, s, p)
    gout = torch.randn(2, 4, n_out, *F.conv3d(x, w, b, stride=s, padding=p).shape[3:], generator=g)
    x0, x1 = spatial.slab(n, space.index, space.size)
    o0, o1 = spatial.slab(n_out, space.index, space.size)
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x[:, :, x0:x1], w, b))
    out = spatial.halo_conv(xs, ws, bs, (s,) * 3, (p,) * 3, space, depth=n)
    (out * gout[:, :, o0:o1]).sum().backward()
    return out.detach(), xs.grad, ws.grad, bs.grad


def _module(name):
    torch.manual_seed(3)
    if name == "group_norm":
        return GroupNorm(4, 8), 7, None
    if name == "instance_norm":
        return InstanceNorm(8), 3, None  # 3 planes over 4 ranks: one holds none
    if name == "attention_block":
        return AttentionBlock(3, 8, num_head_channels=4, norm_num_groups=4), 12, None
    return SpatialTransformer(3, 8, 2, 4, norm_num_groups=4, cross_attention_dim=5), 12, torch.rand(2, 1, 5)


def _module_inputs(name):
    module, n, context = _module(name)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():  # non-trivial affines (and a non-zero residual projection)
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5 + (1.0 if p.dim() == 1 and p.shape[0] == 8 else 0.0))
    x = torch.randn(2, 8, n, 3, 2, generator=g) * 2.0 + 0.5
    return module, x, context, g


def _module_case(space, name):
    module, x, context, g = _module_inputs(name)
    out_full = module(x, context=context) if context is not None else module(x)
    gout = torch.randn(out_full.shape, generator=g)
    x0, x1 = spatial.slab(x.shape[2], space.index, space.size)
    xs = x[:, :, x0:x1].clone().requires_grad_(True)
    with spatial.sharded([module], space):
        out = module(xs, context=context) if context is not None else module(xs)
    (out * gout[:, :, x0:x1]).sum().backward()
    return out.detach(), xs.grad, {k: p.grad.clone() for k, p in module.named_parameters()}


def _unsharded_module(name):
    module, x, context, g = _module_inputs(name)
    x.requires_grad_(True)
    out = module(x, context=context) if context is not None else module(x)
    out.backward(torch.randn(out.shape, generator=g))
    return out.detach(), x.grad, {k: p.grad for k, p in module.named_parameters()}


def _close(got, want, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item() / scale
    assert err <= TOL_MODULE, f"{what}: {err:.3e} of max|value|"


def _check_modules(ranks):
    """Every rank's slabs in rank order make up the unsharded output and input
    gradient, and the ranks' weight gradients sum to the unsharded ones."""
    for s in GROUP_SIZES:
        parts = [r["modules"] for r in ranks[:s]]
        for case in CONV_CASES:
            k, st, p, n = case
            x, w, b, g = _conv_inputs(k, n)
            x, w, b = (t.requires_grad_(True) for t in (x, w, b))
            want = F.conv3d(x, w, b, stride=st, padding=p)
            want.backward(torch.randn(want.shape, generator=g))
            got = [part[("conv", s, case)] for part in parts]
            what = f"k{k} s{st} p{p} depth {n} over {s}"
            _close(torch.cat([o for o, *_ in got], 2), want.detach(), f"{what}: output")
            _close(torch.cat([gx for _, gx, _, _ in got], 2), x.grad, f"{what}: input gradient")
            _close(sum(gw for *_, gw, _ in got), w.grad, f"{what}: weight gradient")
            _close(sum(gb for *_, gb in got), b.grad, f"{what}: bias gradient")
        for name in ("group_norm", "instance_norm", "attention_block", "transformer"):
            out, gx, gp = _unsharded_module(name)
            got = [part[(name, s)] for part in parts]
            _close(torch.cat([o for o, _, _ in got], 2), out, f"{name} over {s}: output")
            _close(torch.cat([x for _, x, _ in got], 2), gx, f"{name} over {s}: input gradient")
            largest = max(g.abs().max().item() for g in gp.values())
            for key, want in gp.items():
                got_p = sum(r[2][key] for r in got)
                if want.abs().max().item() < dryrun.NOISE_TENSOR * largest:
                    # rounding noise (to_k's bias: exactly 0, a softmax row ignores a shift of all its
                    # scores): under that floor on both sides, as dryrun.compare_grads holds it
                    assert got_p.abs().max().item() < dryrun.NOISE_TENSOR * largest, f"{name} over {s}: {key}"
                    continue
                _close(got_p, want, f"{name} over {s}: {key}")


def _check_flagship(ranks, one, cases, world):
    lrs = {"generator": CFG["training"]["base_lr"], "discriminator": CFG["training"]["disc_lr"]}
    for case in cases:
        params = [r["flagship"][case][0] for r in ranks]
        for p in params[1:]:
            assert all(torch.equal(params[0][k], p[k]) for k in p), f"{case}: replicas differ"
        want, grads, metrics, _ = one[case]
        # the first step's gradients (a later step starts from weights Adam's noise moved: compare_params)
        rel = dryrun.compare_grads(ranks[0]["flagship"][case][1][0], grads[0])
        assert rel <= dryrun.TOL_GRADS, f"{case}: gradients {rel:.3e} of max|grad| at {world}"
        verdict = dryrun.compare_params(params[0], want, grads, lrs)
        assert verdict["ok"], f"{case}: {world} vs one process {verdict}"
        for got_m, want_m in zip(ranks[0]["flagship"][case][2], metrics):
            for key, value in want_m.items():
                np.testing.assert_allclose(got_m[key], value, rtol=1e-5, atol=1e-7, err_msg=f"{case} {key}")
        bytes_ = ranks[0]["flagship"][case][3][0]
        assert all(bytes_[kind] > 0 for kind in ("halo", "norm", "kv", "mean")), bytes_
        assert (bytes_["volume"] > 0) == (case in ("perceptual", "remat")), bytes_


def _jax_steps(spec, n_data):
    """The JAX step on its own (n_data, space 2) mesh from the same weights, over
    the same two global batches: the params after them and each step's metrics."""
    import jax
    import jax.numpy as jnp

    from cips_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cips_tpu.parallel.mesh import replicate, shard_batch as jax_shard_batch
    from cips_tpu.training import unet_synthesis as jax_synthesis
    from cips_tpu.training.common import TrainState
    from cips_tpu.training.common import adam as jax_adam

    g, d, g_params, d_params = spec["jax"]
    train_cfg = CFG["training"]
    mesh = jax_make_mesh(n_data=n_data, n_space=2)
    state = replicate(mesh, jax_synthesis.GANState(g=TrainState.create(g_params, jax_adam(train_cfg["base_lr"])),
                                                   d=TrainState.create(d_params, jax_adam(train_cfg["disc_lr"])),
                                                   p_params=None, step=jnp.zeros((), jnp.int32)))
    step = jax.jit(jax_synthesis.make_train_step(g, d, None, train_cfg))
    metrics = []
    for batch in spec["batches"]:
        state, m = step(state, jax_shard_batch(mesh, batch, spatial_axis=1))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _check_jax(ranks, jax_state, jax_metrics, world):
    from cips_tpu_torch.data.jax_params import discriminator_from_jax_params, from_jax_params

    import jax

    train_cfg = CFG["training"]
    for i, want in enumerate(jax_metrics):
        for key, value in want.items():  # tests/test_torch_port_train.py's metric limit
            np.testing.assert_allclose(ranks[0]["flagship"]["plain"][2][i][key], value, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{world} vs JAX step {i} {key}")
    got = ranks[0]["flagship"]["plain"][0]
    for prefix, params, convert, lr in (
        ("generator", jax_state.g.params, lambda t: from_jax_params(t, LEVELS), train_cfg["base_lr"]),
        ("discriminator", jax_state.d.params, lambda t: discriminator_from_jax_params(t, 1), train_cfg["disc_lr"]),
    ):
        # after 2 Adam steps: within 6 lr (3 a step, as tests/test_torch_port_ddp.py holds the data axis)
        for name, value in convert(jax.tree_util.tree_map(np.asarray, params)).items():
            np.testing.assert_allclose(got[f"{prefix}.{name}"].numpy(), value.numpy(), atol=6 * lr, rtol=0,
                                       err_msg=f"{world} vs JAX {name}")


@pytest.fixture(scope="module")
def flagship_spec():
    """JAX G and D with random non-zero params (tests/test_torch_port_train.py's
    draw), carried to the port, and two global batches of 2."""
    import jax

    from cips_tpu.training import unet_synthesis as jax_synthesis
    from cips_tpu_torch.data.jax_params import discriminator_from_jax_params, from_jax_params
    from test_torch_port_train import _random_tree

    g, d, _ = jax_synthesis.build_models(CFG, n_covariates=K, dtype=jax.numpy.float32, remat=False, s2d=False)
    rng = np.random.default_rng(0)
    x, ctx = jax.numpy.zeros((1, *CROP, 1)), jax.numpy.zeros((1, 1, K))
    g_params = _random_tree(jax.eval_shape(g.init, jax.random.key(0), x, ctx), rng)
    d_params = _random_tree(jax.eval_shape(d.init, jax.random.key(1), x), rng)
    spec = _spec_numpy()
    spec["g"] = {k: v.numpy() for k, v in from_jax_params(g_params, LEVELS).items()}
    spec["d"] = {k: v.numpy() for k, v in discriminator_from_jax_params(d_params, 1).items()}
    spec["jax"] = (g, d, g_params, d_params)
    return spec


def test_sharded_modules_and_steps_match_unsharded_one_process_and_jax(flagship_spec):
    spec = {k: v for k, v in flagship_spec.items() if k != "jax"}
    four = dryrun.start(_rank_modules, 4, spec, device="cpu", n_space=2, timeout=TIMEOUT)
    two = dryrun.start(_rank_flagship, 2, spec, device="cpu", n_space=2, timeout=TIMEOUT)
    # while the ranks run: the one-process steps and the JAX steps on (1, 2) and (2, 2) meshes
    one = _flagship_runs(spec, None, ("plain", "perceptual", "split_exact", "remat"))
    jax_runs = {n_data: _jax_steps(flagship_spec, n_data) for n_data in (1, 2)}

    ranks4 = four.join()
    _check_modules(ranks4)
    _check_flagship(ranks4, one, ("plain", "split_exact"), "data 2 x space 2")
    _check_jax(ranks4, *jax_runs[2], "data 2 x space 2")

    ranks2 = two.join()
    _check_flagship(ranks2, one, ("plain", "perceptual", "split_exact", "remat"), "data 1 x space 2")
    for a, b in ((ranks2[0]["flagship"]["remat"], ranks2[0]["flagship"]["perceptual"]), (one["remat"], one["perceptual"])):
        for key, value in b[0].items():  # remat and d_remat change nothing, sharded or not
            assert torch.equal(a[0][key], value), key
    _check_jax(ranks2, *jax_runs[1], "data 1 x space 2")
    # the NaN in rank 1's slab: the loss is the whole volume's on both, so both skip both updates
    assert [r["nan_guard"] for r in ranks2] == [(1.0, 0, True)] * 2


# --- train_unet --n_space under torchrun -----------------------------------


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """Five subjects of (10, 18, 10), manifests, covariate stats, the tiny config."""
    root = tmp_path_factory.mktemp("space_train_tree")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        subj = f"s{i:03d}"
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            vol = (rng.random((10, 18, 10)) * (1.0 + 0.2 * i) + 0.02).astype(np.float32)
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), vol)
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
            "--T1_dir", str(root / "t1"), "--min_and_max", str(root / "stats.json"), "--crop_size", *map(str, CROP),
            "--batch_size", "2", "--use_condition", "--dtype", "f32", "--device", "cpu", "--save_every", "1", *extra]


def test_train_unet_n_space_2_under_torchrun_writes_once_and_resumes_at_one_rank(train_tree, tmp_path):
    exp = tmp_path / "space"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "cips_tpu_torch.cli.train_unet",
                           *_cli_args(train_tree, exp, "--epochs", "1", "--n_space", "2")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count(" eval g_loss ") == 1  # rank 0 alone prints
    base = exp / "conditional" / "AV45"
    records = [json.loads(line) for line in (base / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["prefix"] for r in records] == ["eval"]  # one writer
    meta = json.loads((base / "ckpt" / "meta.json").read_text())
    assert meta["last_epoch"] == 0 and np.isfinite(meta["best_metric"])
    got = CheckpointManager(str(base / "ckpt")).restore()
    assert got["step"] == 2  # 5 subjects at batch 2, drop_last: one data group takes both rows
    resumed = train_unet.main(_cli_args(train_tree, exp, "--epochs", "2", "--resume"))
    assert resumed.step == 4 and resumed.opt_g.state_dict()["state"][0]["step"].item() == 4
    assert set(got["unet"]) == set(resumed.g.state_dict())  # the plain networks' names, no new parameter
    assert json.loads((base / "ckpt" / "meta.json").read_text())["last_epoch"] == 1
