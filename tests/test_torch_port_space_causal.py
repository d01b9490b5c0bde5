"""The causal trio on the mesh's space axis, and uneven space slabs, on the CPU.

Ranks run over gloo, each a spawned process with one torch thread, every
process group and join bounded by ``TIMEOUT`` seconds, as in
tests/test_torch_port_space.py. Two spawns; further groups are built inside
them (`spatial.new_group`). What is held:

  * the dry run's full-volume causal mesh: JAX's, data ``CIPS_DRYRUN_DATA`` x
    space the rest; `spatial.space_for`, which tells a slab from a whole volume;
  * one spawn of 4 ranks: the re-slabbing pool and upsample (`blocks.avg_pool_2x`,
    `blocks.nearest_upsample_2x` over a group: odd depths, odd starts, ranks
    with no plane) on groups of 2, 3 and 4 against the unsharded ops, forward and
    gradients; the tiny causal trio at data 2 x space 2 (JAX's `_run_causal` mesh
    for 4 devices), plain and with ``exact_d_fake``; the tiny flagship at space 4
    over uneven slabs: depth 12 (3 planes a rank; the pool's pairs straddle; level
    1's 6 planes part 1 / 2 / 1 / 2), a 3-level flagship at depth 8 (level 2's 2
    planes leave ranks 0 and 2 without a plane, and without a query at its
    attention) and depth 10, which space 4 does not divide (the volumes reach the
    ranks whole and run unsharded: no exchange);
  * one spawn of 2 ranks (data 1 x space 2): the causal trio plain, with
    ``perceptual_weight`` > 0 (both volumes gathered for LPIPS), and a NaN in
    rank 1's slab (both skip);
  * every step against the port's one-process step on the global batch
    (`dryrun.compare_grads` within ``TOL_GRADS``, `dryrun.compare_params`), the
    replicas bit-identical; the plain causal steps at data 2 x space 2 and the
    uneven flagship steps (depth 12, the 3-level depth 8) once against JAX's step
    on its own mesh ((2, 2) and (1, 4), tests/conftest.py's virtual CPU devices),
    within tests/test_torch_port_causal.py's and tests/test_torch_port_space.py's
    limits. The causal steps draw JAX's noise (`causal_task.sample_noise`).

The module imports nothing of JAX at its top: the spawned ranks import it to
find their functions. The JAX package is imported inside the tests.
"""

import copy
import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cips_tpu_torch.models.blocks import avg_pool_2x, nearest_upsample_2x
from cips_tpu_torch.parallel import dryrun, spatial
from cips_tpu_torch.parallel.mesh import shard_batch
from cips_tpu_torch import profiling
from cips_tpu_torch.training import causal_task, unet_synthesis
from cips_tpu_torch.training.common import mean_over_ranks

TIMEOUT = 60  # seconds a spawn's collectives and join may take
K = dryrun.N_COVARIATES
CROP = dryrun.TINY_CROP  # (8, 16, 8)
# the tiny causal trio: dryrun.TINY_CAUSAL's encoder (self-attention at level 1, both attentions
# of its transformer) with a PET decoder that also self-attends at level 0 (4 x 8 x 4 latent tokens),
# tests/test_cli_workloads.py's TINY_CAUSAL_CFG, so that both models' K/V gathers run
CAUSAL = {**dryrun.TINY_CAUSAL,
          "pet_decoder_def": {**dryrun.TINY_CAUSAL["pet_decoder_def"], "attention_levels": [True, False],
                              "num_head_channels": [4, 0]},
          "training": {"base_lr": 1e-3, "disc_lr": 1e-3, "perceptual_weight": 0, "adv_weight": 0.005,
                       "kl_weight": 0.001}}
LATENT = (4, 8, 4, 3)  # z_mu / z_sigma of one sample at CROP
PERCEPTUAL_WEIGHT = 0.02
FLAGSHIP = dryrun.TINY_FLAGSHIP  # 2 levels, cross-attention transformer at level 1
FLAGSHIP3 = {**FLAGSHIP, "atten_unet_def": {**FLAGSHIP["atten_unet_def"], "num_channels": [8, 8, 8],
                                            "attention_levels": [False, False, True],
                                            "num_head_channels": [0, 0, 4]}}
# uneven flagship cases at space 4: (config, levels, crop)
UNEVEN = {"depth 12": (FLAGSHIP, 2, (12, 16, 8)), "3 levels, depth 8": (FLAGSHIP3, 3, (8, 16, 8)),
          "depth 10": (FLAGSHIP, 2, (10, 16, 8))}
UNEVEN_JAX = ("depth 12", "3 levels, depth 8")
# A sharded op against the unsharded one, fp32, relative to max|value|: a pool's means and an
# upsample's copies are exact, their gradients sums of the same terms in another order.
TOL_MODULE = 1e-5
RESAMPLE_DEPTHS = (3, 5, 6, 7, 11, 12)
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


@pytest.mark.parametrize("n,data,want", [(8, None, 4), (3, None, 3), (8, "1", 8), (8, "8", 1)])
def test_dry_run_reads_cips_dryrun_data_for_the_full_causal_mesh(n, data, want, monkeypatch):
    # JAX's _run_causal: data CIPS_DRYRUN_DATA (2 at an even count, else 1) x space the rest
    if data is None:
        monkeypatch.delenv("CIPS_DRYRUN_DATA", raising=False)
    else:
        monkeypatch.setenv("CIPS_DRYRUN_DATA", data)
    assert dryrun.default_n_space(n, "causal", True) == want
    assert dryrun.default_n_space(n, "flagship", True) == (n // 2 if n % 2 == 0 else n)  # the flagship reads none
    monkeypatch.setenv("CIPS_DRYRUN_DATA", "3")
    with pytest.raises(ValueError, match="does not divide"):
        dryrun.default_n_space(8, "causal", True)


def test_atten_unet_refuses_skips_that_do_not_line_up_sharded_or_not():
    # 3 levels at depth 10: 10 pools to 5, then 2, which upsamples to 4; over a space group the
    # check runs on the global depth before any exchange
    g, _, _ = unet_synthesis.build_models(FLAGSHIP3, K, dtype=torch.float32, device="cpu")
    x, ctx = torch.zeros(1, 10, 16, 8, 1), torch.zeros(1, 1, K)
    with pytest.raises(ValueError, match="the skip does not line up"):
        g(x, ctx)
    group = spatial.SpaceGroup(ranks=(0, 1), index=0, group=None, backend="gloo")
    with spatial.sharded([g], group), pytest.raises(ValueError, match="the skip does not line up"):
        g(x[:, :5], ctx)
    g.check_shape((8, 16, 8))  # lines up


def test_space_for_tells_slabs_from_whole_volumes():
    group = spatial.SpaceGroup(ranks=(0, 1, 2, 3), index=1, group=None, backend="gloo")
    assert spatial.space_for(group, 3, 12) is group  # 4 divides 12: slabs of 3
    assert spatial.space_for(group, 10, 10) is None  # 4 does not divide 10: whole, unsharded
    assert spatial.space_for(group, 3, None) is group and spatial.space_for(None, 10, 10) is None
    with pytest.raises(ValueError, match="neither a slab"):
        spatial.space_for(group, 5, 12)


# --- shared pieces of the spawned ranks ------------------------------------


def _params(nets):
    return {f"{net}.{k}": v.detach().clone() for net, m in nets.items() for k, v in m.state_dict().items()}


def _grads(nets):
    return {f"{net}.{k}": p.grad.detach().clone() for net, m in nets.items() for k, p in m.named_parameters()
            if p.grad is not None}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _batches(crop, seed, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t1 = rng.random((2, *crop, 1), np.float32)
        pet = np.clip(t1 * 0.8 + 0.1 * rng.random((2, *crop, 1), np.float32), 0, 1).astype(np.float32)
        out.append({"t1": t1, "pet": pet, "info": rng.random((2, 1, K), np.float32)})
    return out


def _feed_noise(draws):
    """Make `causal_task.sample_noise` hand out ``draws`` (numpy arrays of the
    global shape) in order; returns the function it replaced."""
    queue = [np.array(d) for d in draws]
    replaced = causal_task.sample_noise

    def fed(shape, dtype, device, generator):
        eps = torch.from_numpy(queue.pop(0))
        assert tuple(eps.shape) == tuple(shape), (tuple(eps.shape), tuple(shape))
        return eps.to(device, dtype)

    causal_task.sample_noise = fed
    return replaced


def _causal_cfg(case):
    cfg = copy.deepcopy(CAUSAL)
    if case == "perceptual":
        cfg["training"]["perceptual_weight"] = PERCEPTUAL_WEIGHT
    return cfg


def _causal_state(spec, cfg, mesh):
    models = causal_task.build_models(cfg, K, dtype=torch.float32, device="cpu")
    for model, name in zip(models, ("encoder", "t1_decoder", "pet_decoder", "d", "p")):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["causal"][name].items()})
    return causal_task.init_state(*models, cfg["training"], mesh=mesh)


def _lrs(state):
    return {"generator": state.opt_g.param_groups[0]["lr"], "discriminator": state.opt_d.param_groups[0]["lr"]}


def _causal_runs(spec, mesh, cases):
    """Each causal case's steps at ``mesh`` (None: one process on the global
    batch), JAX's noise fed: {case: (params after the steps, each step's
    gradients, each step's metrics, each step's exchanged bytes, lrs)}."""
    out = {}
    for case in cases:
        cfg = _causal_cfg(case)
        state = _causal_state(spec, cfg, mesh)
        step = causal_task.make_train_step(cfg["training"], exact_d_fake=case == "exact", mesh=mesh, batch_size=2,
                                           volume_depth=CROP[0])
        nets = {"generator": state.gen, "discriminator": state.d}
        grads, metrics, exchanged = [], [], []
        steps = spec["causal_batches"][: 2 if case == "plain" else 1]
        replaced = _feed_noise([eps for draws in spec["noise"][: len(steps)] for eps in draws])
        try:
            for batch in steps:
                if state.space is not None:
                    profiling.reset("space.exchanged.")
                rows = shard_batch(mesh, batch, spatial_axis=1) if mesh is not None else batch
                metrics.append(mean_over_ranks(step(state, _torch(rows), torch.Generator()), mesh))
                exchanged.append(spatial.exchanged() if state.space is not None else {})
                grads.append(_grads(nets))
        finally:
            causal_task.sample_noise = replaced
        out[case] = (_params(nets), grads, metrics, exchanged, _lrs(state))
    return out


def _space4(mesh):
    """``mesh`` (4 ranks) as data 1 x space 4: one group of all 4 ranks, and a data group of each rank alone."""
    kw = dict(timeout=datetime.timedelta(seconds=TIMEOUT))
    space = spatial.new_group(range(4), **kw)
    singles = [dist.new_group([r], **kw) for r in range(4)]
    return dataclasses.replace(mesh, space_count=4, space=space, data_group=singles[mesh.rank])


def _flagship_state(spec, case, mesh):
    cfg = UNEVEN[case][0]
    g, d, p = unet_synthesis.build_models(cfg, K, dtype=torch.float32, device="cpu")
    g.load_state_dict({k: torch.from_numpy(v) for k, v in spec["flagship"][case]["g"].items()})
    d.load_state_dict({k: torch.from_numpy(v) for k, v in spec["flagship"][case]["d"].items()})
    return unet_synthesis.init_state(g, d, cfg["training"], p, mesh=mesh)


def _flagship_runs(spec, mesh, cases):
    """Each uneven flagship case's two steps at ``mesh`` (None: one process):
    {case: (params after them, each step's gradients, metrics, exchanged bytes)}."""
    out = {}
    for case in cases:
        state = _flagship_state(spec, case, mesh)
        crop = UNEVEN[case][2]
        step = unet_synthesis.make_train_step(UNEVEN[case][0]["training"], mesh=mesh, volume_depth=crop[0])
        nets = {"generator": state.g, "discriminator": state.d}
        grads, metrics, exchanged = [], [], []
        for batch in spec["flagship"][case]["batches"]:
            if state.space is not None:
                profiling.reset("space.exchanged.")
            rows = shard_batch(mesh, batch, spatial_axis=1) if mesh is not None else batch
            metrics.append({k: float(v) for k, v in step(state, _torch(rows)).items()})  # data 1: the batch's
            exchanged.append(spatial.exchanged() if state.space is not None else {})
            grads.append(_grads(nets))
        out[case] = (_params(nets), grads, metrics, exchanged)
    return out


def _resample_input(n):
    g = torch.Generator().manual_seed(n)
    return torch.randn(2, 3, n, 5, 4, generator=g), g


def _resample_case(space, op, n):
    """This rank's slab of ``op`` over a slab of depth ``n`` and its input's
    gradient under a seeded linear loss."""
    x, g = _resample_input(n)
    full = op(x)
    gout = torch.randn(full.shape, generator=g)
    x0, x1 = spatial.slab(n, space.index, space.size)
    o0, o1 = spatial.slab(full.shape[2], space.index, space.size)
    xs = x[:, :, x0:x1].clone().requires_grad_(True)
    out = op(xs, space, n)
    (out * gout[:, :, o0:o1]).sum().backward()
    return out.detach(), xs.grad


def _rank_four(mesh, spec):
    """The resampling ops on groups of 2, 3 and 4; the causal trio at data 2 x
    space 2; the uneven flagship cases at data 1 x space 4."""
    groups = {s: spatial.new_group(range(s), timeout=datetime.timedelta(seconds=TIMEOUT)) for s in GROUP_SIZES}
    out = {"resample": {}}
    for s, space in groups.items():
        if space is None:
            continue
        for op in (avg_pool_2x, nearest_upsample_2x):
            for n in RESAMPLE_DEPTHS:
                out["resample"][(op.__name__, s, n)] = _resample_case(space, op, n)
    out["causal"] = _causal_runs(spec, mesh, ("plain", "exact"))
    out["flagship"] = _flagship_runs(spec, _space4(mesh), tuple(UNEVEN))
    return out


def _rank_two(mesh, spec):
    """Data 1 x space 2: the causal trio plain and with the perceptual term, then a NaN in rank 1's slab."""
    out = {"causal": _causal_runs(spec, mesh, ("plain", "perceptual"))}
    state = _causal_state(spec, CAUSAL, mesh)
    before = _params({"generator": state.gen, "discriminator": state.d})
    batch = {k: v.copy() for k, v in spec["causal_batches"][0].items()}
    batch["t1"][0, -1, 0, 0, 0] = np.nan  # the last plane: rank 1's slab
    step = causal_task.make_train_step(CAUSAL["training"], nan_guard=True, mesh=mesh, batch_size=2,
                                       volume_depth=CROP[0])
    replaced = _feed_noise(spec["noise"][0])
    try:
        metrics = step(state, _torch(shard_batch(mesh, batch, spatial_axis=1)), torch.Generator())
    finally:
        causal_task.sample_noise = replaced
    after = _params({"generator": state.gen, "discriminator": state.d})
    out["nan_guard"] = (float(metrics["skipped_nonfinite"]), state.step,
                        all(torch.equal(before[k], after[k]) for k in before))
    return out


# --- the checks --------------------------------------------------------------


def _close(got, want, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item() / scale
    assert err <= TOL_MODULE, f"{what}: {err:.3e} of max|value|"


def _check_resample(ranks):
    """Every rank's slabs in rank order make up the unsharded op's output and input gradient."""
    for s in GROUP_SIZES:
        for op in (avg_pool_2x, nearest_upsample_2x):
            for n in RESAMPLE_DEPTHS:
                x, g = _resample_input(n)
                x.requires_grad_(True)
                want = op(x)
                want.backward(torch.randn(want.shape, generator=g))
                got = [r["resample"][(op.__name__, s, n)] for r in ranks[:s]]
                what = f"{op.__name__} of depth {n} over {s}"
                _close(torch.cat([o for o, _ in got], 2), want.detach(), f"{what}: output")
                _close(torch.cat([gx for _, gx in got], 2), x.grad, f"{what}: input gradient")


def _check_steps(ranks, one, key, lrs, world, kinds=None):
    """Each case's replicas identical, its first step's gradients and its parameters
    against one process, its metrics within 1e-5; ``kinds``: {case: the exchanges
    that must have run} (every other kind none)."""
    for case, (want, grads, metrics, *_) in one.items():
        params = [r[key][case][0] for r in ranks]
        for p in params[1:]:
            assert all(torch.equal(params[0][k], p[k]) for k in p), f"{world} {case}: replicas differ"
        rel = dryrun.compare_grads(ranks[0][key][case][1][0], grads[0])
        assert rel <= dryrun.TOL_GRADS, f"{world} {case}: gradients {rel:.3e} of max|grad|"
        verdict = dryrun.compare_params(params[0], want, grads, lrs)
        assert verdict["ok"], f"{world} {case}: vs one process {verdict}"
        for got_m, want_m in zip(ranks[0][key][case][2], metrics):
            for name, value in want_m.items():
                np.testing.assert_allclose(got_m[name], value, rtol=1e-5, atol=1e-7, err_msg=f"{world} {case} {name}")
        if kinds is not None:
            exchanged = ranks[0][key][case][3][0]
            assert {k for k, v in exchanged.items() if v > 0} == set(kinds[case]), f"{world} {case}: {exchanged}"


def _check_jax_params(got, want, lr, steps, what):
    for name, value in want.items():  # within 3 lr a step, as tests/test_torch_port_space.py holds it
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=3 * steps * lr, rtol=0,
                                   err_msg=f"{what} {name}")


def _check_metrics(got, want, what):
    for i, step in enumerate(want):
        for key, value in step.items():  # tests/test_torch_port_causal.py's metric limit
            np.testing.assert_allclose(got[i][key], value, rtol=1e-4, atol=1e-7, err_msg=f"{what} step {i} {key}")


# --- JAX ---------------------------------------------------------------------


def _random_tree(shapes, rng):
    from test_torch_port_causal import _random_tree as draw

    return draw(shapes, rng)


def _unpacked(cfg):
    from test_torch_port_causal import _unpacked as unpacked

    return unpacked(cfg)


def _causal_converters():
    from cips_tpu_torch.data.jax_params import (
        diffusion_decoder_from_jax_params,
        encoder_from_jax_params,
        vae_decoder_from_jax_params,
    )

    return (("encoder", encoder_from_jax_params), ("t1_decoder", vae_decoder_from_jax_params),
            ("pet_decoder", diffusion_decoder_from_jax_params))


@pytest.fixture(scope="module")
def spec():
    """The JAX models with random params drawn non-zero everywhere
    (tests/test_torch_port_causal.py's draw), carried to the port: the causal
    trio, D and LPIPS, and each uneven flagship config; the global batches and
    JAX's noise (eps_t1, eps_pet of each step, from keys 100 and 101)."""
    import jax
    import jax.numpy as jnp

    from cips_tpu.training import causal_task as jax_causal
    from cips_tpu.training import unet_synthesis as jax_synthesis
    from cips_tpu_torch.data.jax_params import (
        discriminator_from_jax_params,
        from_jax_params,
        perceptual_from_jax_params,
    )

    enc, t1_dec, pet_dec, disc, perc = jax_causal.build_models(_unpacked(CAUSAL), K, dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    x, z, ctx = jnp.zeros((1, *CROP, 1)), jnp.zeros((1, *LATENT)), jnp.zeros((1, 1, K))
    key = jax.random.key(0)
    jax_params = {
        "encoder": _random_tree(jax.eval_shape(enc.init, key, x), rng),
        "t1_decoder": _random_tree(jax.eval_shape(t1_dec.init, key, z), rng),
        "pet_decoder": _random_tree(jax.eval_shape(pet_dec.init, key, z, ctx), rng),
        "d": _random_tree(jax.eval_shape(disc.init, key, x), rng),
        "p": _random_tree(jax.eval_shape(perc.init, key, x, x), rng),
    }
    causal = {name: {k: v.numpy() for k, v in convert(jax_params[name]).items()}
              for name, convert in _causal_converters()}
    causal["d"] = {k: v.numpy() for k, v in discriminator_from_jax_params(jax_params["d"], 1).items()}
    causal["p"] = {k: v.numpy() for k, v in perceptual_from_jax_params(jax_params["p"]).items()}
    noise = [[np.asarray(jax.random.normal(r, (2, *LATENT), jnp.float32)) for r in jax.random.split(jax.random.key(k))]
             for k in (100, 101)]
    out = {"causal": causal, "causal_batches": _batches(CROP, 1), "noise": noise, "flagship": {},
           "jax": {"causal": ((enc, t1_dec, pet_dec, disc, perc), jax_params)}}
    for i, (case, (cfg, levels, crop)) in enumerate(UNEVEN.items()):
        g, d, _ = jax_synthesis.build_models(cfg, n_covariates=K, dtype=jnp.float32, remat=False, s2d=False)
        x = jnp.zeros((1, *crop, 1))
        g_params = _random_tree(jax.eval_shape(g.init, jax.random.key(0), x, ctx), rng)
        d_params = _random_tree(jax.eval_shape(d.init, jax.random.key(1), x), rng)
        out["flagship"][case] = {
            "g": {k: v.numpy() for k, v in from_jax_params(g_params, levels).items()},
            "d": {k: v.numpy() for k, v in discriminator_from_jax_params(d_params, 1).items()},
            "batches": _batches(crop, 10 + i)}
        out["jax"][case] = (g, d, g_params, d_params)
    return out


def _jax_causal_steps(spec):
    """JAX's causal step on its own (2, 2) mesh over the plain case's two global
    batches, with the noise of keys 100 and 101: each step's metrics, the first
    step's gradients (read back from Adam's first moments) and the params after
    both, converted to the port's names."""
    import jax
    import jax.numpy as jnp

    from cips_tpu.parallel.mesh import make_mesh, replicate
    from cips_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from cips_tpu.training import causal_task as jax_causal
    from cips_tpu.training.common import TrainState
    from cips_tpu.training.common import adam as jax_adam
    from cips_tpu_torch.data.jax_params import discriminator_from_jax_params

    (enc, t1_dec, pet_dec, disc, perc), params = spec["jax"]["causal"]
    train_cfg = CAUSAL["training"]
    mesh = make_mesh(n_data=2, n_space=2)
    gen = {k: params[k] for k in causal_task.GENERATOR_PARTS}
    state = replicate(mesh, jax_causal.CausalState(
        gen=TrainState.create(gen, jax_adam(train_cfg["base_lr"])),
        d=TrainState.create(params["d"], jax_adam(train_cfg["disc_lr"])),
        p_params=params["p"], step=jnp.zeros((), jnp.int32)))
    step = jax.jit(jax_causal.make_train_step(enc, t1_dec, pet_dec, disc, perc, train_cfg))
    metrics, first = [], None
    for i, batch in enumerate(spec["causal_batches"]):
        new, m = step(state, jax_shard_batch(mesh, batch, spatial_axis=1), jax.random.key(100 + i))
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            mu = jax.tree_util.tree_map(lambda a, b: np.asarray((a - 0.9 * b) / 0.1), new.gen.opt_state[0].mu,
                                        state.gen.opt_state[0].mu)
            mu_d = jax.tree_util.tree_map(lambda a, b: np.asarray((a - 0.9 * b) / 0.1), new.d.opt_state[0].mu,
                                          state.d.opt_state[0].mu)
            first = {**{f"generator.{part}.{k}": v for part, convert in _causal_converters()
                        for k, v in convert(mu[part]).items()},
                     **{f"discriminator.{k}": v for k, v in discriminator_from_jax_params(mu_d, 1).items()}}
        state = new
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    gen_params, d_params = to_np(state.gen.params), to_np(state.d.params)
    params = {**{f"generator.{part}.{k}": v for part, convert in _causal_converters()
                 for k, v in convert(gen_params[part]).items()},
              **{f"discriminator.{k}": v for k, v in discriminator_from_jax_params(d_params, 1).items()}}
    return metrics, first, params


def _jax_flagship_steps(spec, case):
    """JAX's flagship step on its own (1, 4) mesh over the case's two global
    batches: each step's metrics and the params after both, in the port's names."""
    import jax
    import jax.numpy as jnp

    from cips_tpu.parallel.mesh import make_mesh, replicate
    from cips_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from cips_tpu.training import unet_synthesis as jax_synthesis
    from cips_tpu.training.common import TrainState
    from cips_tpu.training.common import adam as jax_adam
    from cips_tpu_torch.data.jax_params import discriminator_from_jax_params, from_jax_params

    g, d, g_params, d_params = spec["jax"][case]
    cfg, levels, _ = UNEVEN[case]
    train_cfg = cfg["training"]
    mesh = make_mesh(n_data=1, n_space=4)
    state = replicate(mesh, jax_synthesis.GANState(g=TrainState.create(g_params, jax_adam(train_cfg["base_lr"])),
                                                   d=TrainState.create(d_params, jax_adam(train_cfg["disc_lr"])),
                                                   p_params=None, step=jnp.zeros((), jnp.int32)))
    step = jax.jit(jax_synthesis.make_train_step(g, d, None, train_cfg))
    metrics = []
    for batch in spec["flagship"][case]["batches"]:
        state, m = step(state, jax_shard_batch(mesh, batch, spatial_axis=1))
        metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = {**{f"generator.{k}": v for k, v in from_jax_params(to_np(state.g.params), levels).items()},
              **{f"discriminator.{k}": v for k, v in discriminator_from_jax_params(to_np(state.d.params), 1).items()}}
    return metrics, params


def test_causal_trio_and_uneven_slabs_match_one_process_and_jax(spec):
    shared = {k: v for k, v in spec.items() if k != "jax"}
    four = dryrun.start(_rank_four, 4, shared, device="cpu", n_space=2, timeout=TIMEOUT)
    two = dryrun.start(_rank_two, 2, shared, device="cpu", n_space=2, timeout=TIMEOUT)
    # while the ranks run: the one-process steps and JAX's steps on its own meshes
    one_causal = _causal_runs(shared, None, ("plain", "exact", "perceptual"))
    one_flagship = _flagship_runs(shared, None, tuple(UNEVEN))
    jax_causal = _jax_causal_steps(spec)
    jax_flagship = {case: _jax_flagship_steps(spec, case) for case in UNEVEN_JAX}
    lrs = one_causal["plain"][4]
    flagship_lrs = {"generator": FLAGSHIP["training"]["base_lr"], "discriminator": FLAGSHIP["training"]["disc_lr"]}

    ranks4 = four.join()
    _check_resample(ranks4)
    every = ("halo", "norm", "kv", "mean")
    _check_steps(ranks4, {k: one_causal[k] for k in ("plain", "exact")}, "causal", lrs, "data 2 x space 2",
                 {"plain": every, "exact": every})
    _check_steps(ranks4, one_flagship, "flagship", flagship_lrs, "data 1 x space 4",
                 {"depth 12": every + ("resample",), "3 levels, depth 8": every + ("resample",), "depth 10": ()})
    metrics, first, params = jax_causal
    _check_metrics(ranks4[0]["causal"]["plain"][2], metrics, "data 2 x space 2 vs JAX (2, 2)")
    rel = dryrun.compare_grads(ranks4[0]["causal"]["plain"][1][0], first)
    assert rel <= dryrun.TOL_GRADS, f"data 2 x space 2 vs JAX (2, 2): gradients {rel:.3e} of max|grad|"
    got = ranks4[0]["causal"]["plain"][0]
    for net in ("generator", "discriminator"):
        _check_jax_params({k: got[k] for k in params if k.startswith(net)},
                          {k: v for k, v in params.items() if k.startswith(net)}, lrs[net], 2, "vs JAX (2, 2)")
    for case in UNEVEN_JAX:
        metrics, params = jax_flagship[case]
        _check_metrics(ranks4[0]["flagship"][case][2], metrics, f"{case} over space 4 vs JAX (1, 4)")
        got = ranks4[0]["flagship"][case][0]
        for net in ("generator", "discriminator"):
            _check_jax_params({k: got[k] for k in params if k.startswith(net)},
                              {k: v for k, v in params.items() if k.startswith(net)}, flagship_lrs[net], 2,
                              f"{case} over space 4 vs JAX (1, 4)")

    ranks2 = two.join()
    _check_steps(ranks2, {k: one_causal[k] for k in ("plain", "perceptual")}, "causal", lrs, "data 1 x space 2",
                 {"plain": every, "perceptual": every + ("volume",)})
    # the NaN in rank 1's slab: every loss is the whole volume's on both ranks, so both skip both updates
    assert [r["nan_guard"] for r in ranks2] == [(1.0, 0, True)] * 2
