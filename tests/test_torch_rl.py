"""Parity of the port's model, converter, PPO loss and update, GAE and
curriculum with the JAX package, on the CPU.

Both sides get the same numpy inputs and the same start params (flax params
through ``actor_critic_from_flax``).  Tolerances:

- forward pass: rtol 1e-5, atol 1e-6; flax's LayerNorm takes the variance
  as E[x^2] - E[x]^2, torch's in two passes;
- loss values and grads: those of ``tests/test_fused_update.py`` for the
  fused kernel against ``jax.grad`` (grads atol 2e-5 x max|grad|, metrics
  rtol 2e-5, atol 2e-6);
- GAE: rtol 1e-6, atol 1e-6, the same float32 recurrence in the same order;
- params after a multi-step update: atol 1e-6 x steps; each Adam step
  moves a param by at most about lr = 3e-5, and gradients that differ in
  the last digits change that step by a small fraction of it;
- curriculum: counts equal, radius and bonus at rtol 1e-6 (float32 pow of
  two libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState

from tpu_plume.core.config import CurriculumConfig as JCurCfg
from tpu_plume.core.config import PPOConfig as JPPOCfg
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.rl import curriculum as jcur
from tpu_plume.rl.gae import compute_gae as j_gae
from tpu_plume.rl.ppo import PPOBatch as JBatch
from tpu_plume.rl.ppo import normalize_advantages as j_norm
from tpu_plume.rl.ppo import ppo_loss as j_loss
from tpu_plume.rl.ppo import ppo_update as j_update
from tpu_plume_torch.convert import actor_critic_from_flax, actor_critic_to_flax
from tpu_plume_torch.core.config import CurriculumConfig, PPOConfig
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.rl import curriculum as tcur
from tpu_plume_torch.rl.gae import compute_gae
from tpu_plume_torch.rl.ppo import PPOBatch, normalize_advantages, ppo_loss, ppo_update
from tpu_plume_torch.train.ppo_trainer import ClippedAdam

torch.set_num_threads(1)

HIDDEN = (64, 32)
METRICS = ("loss/total", "loss/policy", "loss/value", "loss/entropy",
           "loss/approx_kl", "loss/clip_frac")


def _flax(obs_dim=6, seed=0):
    model = JActorCritic(num_actions=5, hidden_sizes=HIDDEN)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    params = jax.tree.map(np.asarray, params)
    return model, params


def _torch(params, obs_dim=6):
    m = ActorCritic(obs_dim, 5, HIDDEN)
    m.load_state_dict(actor_critic_from_flax(params))
    return m


def _batch(b, obs_dim=6, seed=1, weights=False):
    rng = np.random.default_rng(seed)
    d = dict(
        obs=rng.standard_normal((b, obs_dim), dtype=np.float32),
        actions=rng.integers(0, 5, b),
        old_log_probs=(-1.6 + 0.2 * rng.standard_normal(b)).astype(np.float32),
        advantages=rng.standard_normal(b, dtype=np.float32),
        returns=rng.standard_normal(b, dtype=np.float32),
        old_values=rng.standard_normal(b, dtype=np.float32),
    )
    if weights:
        d["weights"] = (rng.random(b) > 0.3).astype(np.float32)
    jb = JBatch(**{k: jnp.asarray(v, jnp.int32 if k == "actions" else None)
                   for k, v in d.items()})
    tb = PPOBatch(**{k: torch.from_numpy(v) for k, v in d.items()})
    return jb, tb


def _assert_params_close(model, flax_params, atol_scale=None, atol=None):
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = {k: v.numpy() for k, v in actor_critic_from_flax(flax_params).items()}
    assert got.keys() == want.keys()
    for k in want:
        tol = atol if atol is not None else atol_scale * max(
            np.abs(want[k]).max(), 1e-8)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_state_dict_names_are_reference_pth_layout():
    m = ActorCritic(6, 5, (256, 128))
    assert list(m.state_dict()) == [
        "feature.0.weight", "feature.0.bias", "feature.1.weight",
        "feature.1.bias", "feature.3.weight", "feature.3.bias",
        "feature.4.weight", "feature.4.bias", "actor.weight", "actor.bias",
        "critic.weight", "critic.bias"]
    assert m.feature[1].eps == 1e-6


def test_init_is_orthogonal_with_reference_gains():
    m = ActorCritic(6, 5, (256, 128)).reset_parameters(
        torch.Generator().manual_seed(0))
    w = m.feature[3].weight.detach().double()   # [128, 256]: rows orthogonal
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(128),
                               atol=1e-5)
    a = m.actor.weight.detach().double()
    np.testing.assert_allclose((a @ a.T).numpy(), 1e-4 * np.eye(5), atol=1e-9)
    assert all(float(b.detach().abs().max()) == 0.0
               for n, b in m.named_parameters()
               if n.endswith("bias"))


@pytest.mark.parametrize("obs_dim", [6, 12])
def test_forward_and_round_trip(obs_dim):
    jmodel, params = _flax(obs_dim, seed=obs_dim)
    m = _torch(params, obs_dim)
    obs = np.random.default_rng(0).standard_normal((257, obs_dim),
                                                   dtype=np.float32)
    jl, jv = jmodel.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = m(torch.from_numpy(obs))
    assert tv.shape == (257,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    back = actor_critic_to_flax(m.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("weights", [False, True])
def test_ppo_loss_and_grads_match_jax(weights):
    jmodel, params = _flax()
    m = _torch(params)
    jb, tb = _batch(512, weights=weights)
    cfg_j, cfg_t = JPPOCfg(), PPOConfig()
    grads, jm = jax.grad(j_loss, has_aux=True)(params, jmodel.apply, jb, cfg_j)
    loss, tm = ppo_loss(m, tb, cfg_t)
    loss.backward()
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in m.named_parameters():
        gw = want[name].numpy()
        scale = max(np.abs(gw).max(), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), gw, rtol=0,
                                   atol=2e-5 * scale, err_msg=name)


def test_gae_and_normalization_match_jax():
    rng = np.random.default_rng(3)
    T, N = 16, 32
    r = rng.standard_normal((T, N), dtype=np.float32)
    v = rng.standard_normal((T, N), dtype=np.float32)
    d = rng.random((T, N)) < 0.1
    boot = rng.standard_normal(N, dtype=np.float32)
    ja, jr = j_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                   jnp.asarray(boot), 0.99, 0.95)
    ta, tr = compute_gae(torch.from_numpy(r), torch.from_numpy(v),
                         torch.from_numpy(d), torch.from_numpy(boot), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    flat = ta.reshape(-1)
    np.testing.assert_allclose(
        normalize_advantages(flat, PPOConfig()).numpy(),
        np.asarray(j_norm(jnp.asarray(flat.numpy()), JPPOCfg())),
        rtol=1e-5, atol=1e-6)
    # degenerate std guard: a constant vector centres to zeros
    const = normalize_advantages(torch.full((8,), 3.0), PPOConfig())
    assert torch.equal(const, torch.zeros(8))


def _jax_shuffles(key, batch_size, cfg):
    """The per-epoch shuffles ``tpu_plume.rl.ppo.ppo_update`` draws from
    ``key``, reproduced with public jax.random calls."""
    out = []
    for ek in jax.random.split(key, cfg.epochs):
        if cfg.shuffle_mode == "roll":
            out.append(int(jax.random.randint(ek, (), 0, batch_size)))
        elif cfg.shuffle_mode == "affine":
            k_a, k_b = jax.random.split(ek)
            a = int(jax.random.randint(k_a, (), 0, batch_size // 2,
                                       dtype=jnp.uint32)) * 2 + 1
            b = int(jax.random.randint(k_b, (), 0, batch_size,
                                       dtype=jnp.uint32))
            idx = np.arange(batch_size, dtype=np.int64)
            out.append(torch.from_numpy((a * idx + b) & (batch_size - 1)))
        else:
            out.append(torch.from_numpy(
                np.asarray(jax.random.permutation(ek, batch_size),
                           np.int64)))
    return out


@pytest.mark.parametrize("mode", ["roll", "affine", "permutation"])
def test_ppo_update_matches_jax(mode):
    jmodel, params = _flax(seed=5)
    m = _torch(params)
    b = 128
    jb, tb = _batch(b, seed=6)
    cfg = dict(minibatch_size=32, epochs=3, shuffle_mode=mode,
               learning_rate=3e-5, max_grad_norm=0.5)
    cfg_j, cfg_t = JPPOCfg(**cfg), PPOConfig(**cfg)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-5))
    ts = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    key = jax.random.PRNGKey(9)
    ts, jm = j_update(ts, jb, key, cfg_j)
    opt = ClippedAdam(m.parameters(), 3e-5, 0.5)
    tm = ppo_update(m, opt, tb, cfg_t,
                    shuffles=_jax_shuffles(key, b, cfg_j))
    steps = 3 * (b // 32)
    _assert_params_close(m, jax.tree.map(np.asarray, ts.params),
                         atol=1e-6 * steps)
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)


def test_clip_is_optax_global_norm_clip():
    p = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    g = [np.array([3.0, 0.0, 4.0], np.float32), np.array([0.0, 12.0], np.float32)]
    want = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(x) for x in g], None)[0]
    opt = ClippedAdam(p, 0.0, 0.5)   # lr 0: the step leaves p alone
    for pi, gi in zip(p, g):
        pi.grad = torch.from_numpy(gi.copy())
    opt.step()
    for pi, wi in zip(p, want):
        np.testing.assert_allclose(pi.grad.numpy(), np.asarray(wi), rtol=1e-6)
    assert all(float(pi.detach().abs().max()) == 0.0 for pi in p)


@pytest.mark.parametrize("variant", ["adaptive", "simple"])
def test_curriculum_matches_jax(variant):
    kw = dict(variant=variant, window_size=120)
    jc, tc = JCurCfg(**kw), CurriculumConfig(**kw)
    js = jcur.curriculum_init(jc, 0.6)
    ts = tcur.curriculum_init(tc, 0.6)
    # windows that fire 0, 1 and several times (500 episodes: 4 fires),
    # with success rates above, between and below the thresholds
    windows = [(30, 50), (70, 80), (400, 500), (10, 130), (60, 200),
               (5, 300), (119, 119), (0, 0)]
    for succ, eps in windows:
        js = jcur.curriculum_update(js, jnp.int32(succ), jnp.int32(eps), jc)
        ts = tcur.curriculum_update(ts, succ, eps, tc)
        assert ts.success_count == int(js.success_count)
        assert ts.episode_count == int(js.episode_count)
        assert ts.num_updates == int(js.num_updates)
        np.testing.assert_allclose(float(ts.radius), float(js.radius),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(ts.explore_bonus),
                                   float(js.explore_bonus), rtol=1e-6)
    assert ts.num_updates > 0
    assert float(ts.radius) != 50.0


def test_update_options_of_later_slices_raise():
    _, params = _flax()
    m = _torch(params)
    _, tb = _batch(32)
    for flag in ("fused_update", "bf16_compute", "bf16_update", "f32_heads",
                 "remat"):
        cfg = dataclasses.replace(PPOConfig(minibatch_size=32), **{flag: True})
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ppo_update(m, ClippedAdam(m.parameters(), 1e-3, 0.5), tb, cfg,
                       shuffles=[0] * cfg.epochs)
