"""Mixed precision and remat of the port against the JAX package, on the CPU.

- The bf16 forward (``ActorCritic(dtype=bfloat16)``, with and without
  ``head_dtype=float32``) against flax's bf16 ``ActorCritic`` on 4096 random
  rows.  The two round at the same points but sum in other orders, so a
  product or LayerNorm stat can land on the other side of a bf16 rounding
  boundary: every output is within one bf16 ulp of the largest output
  (atol 2^-7 x max|out|), and fewer than 1% of the outputs differ by more
  than 1e-5 x max|out| (measured: 0.06% of the logits and 0.1% of the
  values with bf16 heads, each by one ulp).
- The ``bf16_update`` split: the update runs a bf16 twin over the same
  params while the rollout runs the f32 model, exactly as without the flag.
- ``remat`` recomputes the loss forward in the backward; on the CPU the
  recomputation is bit-identical, so params and metrics are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core.config import PPOConfig, RolloutConfig, get_preset
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.rl.ppo import PPOBatch, ppo_update
from tpu_plume_torch.rollout.rollout import draw_chunk
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)


@pytest.mark.parametrize("obs_dim", [6, 12])
@pytest.mark.parametrize("f32_heads", [False, True], ids=["bf16_heads",
                                                           "f32_heads"])
def test_bf16_forward_matches_flax(f32_heads, obs_dim):
    jmodel = JActorCritic(dtype=jnp.bfloat16,
                          head_dtype=jnp.float32 if f32_heads else None)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(obs_dim), jnp.zeros((1, obs_dim))))
    obs = np.random.default_rng(obs_dim).standard_normal(
        (4096, obs_dim), dtype=np.float32)
    jl, jv = jmodel.apply(params, jnp.asarray(obs))
    model = ActorCritic(obs_dim, 5, (256, 128), dtype=torch.bfloat16,
                        head_dtype=torch.float32 if f32_heads else None)
    model.load_state_dict(actor_critic_from_flax(params))
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    assert tl.dtype == tv.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for got, want in ((tl.numpy(), np.asarray(jl)), (tv.numpy(), np.asarray(jv))):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * scale)
        assert (np.abs(got - want) > 1e-5 * scale).mean() < 0.01


def test_f32_heads_acts_only_under_bf16():
    cfg = get_preset("ppo_v2_0")
    for kw, want in (
        (dict(f32_heads=True), (torch.float32, None)),
        (dict(f32_heads=True, bf16_compute=True), (torch.bfloat16,
                                                   torch.float32)),
        (dict(bf16_compute=True), (torch.bfloat16, None)),
    ):
        c = cfg.replace(ppo=dataclasses.replace(cfg.ppo, **kw))
        m = ttrain.make_policy_model(c)
        assert (m.dtype, m.head_dtype) == want, kw
    c = cfg.replace(ppo=dataclasses.replace(cfg.ppo, f32_heads=True))
    assert ttrain.policy_dtypes(c, torch.bfloat16) == (torch.bfloat16,
                                                       torch.float32)


def _small_cfg(**ppo):
    cfg = get_preset("ppo_v2_0")
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(64, 32),
                                minibatch_size=32, **ppo),
        rollout=RolloutConfig(num_envs=16, unroll_length=8))


def test_bf16_update_twin_is_bf16_and_rollout_f32(monkeypatch):
    seen = []
    real = ttrain.ppo_update

    def spy(model, optimizer, batch, cfg, **kw):
        seen.append(model)
        return real(model, optimizer, batch, cfg, **kw)

    monkeypatch.setattr(ttrain, "ppo_update", spy)
    runs = {}
    for name, kw in (("f32", {}), ("split", dict(bf16_update=True,
                                                 f32_heads=True))):
        cfg = _small_cfg(**kw)
        loop = ttrain.init_loop(cfg, "cpu")
        draws = draw_chunk(torch.Generator().manual_seed(1), cfg.env, 8, 16)
        runs[name] = (loop,) + ttrain.build_train_step(cfg)(
            loop, draws=draws, shuffles=[3, 77, 0, 101, 64])
    loop, _, stats, traj = runs["split"]
    twin = seen[-1]
    assert loop.model.dtype == torch.float32 and loop.model.head_dtype is None
    assert (twin.dtype, twin.head_dtype) == (torch.bfloat16, torch.float32)
    assert twin is not loop.model and twin.feature is loop.model.feature
    assert ([p.data_ptr() for p in twin.parameters()]
            == [p.data_ptr() for p in loop.model.parameters()])
    # the rollout is the f32 one, bit for bit; the update differs
    _, _, fstats, ftraj = runs["f32"]
    for name in ("action", "value", "log_prob", "reward"):
        assert torch.equal(getattr(traj, name), getattr(ftraj, name)), name
    assert float(stats["loss/total"]) != float(fstats["loss/total"])
    # under bf16_compute the flag is ignored: the update gets the model
    seen.clear()
    cfg = _small_cfg(bf16_compute=True, bf16_update=True)
    loop = ttrain.init_loop(cfg, "cpu")
    ttrain.build_train_step(cfg)(loop, shuffles=[0] * 5)
    assert seen == [loop.model] and loop.model.dtype == torch.bfloat16


def test_remat_update_equals_plain_update():
    rng = np.random.default_rng(6)
    b = 128
    batch = PPOBatch(
        obs=torch.from_numpy(rng.standard_normal((b, 6), dtype=np.float32)),
        actions=torch.from_numpy(rng.integers(0, 5, b)),
        old_log_probs=torch.from_numpy(
            (-1.6 + 0.2 * rng.standard_normal(b)).astype(np.float32)),
        advantages=torch.from_numpy(rng.standard_normal(b, dtype=np.float32)),
        returns=torch.from_numpy(rng.standard_normal(b, dtype=np.float32)),
        old_values=torch.from_numpy(rng.standard_normal(b, dtype=np.float32)),
    )
    out = {}
    for remat in (False, True):
        model = ActorCritic(6, 5, (64, 32)).reset_parameters(
            torch.Generator().manual_seed(5))
        cfg = PPOConfig(minibatch_size=32, epochs=3, remat=remat)
        metrics = ppo_update(model, ttrain.ClippedAdam(model.parameters(),
                                                       3e-5, 0.5),
                             batch, cfg, shuffles=[5, 17, 100])
        out[remat] = (model.state_dict(), metrics)
    (sd0, m0), (sd1, m1) = out[False], out[True]
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
