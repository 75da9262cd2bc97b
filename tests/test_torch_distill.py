"""Distilled PPO of the port against the JAX package on the CPU.

- ``ppo_loss`` and ``ppo_loss_recurrent`` with teacher labels, the
  distill gate off and at 0.2, against JAX's: every metric with
  ``loss/distill``, and the gradients;
- ``RecurrentPPOBatch.envs`` with and without labels;
- one ``build_train_step`` iteration with ``distill_oracle`` set, the
  feedforward and the recurrent policy, against JAX's from the same
  params, env states and draws (``tests/test_torch_train.py``'s and
  ``tests/test_torch_recurrent.py``'s harnesses): the rollout's teacher
  labels (``rollout_chunk(oracle=)``) equal to JAX's
  ``traj.oracle_action``, the loss metrics and the params after the
  update; with ``fused_update`` set the labelled batch takes autodiff.

Tolerances: labels, actions and dones equal; loss metrics of one loss
call rtol 2e-5 / atol 2e-6, gradients atol 2e-5 x max|grad|
(``tests/test_torch_rl.py``); an iteration's metrics rtol 1e-4 / atol
1e-5, params after k Adam steps atol 1e-6 x k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recurrent import E, H, _carry, _jax_chunk_draws, _port_carry, _small_lstm, jax_model, port_model
from test_torch_rl import _batch, _flax, _torch
from test_torch_train import N, T, MB, run_one_iteration
from tpu_plume.core.config import PPOConfig as JPPOCfg
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rl.ppo import RecurrentPPOBatch as JRBatch
from tpu_plume.rl.ppo import ppo_loss as j_loss
from tpu_plume.rl.ppo import ppo_loss_recurrent as j_loss_rec
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.convert import actor_critic_from_flax, recurrent_actor_critic_from_flax
from tpu_plume_torch.core.config import PPOConfig, RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rl.ppo import RecurrentPPOBatch, ppo_loss, ppo_loss_recurrent
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

METRICS = ("loss/total", "loss/policy", "loss/value", "loss/entropy",
           "loss/approx_kl", "loss/clip_frac", "loss/distill")
GATES = (0.0, 0.2)


def _compare_grads(model, grads_tree, from_flax):
    want = from_flax(jax.tree.map(np.asarray, grads_tree))
    for name, p in model.named_parameters():
        gw = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), gw, rtol=0,
                                   atol=2e-5 * max(np.abs(gw).max(), 1e-8),
                                   err_msg=name)


def _compare_metrics(tm, jm):
    assert set(tm) == set(jm) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)


@pytest.mark.parametrize("gate", GATES)
def test_ppo_loss_with_labels_matches_jax(gate):
    jmodel, params = _flax()
    m = _torch(params)
    jb, tb = _batch(512)
    labels = np.random.default_rng(9).integers(0, 5, 512)
    jb = jb.replace(oracle_actions=jnp.asarray(labels, jnp.int32))
    tb = dataclasses.replace(tb, oracle_actions=torch.from_numpy(labels))
    cfg_j = JPPOCfg(distill_coef=0.3, distill_conc_gate=gate)
    cfg_t = PPOConfig(distill_coef=0.3, distill_conc_gate=gate)
    grads, jm = jax.grad(j_loss, has_aux=True)(params, jmodel.apply, jb,
                                                cfg_j)
    loss, tm = ppo_loss(m, tb, cfg_t)
    loss.backward()
    _compare_metrics(tm, jm)
    _compare_grads(m, grads, actor_critic_from_flax)
    # the gate leaves out part of the batch, and the term moves the loss
    if gate:
        assert 0 < (tb.obs[:, 2] > gate).sum() < 512
    assert float(tm["loss/distill"]) > 0


@pytest.mark.parametrize("gate", GATES)
def test_ppo_loss_recurrent_with_labels_matches_jax(gate):
    jm, params = jax_model(True)
    tm = port_model(params, True)
    rng = np.random.default_rng(11)
    t, n = 6, 8
    resets = rng.random((t, n)) < 0.2
    resets[0] = False
    fields = dict(
        obs=rng.normal(size=(t, n, 6)).astype(np.float32),
        actions=rng.integers(0, 5, (t, n)),
        old_log_probs=(-1.6 + 0.2 * rng.normal(size=(t, n))).astype(
            np.float32),
        advantages=rng.normal(size=(t, n)).astype(np.float32),
        returns=rng.normal(size=(t, n)).astype(np.float32),
        old_values=rng.normal(size=(t, n)).astype(np.float32),
        resets=resets, oracle_actions=rng.integers(0, 5, (t, n)))
    h_init = _carry(rng, n)
    kw = dict(arch="lstm", lstm_hidden=H, lstm_embed=E, lstm_layer_norm=True,
              distill_coef=0.3, distill_conc_gate=gate)
    jbatch = JRBatch(h_init=tuple(map(jnp.asarray, h_init)),
                     **{k: jnp.asarray(v) for k, v in fields.items()})
    grads, jmetrics = jax.grad(j_loss_rec, has_aux=True)(
        params, jm.apply, jbatch, JPPOCfg(**kw))
    tbatch = RecurrentPPOBatch(h_init=tuple(map(torch.from_numpy, h_init)),
                               **{k: torch.from_numpy(np.asarray(v))
                                  for k, v in fields.items()})
    loss, tmetrics = ppo_loss_recurrent(tm, tbatch, PPOConfig(**kw))
    loss.backward()
    _compare_metrics(tmetrics, jmetrics)
    _compare_grads(tm, grads, recurrent_actor_critic_from_flax)


@pytest.mark.parametrize("labelled", [False, True])
def test_recurrent_batch_envs_with_and_without_labels(labelled):
    """``envs`` splits the labels as a time-major field when present and
    keeps an absent one None; at T == N == H no field is taken for
    another."""
    t = n = h = 4
    g = torch.Generator().manual_seed(0)
    batch = RecurrentPPOBatch(
        obs=torch.randn(t, n, 6, generator=g),
        actions=torch.randint(0, 5, (t, n), generator=g),
        old_log_probs=torch.randn(t, n, generator=g),
        advantages=torch.randn(t, n, generator=g),
        returns=torch.randn(t, n, generator=g),
        old_values=torch.randn(t, n, generator=g),
        resets=torch.zeros(t, n, dtype=torch.bool),
        h_init=(torch.randn(n, h, generator=g), torch.randn(n, h,
                                                            generator=g)),
        oracle_actions=(torch.randint(0, 5, (t, n), generator=g)
                        if labelled else None))
    index = torch.tensor([2, 0])
    part = batch.envs(index)
    for f in dataclasses.fields(batch):
        got, full = getattr(part, f.name), getattr(batch, f.name)
        if f.name == "h_init":
            for a, b in zip(got, full):
                assert torch.equal(a, b[index])
        elif full is None:
            assert got is None
        else:
            assert torch.equal(got, full[:, index]), f.name
    assert (part.oracle_actions is not None) == labelled


MLP_CASES = {
    "phase": dict(distill_oracle="phase"),
    "look1 gated": dict(distill_oracle="look1", distill_conc_gate=0.2,
                        distill_coef=0.5),
    "phase fused_update": dict(distill_oracle="phase", fused_update=True),
}


def _compare_iteration(jout, tout):
    (jloop, jstats, jtraj), (tloop, tstats, ttraj) = jout, tout
    np.testing.assert_array_equal(ttraj.oracle_action.numpy(),
                                  np.asarray(jtraj.oracle_action))
    np.testing.assert_array_equal(ttraj.action.numpy(),
                                  np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    # the teacher disagrees with the policy somewhere and uses several moves
    labels = ttraj.oracle_action.numpy()
    assert (labels != ttraj.action.numpy()).any()
    assert len(np.unique(labels)) > 1
    for k in METRICS + ("rollout/mean_reward",):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes"):
        assert tstats[k] == int(jstats[k]), k


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_distilled_iteration_matches_jax(case, monkeypatch):
    """One feedforward iteration with the teacher's labels against JAX's;
    under ``fused_update`` the labelled batch takes autodiff (no fused
    launch), as JAX's ``rl/ppo.py:294`` does."""
    from tpu_plume_torch.ops import ppo as fused_ops

    def refuse(*a, **k):
        raise AssertionError("a labelled batch reached the fused kernel")

    monkeypatch.setattr(fused_ops, "fused_ppo_grads", refuse)
    jout, tout, _ = run_one_iteration(**MLP_CASES[case])
    _compare_iteration(jout, tout)
    want = actor_critic_from_flax(jax.tree.map(
        np.asarray, jout[0].train_state.params))
    steps = 5 * (N * T // MB)
    for k, v in tout[0].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


def test_distilled_recurrent_iteration_matches_jax():
    """One recurrent iteration (LayerNorm cell) with the phase teacher's
    labels against JAX's: the labels ride the time-major batch through the
    env permutations of the BPTT update."""
    n, t, mb = 16, 8, 32
    kw = dict(distill_oracle="phase", lstm_layer_norm=True)
    jcfg = _small_lstm(j_get_preset("ppo_v2_0"), JRolloutCfg, **kw)
    tcfg = _small_lstm(t_get_preset("ppo_v2_0"), RolloutConfig, **kw)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(0), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    h0 = tuple(map(jnp.asarray, _carry(np.random.default_rng(2), n)))
    roll = j_init_rollout(k_roll, jcfg.env, n,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init,
                          hidden=h0)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)
    _, k_update = jax.random.split(jloop.key)
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n)))
             for k in jax.random.split(k_update, jcfg.ppo.epochs)]
    model = ttrain.make_policy_model(tcfg)
    model.load_state_dict(recurrent_actor_critic_from_flax(
        jax.tree.map(np.asarray, ts.params)))
    tloop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(),
                                     tcfg.ppo.learning_rate,
                                     tcfg.ppo.max_grad_norm),
        rollout=_port_carry(roll, h0),
        curriculum=curriculum_init(tcfg.curriculum,
                                   tcfg.env.explore_bonus_init),
        generator=torch.Generator())
    jout = jtrain.build_train_step(jcfg)(jloop)
    tout = ttrain.build_train_step(tcfg)(
        tloop, draws=_jax_chunk_draws(roll.key, n, t, tcfg.env),
        shuffles=perms)
    _compare_iteration(jout, tout)
    want = recurrent_actor_critic_from_flax(jax.tree.map(
        np.asarray, jout[0].train_state.params))
    steps = jcfg.ppo.epochs * (n // (mb // t))
    for k, v in tout[0].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)
