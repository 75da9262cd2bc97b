"""The recurrent (LSTM) policy of the port against the JAX package's, on the
CPU: the model, the converter, the rollout with hidden resets, the BPTT
update, one train iteration and the eval's ``rnn=``.

Params come from flax's ``RecurrentActorCritic.init`` through
``tpu_plume_torch.convert``; the randomness is what JAX draws from its keys
(the rollout's key splits, ``rollout/rollout.py:194-206``, and the update's
epoch permutations, ``rl/ppo.py:241, 263``), handed to the port.

Tolerances.  Actions, dones, steps and stop flags are equal.  The f32
forward (logits, values, carry) rtol 1e-5 / atol 1e-6; rollout floats
rtol 1e-5 / atol 1e-4 (the env's); params after k Adam steps atol 1e-6 x k
and loss metrics rtol 1e-4 / atol 1e-5 (``tests/test_torch_train.py``).
Under bf16 compute JAX's CPU backend expands a bf16 sigmoid as
1 / (1 + exp(-x)) with a bf16 rounding after each operation, where PyTorch
rounds the f32 sigmoid once, so a third of the gates differ by one bf16
ulp, and the carry carries that on: the forward within 2^-5 x max|x| (four
bf16 ulps of the largest) over 10 steps, rollout values and log-probs
within one bf16 ulp of the largest (as ``tests/test_torch_flags.py``), and
the update's move in global relative L2 norm below 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState

from test_torch_eval import INWARD, MOVE, NEAR, STAY, _configs, _gate, compare_metrics, jax_draws
from test_torch_train import _port_env_state, _t
from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.core.config import PPOConfig as JPPOConfig
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.models.recurrent import RecurrentActorCritic as JRecurrent
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rl.ppo import RecurrentPPOBatch as JBatch
from tpu_plume.rl.ppo import ppo_update_recurrent as j_update
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.rollout.rollout import rollout_chunk as j_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.convert import recurrent_actor_critic_from_flax, recurrent_actor_critic_to_flax
from tpu_plume_torch.core.config import EnvConfig, PPOConfig, RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.models import RecurrentActorCritic
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rl.ppo import RecurrentPPOBatch, ppo_update_recurrent
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry, rollout_chunk
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

H = E = 16
CELLS = {"plain": False, "ln": True}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_FORWARD = 2.0**-5


def jax_model(ln, dtype=jnp.float32, hidden=H, embed=E, obs_dim=6,
              actions=5, key=0):
    """A flax ``RecurrentActorCritic`` and its params (numpy leaves)."""
    m = JRecurrent(num_actions=actions, embed_size=embed, lstm_hidden=hidden,
                   dtype=dtype, layer_norm_cell=ln)
    params = jax.jit(m.init)(jax.random.PRNGKey(key), m.initial_state(1),
                             jnp.zeros((1, obs_dim)))
    return m, jax.tree.map(np.array, params)


def port_model(params, ln, dtype=torch.float32, hidden=H, embed=E,
               obs_dim=6, actions=5):
    m = RecurrentActorCritic(obs_dim, actions, embed, hidden, dtype, ln)
    m.load_state_dict(recurrent_actor_critic_from_flax(params))
    return m


def _carry(rng, n, hidden=H):
    return tuple(rng.normal(size=(n, hidden)).astype(np.float32)
                 for _ in range(2))


def _close(got, want, bf16, rtol=1e-5, atol=1e-6):
    want = np.asarray(want, np.float32)
    if bf16:
        rtol, atol = 0.0, BF16_FORWARD * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_step_and_sequence_match_jax(cell, dtype):
    """``sequence`` equals a chain of ``step`` calls with the same resets
    (mid-chunk), and both equal JAX's chain of steps (JAX's ``sequence``
    where its scan runs: not with the LayerNorm cell in bf16, whose h is
    bf16 after one step)."""
    ln, (jdt, tdt) = CELLS[cell], DTYPES[dtype]
    jm, params = jax_model(ln, jdt)
    tm = port_model(params, ln, tdt)
    rng = np.random.default_rng(1)
    n, steps = 4, 10
    c0 = _carry(rng, n)
    obs = (3.0 * rng.normal(size=(steps, n, 6))).astype(np.float32)
    resets = np.zeros((steps, n), bool)
    resets[5, 1] = resets[7, 3] = resets[3, 2] = True

    carry, jlogits, jvalues = tuple(map(jnp.asarray, c0)), [], []
    jstep = jax.jit(jm.apply)
    for t in range(steps):
        carry = tuple(jnp.where(resets[t][:, None], 0.0, x).astype(jnp.float32)
                      for x in carry)
        carry, lt, vt = jstep(params, carry, jnp.asarray(obs[t]))
        jlogits.append(lt)
        jvalues.append(vt)
    jcarry = carry

    tc = tuple(map(torch.from_numpy, c0))
    with torch.no_grad():
        scarry, slogits, svalues = tm.sequence(tc, torch.from_numpy(obs),
                                               torch.from_numpy(resets))
        carry, chain = tc, []
        for t in range(steps):
            carry = tuple(torch.where(torch.from_numpy(resets[t])[:, None],
                                      0.0, x) for x in carry)
            carry, lt, vt = tm.step(carry, torch.from_numpy(obs[t]))
            chain.append((lt, vt))
    assert all(x.dtype == torch.float32 for x in scarry)
    for got, want in ((slogits, torch.stack([lt for lt, _ in chain])),
                      (svalues, torch.stack([vt for _, vt in chain])),
                      (scarry[0], carry[0]), (scarry[1], carry[1])):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)

    bf16 = dtype == "bf16"
    _close(slogits, np.stack(jlogits), bf16)
    _close(svalues, np.stack(jvalues), bf16)
    for got, want in zip(scarry, jcarry):
        _close(got, want, bf16)
    if not (ln and bf16):
        _, jl, jv = jax.jit(lambda *a: jm.apply(*a, method="sequence"))(
            params, tuple(map(jnp.asarray, c0)), jnp.asarray(obs),
            jnp.asarray(resets))
        _close(slogits, jl, bf16)
        _close(svalues, jv, bf16)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_converter_round_trip(cell):
    ln = CELLS[cell]
    _, params = jax_model(ln, hidden=8, embed=12, obs_dim=7, actions=7)
    sd = recurrent_actor_critic_from_flax(params)
    tm = RecurrentActorCritic(7, 7, 12, 8, layer_norm_cell=ln)
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    back = recurrent_actor_critic_to_flax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    again = recurrent_actor_critic_from_flax(back)
    for k, v in tm.state_dict().items():
        assert torch.equal(again[k], v), k
    if not ln:
        # gate g of the hidden side: flax's hg kernel, transposed
        np.testing.assert_array_equal(
            sd["cell.hh.weight"][16:24].numpy(),
            params["params"]["cell"]["hg"]["kernel"].T)
        np.testing.assert_array_equal(sd["cell.hh.bias"][8:16].numpy(),
                                      params["params"]["cell"]["hf"]["bias"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_init_follows_flax(cell):
    """The port's init draws flax's distributions: per-gate orthogonal
    recurrent kernels (one [4H, H] matrix with orthonormal columns in the
    LayerNorm cell), truncated lecun-normal input kernels, orthogonal
    encoder and heads with flax's gains, zero biases, unit LayerNorms."""
    ln = CELLS[cell]
    hidden, embed = 32, 64
    tm = RecurrentActorCritic(6, 5, embed, hidden, layer_norm_cell=ln)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.double() for k, v in tm.state_dict().items()}
    eye = torch.eye(hidden, dtype=torch.float64)
    w_hh = sd["cell.hh.weight"]
    blocks = [w_hh] if ln else w_hh.split(hidden)
    for w in blocks:
        torch.testing.assert_close(w.T @ w, eye, atol=1e-5, rtol=0)
    w_ih = sd["cell.ih.weight"]
    std = (1.0 / embed) ** 0.5
    assert w_ih.abs().max() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert abs(float(w_ih.std()) - std) < 0.1 * std
    for name, gain in (("encoder", 2.0**0.5), ("actor", 0.01),
                       ("critic", 1.0)):
        w = sd[f"{name}.weight"]
        small = w if w.shape[0] <= w.shape[1] else w.T
        torch.testing.assert_close(
            small @ small.T, gain**2 * torch.eye(small.shape[0],
                                                 dtype=torch.float64),
            atol=1e-5, rtol=0)
    for k, v in sd.items():
        if k.endswith("bias"):
            assert not v.any(), k
        elif "norm" in k or "ln_" in k:
            assert (v == 1).all(), k
    _, params = jax_model(ln, hidden=hidden, embed=embed)
    assert sorted(sd) == sorted(recurrent_actor_critic_from_flax(params))


N, T = 16, 12


def _env(j):
    cls = JEnvConfig if j else EnvConfig
    return cls(max_steps=6, initial_radius=200.0)


def _jax_chunk_draws(key, n, length, cfg):
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(key, 6)
    return ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (length, n, 2), jnp.float32)),
        gumbel=_t(jax.random.gumbel(k_gumbel, (length, n, cfg.num_actions),
                                    jnp.float32)),
        u_src=_t(jax.random.uniform(k_src, (length, n, 2), jnp.float32)),
        bits=_t(np.asarray(jax.random.bits(k_bits, (length, n), jnp.uint32))
                .view(np.int32)),
    )


def _port_carry(roll, hidden):
    return RolloutCarry(env_state=_port_env_state(roll.env_state),
                        obs=_t(roll.obs),
                        accum=EpisodeAccum.zeros(roll.obs.shape[0], "cpu"),
                        generator=torch.Generator(),
                        hidden=tuple(torch.from_numpy(np.array(x))
                                     for x in hidden))


@pytest.fixture(scope="module", params=sorted(CELLS))
def rollouts(request):
    """One chunk of JAX's rollout with the recurrent policy and the port's
    from the same start (a nonzero carry), params and draws."""
    ln = CELLS[request.param]
    jm, params = jax_model(ln)
    roll = j_init_rollout(jax.random.PRNGKey(3), _env(True), N,
                          radius=200.0, explore_bonus=0.6)
    h0 = tuple(map(jnp.asarray, _carry(np.random.default_rng(4), N)))
    roll = roll.replace(hidden=h0)
    jcarry, jtraj, jboot = jax.jit(
        lambda p, c: j_rollout(p, None, c, _env(True), T, rnn=jm))(params,
                                                                  roll)
    tm = port_model(params, ln)
    tcarry, ttraj, tboot = rollout_chunk(
        tm, _port_carry(roll, h0), _env(False), T,
        draws=_jax_chunk_draws(roll.key, N, T, _env(False)))
    return (jcarry, jtraj, jboot), (tcarry, ttraj, tboot), tm, h0


def test_rollout_matches_jax(rollouts):
    (jcarry, jtraj, jboot), (tcarry, ttraj, tboot), _, _ = rollouts
    np.testing.assert_array_equal(ttraj.action.numpy(),
                                  np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    np.testing.assert_array_equal(ttraj.episode.steps.numpy(),
                                  np.asarray(jtraj.episode.steps))
    for name in ("reward", "value", "log_prob", "obs", "pos"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tboot.numpy(), np.asarray(jboot), rtol=1e-5,
                               atol=1e-4)
    for got, want in zip(tcarry.hidden, jcarry.hidden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    # episodes ended mid-chunk, and the carry was zeroed where the last
    # step ended one
    done = ttraj.done.numpy()
    assert done[:-1].any()
    for x in tcarry.hidden:
        assert not x[torch.from_numpy(done[-1])].any()


def test_rollout_values_equal_the_replay(rollouts):
    """The update's replay (the chunk-start carry, resets = dones shifted
    by one step) reproduces the rollout's log-probs and values."""
    _, (_, ttraj, _), tm, h0 = rollouts
    resets = torch.cat([torch.zeros_like(ttraj.done[:1]), ttraj.done[:-1]])
    with torch.no_grad():
        _, logits, values = tm.sequence(
            tuple(torch.from_numpy(np.array(x)) for x in h0), ttraj.obs,
            resets)
    log_prob = torch.log_softmax(logits, -1).gather(
        -1, ttraj.action[..., None]).squeeze(-1)
    torch.testing.assert_close(log_prob, ttraj.log_prob, rtol=0, atol=1e-5)
    torch.testing.assert_close(values, ttraj.value, rtol=0, atol=1e-5)


UPDATES = {   # name: (T, N, H, layer-norm cell, minibatch, epochs)
    "square": (8, 8, 8, False, 16, 2),
    "plain": (8, 16, 16, False, 32, 3),
    "ln": (8, 16, 16, True, 32, 3),
}


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_matches_jax(name):
    """``ppo_update_recurrent`` against JAX's given its permutations; the
    square case (T == N == H) is where a split by shape would take
    ``h_init`` for a time-major field."""
    t, n, hidden, ln, mb, epochs = UPDATES[name]
    jm, params = jax_model(ln, hidden=hidden)
    rng = np.random.default_rng(len(name))
    resets = rng.random((t, n)) < 0.15
    resets[0] = False
    fields = dict(
        obs=rng.normal(size=(t, n, 6)).astype(np.float32),
        actions=rng.integers(0, 5, (t, n)),
        old_log_probs=-np.abs(rng.normal(size=(t, n))).astype(np.float32)
        - 1.0,
        advantages=rng.normal(size=(t, n)).astype(np.float32),
        returns=rng.normal(size=(t, n)).astype(np.float32),
        old_values=rng.normal(size=(t, n)).astype(np.float32) * 0.1,
        resets=resets)
    h_init = _carry(rng, n, hidden)
    jcfg = JPPOConfig(arch="lstm", lstm_hidden=hidden, lstm_embed=E,
                      lstm_layer_norm=ln, minibatch_size=mb, epochs=epochs,
                      learning_rate=1e-3)
    tcfg = PPOConfig(**dataclasses.asdict(jcfg))
    ts = TrainState.create(apply_fn=jm.apply, params=params, tx=optax.chain(
        optax.clip_by_global_norm(jcfg.max_grad_norm),
        optax.adam(jcfg.learning_rate)))
    key = jax.random.PRNGKey(7)
    jbatch = JBatch(h_init=tuple(map(jnp.asarray, h_init)),
                    **{k: jnp.asarray(v) for k, v in fields.items()})
    jts, jmetrics = j_update(ts, jbatch, key, jcfg)
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n)))
             for k in jax.random.split(key, epochs)]

    tm = port_model(params, ln, hidden=hidden)
    opt = ttrain.ClippedAdam(tm.parameters(), tcfg.learning_rate,
                             tcfg.max_grad_norm)
    tbatch = RecurrentPPOBatch(h_init=tuple(map(torch.from_numpy, h_init)),
                               **{k: torch.from_numpy(np.asarray(v))
                                  for k, v in fields.items()})
    tmetrics = ppo_update_recurrent(tm, opt, tbatch, tcfg, shuffles=perms)

    steps = epochs * (n // max(1, mb // t))
    assert int(jts.step) == steps
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want = recurrent_actor_critic_from_flax(jax.tree.map(np.asarray,
                                                         jts.params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


ITER_N, ITER_T, ITER_MB = 16, 8, 32
ITERATIONS = {
    "f32": {},
    "ln": dict(lstm_layer_norm=True),
    "bf16_compute": dict(bf16_compute=True),
    "bf16_update": dict(bf16_update=True),
}


def _small_lstm(cfg, rollout_cls, **ppo):
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, arch="lstm", lstm_hidden=H,
                                lstm_embed=E, minibatch_size=ITER_MB, **ppo),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=200.0,
                                       window_size=4),
        rollout=rollout_cls(num_envs=ITER_N, unroll_length=ITER_T),
    )


@pytest.mark.parametrize("option", sorted(ITERATIONS))
def test_one_iteration_matches_jax(option):
    """One ``build_train_step`` iteration of the recurrent policy against
    JAX's, from the same params, env states, nonzero carry and curriculum,
    with JAX's draws and epoch permutations."""
    kw = ITERATIONS[option]
    jcfg = _small_lstm(j_get_preset("ppo_v2_0"), JRolloutCfg, **kw)
    tcfg = _small_lstm(t_get_preset("ppo_v2_0"), RolloutConfig, **kw)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(0), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    h0 = tuple(map(jnp.asarray, _carry(np.random.default_rng(2), ITER_N)))
    roll = j_init_rollout(k_roll, jcfg.env, ITER_N,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init,
                          hidden=h0)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)
    _, k_update = jax.random.split(jloop.key)
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, ITER_N)))
             for k in jax.random.split(k_update, jcfg.ppo.epochs)]
    draws = _jax_chunk_draws(roll.key, ITER_N, ITER_T, tcfg.env)

    params0 = jax.tree.map(np.asarray, ts.params)
    start = recurrent_actor_critic_from_flax(params0)
    model = ttrain.make_policy_model(tcfg)
    model.load_state_dict(start)
    tloop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(),
                                     tcfg.ppo.learning_rate,
                                     tcfg.ppo.max_grad_norm),
        rollout=_port_carry(roll, h0),
        curriculum=curriculum_init(tcfg.curriculum,
                                   tcfg.env.explore_bonus_init),
        generator=torch.Generator())
    jloop, jstats, jtraj = jtrain.build_train_step(jcfg)(jloop)
    tloop, tstats, ttraj = ttrain.build_train_step(tcfg)(
        tloop, draws=draws, shuffles=perms)

    bf16 = kw.get("bf16_compute", False) or kw.get("bf16_update", False)
    np.testing.assert_array_equal(ttraj.action.numpy(),
                                  np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    assert ttraj.done.any()
    for name in ("reward", "value", "log_prob"):
        want = np.asarray(getattr(jtraj, name))
        atol = 1e-4
        if kw.get("bf16_compute") and name != "reward":
            atol = max(atol, 2.0**-7 * np.abs(want).max())
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), want,
                                   rtol=1e-5, atol=atol, err_msg=name)
    for k in ("loss/total", "loss/policy", "loss/value", "loss/entropy",
              "loss/approx_kl", "loss/clip_frac", "rollout/mean_reward"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes", "curriculum/updates"):
        assert tstats[k] == int(jstats[k]), k
    for got, want in zip(tloop.rollout.hidden, jloop.rollout.hidden):
        if kw.get("bf16_compute"):
            _close(got, want, True)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-4)

    want = recurrent_actor_critic_from_flax(jax.tree.map(
        np.asarray, jloop.train_state.params))
    got = tloop.model.state_dict()
    if bf16:
        diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
        move = sum(float(((want[k] - start[k]) ** 2).sum()) for k in want)
        assert move > 0 and (diff / move) ** 0.5 < 0.05
    else:
        steps = jcfg.ppo.epochs * (ITER_N // (ITER_MB // ITER_T))
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-6 * steps, err_msg=k)


EVAL_N, EVAL_LENGTH = 32, 60
EVALS = {   # name: (env fields, gate, eval kwargs, actor bias)
    "greedy": (MOVE, None, {}, INWARD),
    "sampled": (MOVE, None, {"greedy": False}, INWARD),
    "heuristic": (NEAR, "heuristic", {}, STAY),
}


def _eval_models(env_cfg, bias, ln=False):
    jm, params = jax_model(ln, key=1)
    params["params"]["actor"]["bias"][:len(bias)] += np.float32(bias)
    return jm, jax.tree.map(jnp.asarray, params), port_model(params, ln)


@pytest.mark.parametrize("name", sorted(EVALS))
def test_evaluate_policy_rnn_matches_jax(name):
    env_kw, gate, kw, bias = EVALS[name]
    jcfg, tcfg = _configs("ppo_v2_0", env_kw)
    jm, params, tm = _eval_models(jcfg.env, bias, ln=name == "sampled")
    jgate, tgate = _gate(gate, jcfg, tcfg)
    key = jax.random.PRNGKey(11)
    jmetrics = jh.evaluate_policy(params, jm.apply, jcfg.env, jcfg.eval, key,
                                  num_episodes=EVAL_N, stop_gate=jgate,
                                  max_steps=EVAL_LENGTH, rnn=jm, **kw)
    draws = jax_draws(key, tcfg.env, EVAL_N, EVAL_LENGTH,
                      greedy=kw.get("greedy", True))
    tmetrics = th.evaluate_policy(tm, tcfg.env, tcfg.eval, draws=draws,
                                  device="cpu", num_episodes=EVAL_N,
                                  stop_gate=tgate, max_steps=EVAL_LENGTH,
                                  rnn=tm, **kw)
    compare_metrics(jmetrics, tmetrics)
    if gate is None:
        # episodes end at different steps, so the frozen carries matter
        assert len(np.unique(tmetrics.steps)) > 2
    else:
        assert 0 < tmetrics.stopped_early.sum() < EVAL_N


def test_generate_expert_data_rnn_matches_jax(tmp_path):
    jcfg, tcfg = _configs("ppo_v2_0", dict(MOVE, max_steps=40))
    jm, params, tm = _eval_models(jcfg.env, INWARD)
    key = jax.random.PRNGKey(5)
    js, ja = jh.generate_expert_data(params, jm.apply, jcfg.env, key,
                                     num_episodes=16, rnn=jm)
    ts, ta = th.generate_expert_data(
        tm, tcfg.env, num_episodes=16, path=str(tmp_path / "e.npz"),
        device="cpu", rnn=tm,
        draws=jax_draws(key, tcfg.env, 16, 40, expert=True))
    assert ts.shape == js.shape and ts.shape[0] < 16 * 40
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
