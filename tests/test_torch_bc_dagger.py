"""Behavior cloning and DAgger of the port against the JAX package on the
CPU.

- ``make_bc_fitter`` and ``make_seq_bc_fitter`` from the same params and
  data, given JAX's epoch permutations (``jax.random.permutation`` of
  each epoch key): params after the fit, per-epoch losses, validation loss
  and accuracy;
- ``train_bc``: the train/validation split JAX's ``fit_bc`` receives
  (both packages' ``fit_bc`` recorded), its printed line, its refusals;
- DAgger's ``_collect`` given the reset and turbulence draws JAX's
  collector takes from its keys, the oracle driving (beta 1) and the
  greedy student (beta 0), feedforward and recurrent student: labels,
  ``valid``, success and finished flags equal, states within the env
  tolerance;
- the aggregate each ``train_dagger`` round fits, bit-equal to what JAX's
  passes to its fitter, both packages' collectors returning the same
  collections and both fitters recorded (flat: the ``max_round_samples``
  subsample and the power-of-two padding; sequence: the episode cap's
  subsample and the cyclic padding).

Tolerances: labels, flags, accuracies' counts and the aggregates equal;
env floats rtol 1e-5 / atol 1e-4; fit losses rtol 1e-4 / atol 1e-5;
params after k AdamW steps atol 1e-6 x k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recurrent import jax_model, port_model
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.evaluation.oracle import make_oracle as j_make_oracle
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.train import bc as jbc
from tpu_plume.train import dagger as jdag
from tpu_plume_torch.convert import actor_critic_from_flax, recurrent_actor_critic_from_flax
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.data.expert import save_expert_data
from tpu_plume_torch.evaluation.harnesses import EvalDraws
from tpu_plume_torch.evaluation.oracle import make_oracle
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.train import bc as tbc
from tpu_plume_torch.train import dagger as tdag

torch.set_num_threads(1)

HIDDEN = (64, 32)
RTOL, ATOL = 1e-5, 1e-4
# A small domain where the phase oracle reaches the source within the
# 40-step episodes at the protocol's radius 50.
DAGGER_ENV = dict(grid_size=250, source_padding=25.0, move_frac=0.1,
                  max_steps=40, initial_radius=50.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _perms(key, n, epochs):
    return [_t(jax.random.permutation(k, n)) for k in
            jax.random.split(key, epochs)]


def _params_close(model, want, steps):
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


def _fit_outputs_close(got, want, n_val):
    (losses, val_loss, val_acc), (jlosses, jval_loss, jval_acc) = got, want
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(val_loss), float(jval_loss), rtol=1e-4,
                               atol=1e-5)
    # the same number of validation rows right
    assert round(float(val_acc) * n_val) == round(float(jval_acc) * n_val)


def test_bc_fitter_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = rng.integers(0, 5, 300)
    xv = rng.normal(size=(50, 6)).astype(np.float32)
    yv = rng.integers(0, 5, 50)
    jm = JActorCritic(num_actions=5, hidden_sizes=HIDDEN)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 6)))
    key = jax.random.PRNGKey(2)
    epochs, bs = 3, 64
    jparams, *jrest = jbc.make_bc_fitter(jm, epochs=epochs, batch_size=bs)(
        params, x, jnp.asarray(y, jnp.int32), xv, jnp.asarray(yv, jnp.int32),
        key)
    model = ActorCritic(6, 5, HIDDEN)
    model.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray,
                                                              params)))
    got = tbc.make_bc_fitter(model, epochs=epochs, batch_size=bs)(
        _t(x), _t(y), _t(xv), _t(yv), perms=_perms(key, 300, epochs))
    _fit_outputs_close(got, jrest, 50)
    _params_close(model, actor_critic_from_flax(
        jax.tree.map(np.asarray, jparams)), epochs * (300 // bs))


def _episodes(rng, t, n):
    """Time-major episode data with each episode active over a prefix."""
    ends = rng.integers(1, t + 1, n)
    mask = np.arange(t)[:, None] < ends[None]
    return (rng.normal(size=(t, n, 6)).astype(np.float32),
            rng.integers(0, 5, (t, n)), mask)


def test_seq_bc_fitter_matches_jax():
    rng = np.random.default_rng(3)
    obs, labels, mask = _episodes(rng, 6, 20)
    v_obs, v_labels, v_mask = _episodes(rng, 6, 8)
    jm, params = jax_model(True)
    key = jax.random.PRNGKey(4)
    epochs, be = 2, 8
    jparams, *jrest = jbc.make_seq_bc_fitter(
        jm, epochs=epochs, batch_episodes=be)(
        params, obs, jnp.asarray(labels, jnp.int32), mask, v_obs,
        jnp.asarray(v_labels, jnp.int32), v_mask, key)
    model = port_model(params, True)
    got = tbc.make_seq_bc_fitter(model, epochs=epochs, batch_episodes=be)(
        _t(obs), _t(labels), _t(mask), _t(v_obs), _t(v_labels), _t(v_mask),
        perms=_perms(key, 20, epochs))
    _fit_outputs_close(got, jrest, int(v_mask.sum()))
    _params_close(model, recurrent_actor_critic_from_flax(
        jax.tree.map(np.asarray, jparams)), epochs * (20 // be))


def _cfgs(**ppo):
    out = []
    for get in (j_get_preset, t_get_preset):
        cfg = get("ppo_v2_0")
        out.append(cfg.replace(
            env=dataclasses.replace(cfg.env, **DAGGER_ENV),
            ppo=dataclasses.replace(cfg.ppo, hidden_sizes=HIDDEN, **ppo)))
    return out


def test_train_bc_split_and_line_match_jax(tmp_path, monkeypatch, capsys):
    """Both packages' ``train_bc`` hand their ``fit_bc`` the same split of
    the same file and print the same line for the same fit results."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "expert_data.npz")
    save_expert_data(path, rng.normal(size=(123, 6)), rng.integers(0, 5, 123))
    seen = {}

    def jfit(model, params, x_tr, y_tr, x_va, y_va, key, epochs, **kw):
        seen["jax"] = [np.asarray(a) for a in (x_tr, y_tr, x_va, y_va)]
        return params, jnp.linspace(2.0, 1.0, epochs), 1.5, 0.25

    def tfit(model, x_tr, y_tr, x_va, y_va, *, epochs, **kw):
        seen["port"] = [a.numpy() for a in (x_tr, y_tr, x_va, y_va)]
        return torch.linspace(2.0, 1.0, epochs), torch.tensor(1.5), \
            torch.tensor(0.25)

    monkeypatch.setattr(jbc, "fit_bc", jfit)
    monkeypatch.setattr(tbc, "fit_bc", tfit)
    jcfg, tcfg = _cfgs()
    jres = jbc.train_bc(jcfg, None, path, epochs=4)
    jline = capsys.readouterr().out
    tres = tbc.train_bc(tcfg, str(tmp_path / "bc"), path, epochs=4,
                        device="cpu")
    assert capsys.readouterr().out == jline
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(got, want)
    assert (tres.samples, tres.train_loss, tres.val_loss,
            tres.val_accuracy) == (jres.samples, jres.train_loss,
                                   jres.val_loss, jres.val_accuracy)
    ckpt = torch.load(tmp_path / "bc" / "checkpoint.pt", weights_only=True)
    assert set(ckpt) == {"model", "config"}


def test_train_bc_refusals_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "expert_data.npz")
    save_expert_data(path, rng.normal(size=(20, 7)), rng.integers(0, 5, 20))
    for kw in ({}, {"arch": "lstm"}):
        jcfg, tcfg = _cfgs(**kw)
        with pytest.raises(ValueError) as jerr:
            jbc.train_bc(jcfg, None, path)
        with pytest.raises(ValueError) as terr:
            tbc.train_bc(tcfg, None, path, device="cpu")
        assert str(terr.value) == str(jerr.value)
        assert ("feedforward" if kw else "expert obs dim 7") in str(
            terr.value)


def _dagger_draws(reset_keys, k_scan, cfg, length):
    """The port's ``EvalDraws`` of JAX's ``_collect`` run: each episode's
    reset from its key (``env.methane.reset``), and per step ``key, k_step,
    k_mix = split(key, 3)`` with one turbulence normal per episode from
    ``split(k_step, n)``."""
    n = reset_keys.shape[0]

    def per_env(k):
        k_src, k_seed, k_wind = jax.random.split(k, 3)
        u = jax.random.uniform(k_src, (2,), jnp.float32)
        seed = jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max)
        return u, seed

    u_src, bits = jax.vmap(per_env)(reset_keys)

    def body(key, _):
        key, k_step, _ = jax.random.split(key, 3)
        return key, jax.vmap(lambda k: jax.random.normal(
            k, (cfg.pos_dim,), jnp.float32))(jax.random.split(k_step, n))

    _, turb = jax.lax.scan(body, k_scan, None, length=length)
    return EvalDraws(u_src=_t(u_src), u_wind=None,
                     bits=_t(np.asarray(bits, np.int32)), turb_noise=_t(turb),
                     gumbel=None)


@pytest.mark.parametrize("arch", ["mlp", "lstm"])
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_collect_matches_jax(arch, beta):
    rnn = arch == "lstm"
    jcfg, tcfg = _cfgs(arch=arch, lstm_hidden=16, lstm_embed=16)
    n, length = 8, jcfg.env.max_steps
    if rnn:
        jm, params = jax_model(False)
        tm = port_model(params, False)
    else:
        jm = JActorCritic(num_actions=5, hidden_sizes=HIDDEN)
        params = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 6)))
        tm = ActorCritic(6, 5, HIDDEN)
        tm.load_state_dict(actor_critic_from_flax(
            jax.tree.map(np.asarray, params)))
    reset_keys = jax.random.split(jax.random.PRNGKey(8), n)
    k_scan = jax.random.PRNGKey(9)
    want = jdag._collect(jm, j_make_oracle("phase", jcfg.env), jcfg.env, n,
                         beta, rnn=rnn)(params, reset_keys, k_scan)
    got = tdag._collect(tm, make_oracle("phase", tcfg.env), tcfg.env, n,
                        beta, rnn=rnn, device="cpu",
                        draws=_dagger_draws(reset_keys, k_scan, tcfg.env,
                                            length))
    states, labels, valid, succ, finished = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[3].numpy(), succ)
    np.testing.assert_array_equal(got[4].numpy(), finished)
    np.testing.assert_allclose(got[0].numpy(), states, rtol=RTOL, atol=ATOL)
    if beta == 1.0:
        # the oracle flies: episodes end early, some inside the 40-px gate,
        # and are frozen from then on
        assert succ.any() and valid.any() and not valid.all()


def _fake_round(r, n, t, rng_seed=10):
    """One collection (states, labels, valid, succ, finished) of ``n``
    episodes over ``t`` steps, different per round."""
    rng = np.random.default_rng(rng_seed + r)
    ends = rng.integers(1, t + 1, n)
    valid = np.arange(t)[:, None] < ends[None]
    states = rng.normal(size=(t, n, 6)).astype(np.float32)
    labels = rng.integers(0, 5, (t, n)).astype(np.int32)
    succ = rng.random(n) < 0.3
    return states, labels, valid, succ, ends < t


AGGREGATES = {   # name: (arch, episodes per round, rounds, train_dagger kw)
    "flat": ("mlp", 80, 3, dict(max_round_samples=1000)),
    "sequence": ("lstm", 80, 2, dict(seq_episode_cap=128)),
}


@pytest.mark.parametrize("name", sorted(AGGREGATES))
def test_dagger_aggregate_matches_jax(name, monkeypatch, capsys):
    arch, n, rounds, kw = AGGREGATES[name]
    jcfg, tcfg = _cfgs(arch=arch, lstm_hidden=16, lstm_embed=16)
    t = jcfg.env.max_steps
    fits = {"jax": [], "port": []}
    calls = {"jax": 0, "port": 0}

    def collection(pkg):
        r = calls[pkg]
        calls[pkg] += 1
        return _fake_round(r, n, t)

    def j_collect(model, oracle, env_cfg, n_, beta, rnn=False):
        return lambda params, reset_keys, k_scan: tuple(
            jnp.asarray(x) for x in collection("jax"))

    def t_collect(model, oracle, env_cfg, n_, beta, **kw_):
        return tuple(torch.from_numpy(x) for x in collection("port"))

    def j_fitter(model, **fkw):
        def fit(params, *arrays):
            fits["jax"].append([np.asarray(a) for a in arrays[:-1]])
            return params, jnp.zeros(2), jnp.float32(0), jnp.float32(0)
        return fit

    def t_fitter(model, **fkw):
        def fit(*arrays, generator=None, perms=None):
            fits["port"].append([a.numpy() for a in arrays
                                 if isinstance(a, torch.Tensor)])
            return torch.zeros(2), torch.tensor(0.0), torch.tensor(0.0)
        return fit

    monkeypatch.setattr(jdag, "_collect", j_collect)
    monkeypatch.setattr(tdag, "_collect", t_collect)
    fitter = "make_seq_bc_fitter" if arch == "lstm" else "make_bc_fitter"
    monkeypatch.setattr(jbc, fitter, j_fitter)
    monkeypatch.setattr(tbc, fitter, t_fitter)
    jres = jdag.train_dagger(jcfg, None, rounds=rounds, episodes_per_round=n,
                             **kw)
    jlines = capsys.readouterr().out
    tres = tdag.train_dagger(tcfg, None, rounds=rounds, episodes_per_round=n,
                             device="cpu", **kw)
    assert capsys.readouterr().out == jlines
    assert len(fits["jax"]) == len(fits["port"]) == rounds
    for r, (got, want) in enumerate(zip(fits["port"], fits["jax"])):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, (r, g.shape, w.shape)
            np.testing.assert_array_equal(g, w)
    assert (tres.samples, tres.eval_success) == (jres.samples,
                                                 jres.eval_success)
    # the subsample and the padding both ran
    first = fits["port"][0][0]
    if arch == "mlp":
        assert first.shape[0] == 4096 and kw["max_round_samples"] < (
            _fake_round(0, n, t)[2].sum())
    else:
        assert fits["port"][-1][0].shape[1] == 128
