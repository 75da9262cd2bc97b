"""One small ``build_train_step`` iteration of the port against the JAX
package's for each slice-2 option, on the CPU (the harness of
``tests/test_torch_train.py``: the same start, draws and shuffles).

- ``fused_update`` (minibatch 128, so that the gate takes it): the port runs
  the fused kernel's plain version while JAX on the CPU runs autodiff; they
  agree at the fused-vs-autodiff tolerance of ``tests/test_fused_update.py``,
  so the f32 iteration tolerances below hold.
- ``remat``: the same function as the plain update.
- ``bf16_compute``, ``bf16_update`` and ``f32_heads`` (with
  ``bf16_compute``, since alone it is a no-op).

Tolerances.  Actions, dones and curriculum counts are equal.  Rollout floats
get rtol 1e-5 / atol 1e-4 (the env's), and under ``bf16_compute`` values
and log-probs also one bf16 ulp of the largest (atol 2^-7 x max|v|).  Loss
metrics, averages over the minibatch steps, get rtol 1e-4 / atol 1e-5.
Params after the update: f32 options atol 1e-6 per Adam step, as in
``tests/test_torch_train.py``; bf16 options compare the update's move
(params after minus before) in global relative L2 norm below 0.05
(measured 0.021-0.022): the two frameworks round bf16 gradients apart in
their last bit, and Adam's normalisation turns such differences into
differences of step size for entries whose gradients are near zero.
"""

import jax
import numpy as np
import pytest

from test_torch_train import MB, N, T, run_one_iteration
from tpu_plume_torch.convert import actor_critic_from_flax

OPTIONS = {
    "fused_update": dict(fused_update=True, minibatch_size=128),
    "remat": dict(remat=True),
    "bf16_compute": dict(bf16_compute=True),
    "bf16_update": dict(bf16_update=True),
    "f32_heads": dict(bf16_compute=True, f32_heads=True),
}
METRICS = ("loss/total", "loss/policy", "loss/value", "loss/entropy",
           "loss/approx_kl", "loss/clip_frac")


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_one_iteration_matches_jax(option):
    kw = OPTIONS[option]
    bf16 = kw.get("bf16_compute", False) or kw.get("bf16_update", False)
    (jloop, jstats, jtraj), (tloop, tstats, ttraj), start = \
        run_one_iteration(**kw)

    np.testing.assert_array_equal(ttraj.action.numpy(), np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    for name in ("reward", "value", "log_prob"):
        want = np.asarray(getattr(jtraj, name))
        atol = 1e-4
        if kw.get("bf16_compute") and name != "reward":
            atol = max(atol, 2.0**-7 * np.abs(want).max())
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), want,
                                   rtol=1e-5, atol=atol, err_msg=name)

    for k in METRICS + ("rollout/mean_reward",):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes", "curriculum/updates"):
        assert tstats[k] == int(jstats[k]), k
    np.testing.assert_allclose(tstats["curriculum/radius"],
                               float(jstats["curriculum/radius"]), rtol=1e-6)

    want = actor_critic_from_flax(jax.tree.map(np.asarray,
                                               jloop.train_state.params))
    got = tloop.model.state_dict()
    if bf16:
        diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
        move = sum(float(((want[k] - start[k]) ** 2).sum()) for k in want)
        assert move > 0 and (diff / move) ** 0.5 < 0.05
    else:
        steps = 5 * (N * T // kw.get("minibatch_size", MB))
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-6 * steps, err_msg=k)
