"""Parity of the port's fused PPO gradient module (``tpu_plume_torch.ops.ppo``)
with the JAX package, on the CPU.

``fused_ppo_grads_plain`` (the CUDA kernel's formulas in plain PyTorch) is
held to the Pallas kernel ``tpu_plume.ops.pallas_ppo.fused_ppo_grads`` in
interpret mode and to ``jax.grad(ppo_loss)``, at the setups and tolerances
of ``tests/test_fused_update.py``: grads atol 2e-5 x max|grad| of each
tensor, metrics rtol 2e-5, atol 2e-6.  Under ``bf16_compute`` it is held to
the Pallas kernel only, at the same tolerances: both round the same four
forward products' operands to bf16, while flax's bf16 autodiff rounds every
activation and is a different function.  Both sides get the same numpy
inputs and the same flax params (through ``actor_critic_from_flax``).
The plain version's bf16 product (``_ordered_mm``) is held to a numpy loop
that rounds each multiply-add step once, as the kernel's ``__fmaf_rn``
does, and the wrapper's pure-Python plan (the dW2 kernel's row split, the
workspace's segments) is checked at the main path's and the tests' widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import PPOConfig as JPPOCfg
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.ops.pallas_ppo import fused_ppo_grads as j_fused
from tpu_plume.rl.ppo import PPOBatch as JBatch
from tpu_plume.rl.ppo import ppo_loss as j_loss
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core.config import PPOConfig
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import ppo as fused_ops
from tpu_plume_torch.rl.ppo import PPOBatch, ppo_update
from tpu_plume_torch.train.ppo_trainer import ClippedAdam

torch.set_num_threads(1)

METRICS = ("loss/total", "loss/policy", "loss/value", "loss/entropy",
           "loss/approx_kl", "loss/clip_frac")
# test_fused_update.py's two setups: (batch, obs_dim, seed)
SETUPS = {"b512_d6": (512, 6, 0), "b1024_d12": (1024, 12, 3)}


def _setup(b, d, seed):
    """Default-width flax model and a batch drawn with numpy from ``seed``."""
    jmodel = JActorCritic(num_actions=5)
    params = jax.tree.map(np.asarray,
                          jmodel.init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, d))))
    rng = np.random.default_rng(seed + 1)
    arrays = dict(
        obs=rng.standard_normal((b, d), dtype=np.float32),
        actions=rng.integers(0, 5, b),
        old_log_probs=(-1.6 + 0.2 * rng.standard_normal(b)).astype(np.float32),
        advantages=rng.standard_normal(b, dtype=np.float32),
        returns=rng.standard_normal(b, dtype=np.float32),
        old_values=rng.standard_normal(b, dtype=np.float32),
    )
    jb = JBatch(**{k: jnp.asarray(v, jnp.int32 if k == "actions" else None)
                   for k, v in arrays.items()})
    tb = PPOBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    model = ActorCritic(d, 5)
    model.load_state_dict(actor_critic_from_flax(params))
    return jmodel, params, jb, tb, model


def _assert_matches(grads, metrics, jgrads, jmetrics):
    want = actor_critic_from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        gw = want[name].numpy()
        assert tuple(g.shape) == gw.shape, name
        scale = max(np.abs(gw).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), gw, rtol=0, atol=2e-5 * scale,
                                   err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_plain_matches_pallas_kernel(setup, bf16):
    b, d, seed = SETUPS[setup]
    _, params, jb, tb, model = _setup(b, d, seed)
    jgrads, jmetrics = j_fused(params, jb,
                               JPPOCfg(minibatch_size=b, bf16_compute=bf16),
                               interpret=True)
    grads, metrics = fused_ops.fused_ppo_grads_plain(
        model, tb, PPOConfig(minibatch_size=b, bf16_compute=bf16))
    _assert_matches(grads, metrics, jgrads, jmetrics)


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_plain_matches_autodiff(setup):
    b, d, seed = SETUPS[setup]
    jmodel, params, jb, tb, model = _setup(b, d, seed)
    jgrads, jmetrics = jax.grad(j_loss, has_aux=True)(
        params, jmodel.apply, jb, JPPOCfg(minibatch_size=b))
    grads, metrics = fused_ops.fused_ppo_grads(model, tb,
                                               PPOConfig(minibatch_size=b))
    _assert_matches(grads, metrics, jgrads, jmetrics)


def test_gating_mirrors_make_grad_fn():
    _, _, _, _, model = _setup(512, 6, 0)
    assert fused_ops.supports(model) and fused_ops.pick_tile(512) > 0
    assert fused_ops.pick_tile(500) == 0                 # ragged minibatch
    assert not fused_ops.supports(ActorCritic(6, 5, (64, 32, 16)))
    assert not fused_ops.supports(torch.nn.Linear(6, 8))
    lone_trunk = torch.nn.Module()
    lone_trunk.feature = torch.nn.Sequential(torch.nn.Linear(6, 8))
    assert not fused_ops.supports(lone_trunk)


def test_update_takes_the_fused_path_only_where_jax_does(monkeypatch):
    calls = []
    plain = fused_ops.fused_ppo_grads

    def counting(model, batch, cfg):
        calls.append(batch.obs.shape[0])
        return plain(model, batch, cfg)

    monkeypatch.setattr(fused_ops, "fused_ppo_grads", counting)
    _, _, _, tb, model = _setup(512, 6, 0)
    cfg = PPOConfig(minibatch_size=256, epochs=1, fused_update=True)

    def run(model, batch, cfg):
        calls.clear()
        ppo_update(model, ClippedAdam(model.parameters(), 3e-5, 0.5), batch,
                   cfg, shuffles=[0] * cfg.epochs)
        return len(calls)

    assert run(model, tb, cfg) == 2
    weighted = tb.map(lambda x: x)
    weighted.weights = torch.ones(512)
    assert run(model, weighted, cfg) == 0                 # per-sample weights
    ragged = PPOConfig(minibatch_size=64, epochs=1, fused_update=True)
    assert run(model, tb, ragged) == 0                    # no row tile
    deep = ActorCritic(6, 5, (32, 32, 32))
    assert run(deep, tb, cfg) == 0                        # not the standard net
    assert run(model, tb, PPOConfig(minibatch_size=256, epochs=1)) == 0


def test_cuda_wrapper_raises_on_cpu_tensors():
    _, _, _, tb, model = _setup(512, 6, 0)
    before = fused_ops.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ops.fused_ppo_grads_cuda(model, tb, PPOConfig(minibatch_size=512))
    assert fused_ops.launches == before


def test_fused_update_matches_jax_autodiff_update():
    """A whole fused ``ppo_update`` (plain version on the CPU) against the
    JAX update, which runs autodiff on the CPU: params after 2 epochs x 2
    minibatches at atol 1e-6 per Adam step, metrics as above."""
    import optax
    from flax.training.train_state import TrainState

    from tpu_plume.rl.ppo import ppo_update as j_update

    jmodel, params, jb, tb, model = _setup(512, 6, 0)
    kw = dict(minibatch_size=256, epochs=2, fused_update=True)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-5))
    ts = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    key = jax.random.PRNGKey(9)
    ts, jm = j_update(ts, jb, key, JPPOCfg(**kw))
    shuffles = [int(jax.random.randint(ek, (), 0, 512))
                for ek in jax.random.split(key, 2)]
    tm = ppo_update(model, ClippedAdam(model.parameters(), 3e-5, 0.5), tb,
                    PPOConfig(**kw), shuffles=shuffles)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, ts.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6 * 4, err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)


def test_ordered_mm_rounds_each_step_once():
    """``_ordered_mm`` is the kernel's ``__fmaf_rn`` loop: each step
    ``s + a_k w_k`` taken exactly (in f64) and rounded once to f32, over k
    in turn; checked against numpy on inputs that are not bf16-rounded,
    where a multiply rounded before the add would differ."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((16, 40), dtype=np.float32)
    w = rng.standard_normal((24, 40), dtype=np.float32)
    want = np.zeros((16, 24), np.float32)
    unfused = np.zeros((16, 24), np.float32)
    for k in range(a.shape[1]):
        step = np.float64(a[:, k, None]) * np.float64(w[None, :, k])
        want = (np.float64(want) + step).astype(np.float32)
        unfused = unfused + a[:, k, None] * w[None, :, k]
    got = fused_ops._ordered_mm(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(unfused, want)


@pytest.mark.parametrize("n,d,hidden,sms", [
    (65536, 6, (256, 128), 132), (65536, 12, (64, 32), 132),
    (512, 6, (64, 32), 132), (512, 12, (256, 128), 132), (128, 6, (64, 32), 8),
])
def test_kernel_plan(n, d, hidden, sms):
    """The dW2 kernel's split covers every row once in whole 16-row steps
    with no empty split and about one block per SM; the workspace's
    segments are 256-byte aligned and hold the row slabs, h1, dz2 and the
    dW2 slabs."""
    h1, h2 = hidden
    splits, rows = fused_ops.dw2_split(n, h1, h2, sms)
    assert rows % fused_ops.DW2_STEP_ROWS == 0
    assert (splits - 1) * rows < n <= splits * rows
    tiles = -(-h1 // fused_ops.DW2_TILE) * -(-h2 // fused_ops.DW2_TILE)
    assert tiles * splits <= max(sms, tiles) + tiles
    blocks = min(n // fused_ops.KERNEL_ROWS, 2 * sms)
    ws = fused_ops.workspace(n, d, h1, h2, 5, blocks, splits)
    model = ActorCritic(d, 5, hidden)
    small = sum(p.numel() for name, p in model.named_parameters()
                if name != "feature.3.weight") + 5
    assert ws["slab"][1] == blocks * small
    assert ws["h1"][1] == n * h1 and ws["dz2"][1] == n * h2
    assert ws["slab2"][1] == splits * h1 * h2
    ends = [0]
    for name in ("slab", "h1", "dz2", "slab2"):
        off, size = ws[name]
        assert off % 64 == 0 and off >= ends[-1]
        ends.append(off + size)
    assert ws["total"][1] >= ends[-1]
