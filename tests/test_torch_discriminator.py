"""The port's GAIL discriminator against the JAX package's on the CPU.

- the forward, ``bce_with_logits``, ``discriminator_loss`` and
  ``gail_reward`` from the same params (flax's through
  ``convert.discriminator_from_flax``) on the same numpy inputs, rtol 1e-5
  / atol 1e-6; the loss's gradients atol 2e-5 x max|grad|;
- the converter both ways, exactly;
- the reference ``discriminator.pth``: the JAX package's export loaded by
  the port's module, and the port's state_dict loaded by JAX's
  ``import_discriminator_pth``, each computing the other's logits;
- the init: flax's ``Dense`` defaults (lecun-normal kernels truncated at
  two deviations, zero biases), their spread against flax's own draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.data.torch_export import export_discriminator_pth, import_discriminator_pth
from tpu_plume.models import Discriminator as JDiscriminator
from tpu_plume.models import discriminator as jd
from tpu_plume_torch.convert import discriminator_from_flax, discriminator_to_flax
from tpu_plume_torch.models import Discriminator
from tpu_plume_torch.models import discriminator as td

torch.set_num_threads(1)

OBS, ACT, B = 6, 5, 256


def _flax(key=0, obs=OBS, act=ACT, hidden=128):
    m = JDiscriminator(hidden=hidden)
    params = m.init(jax.random.PRNGKey(key), jnp.zeros((1, obs)),
                    jnp.zeros((1, act)))
    return m, jax.tree.map(np.asarray, params)


def _port(params):
    d = Discriminator(OBS, ACT)
    d.load_state_dict(discriminator_from_flax(params))
    return d


def _inputs(seed, n=B):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(n, OBS)).astype(np.float32)
    actions = rng.integers(0, ACT, n)
    return states, np.eye(ACT, dtype=np.float32)[actions]


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=1e-5, atol=1e-6, err_msg=err_msg)


def test_forward_and_losses_match_jax():
    jm, params = _flax()
    d = _port(params)
    (es, ea), (ps, pa) = _inputs(1), _inputs(2)
    t = torch.from_numpy
    _close(d(t(es), t(ea)), jm.apply(params, es, ea), "logits")
    _close(td.gail_reward(d, t(ps), t(pa)),
           jd.gail_reward(jm.apply, params, ps, pa), "gail_reward")
    logits = np.random.default_rng(3).normal(size=B).astype(np.float32) * 8
    targets = (np.random.default_rng(4).random(B) < 0.5).astype(np.float32)
    _close(td.bce_with_logits(t(logits), t(targets)),
           jd.bce_with_logits(logits, targets), "bce")
    loss = td.discriminator_loss(d, t(es), t(ea), t(ps), t(pa))
    jloss, grads = jax.value_and_grad(
        lambda p: jd.discriminator_loss(jm.apply, p, es, ea, ps, pa))(params)
    _close(loss, jloss, "discriminator_loss")
    loss.backward()
    want = discriminator_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in d.named_parameters():
        gw = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), gw, rtol=0,
                                   atol=2e-5 * np.abs(gw).max(), err_msg=name)


def test_converter_round_trip():
    _, params = _flax(5)
    sd = discriminator_from_flax(params)
    assert sorted(sd) == ["net.0.bias", "net.0.weight", "net.2.bias",
                          "net.2.weight"]
    back = discriminator_to_flax(sd)
    for name in ("Dense_0", "Dense_1"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][name][leaf],
                                          params["params"][name][leaf])
    assert sorted(Discriminator(OBS, ACT).state_dict()) == sorted(sd)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pth_interop(writer, tmp_path):
    """The reference layout written by one package, read by the other."""
    jm, params = _flax(6)
    es, ea = _inputs(7)
    path = str(tmp_path / "discriminator.pth")
    if writer == "jax":
        export_discriminator_pth(params, path)
        d = Discriminator(OBS, ACT)
        d.load_state_dict(torch.load(path, weights_only=True))
        _close(d(torch.from_numpy(es), torch.from_numpy(ea)),
               jm.apply(params, es, ea))
    else:
        d = Discriminator(OBS, ACT).reset_parameters(
            torch.Generator().manual_seed(0))
        torch.save(d.state_dict(), path)
        jparams = import_discriminator_pth(path)
        _close(d(torch.from_numpy(es), torch.from_numpy(ea)),
               jm.apply(jparams, es, ea))


def test_init_follows_flax():
    """lecun-normal: truncated at two deviations of the scaled normal, a
    spread of 1 / sqrt(fan_in) (flax's own draw of the same shapes agrees
    within sampling error), zero biases."""
    obs, act, hidden = 250, 6, 512
    d = Discriminator(obs, act, hidden).reset_parameters(
        torch.Generator().manual_seed(3))
    _, params = _flax(3, obs, act, hidden)
    for torch_name, flax_name in (("net.0", "Dense_0"), ("net.2", "Dense_1")):
        w = getattr(d.net, torch_name[-1]).weight.detach().numpy()
        fan_in = w.shape[1]
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= 2 * sigma + 1e-7
        want = params["params"][flax_name]["kernel"]
        # the sample std's relative error is about 1 / sqrt(2 n)
        err = 1 / np.sqrt(2 * w.size)
        assert abs(w.std() * np.sqrt(fan_in) - 1) < 5 * err
        assert abs(w.std() / want.std() - 1) < 8 * err
        assert not getattr(d.net, torch_name[-1]).bias.detach().numpy().any()
