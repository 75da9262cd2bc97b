"""The plain reference of the benchmark's training cells: float32 PyTorch
with TF32 off, independent of the program (it imports neither the port nor
the JAX package), re-deriving from the benchmark's inputs everything the
port derives from them.

- ``prng``: the counter-based cell hash behind the turbulence;
- ``field_isotropic`` / ``field_bank``: the analytic isotropic plume and
  the sub-cell 3-D bank, each a ``new_field`` / ``sample`` / ``wind``
  triple that ``env`` steps over (a configuration names its field);
- ``env``: the methane env's reset, step and auto-reset (reward v1_1);
- ``policy_mlp`` / ``policy_lstm``: the MLP actor-critic and the
  recurrent PPO-LSTM (``layers``: what they share), found by the
  program's ``ppo.arch`` as run (``registry.reference_policy``).  A
  policy module holds ``layout`` (its parameters in the program's
  ``state_dict`` names), ``shuffles`` (the checked
  steps' draws of one epoch's shuffle each), ``initial_carry``, ``step``
  (``(carry, obs) -> (carry', logits, value)``), ``update_batch``,
  ``minibatches`` and ``minibatch_forward`` (how an epoch's batch is cut,
  and each minibatch's logits and values) and ``macs_per_row`` (its
  matmul multiply-adds per row, for ``counts.train_flops``);
- ``train``: the training iteration (rollout, GAE, PPO update with the
  global-norm clip and Adam, the curriculum) over the checked steps,
  shared by every policy.
"""
