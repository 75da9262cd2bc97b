"""The plain reference of the benchmark's training cells: float32 PyTorch
with TF32 off, independent of the program (it imports neither the port nor
the JAX package), re-deriving from the benchmark's inputs everything the
port derives from them.

- ``prng``: the counter-based cell hash behind the turbulence;
- ``field_isotropic`` / ``field_bank``: the analytic isotropic plume and
  the sub-cell 3-D bank, each a ``new_field`` / ``sample`` / ``wind``
  triple that ``env`` steps over (a configuration names its field);
- ``env``: the methane env's reset, step and auto-reset (reward v1_1);
- ``policy``: the MLP actor-critic forward;
- ``train``: the training iteration (rollout, GAE, PPO update with the
  global-norm clip and Adam, the curriculum) over the checked steps.
"""
