"""tpu_plume_torch: the PyTorch/CUDA port of tpu_plume.

It imports ``torch`` and never JAX or the ``tpu_plume`` package.  Its
entry points run on the card unless the caller asks for the CPU.
"""
