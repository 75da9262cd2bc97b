"""The benchmark of ``tpu_plume_torch``, the PyTorch and CUDA port: full-batch
PPO training on one H100 (``BENCHMARK.json`` at the repository's root names
its cells and metrics).

    python3 -m plumebench.run --workload ppo_v2_0.train.n16384 --seed 7 --seconds 10 --trace 0

The harness (``run``, ``harness``) reads its cells from data files
(``registry``): ``configs/``, ``traffic/``, ``workloads/`` and
``metrics/``.  Its inputs come from one generator (``inputs``), its counts
of work from frozen copies (``counts``), its comparison from a plain
reference (``reference/``, with the field each configuration names and
the policy of its ``ppo.arch``; ``check``).  ``control`` reads the limits'
readings on the card and ``rehearse`` runs a cell at a tiny size on the
CPU.  Nothing here imports JAX or the JAX package (``imports``).
"""
