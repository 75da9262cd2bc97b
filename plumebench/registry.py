"""Finds the benchmark's data files by name and joins them into one run's
``Spec``.

- ``configs/<name>.json``: a configuration: the port's preset, every env,
  PPO and curriculum field as run, the policy's widths, the bank (or
  null), the reference's field (``"reference": {"field": <name>}``), and
  what was changed from the source (``reduced``) or set here
  (``assumed``).
- ``reference/field_<name>.py``: the reference field a configuration
  names; ``reference/policy_<arch>.py``: the reference policy of the
  program's ``ppo.arch`` as run (the traffic's overrides applied).
- ``traffic/<name>.json``: a training job's shape: envs, unroll, epochs,
  minibatches per epoch, ``sync_every`` and PPO fields of the update path.
- ``workloads/<cell>.json``: a cell: its configuration, its traffic, the
  chips it needs, how many steps the reference follows and the limit of
  each compared number.
- ``metrics/<name>.json`` and ``metrics/<name>.py``: a per-layer metric
  and its reader; ``metrics/<name>.kernels.<tag>.json`` files add kernel
  names to a metric's own list.

Adding a configuration, a traffic mix, a cell, a metric, a reference
field or the reference policy of another ``ppo.arch`` is adding files.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def _load(kind: str, name: str) -> dict:
    path = os.path.join(ROOT, kind, f"{name}.json")
    if not os.path.isfile(path):
        have = sorted(os.path.basename(p)[:-5] for p in
                      glob.glob(os.path.join(ROOT, kind, "*.json")))
        raise KeyError(f"no {kind} file {name!r}; found {have}")
    with open(path) as fh:
        return json.load(fh)


def names(kind: str) -> list:
    """The names of every ``kind`` file (a metric's kernel lists aside)."""
    return sorted(os.path.basename(p)[:-5]
                  for p in glob.glob(os.path.join(ROOT, kind, "*.json"))
                  if ".kernels." not in os.path.basename(p))


@dataclasses.dataclass
class Spec:
    """One cell as run: the joined configuration, traffic and workload."""

    cell: str
    config: dict
    traffic: dict
    workload: dict
    num_envs: int
    unroll_length: int
    epochs: int
    minibatch_size: int

    @property
    def env(self) -> dict:
        return self.config["env"]

    @property
    def policy(self) -> dict:
        return self.config["policy"]

    @property
    def bank(self):
        return self.config.get("bank")

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    @property
    def sync_every(self) -> int:
        return int(self.traffic["sync_every"])

    @property
    def checked_steps(self) -> int:
        return int(self.workload["checked_steps"])

    @property
    def limits(self) -> dict:
        return self.workload["limits"]

    def ppo(self) -> dict:
        """The PPO fields as run: the configuration's, then the traffic's
        update path, with the minibatch and epochs of the job's shape."""
        ppo = dict(self.config["ppo"])
        ppo.update(self.traffic.get("ppo", {}))
        ppo.update(minibatch_size=self.minibatch_size, epochs=self.epochs)
        return ppo


def spec(cell: str, overrides: dict | None = None) -> Spec:
    """The ``Spec`` of ``cell``; ``overrides`` (tests and rehearsals only)
    replaces ``num_envs``, ``unroll_length`` or the bank's entries."""
    workload = _load("workloads", cell)
    config = _load("configs", workload["config"])
    traffic = _load("traffic", workload["traffic"])
    overrides = dict(overrides or {})
    if "bank" in overrides:
        config = dict(config, bank=dict(config["bank"], **overrides.pop("bank")))
    n = int(overrides.pop("num_envs", traffic["num_envs"]))
    t = int(overrides.pop("unroll_length", traffic["unroll_length"]))
    if overrides:
        raise KeyError(f"unknown overrides {sorted(overrides)}")
    batch = n * t
    per_epoch = int(traffic["minibatches_per_epoch"])
    if batch % per_epoch:
        raise ValueError(f"batch {batch} does not split into {per_epoch} "
                         f"minibatches")
    return Spec(cell=cell, config=config, traffic=traffic, workload=workload,
                num_envs=n, unroll_length=t, epochs=int(traffic["epochs"]),
                minibatch_size=batch // per_epoch)


def train_config(s: Spec, seed: int):
    """The port's ``TrainConfig`` of ``s``: the preset's, with every env,
    PPO and curriculum field the configuration and traffic state."""
    from tpu_plume_torch.core.config import (
        CurriculumConfig,
        EnvConfig,
        PPOConfig,
        RolloutConfig,
        get_preset,
    )

    def tuples(d: dict) -> dict:
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    base = get_preset(s.config["preset"])
    return base.replace(
        env=EnvConfig(**tuples(s.env)),
        ppo=PPOConfig(**tuples(s.ppo())),
        curriculum=CurriculumConfig(**s.config["curriculum"]),
        rollout=RolloutConfig(num_envs=s.num_envs,
                              unroll_length=s.unroll_length),
        seed=int(seed))


@dataclasses.dataclass
class Metric:
    """A per-layer metric: its file's entries and its reader."""

    name: str
    entry: dict
    kernels: tuple
    read: object     # read(ctx, metric) -> float | None


_MODULES: dict = {}


def _module(path: str):
    """The Python file at ``path``, executed once and kept by its path."""
    if path not in _MODULES:
        mod_spec = importlib.util.spec_from_file_location(
            f"plumebench_file_{len(_MODULES)}", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def metrics() -> list:
    """Every per-layer metric in ``metrics/``, each with its reader."""
    out = []
    for name in names("metrics"):
        entry = _load("metrics", name)
        kernels = list(entry.get("kernels", ()))
        for extra in sorted(glob.glob(os.path.join(
                ROOT, "metrics", f"{glob.escape(name)}.kernels.*.json"))):
            with open(extra) as fh:
                kernels += json.load(fh)["kernels"]
        read = _module(os.path.join(ROOT, "metrics", f"{name}.py")).read
        out.append(Metric(name=name, entry=entry, kernels=tuple(kernels),
                          read=read))
    return out


def _reference(kind: str, name: str):
    """The module ``reference/<kind>_<name>.py`` under ``ROOT``."""
    where = os.path.join(ROOT, "reference")
    path = os.path.join(where, f"{kind}_{name}.py")
    if not os.path.isfile(path):
        have = sorted(os.path.basename(p)[len(kind) + 1:-3] for p in
                      glob.glob(os.path.join(where, f"{kind}_*.py")))
        raise KeyError(f"no reference {kind} {name!r}; found {have}")
    return _module(path)


def reference_field(s: Spec):
    """The reference's field module the configuration names
    (``reference/field_<name>.py``)."""
    return _reference("field", s.config["reference"]["field"])


def reference_policy(s: Spec):
    """The reference's policy module of the program's architecture as run
    (``reference/policy_<ppo.arch>.py``): its parameter layout, shuffles,
    carry, rollout step, minibatches and forward, and its multiply-adds
    per row (``reference/__init__.py``)."""
    return _reference("policy", s.ppo()["arch"])
