"""Data parallel over ``torch.distributed`` (port of
``tpu_plume/parallel/mesh.py``).

JAX lays the env axis over a 1-D device mesh and lets XLA insert the
collectives.  The port runs one process per device, each holding ``N / W``
of the N envs (its rank's contiguous slice), and a replica of the learner.
The train step keeps one invariant: **W ranks compute the step that one
process computes on N envs** (``train/ppo_trainer.py`` ``build_train_step``
and ``train/gail_trainer.py`` read the loop's ``mesh``):

- every rank draws the chunk's randomness at the global [T, N] shapes from
  the same seeded generator and takes its slice (``ChunkDraws.envs``), so
  the trajectories are the single process's;
- advantages are normalized over the global batch, the minibatch shuffles
  are drawn globally and each rank takes its rows of each global
  minibatch, its loss the sum over them divided by the global size; the
  gradients are summed over the ranks before the global-norm clip, so
  every rank's Adam step is the same;
- episode counts and the logged means are summed over the ranks before
  the curriculum reads them.

At world size 1 the statistics are the plain step's and each collective
is the identity, so the step equals the plain step bit for bit.  The
process group is the caller's: ``torch.distributed.init_process_group``
(NCCL on the card, gloo on the CPU) before ``make_mesh``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpu_plume_torch.core.tree import flatten, tree_map


@dataclass(frozen=True)
class Mesh:
    """The rank's place in the data-parallel group: ``rank`` of
    ``world_size`` processes, its ``device``, and whether collectives run
    (``grouped``: a process group is initialized; without one the mesh is
    the trivial world of one and each collective is a no-op)."""

    rank: int
    world_size: int
    device: torch.device
    grouped: bool

    def envs(self, num_envs: int) -> slice:
        """The rank's slice of ``num_envs`` envs."""
        n = num_envs // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (a new tensor)."""
        x = x.detach().clone()
        if self.grouped:
            dist.all_reduce(x)
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean of a tensor of which each rank holds an equal
        share: the mean of the ranks' means."""
        return self.sum(x.mean() / self.world_size)

    def sum_grads(self, params) -> None:
        """Each parameter's ``.grad`` summed over the ranks, in place, in
        one collective."""
        grads = [p.grad for p in params if p.grad is not None]
        if not self.grouped or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    def broadcast(self, x: torch.Tensor) -> None:
        """Rank 0's ``x`` in every rank's ``x``, in place (through the
        mesh's device where the backend needs it there)."""
        if not self.grouped:
            return
        if x.device == self.device:
            dist.broadcast(x, 0)
            return
        y = x.to(self.device)
        dist.broadcast(y, 0)
        x.copy_(y.to(x.device))


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """The data-parallel mesh of this process: its rank, the world size
    and its device in the initialized process group (NCCL: the card of
    rank ``rank % device_count``; gloo: the CPU, or ``device``), or a world
    of one without a group.  Asking for more devices than the group has
    ranks raises ``ValueError``."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        nccl = dist.get_backend() == "nccl"
    else:
        world, rank, nccl = 1, 0, False
    if num_devices is not None and num_devices != world:
        if num_devices > world:
            raise ValueError(f"requested {num_devices} devices, only {world} "
                             f"available (one process per device)")
        raise ValueError(f"requested {num_devices} devices of a group of "
                         f"{world}: start {num_devices} processes")
    if device is None:
        device = (f"cuda:{rank % torch.cuda.device_count()}" if nccl
                  else "cpu")
    return Mesh(rank=rank, world_size=world, device=torch.device(device),
                grouped=dist.is_available() and dist.is_initialized())


def shard_batch(tree, mesh: Mesh):
    """The rank's slice of the leading (env or batch) axis of every tensor
    of ``tree``, in memory of its own."""
    return tree_map(lambda x: x[mesh.envs(x.shape[0])].clone(), tree)


def replicate(obj, mesh: Mesh):
    """Rank 0's copy of ``obj`` on every rank, in place: a module's
    parameters and buffers, an optimizer's state (``ClippedAdam`` or a
    ``torch.optim`` optimizer), a generator's state, or the tensors of a
    tree (``core.tree``).  Returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        for x in list(obj.parameters()) + list(obj.buffers()):
            mesh.broadcast(x.data)
    elif isinstance(obj, torch.Generator):
        state = obj.get_state()
        mesh.broadcast(state)
        obj.set_state(state)
    elif hasattr(obj, "adam"):
        replicate(obj.adam, mesh)
    elif isinstance(obj, torch.optim.Optimizer):
        for state in obj.state.values():
            for x in state.values():
                if isinstance(x, torch.Tensor):
                    mesh.broadcast(x)
    else:
        for x in flatten(obj)[0]:
            mesh.broadcast(x)
    return obj


def shard_loop_carry(loop, mesh: Mesh):
    """A ``ppo_trainer.LoopCarry`` laid out for data parallel: the env
    state, obs, episode accumulators, recurrent carry and guide state cut
    to the rank's ``N / W`` envs, the model, optimizer and generator
    replicated from rank 0, and the mesh kept in the carry, so that the
    train step reads the layout from the state it is given."""
    num_envs = loop.rollout.obs.shape[0]
    if num_envs % mesh.world_size != 0:
        raise ValueError(
            f"num_envs={num_envs} must be divisible by the mesh size "
            f"{mesh.world_size} to shard the env axis evenly")
    r = loop.rollout
    rollout = dataclasses.replace(
        r, env_state=shard_batch(r.env_state, mesh),
        obs=shard_batch(r.obs, mesh), accum=shard_batch(r.accum, mesh),
        hidden=shard_batch(r.hidden, mesh),
        guide_state=shard_batch(r.guide_state, mesh))
    for part in (loop.model, loop.optimizer, loop.generator):
        replicate(part, mesh)
    return dataclasses.replace(loop, rollout=rollout, mesh=mesh)


def shard_gail_carry(carry, mesh: Mesh):
    """A ``gail_trainer.GAILCarry`` laid out as ``shard_loop_carry`` lays
    out its PPO loop, the discriminator and its optimizer replicated: its
    minibatch is drawn globally, each sample counted by the rank that holds
    it, and its gradients summed over the ranks as the policy's are."""
    replicate(carry.disc, mesh)
    replicate(carry.disc_optimizer, mesh)
    return dataclasses.replace(carry, ppo=shard_loop_carry(carry.ppo, mesh))
