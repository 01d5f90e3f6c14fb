"""Data-parallel gradients and AdamW with its moments sharded over the ranks
(ZeRO-1), on flat fp32 buffers.

Counterpart of the JAX Trainer's "data" mesh axis and `shard_opt_state`
(`training/trainer.py` there: XLA turns the update into reduce-scatter,
sharded update and all-gather). Each label group of parameters (base,
cond, and the frozen parameters that still get a gradient, which count in
grad_norm) is one flat buffer, padded to a multiple of the world:

  * `reduce_grads` flattens each group's gradients and reduce-scatters them
    (`reduce_scatter_flat`), divided by the world: this rank's shard of the
    mean gradient over the ranks (all of it, by `all_reduce_sum`, when the
    moments are replicated);
  * `sq_norm` sums the squares of the shards over the ranks: the squared
    norm of the mean gradient, as `optax.global_norm` of the reduced grads;
  * `step` runs AdamW on the shard (torch.optim.AdamW's arithmetic, which
    the one-process Trainer runs) and all-gathers the updated parameters.

The JAX package shards each moment leaf on an axis; this layout differs, and
the numbers do not: the update is replicated AdamW's, and a rank holds
ceil(n / W) moment elements of each group's n. `state_dict` gathers the
moments into torch.optim.AdamW's own state dict, and `load_state_dict`
takes this rank's shard of one, so a checkpoint does not depend on the
world size.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from morphablediffusion_torch.parallel.collectives import (all_gather_cat, all_reduce_sum,
                                                           reduce_scatter_flat)
from morphablediffusion_torch.parallel.mesh import Mesh


class FlatGroup:
    """One label group's parameters as a flat buffer of `padded` elements
    (a multiple of the world), of which this rank owns [lo, hi)."""

    def __init__(self, label: str, named: Sequence[Tuple[str, torch.nn.Parameter]],
                 lr_mult: float, trainable: bool, mesh: Mesh, shard: bool):
        self.label, self.lr_mult, self.trainable = label, lr_mult, trainable
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        for n, p in named:
            if p.dtype != torch.float32:
                raise ValueError(f"{n}: the sharded optimizer takes fp32 parameters, "
                                 f"not {p.dtype}")
        self.sizes = [p.numel() for p in self.params]
        self.numel = sum(self.sizes)
        world = mesh.world if shard else 1
        self.padded = math.ceil(self.numel / world) * world
        per = self.padded // world
        self.lo, self.hi = (mesh.rank * per, (mesh.rank + 1) * per) if shard else (0, self.padded)

    def flatten(self, tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
        flat = torch.zeros(self.padded, dtype=torch.float32, device=device)
        o = 0
        for t, n in zip(tensors, self.sizes):
            flat[o:o + n] = t.reshape(-1)
            o += n
        return flat

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        out, o = [], 0
        for p, n in zip(self.params, self.sizes):
            out.append(flat[o:o + n].view_as(p))
            o += n
        return out


class ShardedAdamW:
    """AdamW over `groups` [(label, [(name, parameter)], lr_mult,
    trainable)] with the given hyper-parameters; shard=False keeps the
    moments replicated (all_reduce instead of reduce_scatter, no gather)."""

    def __init__(self, groups, mesh: Mesh, shard: bool, betas, eps: float,
                 weight_decay: float):
        if mesh.group is None:
            raise ValueError("ShardedAdamW runs on a mesh with a process group")
        self.mesh, self.shard = mesh, shard
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        self.groups = [FlatGroup(label, named, mult, trainable, mesh, self.shard)
                       for label, named, mult, trainable in groups]
        self.steps = 0
        self.exp_avg: Dict[str, torch.Tensor] = {}
        self.exp_avg_sq: Dict[str, torch.Tensor] = {}
        self.device = mesh.device

    @property
    def trainable(self) -> List[FlatGroup]:
        return [g for g in self.groups if g.trainable]

    def moment_elements(self) -> int:
        """The moment elements this rank holds (both moments)."""
        return sum(2 * (g.hi - g.lo) for g in self.trainable)

    def reduce_grads(self) -> Dict[str, torch.Tensor]:
        """This rank's shard of each group's mean gradient over the ranks
        (fp32); frees the parameters' own gradients. A parameter without a
        gradient counts as zero (optax.adamw still decays it)."""
        out = {}
        for g in self.groups:
            flat = g.flatten([p.grad if p.grad is not None else torch.zeros_like(p)
                              for p in g.params], self.device)
            for p in g.params:
                p.grad = None
            shard = (reduce_scatter_flat(flat, self.mesh) if self.shard
                     else all_reduce_sum(flat, self.mesh))
            out[g.label] = shard / self.mesh.world
        return out

    def sq_norm(self, shards: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The squared norm over the ranks of the whole of `shards`."""
        local = sum(s.pow(2).sum() for s in shards.values())
        return all_reduce_sum(local, self.mesh) if self.shard else local

    @torch.no_grad()
    def step(self, shards: Dict[str, torch.Tensor], lr: float) -> None:
        """One AdamW step of every trainable group on its gradient shard,
        torch.optim.AdamW's arithmetic (decoupled decay, bias corrections),
        then every rank's updated shard gathered into the parameters."""
        self.steps += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.steps, 1 - b2 ** self.steps
        for g in self.trainable:
            grad = shards[g.label]
            if g.label not in self.exp_avg:
                self.exp_avg[g.label] = torch.zeros_like(grad)
                self.exp_avg_sq[g.label] = torch.zeros_like(grad)
            m, v = self.exp_avg[g.label], self.exp_avg_sq[g.label]
            glr = lr * g.lr_mult
            param = g.flatten([p.detach() for p in g.params], self.device)[g.lo:g.hi]
            param.mul_(1 - glr * self.weight_decay)
            m.lerp_(grad, 1 - b1)
            v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            param.addcdiv_(m, denom, value=-glr / bc1)
            full = all_gather_cat(param, 0, self.mesh) if self.shard else param
            for p, new in zip(g.params, g.unflatten(full)):
                p.copy_(new)

    # checkpoints: torch.optim.AdamW's state dict, whatever the world

    def _gather(self, shard: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(shard, 0, self.mesh) if self.shard else shard

    def state_dict(self, template: Dict) -> Dict:
        """torch.optim.AdamW's state dict over the trainable groups (in
        their order), with `template` (an AdamW's state dict before any
        step) giving its param_groups. Every rank must call it."""
        state, index = {}, 0
        for g in self.trainable:
            if self.steps:
                ms = g.unflatten(self._gather(self.exp_avg[g.label]))
                vs = g.unflatten(self._gather(self.exp_avg_sq[g.label]))
                for m, v in zip(ms, vs):
                    state[index] = {"step": torch.tensor(float(self.steps)),
                                    "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
                    index += 1
            else:
                index += len(g.params)
        return {"state": state, "param_groups": template["param_groups"]}

    def load_state_dict(self, sd: Dict) -> None:
        """This rank's shard of torch.optim.AdamW's state dict `sd`."""
        self.exp_avg, self.exp_avg_sq, self.steps = {}, {}, 0
        if not sd["state"]:
            return
        index = 0
        for g in self.trainable:
            entries = [sd["state"][index + i] for i in range(len(g.params))]
            index += len(g.params)
            self.steps = int(entries[0]["step"])
            for key, store in (("exp_avg", self.exp_avg), ("exp_avg_sq", self.exp_avg_sq)):
                flat = g.flatten([e[key].to(self.device) for e in entries], self.device)
                store[g.label] = flat[g.lo:g.hi].clone()

    def gathered(self, shards: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{parameter name: tensor} of per-group shards gathered over the
        ranks (the accumulated gradients, for a checkpoint)."""
        out = {}
        for g in self.groups:
            for n, t in zip(g.names, g.unflatten(self._gather(shards[g.label]))):
                out[n] = t.clone()
        return out

    def shards_of(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of `gathered`: this rank's shards of full tensors."""
        return {g.label: g.flatten([tensors[n].to(self.device) for n in g.names],
                                   self.device)[g.lo:g.hi].clone() for g in self.groups}
