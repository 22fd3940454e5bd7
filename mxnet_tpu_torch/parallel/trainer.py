"""``DataParallelTrainer``: the one-device dense path of the JAX
package's ``parallel/trainer.py``.

``step(data, label)`` runs the forward, the loss (the mean of
``loss_fn(block(*data), label)``), the backward and the optimizer update
over every trainable parameter, and returns the loss.  In the reference
``fuse_step=True`` compiles the three into one XLA program; here they are
one eager call either way, so ``fuse_step`` is accepted for the same call
site and changes nothing.  Gradients are ``torch.autograd.grad`` of the
loss, never accumulated in ``.grad``.  Not ported: meshes of more than
one device, ``step_multi``, a captured (CUDA-graph) step, gradient
compression and sharding plans.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import optimizer as opt
from ..base import MXNetError
from .mesh import make_mesh

__all__ = ["DataParallelTrainer"]


class DataParallelTrainer:
    """Trains ``block`` (initialized) on a one-device mesh.

    Args:
      block: the model, an ``nn.Module`` with its parameters on the
        mesh's device.
      loss_fn: ``(outputs, label) -> loss`` tensor; the step takes its
        mean.
      optimizer: the optimizer's name, ``"adam"``.
      optimizer_params: its keyword arguments.
      mesh: ``make_mesh({"dp": 1}, devices=[...])``; default: the mesh
        of the block's device.
      fuse_step: accepted for the reference's call site (see the module
        docstring).
    """

    def __init__(self, block, loss_fn: Callable, optimizer: str,
                 optimizer_params=None, mesh=None, fuse_step: bool = False):
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = opt.create(optimizer, **(optimizer_params or {}))
        if not isinstance(self.optimizer, opt.Adam):
            raise MXNetError(f"optimizer {optimizer!r} is not ported for "
                             "DataParallelTrainer, which has 'adam'")
        self._params = [p for p in block.parameters() if p.requires_grad]
        if not self._params:
            raise MXNetError("the block has no trainable parameters")
        if mesh is None:
            mesh = make_mesh({"dp": 1}, devices=[self._params[0].device])
        if "dp" not in mesh.shape:
            raise MXNetError(f"the mesh {mesh} has no 'dp' axis")
        self.mesh = mesh
        dev = mesh.device
        for p in self._params:
            if p.device != dev:
                raise MXNetError(f"a parameter is on {p.device}, the mesh "
                                 f"on {dev}: initialize the block on the "
                                 "mesh's device")
        self._states = [self.optimizer.create_state(p)
                        for p in self._params]
        self.num_update = 0

    def _put(self, x):
        if x is None:
            return None
        return torch.as_tensor(x, device=self.mesh.device)

    def step(self, data, label):
        """One training step on the batch; returns the loss (a 0-d tensor
        on the device, not synchronised)."""
        if not isinstance(data, (tuple, list)):
            data = (data,)
        data = tuple(self._put(x) for x in data)
        label = self._put(label)
        was_training = self.block.training
        self.block.train()
        try:
            with torch.enable_grad():
                loss = self.loss_fn(self.block(*data), label).mean()
                grads = torch.autograd.grad(loss, self._params,
                                            allow_unused=True,
                                            materialize_grads=True)
        finally:
            self.block.train(was_training)
        self.num_update += 1
        self.optimizer.update(self._params, grads, self._states,
                              self.num_update)
        return loss.detach()
