"""``DataParallelTrainer``: the dense, compressed and ZeRO steps of the
JAX package's ``parallel/trainer.py``, one process a rank.

``step(data, label)`` takes the **global** batch on every rank, as the
reference's does.  Rank r of the mesh's ``dp`` axis (W ranks, one card
each, ``python -m mxnet_tpu_torch.launch -n W``) keeps its block of rows,
``[r B/W, (r+1) B/W)``, as ``P("dp")`` gives device r; it runs the
forward, the loss (the mean of ``loss_fn(block(*data), label)`` over its
rows), the backward (``torch.autograd.grad``, never accumulated in
``.grad``) and an exchange of the gradients over the dp group, then the
optimizer's update; the loss returned is the mean over the global batch,
so the W ranks compute what the JAX package computes with ``dp=W``.
BatchNorm's training statistics inside the step are the global batch's
(``parallel.mesh.sync_batch_stats``), as XLA computes them over the
mesh.  The exchange:

* **dense**: the gradients, in flat buckets of up to ``BUCKET_BYTES``
  (one all-reduce a bucket, not one a parameter), summed and divided by
  W;
* ``compression={"type": "int8"}``: every gradient through
  ``collectives.quantized_psum`` (one int8 all-to-all and one int8
  all-gather a step for all of them), divided by W;
* ``compression={"type": "2bit", "threshold": t}``: through
  ``collectives.twobit_psum``, each rank keeping its residuals across
  steps;
* ``MXTPU_ZERO_STAGE=1`` or ``2`` (``fuse_step=True``; W > 1, or a
  launched job of one rank): ZeRO.
  Stage 1 all-reduces the gradients (int8 with ``compression``) and
  cuts this rank's slice, stage 2 reduce-scatters them (int8: the
  quantized reduce-scatter); the rule updates only the rank's flat
  slice of every parameter (each flat zero-padded to a multiple of W,
  slice r of it), against states of 1/W the size, and the new slices are
  all-gathered into the weights.  An ineligible trainer (no
  ``fuse_step``, 2bit compression, multi-precision) warns and runs stage
  0, as the reference does.

The optimizer is one of the reference's ``_FUSED_RULES``: ``"adam"`` or
``"sgd"`` (with or without momentum), each one multi-tensor update over
every parameter; NAG, RMSProp, AdamW and AdaGrad, each the optimizer's
own update.  A block with deferred parameter shapes gets them from one
predict-mode call on the first batch, without recording.  Updates the
forward makes in place (BatchNorm's running statistics) happen inside
the step.  Given NDArrays, the block and ``loss_fn`` see NDArrays,
recorded as inside ``autograd.record()``, and the loss comes back as an
NDArray on the mesh's context; given tensors or numpy arrays, they see
tensors and the loss is a 0-d tensor.

``fuse_step=True`` makes the step one CUDA-graph replay on the card
(``_capture.StepCapture``), the collectives inside the graph: the first
step of each input signature runs eagerly (which also sets the NCCL
communicator up), the next is captured, and every later one replays;
the per-step scalars go in through device tensors.  A capture that fails
raises (with NCCL, a torch that cannot capture a collective raises
here).  ``step_multi`` runs K such steps over (K, B, ...) batches, or
over one batch with ``repeat=K``, and returns the K losses.  On the CPU
the same step body runs eagerly, over gloo.  ``state_bytes`` is this
rank's optimizer-state memory.

``param_sharding=`` (a ``(name, shape) -> PartitionSpec | None`` rule
over the gluon names, as ``parallel.moe_param_rule`` and
``planning.llama_param_rule`` make) and ``plan=`` (a ``ShardingPlan``:
its axes make the mesh, its rules the layout, its ``zero_stage``
overrides ``MXTPU_ZERO_STAGE``; default the plan ``MXTPU_SHARDING_PLAN``
names, which explicit arguments override) lay the parameters out over
the mesh's other axes (tensor and expert parallel), with the reference's
conflicts: ``plan`` with ``param_sharding``, a ``dp_axis`` or ``mesh``
unlike the plan's, and compression with a rule each raise; a rule makes
ZeRO ineligible.  Such a layout runs on ``torch.distributed.tensor``: the
mesh becomes a ``DeviceMesh`` of the same ranks and axis names, each
parameter a ``DTensor`` sharded as its spec says
(``planner.placements``), the rank's rows a ``DTensor`` sharded over
``dp`` and whole on the other axes, and the forward, the loss and
``torch.autograd.grad`` run on them under ``implicit_replication`` (a
tensor the model makes is whole on every rank).  So each product on a
sharded weight runs on this rank's shard and DTensor inserts the
collectives, as GSPMD does under the JAX trainer; attention runs its
kernels on each rank's batch rows and heads (``ops.attention``).  Each
gradient is reduced to its parameter's placements, the optimizer
updates this rank's shards (its states are the shards' size), and the
block's own tensors receive the gathered weights after every step.  A
sharded layout needs a process group (a launched job, of one rank on a
one-card machine) and runs eagerly, without the CUDA graph.  A plan
whose rules shard nothing on its mesh is data parallel, as in the
reference.  The reference's RMSProp rule runs the plain update whatever
``centered`` says; the port's runs the optimizer's own (ROADMAP queue
3, R2).  The reference's compressed and ZeRO steps normalise BatchNorm
over each device's rows; the port's over the global batch in every
variant (R10).
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, NamedTuple

import torch
from torch.nn.parameter import UninitializedParameter

from .. import autograd
from .. import optimizer as opt
from .._capture import StepCapture
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _ctx_of
from . import collectives as col
from . import zero
from .mesh import make_mesh, sync_batch_stats

__all__ = ["DataParallelTrainer"]


class _Rule(NamedTuple):
    """How a fused step creates an optimizer's states, stages its
    per-step scalars for step ``t`` and updates every parameter."""
    states: Callable
    stage: Callable
    apply: Callable
    static_key: Callable


def _per_tensor_rule():
    """The rule of an optimizer whose update is one op a parameter
    (``optimizer._PerTensor``)."""
    return _Rule(
        lambda o, params: [o.create_tensor_state(p) for p in params],
        lambda o, device, t: o.stage(device, t),
        lambda o, params, grads, states, scalars: o.apply_tensors(
            params, list(grads), states, scalars),
        lambda o: o.static_key(()))


# the reference's _FUSED_RULES (parallel/trainer.py:90-135)
_FUSED_RULES = {
    "Adam": _Rule(
        lambda o, params: [(torch.zeros_like(p), torch.zeros_like(p))
                           for p in params],
        lambda o, device, t: o.stage(device, t),
        lambda o, params, grads, states, scalars: o.apply_tensors(
            params, list(grads), states, scalars),
        lambda o: o.static_key(())),
    "SGD": _Rule(
        lambda o, params: [torch.zeros_like(p) if o.momentum else None
                           for p in params],
        lambda o, device, t: o.stage(device),
        lambda o, params, grads, states, scalars: o.apply_tensors(
            params, list(grads), states, scalars),
        lambda o: o.static_key(())),
    "NAG": _per_tensor_rule(),
    "RMSProp": _per_tensor_rule(),
    "AdamW": _per_tensor_rule(),
    "AdaGrad": _per_tensor_rule(),
}


def _device_of(block):
    """The device of the block's parameters (a deferred one's is the
    device ``initialize`` named)."""
    for p in block.parameters():
        if not isinstance(p, UninitializedParameter):
            return p.device
        deferred = getattr(p, "mx_deferred", None)
        if deferred is not None:
            return torch.device(deferred[1])
    raise MXNetError("the block has no initialized parameters")


#: the largest flat bucket of the dense all-reduce (PyTorch DDP's default)
BUCKET_BYTES = 25 << 20


def _default_mesh(block):
    """``{"dp": W}`` over the process group (W its size, 1 without one),
    on the block's device."""
    import torch.distributed as dist
    w = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    return make_mesh({"dp": w}, devices=[_device_of(block)])


def _buckets(params, limit):
    """Index lists of consecutive parameters of one dtype, each list at
    most ``limit`` bytes (or one parameter past it)."""
    out, cur, size, dtype = [], [], 0, None
    for i, p in enumerate(params):
        nbytes = p.numel() * p.element_size()
        if cur and (p.dtype != dtype or size + nbytes > limit):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
        dtype = p.dtype
    if cur:
        out.append(cur)
    return out


class DataParallelTrainer:
    """Trains ``block`` (initialized) over the mesh's ``dp`` axis.

    Args:
      block: the model, an ``nn.Module`` with its parameters on this
        rank's device.
      loss_fn: ``(outputs, label) -> loss``; the step takes its mean.
      optimizer: a name (``"adam"``, ``"sgd"``, ``"nag"``, ``"rmsprop"``,
        ``"adamw"``, ``"adagrad"``) or an ``Optimizer``.
      optimizer_params: its keyword arguments.
      mesh: ``make_mesh({"dp": W})``; default: the process group's
        ranks (one without a group) on the block's device.
      dp_axis: the mesh axis the batch is split over.
      fuse_step: the step as one captured graph (see the module
        docstring); required by ``step_multi``, compression and ZeRO.
      compression: ``{"type": "int8"}`` or ``{"type": "2bit",
        "threshold": t}`` for the gradient exchange.
      param_sharding: a ``(name, shape) -> PartitionSpec | None`` rule
        over the gluon parameter names (see the module docstring).
      plan: a ``parallel.ShardingPlan``, instead of ``mesh``/
        ``dp_axis``/``param_sharding``.
    """

    def __init__(self, block, loss_fn: Callable, optimizer,
                 optimizer_params=None, mesh=None, dp_axis: str = "dp",
                 param_sharding=None, fuse_step: bool = False,
                 compression=None, plan=None):
        from . import planner
        # the environment's plan is ambient: explicit layout arguments
        # win over it (a rule skips it; a mesh or dp_axis unlike it
        # warns and keeps the arguments); an explicit plan= is strict
        if plan is None and param_sharding is None:
            env_plan = planner.plan_from_env()
            mesh_conflict = env_plan is not None and mesh is not None \
                and dict(mesh.shape) != dict(env_plan.axes)
            axis_conflict = env_plan is not None and \
                dp_axis not in ("dp", env_plan.dp_axis)
            if mesh_conflict or axis_conflict:
                what = "mesh axes" if mesh_conflict else "dp_axis"
                warnings.warn(
                    f"MXTPU_SHARDING_PLAN disagrees with this "
                    f"trainer's explicit {what}; ignoring the env "
                    "plan (explicit args win)", stacklevel=2)
            else:
                plan = env_plan
        if plan is not None:
            if not isinstance(plan, planner.ShardingPlan):
                raise MXNetError(
                    f"plan= must be a parallel.ShardingPlan, got "
                    f"{type(plan).__name__}")
            if param_sharding is not None:
                raise MXNetError(
                    "pass plan= OR param_sharding=, not both — the "
                    "plan's rules ARE the param layout")
            if dp_axis not in ("dp", plan.dp_axis):
                raise MXNetError(
                    f"dp_axis {dp_axis!r} conflicts with the plan's "
                    f"dp_axis {plan.dp_axis!r}")
            dp_axis = plan.dp_axis
            if mesh is None:
                mesh = plan.build_mesh(devices=[_device_of(block)])
            elif dict(mesh.shape) != dict(plan.axes):
                raise MXNetError(
                    f"mesh axes {dict(mesh.shape)} do not match the "
                    f"plan's {dict(plan.axes)}")
            param_sharding = plan.param_rule()
        self.plan = plan
        self._param_sharding = param_sharding
        if param_sharding is not None and compression is not None:
            raise MXNetError(
                "gradient compression is a data-parallel wire "
                "optimization; it cannot combine with a "
                "param_sharding (tensor-parallel) rule")
        self.block = block
        self.loss_fn = loss_fn
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self.optimizer = optimizer
        else:
            self.optimizer = opt.create(optimizer,
                                        **(optimizer_params or {}))
        self._rule = _FUSED_RULES.get(type(self.optimizer).__name__)
        if self._rule is None:
            raise MXNetError(f"optimizer {type(self.optimizer).__name__} "
                             "has no fused rule (the reference's "
                             "two-phase step for it is not ported); "
                             "DataParallelTrainer has "
                             f"{sorted(r.lower() for r in _FUSED_RULES)}")
        if mesh is None:
            mesh = _default_mesh(block)
        if dp_axis not in mesh.shape:
            raise MXNetError(f"the mesh {mesh} has no {dp_axis!r} axis")
        self.mesh = mesh
        self.dp_axis = dp_axis
        self._axis = col._axis(dp_axis, mesh)
        self._n = self._axis.n
        self._params = None
        self.num_update = 0
        self._fuse = bool(fuse_step)
        self._capture = StepCapture("DataParallelTrainer.step")
        self._scalars = None
        self._compression = self._check_compression(compression)
        self._zero_stage = self._choose_zero_stage()
        self._dmesh = None
        if not any(isinstance(p, UninitializedParameter)
                   for p in block.parameters()):
            self._setup()

    def _check_compression(self, compression):
        if compression is None:
            return None
        cfg = dict(compression)
        ctype = cfg.get("type")
        if ctype not in ("int8", "2bit"):
            raise MXNetError(f"compression type must be 'int8' or '2bit', "
                             f"got {ctype!r}")
        allowed = {"type", "threshold"} if ctype == "2bit" else {"type"}
        unknown = set(cfg) - allowed
        if unknown:
            raise MXNetError(
                f"unknown compression option(s) {sorted(unknown)} for type "
                f"{ctype!r} (allowed: {sorted(allowed)})")
        if ctype == "2bit":
            cfg["threshold"] = float(cfg.get("threshold", 0.5))
            if not cfg["threshold"] > 0:
                raise MXNetError("compression threshold must be positive")
        if not self._fuse:
            raise MXNetError("gradient compression requires fuse_step=True "
                             "(the compressed exchange lives inside the "
                             "step)")
        return cfg

    def _choose_zero_stage(self):
        """The plan's ``zero_stage`` when it sets one, else
        ``MXTPU_ZERO_STAGE``, when this trainer can shard its update,
        else 0 (with a warning, as the reference).  A dp axis of one rank
        shards only in a launched job (a process group of one), where
        the slice is the whole parameter and the collectives still run."""
        if self.plan is not None and self.plan.zero_stage is not None:
            stage = int(self.plan.zero_stage)
        else:
            stage = zero.stage_from_env()
        if not stage or (self._n == 1 and self._axis.group is None):
            return 0
        reason = zero.eligibility(self._fuse, self._compression,
                                  self.optimizer, self._param_sharding)
        if reason is not None:
            warnings.warn(f"MXTPU_ZERO_STAGE={stage} requested but this "
                          f"trainer cannot shard its update ({reason}); "
                          "running stage 0", stacklevel=3)
            return 0
        return stage

    def _setup(self):
        """The trainable parameters, the optimizer's states (this rank's
        slices under ZeRO) and the exchange's buffers, once every
        parameter shape is known."""
        self._params = [p for p in self.block.parameters()
                        if p.requires_grad]
        if not self._params:
            raise MXNetError("the block has no trainable parameters")
        dev = self.mesh.device
        for p in self._params:
            if p.device != dev:
                raise MXNetError(f"a parameter is on {p.device}, the mesh "
                                 f"on {dev}: initialize the block on the "
                                 "mesh's device")
        self._dmesh = None
        if self._param_sharding is not None:
            self._setup_sharded()
            return
        self._buckets = _buckets(self._params, BUCKET_BYTES)
        if self._zero_stage:
            self._layout = col._layout([p.numel() for p in self._params],
                                       self._n)
            chunks = self._layout[0]
            self._states = self._rule.states(
                self.optimizer,
                [torch.zeros(c, dtype=torch.float32, device=dev)
                 for c in chunks])
        else:
            self._states = self._rule.states(self.optimizer, self._params)
        self._residuals = None
        if self._compression and self._compression["type"] == "2bit":
            self._residuals = [torch.zeros_like(p, dtype=torch.float32)
                               for p in self._params]

    def _setup_sharded(self):
        """The rule's layout on ``torch.distributed.tensor``: the
        ``DeviceMesh`` of the mesh's ranks and axis names, each trainable
        parameter's placements and its ``DTensor`` (this rank's shard,
        from rank 0's values), the batch's placements (rows over ``dp``,
        whole elsewhere) and the optimizer's states of the shards."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        from . import planner
        if not (dist.is_available() and dist.is_initialized()):
            raise MXNetError(
                "a param_sharding layout runs on torch.distributed.tensor, "
                "which needs a process group: start the job with `python "
                "-m mxnet_tpu_torch.launch -n W ...` (W = 1 on one card)")
        mesh = self.mesh
        axes = list(mesh.shape)
        dm = getattr(mesh, "_device_mesh", None)
        if dm is None:
            dm = DeviceMesh(mesh.device.type, torch.arange(mesh.size).reshape(
                [int(mesh.shape[a]) for a in axes]),
                mesh_dim_names=tuple(axes))
            mesh._device_mesh = dm
        gluon = {id(p._tensor): name
                 for name, p in self.block.collect_params().items()}
        named = [(n, t) for n, t in self.block.named_parameters()
                 if t.requires_grad]
        self._placements = [list(pl) for pl in planner.resolve_shardings(
            mesh, [(gluon.get(id(t), n), tuple(t.shape)) for n, t in named],
            self._param_sharding)]
        dparams = {n: distribute_tensor(t.detach(), dm, pl).requires_grad_()
                   for (n, t), pl in zip(named, self._placements)}
        self._dparams = dparams
        self._dmesh = dm
        self._batch_pl = [Shard(0) if a == self.dp_axis else Replicate()
                          for a in axes]
        self._states = self._rule.states(
            self.optimizer, [d.to_local() for d in dparams.values()])

    def _sharded_body(self, nd_in, given, *tensors):
        """One step of a sharded layout: the rank's rows as ``DTensor``s,
        the block over the parameters' ``DTensor``s
        (``functional_call``), the global mean loss, the gradients
        reduced to each parameter's placements, the optimizer on this
        rank's shards, and the gathered weights into the block."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        dm = self._dmesh
        it = iter(tensors)
        data = [DTensor.from_local(next(it), dm, self._batch_pl)
                if g else None for g in given]
        label = DTensor.from_local(next(it), dm, self._batch_pl)
        params = list(self._dparams.values())
        with implicit_replication(), torch.enable_grad():
            if nd_in:
                ctx = _ctx_of(self.mesh.device)
                with autograd.record():
                    out = torch.func.functional_call(
                        self.block, self._dparams,
                        tuple(None if t is None else NDArray(t, ctx=ctx)
                              for t in data))
                    loss = self.loss_fn(out, NDArray(label, ctx=ctx))
            else:
                out = torch.func.functional_call(self.block, self._dparams,
                                                 tuple(data))
                loss = self.loss_fn(out, label)
            loss = (loss.tensor if isinstance(loss, NDArray)
                    else loss).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            grads = [g.redistribute(dm, pl).to_local()
                     for g, pl in zip(grads, self._placements)]
            self._rule.apply(self.optimizer,
                             [p.to_local() for p in params], grads,
                             self._states, self._scalars)
            named = dict(self.block.named_parameters())
            for name, p in self._dparams.items():
                named[name].copy_(p.full_tensor())
            loss = loss.detach().full_tensor()
        return (loss,)

    def _resolve_shapes(self, data):
        """One predict-mode call without recording, so that every
        deferred parameter shape is known (the reference's ``_setup``)."""
        with autograd.pause(), torch.no_grad():
            self.block(*[None if x is None else NDArray(x)
                         for x in data])
        self._setup()

    @property
    def captures(self):
        """Graphs captured (one a signature, again after a static
        attribute changed)."""
        return self._capture.captures

    @property
    def replays(self):
        """Steps run as a graph replay."""
        return self._capture.replays

    @property
    def pool_bytes(self):
        """Device memory the live graphs reserved."""
        return self._capture.pool_bytes

    @property
    def zero_stage(self):
        return self._zero_stage

    @property
    def state_bytes(self):
        """This rank's optimizer-state bytes (its slices under ZeRO)."""
        def size(s):
            if isinstance(s, torch.Tensor):
                return s.numel() * s.element_size()
            if isinstance(s, (list, tuple)):
                return sum(size(x) for x in s)
            return 0
        return size(self._states) if self._params is not None else 0

    def _put(self, x):
        if x is None:
            return None
        if isinstance(x, NDArray):
            x = x.tensor
        return torch.as_tensor(x, device=self.mesh.device)

    def _inputs(self, data, label):
        if not isinstance(data, (tuple, list)):
            data = (data,)
        nd_in = any(isinstance(x, NDArray) for x in (*data, label))
        return [self._put(x) for x in data], self._put(label), nd_in

    def _shard(self, x):
        """This rank's block of rows of the global batch ``x``."""
        if x is None or self._n == 1:
            return x
        b = x.shape[0]
        if b % self._n:
            raise MXNetError(f"the global batch {b} does not divide over "
                             f"{self._n} dp ranks")
        r = self._axis.index
        return x[r * (b // self._n):(r + 1) * (b // self._n)]

    def _out(self, loss, nd_in):
        return NDArray(loss, ctx=_ctx_of(loss.device)) if nd_in else loss

    # -- the step body -----------------------------------------------------
    def _body(self, nd_in, given, *tensors):
        """One step on this rank's rows (the data inputs that are not
        None, as ``given`` marks them, then the label): what a graph
        captures.  The update reads the scalars staged in ``_run``."""
        it = iter(tensors)
        data = [next(it) if g else None for g in given]
        label = next(it)
        group = self._axis.group if self._n > 1 else None
        with sync_batch_stats(group):
            if nd_in:
                ctx = _ctx_of(label.device)
                with autograd.record():
                    loss = self.loss_fn(
                        self.block(*[None if t is None else
                                     NDArray(t.detach(), ctx=ctx)
                                     for t in data]),
                        NDArray(label.detach(), ctx=ctx))
            else:
                with torch.enable_grad():
                    loss = self.loss_fn(self.block(*data), label)
            with torch.enable_grad():
                loss = (loss.tensor if isinstance(loss, NDArray)
                        else loss).mean()
                grads = torch.autograd.grad(loss, self._params,
                                            allow_unused=True,
                                            materialize_grads=True)
        loss = loss.detach()
        if self._axis.group is not None:
            loss = col._all_reduce(loss, self._axis) / self._n
        if self._zero_stage:
            self._zero_update(grads)
        else:
            self._rule.apply(self.optimizer, self._params,
                             self._exchange(grads), self._states,
                             self._scalars)
        return (loss,)

    def _exchange(self, grads):
        """The gradients of the global mean loss: this rank's, summed
        over the dp group (dense buckets, int8 or 2bit) and divided by
        W."""
        ax, n = self._axis, self._n
        if self._compression is None:
            if ax.group is None:
                return grads
            out = [None] * len(grads)
            for bucket in self._buckets:
                flat = torch.cat([grads[i].reshape(-1) for i in bucket])
                col._all_reduce_(flat, ax).div_(n)
                pieces = flat.split([grads[i].numel() for i in bucket])
                for i, piece in zip(bucket, pieces):
                    out[i] = piece.view_as(grads[i])
            return out
        if self._compression["type"] == "int8":
            return [g / n for g in col.quantized_psum_many(grads, ax)]
        sums, res = col.twobit_psum_many(
            grads, ax, threshold=self._compression["threshold"],
            residuals=self._residuals)
        with torch.no_grad():
            for r, new in zip(self._residuals, res):
                r.copy_(new)
        return [s / n for s in sums]

    def _zero_update(self, grads):
        """ZeRO: this rank's slice of every gradient (stage 1: cut from
        the all-reduced gradients; stage 2: reduce-scattered), the rule
        on the slices of the flat parameters, the slices all-gathered."""
        ax, n, r = self._axis, self._n, self._axis.index
        chunks, offs, total = self._layout
        int8 = self._compression is not None
        if self._zero_stage == 1:
            full = col.quantized_psum_many(grads, ax) if int8 else [
                g.reshape(-1).to(torch.float32) for g in grads]
            if not int8:
                flat = torch.cat(full)
                col._all_reduce_(flat, ax)
                full = flat.split([g.numel() for g in grads])
            g_local = self._local_slices(full)
        elif int8:
            g_local = torch.cat(col.quantized_reduce_scatter_many(grads, ax))
        else:
            g_local = col._scatter_rows(col._rows(
                [g.reshape(-1).to(torch.float32) for g in grads], n, chunks,
                offs, total, torch.float32), ax)
        g_local = g_local / n
        p_local = self._local_slices([p.detach() for p in self._params])
        p_sl = [p_local[o:o + c] for c, o in zip(chunks, offs)]
        g_sl = [g_local[o:o + c] for c, o in zip(chunks, offs)]
        self._rule.apply(self.optimizer, p_sl, g_sl, self._states,
                         self._scalars)
        rows = col._gather_rows(p_local, ax)
        with torch.no_grad():
            for p, c, o in zip(self._params, chunks, offs):
                p.copy_(rows[:, o:o + c].reshape(-1)[:p.numel()]
                        .view(p.shape))

    def _local_slices(self, tensors):
        """(C,) f32: slice r of each tensor's zero-padded flat, side by
        side (the ZeRO layout)."""
        r = self._axis.index
        chunks, offs, total = self._layout
        out = torch.zeros(total, dtype=torch.float32,
                          device=self.mesh.device)
        for t, c, o in zip(tensors, chunks, offs):
            flat = t.reshape(-1)
            lo, hi = r * c, min((r + 1) * c, flat.numel())
            if hi > lo:
                out[o:o + hi - lo] = flat[lo:hi]
        return out

    def _run(self, data, label, nd_in):
        """Stage step ``num_update + 1``'s scalars and run the step on
        this rank's rows (captured or replayed with ``fuse_step``);
        returns the loss."""
        from ..contrib import amp
        data = [self._shard(x) for x in data]
        label = self._shard(label)
        if self._params is None:
            self._resolve_shapes(data)
        t = self.num_update + 1
        self._scalars = self._rule.stage(self.optimizer, self.mesh.device, t)
        given = tuple(x is not None for x in data)
        tensors = [x for x in data if x is not None] + [label]
        sharded = self._dmesh is not None
        body = functools.partial(
            self._sharded_body if sharded else self._body, nd_in, given)
        was_training = self.block.training
        self.block.train()
        try:
            if self._fuse and not sharded:
                key = (nd_in, given, self._rule.static_key(self.optimizer),
                       amp.target_dtype(), self._zero_stage,
                       None if self._compression is None
                       else tuple(sorted(self._compression.items())))
                (loss,) = self._capture.run(body, tensors, key)
            else:
                (loss,) = body(*tensors)
        finally:
            self.block.train(was_training)
        self.num_update = t
        return loss

    def step(self, data, label):
        """One training step on the global batch; returns the loss (0-d,
        on the device, not synchronised): an NDArray when NDArrays came
        in."""
        data, label, nd_in = self._inputs(data, label)
        loss = self._run(data, label, nd_in)
        # a replay's output is the graph's buffer, which the next
        # replay overwrites
        return self._out(loss.clone() if self._fuse and self._dmesh is None
                         else loss, nd_in)

    def step_multi(self, data, label, repeat=None):
        """K steps: over (K, B, ...) ``data`` and (K, B, ...) ``label``,
        or over one batch ``repeat=K`` times.  Returns the (K,) losses;
        the result is that of K ``step()`` calls.  Requires
        ``fuse_step=True``."""
        if not self._fuse:
            raise MXNetError("step_multi requires fuse_step=True")
        data, label, nd_in = self._inputs(data, label)
        if repeat is not None:
            k = int(repeat)
            if k <= 0:
                raise MXNetError(f"step_multi: repeat must be positive, "
                                 f"got {repeat}")
            batches = [(data, label)] * k
        else:
            k = label.shape[0]
            if any(x is not None and x.shape[0] != k for x in data):
                raise MXNetError(
                    f"step_multi: the leading dims of data "
                    f"{[None if x is None else tuple(x.shape) for x in data]}"
                    f" and label {tuple(label.shape)} must all be K")
            batches = [([None if x is None else x[i] for x in data],
                        label[i]) for i in range(k)]
        losses = None
        for i, (d, l) in enumerate(batches):
            loss = self._run(d, l, nd_in)
            if losses is None:
                losses = loss.new_empty((k,) + tuple(loss.shape))
            losses[i].copy_(loss)
        return self._out(losses, nd_in)
