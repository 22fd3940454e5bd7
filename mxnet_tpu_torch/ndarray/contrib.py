"""Control-flow ops: ``foreach``, ``while_loop`` and ``cond``, as the JAX
package's ``ndarray/contrib.py`` (``mx.nd.contrib``, ``F.contrib``).

The JAX package lowers them to ``lax.scan`` and ``lax.cond`` so that a
loop is one region of its compiled program.  Here they are Python over
the body's own ops, with the reference's semantics:

* ``foreach`` runs the body once a slice of axis 0 and stacks the
  outputs.  Under ``hybridize()`` the CachedOp captures the unrolled
  loop, so a replay is still one launch from the host.
* ``while_loop`` is the reference's masked loop: the body runs
  ``max_iterations`` times, and once ``cond`` has turned false the loop
  variables stop changing and the outputs are zeros.  The predicate
  stays on the device (no host sync), so the loop can be captured.
* ``cond`` evaluates both branches and selects with ``where``, so
  nothing waits for the predicate on the host: the value is the taken
  branch's, and so is the gradient unless the other branch's own
  backward gives inf or NaN at these inputs (``0 * inf``).

PyTorch's autograd differentiates through all three, to the data, the
states and any array a body reads (the reference's closure capture).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.registry import OpDef, get_op
from .ndarray import NDArray, invoke

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(arrays):
    return invoke(get_op("stack"), arrays, axis=0)


def _where_scalar(pred, a, b):
    """``a`` where the one-element ``pred`` is nonzero, else ``b``."""
    return torch.where(pred.reshape(()) != 0, a, b.to(a.dtype))


# unregistered (no ``mx.nd`` function): the loops' select, run through
# ``invoke`` so that it records only inside ``autograd.record()``
_SELECT = OpDef("_contrib_select", _where_scalar, 3, 1, (), False)


def foreach(body, data, init_states):
    """Run ``body(data_slice, states) -> (outputs, new_states)`` over
    axis 0 of ``data`` (an NDArray or a list of them); returns the
    outputs stacked over that axis and the final states, in the forms
    the body returned them."""
    data_list = _as_list(data)
    length = data_list[0].shape[0]
    if length == 0:
        raise MXNetError("foreach: zero-length data")
    states = init_states
    steps = []
    out_is_list = False
    for i in range(length):
        xs = [d[i] for d in data_list]
        outs, states = body(xs if isinstance(data, (list, tuple))
                            else xs[0], states)
        out_is_list = isinstance(outs, (list, tuple))
        steps.append(_as_list(outs))
    stacked = [_stack([s[k] for s in steps]) for k in range(len(steps[0]))]
    return (stacked if out_is_list else stacked[0]), states


def _select(pred, a, b):
    return invoke(_SELECT, [pred, a, b])


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``cond(*loop_vars) -> scalar``, ``func(*loop_vars) ->
    (step_output, new_loop_vars)``.  Returns ``(outputs,
    final_loop_vars)``: the step outputs stacked over ``max_iterations``
    rows, zeros from the step where ``cond`` first read false, and the
    loop variables as they stood then."""
    if max_iterations is None:
        raise MXNetError("while_loop: max_iterations is required")
    lv_is_list = isinstance(loop_vars, (list, tuple))
    lvs = _as_list(loop_vars)
    active = None
    steps = []
    out_is_list = False
    for _ in range(int(max_iterations)):
        c = cond(*lvs)
        c = NDArray((c._t.reshape(()) != 0).detach(), ctx=c.context)
        active = c if active is None else NDArray(active._t & c._t,
                                                  ctx=c.context)
        res = func(*lvs)
        if not (isinstance(res, tuple) and len(res) == 2):
            raise MXNetError("while_loop: func must return "
                             "(step_output, new_loop_vars)")
        step_out, new_vars = res
        out_is_list = isinstance(step_out, (list, tuple))
        outs = [] if step_out is None else _as_list(step_out)
        steps.append([_select(active, o, o.zeros_like()) for o in outs])
        lvs = [_select(active, n, v)
               for n, v in zip(_as_list(new_vars), lvs)]
    stacked = [_stack([s[k] for s in steps])
               for k in range(len(steps[0]))] if steps else []
    outs = stacked if out_is_list else (stacked[0] if stacked else [])
    return outs, (lvs if lv_is_list else lvs[0])


def cond(pred, then_func, else_func):
    """``then_func()`` where the scalar ``pred`` (or what the callable
    ``pred`` returns) is nonzero, else ``else_func()``; the branches take
    no arguments and return an NDArray or a list of them."""
    pred_nd = pred() if callable(pred) else pred
    if not isinstance(pred_nd, NDArray):
        raise MXNetError("cond: pred must be (a callable returning) an "
                         "NDArray scalar")
    then_out = then_func()
    else_out = else_func()
    outs = [_select(pred_nd, a, b) for a, b in
            zip(_as_list(then_out), _as_list(else_out))]
    return outs if isinstance(then_out, (list, tuple)) else outs[0]
