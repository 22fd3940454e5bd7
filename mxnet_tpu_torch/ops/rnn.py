"""The recurrence of ``gluon.rnn``'s ``RNN``, ``LSTM`` and ``GRU`` layers.

The JAX package projects every step's input with one GEMM and runs the
recurrent half as ``lax.scan`` (``gluon/rnn/rnn_layer.py``).  Here one
layer (both of its directions) is one call of PyTorch's fused
recurrence, ``torch._VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``: cuDNN
on the card, ATen on the CPU.  The formulas and the gate orders are the
reference's: LSTM ``[i, f, c, o]`` is PyTorch's ``[i, f, g, o]``, GRU
``[r, z, n]`` with ``n = tanh(x_n + r * (W_hn h + b_hn))`` is PyTorch's
GRU, and a bidirectional layer concatenates [forward, backward] on the
feature axis with its final states stacked (forward, backward), as the
reference's loop over directions does.

* **Float32 is float32.**  cuDNN's RNN would run float32 on TF32 tensor
  cores while ``torch.backends.cudnn.allow_tf32`` is on (PyTorch's
  default), and reads the flag again in the backward.  A recorded call
  therefore runs the recurrence under its own autograd node
  (:class:`_Ieee`) whose forward and backward both hold the flag off.
* **The backward needs a training-mode forward** (cuDNN keeps its
  reserve space only then), so ``train`` is whether a gradient is
  recorded, not ``autograd.is_training()``.  Dropout between layers is
  the caller's (the layer's own ``mx.random`` draw, as the reference
  applies it); the recurrence runs with dropout 0.
* **Weights are copied a call.**  The layer keeps the reference's
  separate parameters (``l0_i2h_weight``, ...), which are not one
  cuDNN weight buffer, so cuDNN packs them at every call (PyTorch warns
  once per call site).  At forecasting widths that is a few kilobytes.

``nd.RNN`` stays unported exactly as in the JAX package, which raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import _VF

from .nn import _ieee_f32
from .registry import register

__all__ = ["recurrent_layer"]

_FUSED = {"lstm": _VF.lstm, "gru": _VF.gru, "rnn_tanh": _VF.rnn_tanh,
          "rnn_relu": _VF.rnn_relu}


def _run(mode, bidirectional, train, x, *rest):
    """One fused layer: ``rest`` is the states ([h] or [h, c]) then the
    weights.  Returns (output, h_n[, c_n])."""
    n_states = 2 if mode == "lstm" else 1
    states, weights = rest[:n_states], list(rest[n_states:])
    hx = tuple(states) if mode == "lstm" else states[0]
    return tuple(_FUSED[mode](x, hx, weights, True, 1, 0.0, train,
                              bidirectional, False))


class _Ieee(torch.autograd.Function):
    """A recorded layer: the fused recurrence as one node whose forward
    and backward both run with cuDNN's TF32 off."""

    @staticmethod
    def forward(ctx, mode, bidirectional, *tensors):
        ctx.set_materialize_grads(False)
        with torch.enable_grad(), _ieee_f32():
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in tensors]
            outs = _run(mode, bidirectional, True, *leaves)
        ctx.leaves, ctx.outs = leaves, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        leaves, outs = ctx.leaves, ctx.outs
        ctx.leaves = ctx.outs = None
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in leaves if t.requires_grad]
        if not pairs or not wrt:
            return (None,) * (2 + len(leaves))
        with _ieee_f32():
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in leaves)


def recurrent_layer(mode, x, states, weights, bidirectional=False):
    """One recurrent layer over time-major ``x`` (T, N, C).

    ``mode`` is ``lstm``, ``gru``, ``rnn_tanh`` or ``rnn_relu``;
    ``states`` the initial (dirs, N, H) tensors ([h], or [h, c] for the
    LSTM); ``weights`` ``[i2h_weight, h2h_weight, i2h_bias, h2h_bias]``
    for each direction.  Returns ``(out (T, N, dirs * H), [h_n(, c_n)])``.
    """
    tensors = (x, *states, *weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        outs = _Ieee.apply(mode, bidirectional, *tensors)
    else:
        with _ieee_f32():
            outs = _run(mode, bidirectional, False, *tensors)
    return outs[0], list(outs[1:])


@register("RNN", num_inputs=None, num_outputs=-1)
def _rnn_fused(data, params, state, *rest, state_size=0, num_layers=1,
               mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
               projection_size=None, use_sequence_length=False,
               lstm_state_clip_min=None, lstm_state_clip_max=None,
               lstm_state_clip_nan=False):
    """The reference's fused RNN op over its packed ``params`` layout:
    not ported, as in the JAX package; the ``gluon.rnn`` layers are the
    way in."""
    raise NotImplementedError("fused RNN op is provided via gluon.rnn "
                              "layers (scan-based); direct nd.RNN lands "
                              "with the RNN milestone")
