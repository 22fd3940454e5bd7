"""Probabilistic time-series forecasters, as the JAX package's
``models/forecast.py``: GluonTS's DeepAR and Transformer (BASELINE
config #4).

* Training is the reference's gluon loop: ``net.hybridize()``,
  ``gluon.Trainer(net.collect_params(), "adam", ...)``, ``loss =
  net(past_target, future_target).mean()`` inside ``autograd.record()``,
  ``loss.backward()``, ``trainer.step(B)``.  ``net(...)`` is the
  per-series negative log-likelihood (B,) of a Gaussian head with
  GluonTS's mean-|x| scaling; hybridized, it is one replay of the
  block's CachedOp and the backward one more.
* DeepAR's recurrence is ``gluon.rnn.LSTM`` (one fused cuDNN call a
  layer on the card); the Transformer's blocks are
  ``gluon.contrib.nn``'s, its decoder's causal mask a query-dependent
  4-D mask, so its attention takes the plain path, as the reference's
  takes XLA's.
* Prediction is the reference's eager loop, one step a call of the
  blocks (run inline, no CachedOp of their own): ``forecast`` the mean
  path, ``DeepAR.sample`` ancestral sample paths whose normal draws come
  from the device's ``mx.random`` stream, so ``mx.random.seed`` before
  a call fixes its paths.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import autograd
from .. import ndarray as nd
from .. import random as mxrand
from ..base import MXNetError
from ..gluon import nn, rnn
from ..gluon.block import HybridBlock, inline_calls
from ..gluon.contrib.nn import (MultiHeadAttention, PositionwiseFFN,
                                TransformerEncoder)

__all__ = ["DeepAR", "TransformerForecaster", "gaussian_nll"]

_MIN_SIGMA = 1e-4


def _predict(method):
    """A prediction method: the blocks it calls run inline, and record
    only inside ``autograd.record()``."""
    @functools.wraps(method)
    def wrapper(*args, **kwargs):
        with inline_calls(), torch.set_grad_enabled(autograd.is_recording()):
            return method(*args, **kwargs)
    return wrapper


def gaussian_nll(F, target, mu, sigma):
    """Per-element Gaussian negative log-likelihood."""
    return (F.log(sigma)
            + 0.5 * float(np.log(2 * np.pi))
            + 0.5 * F.square((target - mu) / sigma))


class _GaussianHead(HybridBlock):
    """Features -> (mu, sigma); sigma = softrelu + 1e-4."""

    def __init__(self, in_units, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.mu_proj = nn.Dense(1, flatten=False, in_units=in_units,
                                    prefix="mu_")
            self.sigma_proj = nn.Dense(1, flatten=False, in_units=in_units,
                                       prefix="sigma_")

    def hybrid_forward(self, F, h):
        mu = self.mu_proj(h).reshape(h.shape[:-1])
        raw = self.sigma_proj(h).reshape(h.shape[:-1])
        sigma = F.Activation(raw, act_type="softrelu") + _MIN_SIGMA
        return mu, sigma


def _mean_abs_scale(F, context):
    """GluonTS's mean-|x| scale over the time axis, (B, T) -> (B, 1)."""
    return F.mean(F.abs(context), axis=1, keepdims=True) + 1.0


class DeepAR(HybridBlock):
    """Autoregressive LSTM forecaster (GluonTS ``DeepAREstimator``'s
    network).

    ``net(past_target, future_target)`` is the teacher-forced NLL over
    the context and prediction range, (B,); :meth:`sample` draws
    ancestral sample paths and :meth:`forecast` gives the mean path."""

    def __init__(self, context_length, prediction_length, num_cells=40,
                 num_layers=2, dropout=0.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if context_length < 1 or prediction_length < 1:
            raise MXNetError("context_length and prediction_length must "
                             "be >= 1")
        self.context_length = int(context_length)
        self.prediction_length = int(prediction_length)
        self._num_cells = int(num_cells)
        with self.name_scope():
            self.lstm = rnn.LSTM(num_cells, num_layers=num_layers,
                                 layout="NTC", dropout=dropout,
                                 input_size=1, prefix="lstm_")
            self.head = _GaussianHead(num_cells, prefix="head_")

    def hybrid_forward(self, F, past_target, future_target):
        """Teacher-forced NLL over the whole unrolled range, (B,)."""
        scale = _mean_abs_scale(F, past_target)          # (B, 1)
        full = F.concat(past_target, future_target, dim=1) / scale
        inputs = F.expand_dims(
            F.slice_axis(full, axis=1, begin=0, end=-1), axis=2)
        labels = F.slice_axis(full, axis=1, begin=1, end=None)
        h = self.lstm(inputs)                            # (B, T-1, H)
        mu, sigma = self.head(h)
        nll = gaussian_nll(F, labels, mu, sigma)
        # sigma is in scaled space: + log(scale) restores the true
        # likelihood's normalization (a constant of the parameters)
        return F.mean(nll, axis=1) + F.mean(F.log(scale), axis=1)

    # -- prediction (eager) ----------------------------------------------
    def _warm_up(self, past_target):
        """Run the LSTM over past[:-1]; past[-1] is the first prediction
        step's input, as in training (step t's input is target[t-1],
        its label target[t])."""
        scale = _mean_abs_scale(nd, past_target)
        past_scaled = past_target / scale
        states = self.lstm.begin_state(past_target.shape[0],
                                       ctx=past_target.context)
        h = None
        if past_target.shape[1] > 1:
            ctx_in = nd.expand_dims(
                nd.slice_axis(past_scaled, axis=1, begin=0, end=-1), axis=2)
            h, states = self.lstm(ctx_in, states)
        last = nd.slice_axis(past_scaled, axis=1, begin=-1, end=None)
        return h, states, scale, last

    @_predict
    def forecast(self, past_target):
        """The mean path, (B, prediction_length)."""
        _, states, scale, prev = self._warm_up(past_target)
        outs = []
        for _ in range(self.prediction_length):
            h, states = self.lstm(nd.expand_dims(prev, axis=2), states)
            mu, _ = self.head(h)
            prev = mu.reshape((-1, 1))
            outs.append(prev * scale)
        return nd.concat(*outs, dim=1)

    @_predict
    def sample(self, past_target, num_samples=100):
        """Ancestral sample paths, (num_samples, B, prediction_length)."""
        b = past_target.shape[0]
        rep = nd.repeat(past_target, repeats=num_samples, axis=0)
        _, states, scale, prev = self._warm_up(rep)
        outs = []
        for _ in range(self.prediction_length):
            h, states = self.lstm(nd.expand_dims(prev, axis=2), states)
            mu, sigma = self.head(h)
            eps = mxrand.normal(0, 1, shape=mu.shape,
                                ctx=past_target.context)
            prev = (mu + sigma * eps).reshape((-1, 1))
            outs.append(prev * scale)
        paths = nd.concat(*outs, dim=1)      # (B * S, P)
        return paths.reshape((b, num_samples, self.prediction_length)) \
            .transpose((1, 0, 2))


class _TransformerDecoderCell(HybridBlock):
    """Causal self-attention, cross-attention, FFN (post-LN)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.self_att = MultiHeadAttention(units, num_heads,
                                               dropout=dropout)
            self.cross_att = MultiHeadAttention(units, num_heads,
                                                dropout=dropout)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout)
            self.norm_self = nn.LayerNorm(in_channels=units)
            self.norm_cross = nn.LayerNorm(in_channels=units)
            self.norm_ffn = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, memory, causal_mask):
        x = self.norm_self(x + self.self_att(x, None, None, causal_mask))
        x = self.norm_cross(x + self.cross_att(x, memory, memory))
        return self.norm_ffn(x + self.ffn(x))


class TransformerForecaster(HybridBlock):
    """Encoder-decoder attention forecaster (GluonTS
    ``TransformerEstimator``'s network).

    ``net(past_target, future_target)`` -> (B,) NLL: the encoder attends
    over the scaled context, the decoder runs causal self-attention over
    the teacher-forced target prefix and cross-attention into the
    encoder's memory, then the Gaussian head."""

    def __init__(self, context_length, prediction_length, units=32,
                 hidden_size=64, num_heads=4, enc_layers=2, dec_layers=2,
                 dropout=0.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if context_length < 1 or prediction_length < 1:
            raise MXNetError("context_length and prediction_length must "
                             "be >= 1")
        self.context_length = int(context_length)
        self.prediction_length = int(prediction_length)
        self._units = units
        with self.name_scope():
            self.enc_proj = nn.Dense(units, flatten=False, in_units=1,
                                     prefix="encproj_")
            self.dec_proj = nn.Dense(units, flatten=False, in_units=1,
                                     prefix="decproj_")
            self.params.get("enc_pos", shape=(context_length, units),
                            init="normal")
            self.params.get("dec_pos", shape=(prediction_length, units),
                            init="normal")
            self.encoder = TransformerEncoder(
                units, hidden_size, enc_layers, num_heads, dropout=dropout,
                prefix="enc_")
            self.dec_cells = []
            for i in range(dec_layers):
                cell = _TransformerDecoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    prefix=f"dec{i}_")
                self.register_child(cell, f"dec{i}")
                self.dec_cells.append(cell)
            self.head = _GaussianHead(units, prefix="head_")

    def _causal_mask(self, F, length, ctx):
        steps = F.arange(0, length, ctx=ctx)
        m = F.broadcast_greater_equal(F.expand_dims(steps, axis=1),
                                      F.expand_dims(steps, axis=0))
        return m.reshape((1, 1, length, length))

    def _encode(self, F, past_scaled, enc_pos):
        x = self.enc_proj(F.expand_dims(past_scaled, axis=2))
        x = x + F.expand_dims(enc_pos, axis=0)
        return self.encoder(x)

    def _decode(self, F, dec_in_scaled, memory, dec_pos, length):
        y = self.dec_proj(F.expand_dims(dec_in_scaled, axis=2))
        y = y + F.expand_dims(
            F.slice_axis(dec_pos, axis=0, begin=0, end=length), axis=0)
        cm = self._causal_mask(F, length, dec_in_scaled.context)
        for cell in self.dec_cells:
            y = cell(y, memory, cm)
        return self.head(y)

    def hybrid_forward(self, F, past_target, future_target, enc_pos=None,
                       dec_pos=None):
        scale = _mean_abs_scale(F, past_target)
        past_scaled = past_target / scale
        future_scaled = future_target / scale
        memory = self._encode(F, past_scaled, enc_pos)
        # the decoder's input: the last context value, then future[:-1]
        dec_in = F.concat(
            F.slice_axis(past_scaled, axis=1, begin=-1, end=None),
            F.slice_axis(future_scaled, axis=1, begin=0, end=-1), dim=1)
        mu, sigma = self._decode(F, dec_in, memory, dec_pos,
                                 self.prediction_length)
        nll = gaussian_nll(F, future_scaled, mu, sigma)
        return F.mean(nll, axis=1) + F.mean(F.log(scale), axis=1)

    @_predict
    def forecast(self, past_target):
        """The mean path by greedy autoregression, (B, P)."""
        scale = _mean_abs_scale(nd, past_target)
        past_scaled = past_target / scale
        enc_pos = self._gluon_param("enc_pos").data(past_target.context)
        dec_pos = self._gluon_param("dec_pos").data(past_target.context)
        memory = self._encode(nd, past_scaled, enc_pos)
        dec_in = nd.slice_axis(past_scaled, axis=1, begin=-1, end=None)
        for t in range(self.prediction_length):
            mu, _ = self._decode(nd, dec_in, memory, dec_pos, t + 1)
            nxt = nd.slice_axis(mu, axis=1, begin=-1, end=None)
            dec_in = nd.concat(dec_in, nxt, dim=1)
        preds = nd.slice_axis(dec_in, axis=1, begin=1, end=None)
        return preds * scale
