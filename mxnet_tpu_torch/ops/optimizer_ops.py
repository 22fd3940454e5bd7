"""Update operators, as the JAX package's ``ops/optimizer_ops.py``: the
per-parameter updates of every optimizer (``sgd_update``,
``sgd_mom_update``, ``nag_mom_update``, the multi-precision
``mp_sgd_update`` and ``mp_sgd_mom_update``, ``adam_update``,
``adamw_update``, ``rmsprop_update``, ``rmspropalex_update``,
``ftrl_update``, ``signsgd_update``, ``signum_update``,
``adagrad_update``, ``adadelta_update``, ``lamb_update_phase1`` and
``_phase2``), the multi-tensor family (``multi_sgd_update``,
``multi_sgd_mom_update``, ``multi_mp_sgd_update``,
``multi_mp_sgd_mom_update``, ``multi_adam_update``,
``multi_lamb_update``, ``multi_sum_sq``, ``multi_lars``) and
``clip_by_global_norm``.

Each returns the updated tensors; ``invoke`` writes them into ``out=``
in place.  ``lr``, ``wd``, ``rescale_grad`` (and ``eta``, ``t``) are
scalar attrs: Python numbers, or 0-d tensors on the weight's device (the
optimizer's device scalars, which a captured step reads afresh at each
replay).  With Python numbers, no clipping and no weight decay,
``sgd_update`` is one fused ``w + (-lr * rescale_grad) * g``.  The
multi-tensor ops take the reference's flat layout: ``num_weights``
weights, their gradients, each state group, then the per-parameter
``lrs`` and ``wds`` (1-d; ``multi_lamb_update`` also ``ts``, the step
counts) and the 0-d ``rescale_grad``, and return every updated tensor in
its input's type.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient, wd=None, weight=None):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd is not None:
        g = g + wd * weight
    return g


def _row_mask(grad):
    """Rows a (row-sparse) gradient touches: any nonzero in the row (a
    row that was looked up but whose gradient is exactly zero is not
    touched).  The lazy update leaves the other rows alone: no weight
    decay, no decay of their optimizer state.  A fixed-shape mask over
    the dense buffer, so a captured step can take it."""
    m = torch.any((grad != 0).reshape(grad.shape[0], -1), dim=1)
    return m.reshape((-1,) + (1,) * (grad.dim() - 1))


@register("sgd_update", num_inputs=2,
          scalar_attrs=("lr", "wd", "rescale_grad"))
def sgd_update(weight, grad, lr, wd, rescale_grad=1.0, *,
               clip_gradient=-1.0, lazy_update=False):
    numbers_only = all(isinstance(s, numbers.Number)
                       for s in (lr, wd, rescale_grad))
    if numbers_only and (clip_gradient is None or clip_gradient <= 0) \
            and wd == 0 and not lazy_update:
        return torch.add(weight, grad, alpha=-lr * rescale_grad)
    new_w = weight - lr * _prep_grad(grad, rescale_grad, clip_gradient, wd,
                                     weight)
    if lazy_update:
        return torch.where(_row_mask(grad), new_w, weight)
    return new_w


@register("sgd_mom_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr, wd, rescale_grad=1.0, *,
                   momentum=0.0, clip_gradient=-1.0, lazy_update=False):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    if lazy_update:
        mask = _row_mask(grad)
        new_mom = torch.where(mask, new_mom, mom)
        return torch.where(mask, weight + new_mom, weight), new_mom
    return weight + new_mom, new_mom


@register("nag_mom_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2)
def nag_mom_update(weight, grad, mom, lr, wd, rescale_grad=1.0, *,
                   momentum=0.0, clip_gradient=-1.0):
    """Nesterov momentum: ``m = momentum m + g``,
    ``w -= lr (g + momentum m)``."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


# the mp ops run on the float32 master weight; the low-precision weight
# is its rounding
@register("mp_sgd_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2,
          scalar_ref_input=2)
def mp_sgd_update(weight, grad, weight32, lr, wd, rescale_grad=1.0, *,
                  clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_inputs=4,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=3,
          scalar_ref_input=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, wd,
                      rescale_grad=1.0, *, momentum=0.0,
                      clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = momentum * mom - lr * g
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


@register("adam_update", num_inputs=4,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=3)
def adam_update(weight, grad, mean, var, lr, wd, rescale_grad=1.0, *,
                beta1=0.9, beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                lazy_update=False):
    """Adam with the bias correction already on ``lr``:
    ``m = beta1 m + (1 - beta1) g``, ``v = beta2 v + (1 - beta2) g^2``,
    ``w -= lr m / (sqrt(v) + epsilon)``; lazily, only the touched rows of
    ``w``, ``m`` and ``v`` change."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    if lazy_update:
        mask = _row_mask(grad)
        return (torch.where(mask, w, weight),
                torch.where(mask, new_mean, mean),
                torch.where(mask, new_var, var))
    return w, new_mean, new_var


@register("adamw_update", num_inputs=4,
          scalar_attrs=("lr", "eta", "wd", "rescale_grad"), num_outputs=3)
def adamw_update(weight, grad, mean, var, lr, eta, wd, rescale_grad=1.0,
                 *, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay:
    ``w -= eta (lr m / (sqrt(v) + epsilon) + wd w)``."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                        + wd * weight)
    return w, new_mean, new_var


@register("rmsprop_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2)
def rmsprop_update(weight, grad, n, lr, wd, rescale_grad=1.0, *,
                   gamma1=0.95, epsilon=1e-8, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1.0 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n


@register("rmspropalex_update", num_inputs=5,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=4)
def rmspropalex_update(weight, grad, n, g_acc, delta, lr, wd,
                       rescale_grad=1.0, *, gamma1=0.95, gamma2=0.9,
                       epsilon=1e-8, clip_gradient=-1.0,
                       clip_weights=-1.0):
    """Graves' centered RMSProp.  ``clip_weights`` is accepted and, as in
    the reference, not applied."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1.0 - gamma1) * torch.square(g)
    new_g = gamma1 * g_acc + (1.0 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return weight + new_delta, new_n, new_g, new_delta


@register("ftrl_update", num_inputs=4,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=3)
def ftrl_update(weight, grad, z, n, lr, wd, rescale_grad=1.0, *,
                lamda1=0.01, beta=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w, new_z, new_n


@register("signsgd_update", num_inputs=2,
          scalar_attrs=("lr", "wd", "rescale_grad"))
def signsgd_update(weight, grad, lr, wd, rescale_grad=1.0, *,
                   clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * torch.sign(g)


@register("signum_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2)
def signum_update(weight, grad, mom, lr, wd, rescale_grad=1.0, *,
                  momentum=0.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - (1.0 - momentum) * g
    w = weight + lr * torch.sign(new_mom)
    if wd_lh > 0:
        w = w - lr * wd_lh * weight
    return w, new_mom


@register("adagrad_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2)
def adagrad_update(weight, grad, history, lr, wd, rescale_grad=1.0, *,
                   epsilon=1e-7, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_h = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_h) + epsilon), new_h


@register("adadelta_update", num_inputs=4,
          scalar_attrs=("wd", "rescale_grad"), num_outputs=3)
def adadelta_update(weight, grad, acc_g, acc_delta, wd, rescale_grad=1.0,
                    *, rho=0.9, epsilon=1e-5, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_acc_g = rho * acc_g + (1.0 - rho) * torch.square(g)
    delta = (torch.sqrt(acc_delta + epsilon)
             / torch.sqrt(new_acc_g + epsilon) * g)
    new_acc_delta = rho * acc_delta + (1.0 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta


def _bias_denominator(beta, t):
    """``1 - beta^t`` in float32, ``t`` a number or a 0-d tensor (read
    on the device, never on the host)."""
    if torch.is_tensor(t):
        return 1.0 - torch.pow(beta, t.float())
    return float(np.float32(1.0) - np.power(np.float32(beta), np.float32(t)))


@register("lamb_update_phase1", num_inputs=4,
          scalar_attrs=("wd", "t", "rescale_grad"), num_outputs=3)
def lamb_update_phase1(weight, grad, mean, var, wd, t=1, rescale_grad=1.0,
                       *, beta1=0.9, beta2=0.999, epsilon=1e-6,
                       bias_correction=True, clip_gradient=-1.0):
    """LAMB's direction ``m^ / (sqrt(v^) + epsilon) + wd w`` (``m^``,
    ``v^`` bias-corrected at step ``t``), with the new moments."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / _bias_denominator(beta1, t)
        v = v / _bias_denominator(beta2, t)
    return m / (torch.sqrt(v) + epsilon) + wd * weight, new_mean, new_var


def _trust_ratio(r1, r2, lower_bound, upper_bound):
    """``r1 / r2`` where both norms are positive, else 1, clamped to the
    bounds that are set (> 0)."""
    ok = (r1 > 0.0) & (r2 > 0.0)
    trust = torch.where(ok, r1 / torch.where(ok, r2, torch.ones_like(r2)),
                        torch.ones_like(r1))
    if lower_bound is not None and lower_bound > 0:
        trust = torch.clamp(trust, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        trust = torch.clamp(trust, max=upper_bound)
    return trust


@register("lamb_update_phase2", num_inputs=4, scalar_attrs=("lr",))
def lamb_update_phase2(weight, g_update, r1, r2, lr, *, lower_bound=-1.0,
                       upper_bound=-1.0):
    """``w -= lr * trust * g_update``, trust = ``r1 / r2`` (the norms of
    the weight and of phase 1's direction)."""
    return weight - lr * _trust_ratio(r1, r2, lower_bound,
                                      upper_bound) * g_update


def _sum_sq(a):
    return torch.sum(torch.square(a.float()))


def _rescaled_grads(gs, rescale_grad, clip_gradient, clip_global_norm):
    """grad * rescale, then the global-norm clip over all of them when
    ``clip_global_norm`` > 0, then the per-element clip."""
    gs = [g * rescale_grad for g in gs]
    if clip_global_norm > 0:
        _, scale = global_norm_scale(gs, clip_global_norm)
        gs = [g * scale.to(g.dtype) for g in gs]
    if clip_gradient is not None and clip_gradient > 0:
        gs = [torch.clamp(g, -clip_gradient, clip_gradient) for g in gs]
    return gs


def _split(arrays, n, groups, n_scalars):
    """The multi ops' flat inputs: ``groups`` lists of ``n`` tensors,
    then ``n_scalars`` trailing arrays."""
    lists = [arrays[i * n:(i + 1) * n] for i in range(groups)]
    return lists, arrays[groups * n:groups * n + n_scalars]


@register("multi_sgd_update", num_inputs=None, num_outputs=-1)
def multi_sgd_update(*arrays, num_weights, clip_gradient=-1.0,
                     clip_global_norm=-1.0):
    """n weights, n grads, lrs, wds, rescale_grad -> n weights."""
    (ws, gs), (lrs, wds, rescale) = _split(arrays, num_weights, 2, 3)
    gs = _rescaled_grads(gs, rescale, clip_gradient, clip_global_norm)
    return tuple((w - lrs[j] * (gs[j] + wds[j] * w)).to(w.dtype)
                 for j, w in enumerate(ws))


@register("multi_sgd_mom_update", num_inputs=None, num_outputs=-1)
def multi_sgd_mom_update(*arrays, num_weights, momentum=0.0,
                         clip_gradient=-1.0, clip_global_norm=-1.0):
    """n weights, n grads, n momenta, lrs, wds, rescale_grad -> n
    weights, n momenta."""
    (ws, gs, moms), (lrs, wds, rescale) = _split(arrays, num_weights, 3, 3)
    gs = _rescaled_grads(gs, rescale, clip_gradient, clip_global_norm)
    new_ws, new_moms = [], []
    for j, w in enumerate(ws):
        new_mom = momentum * moms[j] - lrs[j] * (gs[j] + wds[j] * w)
        new_ws.append((w + new_mom).to(w.dtype))
        new_moms.append(new_mom.to(moms[j].dtype))
    return tuple(new_ws) + tuple(new_moms)


@register("multi_mp_sgd_update", num_inputs=None, num_outputs=-1)
def multi_mp_sgd_update(*arrays, num_weights, clip_gradient=-1.0,
                        clip_global_norm=-1.0):
    """n low-precision weights, n grads, n float32 masters, lrs, wds,
    rescale_grad -> n weights, n masters."""
    (ws, gs, w32s), (lrs, wds, rescale) = _split(arrays, num_weights, 3, 3)
    gs = _rescaled_grads([g.float() for g in gs], rescale, clip_gradient,
                         clip_global_norm)
    new_w32s = [w32 - lrs[j] * (gs[j] + wds[j] * w32)
                for j, w32 in enumerate(w32s)]
    return tuple(w.to(ws[j].dtype) for j, w in enumerate(new_w32s)) \
        + tuple(new_w32s)


@register("multi_mp_sgd_mom_update", num_inputs=None, num_outputs=-1)
def multi_mp_sgd_mom_update(*arrays, num_weights, momentum=0.0,
                            clip_gradient=-1.0, clip_global_norm=-1.0):
    """n low-precision weights, n grads, n float32 momenta, n float32
    masters, lrs, wds, rescale_grad -> n weights, n momenta, n
    masters."""
    (ws, gs, moms, w32s), (lrs, wds, rescale) = _split(
        arrays, num_weights, 4, 3)
    gs = _rescaled_grads([g.float() for g in gs], rescale, clip_gradient,
                         clip_global_norm)
    new_ws, new_moms, new_w32s = [], [], []
    for j, w32 in enumerate(w32s):
        new_mom = momentum * moms[j] - lrs[j] * (gs[j] + wds[j] * w32)
        nw32 = w32 + new_mom
        new_ws.append(nw32.to(ws[j].dtype))
        new_moms.append(new_mom)
        new_w32s.append(nw32)
    return tuple(new_ws) + tuple(new_moms) + tuple(new_w32s)


@register("multi_adam_update", num_inputs=None, num_outputs=-1)
def multi_adam_update(*arrays, num_weights, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, clip_gradient=-1.0,
                      clip_global_norm=-1.0):
    """n weights, n grads, n means, n vars, lrs (bias-corrected), wds,
    rescale_grad -> n weights, n means, n vars."""
    (ws, gs, means, variances), (lrs, wds, rescale) = _split(
        arrays, num_weights, 4, 3)
    gs = _rescaled_grads(gs, rescale, clip_gradient, clip_global_norm)
    new_ws, new_means, new_vars = [], [], []
    for j, w in enumerate(ws):
        g = gs[j] + wds[j] * w
        new_mean = beta1 * means[j] + (1.0 - beta1) * g
        new_var = beta2 * variances[j] + (1.0 - beta2) * torch.square(g)
        new_ws.append((w - lrs[j] * new_mean
                       / (torch.sqrt(new_var) + epsilon)).to(w.dtype))
        new_means.append(new_mean.to(means[j].dtype))
        new_vars.append(new_var.to(variances[j].dtype))
    return tuple(new_ws) + tuple(new_means) + tuple(new_vars)


@register("multi_lamb_update", num_inputs=None, num_outputs=-1)
def multi_lamb_update(*arrays, num_weights, beta1=0.9, beta2=0.999,
                      epsilon=1e-6, bias_correction=True, lower_bound=-1.0,
                      upper_bound=-1.0, clip_gradient=-1.0,
                      clip_global_norm=-1.0):
    """LAMB over n tensors (phase 1, each tensor's trust ratio, phase 2):
    n weights, n grads, n means, n vars, lrs, wds, ts, rescale_grad -> n
    weights, n means, n vars."""
    (ws, gs, means, variances), (lrs, wds, ts, rescale) = _split(
        arrays, num_weights, 4, 4)
    gs = _rescaled_grads(gs, rescale, clip_gradient, clip_global_norm)
    new_ws, new_means, new_vars = [], [], []
    for j, w in enumerate(ws):
        new_mean = beta1 * means[j] + (1.0 - beta1) * gs[j]
        new_var = beta2 * variances[j] + (1.0 - beta2) * torch.square(gs[j])
        m, v = new_mean, new_var
        if bias_correction:
            m = m / _bias_denominator(beta1, ts[j])
            v = v / _bias_denominator(beta2, ts[j])
        update = m / (torch.sqrt(v) + epsilon) + wds[j] * w
        trust = _trust_ratio(torch.linalg.vector_norm(w),
                             torch.linalg.vector_norm(update), lower_bound,
                             upper_bound)
        new_ws.append((w - lrs[j] * trust * update).to(w.dtype))
        new_means.append(new_mean.to(means[j].dtype))
        new_vars.append(new_var.to(variances[j].dtype))
    return tuple(new_ws) + tuple(new_means) + tuple(new_vars)


@register("multi_sum_sq", num_inputs=None)
def multi_sum_sq(*arrays, num_arrays):
    """Each array's sum of squares in float32, stacked (1-d)."""
    return torch.stack([_sum_sq(a) for a in arrays[:num_arrays]])


@register("multi_lars", num_inputs=4, scalar_attrs=("rescale_grad",))
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, rescale_grad=1.0,
               *, eta=0.001, eps=1e-8):
    """LARS: where both norms are positive,
    ``lr_j *= eta ||w_j|| / (||g_j|| + wd_j ||w_j|| + eps)``."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = eta * w_norm / (g_norm + wds * w_norm + eps)
    return lrs * torch.where((w_norm > 0.0) & (g_norm > 0.0), ratio,
                             torch.ones_like(ratio))


def global_norm_scale(arrays, max_norm):
    """(the global 2-norm of ``arrays``, accumulated in float32, and
    ``min(1, max_norm / (norm + 1e-8))``)."""
    total = sum(torch.sum(torch.square(a.float())) for a in arrays)
    norm = torch.sqrt(total)
    return norm, torch.clamp(max_norm / (norm + 1e-8), max=1.0)


@register("clip_by_global_norm", num_inputs=None, num_outputs=-1,
          scalar_attrs=("max_norm",), scalar_ref_input=None)
def clip_by_global_norm(*arrays):
    """Every array scaled so that their global 2-norm is at most
    ``max_norm`` (the trailing scalar), then the norm before the clip:
    one op over all arrays (``gluon.utils.clip_global_norm``)."""
    *arrs, max_norm = arrays
    norm, scale = global_norm_scale(arrs, max_norm)
    return tuple(a * scale.to(a.dtype) for a in arrs) + (norm,)
