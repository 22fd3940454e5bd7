"""The plain operators of the port's BERT path against the JAX
package's, and dropout by its statistics.

Layer norm, exact GELU, log-softmax and pick (values and input
gradients, float32, rtol=atol=1e-5) take the same numpy inputs in both
packages.  Dropout draws from another generator than the JAX package's
keys, so it is held to its contract instead: a keep rate within 1 % of
1 - p over 1e6 elements, kept values scaled by 1 / (1 - p), the identity
when not training, and the same mask from the same seed.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd, nd
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.ops import nn as ops

TOL = 1e-5


def _jax_op(fn, x, *consts):
    jx = nd.array(x)
    jx.attach_grad()
    with autograd.record():
        y = fn(jx, *(nd.array(c) for c in consts))
        loss = (y * nd.array(np.linspace(-1, 1, y.size, dtype="f4")
                             .reshape(y.shape))).sum()
    loss.backward()
    return y.asnumpy(), jx.grad.asnumpy()


def _port_op(fn, x, *consts):
    tx = torch.from_numpy(x).requires_grad_(True)
    y = fn(tx, *(torch.from_numpy(c) for c in consts))
    w = torch.from_numpy(np.linspace(-1, 1, y.numel(), dtype="f4")
                         .reshape(tuple(y.shape)))
    (y * w).sum().backward()
    return y.detach().numpy(), tx.grad.numpy()


OPS = {
    "layer_norm": (lambda x, g, b: nd.LayerNorm(x, g, b),
                   lambda x, g, b: ops.layer_norm(x, g, b)),
    "gelu": (lambda x: nd.LeakyReLU(x, act_type="gelu"), ops.gelu),
    "log_softmax": (lambda x: nd.log_softmax(x, axis=-1),
                    lambda x: ops.log_softmax(x, axis=-1)),
    "pick": (lambda x, i: nd.pick(x, i, axis=-1),
             lambda x, i: ops.pick(x, i, axis=-1)),
    "tanh": (lambda x: nd.Activation(x, act_type="tanh"),
             lambda x: ops.activation(x, "tanh")),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 32) * 2 + 0.5).astype("f4")
    consts = ()
    if name == "layer_norm":
        consts = (rng.randn(32).astype("f4"), rng.randn(32).astype("f4"))
    elif name == "pick":
        consts = (rng.randint(-2, 35, (4, 6)).astype("f4"),)   # clipped
    jfn, tfn = OPS[name]
    wy, wg = _jax_op(jfn, x, *consts)
    gy, gg = _port_op(tfn, x, *consts)
    np.testing.assert_allclose(gy, wy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gg, wg, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(p):
    x = torch.full((1000, 1000), 2.0)
    gen = torch.Generator().manual_seed(0)
    y = ops.dropout(x, p=p, training=True, generator=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    assert torch.allclose(y[kept], torch.tensor(2.0 / (1 - p)))
    again = ops.dropout(x, p=p, training=True,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_dropout_block_train_and_eval():
    """The block follows the module's training mode; its draws come from
    the device's mx.random stream, reproducible from mx.random.seed."""
    drop = Dropout(0.3)
    x = torch.ones(64, 64)
    drop.eval()
    assert drop(x) is x
    drop.train()
    mx.random.seed(7)
    a = drop(x)
    mx.random.seed(7)
    b = drop(x)
    assert torch.equal(a, b) and (a == 0).any()
    assert ops.dropout(x, p=0.3, training=False) is x
    assert ops.dropout(x, p=0.0, training=True) is x
