"""The port's Adam and softmax cross-entropy against the JAX package's.

Adam: the same weights and gradients (numpy, seeded) through the JAX
``Adam.update`` and the port's multi-tensor ``Adam.update``, with weight
decay, gradient clipping and ``rescale_grad``; weights and both moments
agree to rtol=1e-6 after steps 1 and 3 (float32; the bias-corrected
learning rate rounds to float32 on both sides).  Cross-entropy: values
and input gradients to 1e-6.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd, nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxSCE
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

TOL = 1e-6
SHAPES = [(6, 5), (5,), (3, 4, 2)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(wd=0.1, clip_gradient=0.05, rescale_grad=0.5),
    dict(learning_rate=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6, wd=0.01),
], ids=["defaults", "wd-clip-rescale", "betas-eps"])
def test_adam_matches_jax_update(kw):
    rng = np.random.RandomState(0)
    weights = [rng.randn(*s).astype("f4") for s in SHAPES]
    jo = jopt.Adam(**kw)
    to = topt.Adam(**kw)
    jw = [nd.array(w) for w in weights]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    tw = [torch.from_numpy(w.copy()) for w in weights]
    ts = [to.create_state(w) for w in tw]
    for t in (1, 2, 3):
        grads = [rng.randn(*s).astype("f4") * 0.2 for s in SHAPES]
        for i, g in enumerate(grads):
            jo.update(i, jw[i], nd.array(g), js[i])
        to.update(tw, [torch.from_numpy(g) for g in grads], ts, t)
        if t in (1, 3):
            for i in range(len(SHAPES)):
                for got, want in ((tw[i], jw[i]), (ts[i][0], js[i][0]),
                                  (ts[i][1], js[i][1])):
                    np.testing.assert_allclose(got.numpy(), want.asnumpy(),
                                               rtol=TOL, atol=TOL)


def test_adam_corrected_lr_and_create():
    o = topt.create("adam", learning_rate=1e-4)
    assert o.corrected_lr(1) == pytest.approx(1e-4 * np.sqrt(0.001) / 0.1)
    with pytest.raises(MXNetError, match="not ported"):
        topt.create("lamb")


@pytest.mark.parametrize("shape,dtype", [((8, 50), "float32"),
                                         ((4, 2), "float32"),
                                         ((8, 50), "bfloat16")],
                         ids=["mlm", "nsp", "bf16"])
def test_softmax_cross_entropy_matches_jax(shape, dtype):
    rng = np.random.RandomState(1)
    pred = (rng.randn(*shape) * 3).astype("f4")
    label = rng.randint(0, shape[1], shape[0]).astype("f4")
    label[0] = shape[1] + 5                       # clipped into range
    jp = nd.array(pred).astype(dtype)
    jp.attach_grad()
    with autograd.record():
        jl = JaxSCE()(jp, nd.array(label))
    jl.backward()
    tp = torch.from_numpy(pred).to(getattr(torch, dtype))
    tp.requires_grad_(True)
    tl = SoftmaxCrossEntropyLoss()(tp, torch.from_numpy(label))
    tl.backward(torch.ones_like(tl))
    tol = TOL if dtype == "float32" else 2e-2
    assert tuple(tl.shape) == (shape[0],)
    np.testing.assert_allclose(tl.float().detach().numpy(),
                               jl.astype("float32").asnumpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tp.grad.float().numpy(),
                               jp.grad.astype("float32").asnumpy(),
                               rtol=tol, atol=tol)
