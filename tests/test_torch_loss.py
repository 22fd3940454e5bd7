"""The port's ``gluon.loss`` against the JAX package's, value and
gradient, for every loss and each of its branches.

Both packages get the same seeded numpy inputs as NDArrays, record the
loss inside ``autograd.record()`` and run ``backward`` on
``sum(loss * head)`` for a fixed numpy ``head``: the per-sample losses
and the gradient of every floating input that is not a class index
agree to ``test_utils``' float32 tolerances (rtol 1e-4, atol 1e-5).
Optional inputs go in by position (``sample_weight``, then
``pos_weight``), as the JAX package's Block takes them.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import loss as jloss
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss

CPU = mx.cpu()
F32 = dict(rtol=1e-4, atol=1e-5)
B, K = 4, 5


def _rng(seed):
    return np.random.RandomState(seed)


def _x(*shape, seed=0, scale=1.0):
    return (_rng(seed).randn(*shape) * scale).astype("f4")


def _binary(*shape, seed=1):
    return (_rng(seed).rand(*shape) > 0.5).astype("f4")


def _signed(*shape, seed=1):
    return _binary(*shape, seed=seed) * 2 - 1


def _prob(*shape, seed=0):
    return _rng(seed).uniform(0.05, 0.95, shape).astype("f4")


def _dist(*shape, seed=2):
    e = np.exp(_rng(seed).randn(*shape))
    return (e / e.sum(-1, keepdims=True)).astype("f4")


def _log_dist(*shape, seed=0):
    return np.log(_dist(*shape, seed=seed)).astype("f4")


def _labels(*shape, seed=3, classes=K):
    return _rng(seed).randint(0, classes, shape).astype("f4")


SW = _rng(7).uniform(0.5, 1.5, (B, 1)).astype("f4")

# name -> (class name, constructor kwargs, [inputs], [differentiated])
CASES = {
    "l2": ("L2Loss", {}, [_x(B, K), _x(B, K, seed=1)], [0, 1]),
    "l2_weight_sample_weight": ("L2Loss", dict(weight=3.0),
                                [_x(B, K), _x(B, K, seed=1), SW], [0]),
    "l2_batch_axis1": ("L2Loss", dict(batch_axis=1),
                       [_x(K, B, 2), _x(K, B, 2, seed=1)], [0]),
    "l2_label_reshaped": ("L2Loss", {}, [_x(B, 1), _x(B, seed=1)], [0]),
    "l1": ("L1Loss", {}, [_x(B, K), _x(B, K, seed=1)], [0, 1]),
    "l1_weight_sample_weight": ("L1Loss", dict(weight=0.5),
                                [_x(B, K), _x(B, K, seed=1), SW], [0]),
    "sbce_logits": ("SigmoidBinaryCrossEntropyLoss", {},
                    [_x(B, K, scale=3), _binary(B, K)], [0]),
    "sbce_logits_pos_weight": ("SigmoidBinaryCrossEntropyLoss", {},
                               [_x(B, K, scale=3), _binary(B, K), None,
                                _prob(K, seed=5) * 3], [0]),
    "sbce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                          dict(from_sigmoid=True),
                          [_prob(B, K), _binary(B, K)], [0]),
    "sbce_from_sigmoid_pos_weight": ("SigmoidBinaryCrossEntropyLoss",
                                     dict(from_sigmoid=True),
                                     [_prob(B, K), _binary(B, K), None,
                                      _prob(K, seed=5) * 3], [0]),
    "sbce_weight_sample_weight": ("SigmoidBCELoss", dict(weight=2.0),
                                  [_x(B, K, scale=3), _binary(B, K), SW],
                                  [0]),
    "sbce_batch_axis1": ("SigmoidBCELoss", dict(batch_axis=1),
                         [_x(K, B, scale=3), _binary(K, B)], [0]),
    "sce_sparse": ("SoftmaxCrossEntropyLoss", {},
                   [_x(B, K, scale=2), _labels(B)], [0]),
    "sce_sparse_3d": ("SoftmaxCrossEntropyLoss", {},
                      [_x(B, 3, K, scale=2), _labels(B, 3)], [0]),
    "sce_dense": ("SoftmaxCrossEntropyLoss", dict(sparse_label=False),
                  [_x(B, K, scale=2), _dist(B, K)], [0, 1]),
    "sce_from_logits": ("SoftmaxCrossEntropyLoss", dict(from_logits=True),
                        [_log_dist(B, K), _labels(B)], [0]),
    "sce_dense_from_logits": ("SoftmaxCELoss",
                              dict(sparse_label=False, from_logits=True),
                              [_log_dist(B, K), _dist(B, K)], [0, 1]),
    "sce_weight_sample_weight": ("SoftmaxCrossEntropyLoss",
                                 dict(weight=0.25),
                                 [_x(B, K, scale=2), _labels(B), SW], [0]),
    "sce_axis0_batch_axis1": ("SoftmaxCrossEntropyLoss",
                              dict(axis=0, batch_axis=1),
                              [_x(K, B, scale=2), _labels(B)], [0]),
    "kldiv_from_logits": ("KLDivLoss", {},
                          [_log_dist(B, K), _dist(B, K)], [0, 1]),
    "kldiv_softmax": ("KLDivLoss", dict(from_logits=False),
                      [_x(B, K, scale=2), _dist(B, K)], [0, 1]),
    "kldiv_weight_sample_weight": ("KLDivLoss", dict(weight=2.0),
                                   [_log_dist(B, K), _dist(B, K), SW], [0]),
    "huber": ("HuberLoss", {}, [_x(B, K, scale=2), _x(B, K, seed=1)],
              [0, 1]),
    "huber_rho": ("HuberLoss", dict(rho=0.5),
                  [_x(B, K, scale=2), _x(B, K, seed=1), SW], [0]),
    "hinge": ("HingeLoss", {}, [_x(B, K), _signed(B, K)], [0]),
    "hinge_margin_weight": ("HingeLoss", dict(margin=2.0, weight=0.5),
                            [_x(B, K), _signed(B, K), SW], [0]),
    "squared_hinge": ("SquaredHingeLoss", {}, [_x(B, K), _signed(B, K)],
                      [0]),
    "squared_hinge_margin": ("SquaredHingeLoss", dict(margin=0.5),
                             [_x(B, K), _signed(B, K), SW], [0]),
    "logistic_signed": ("LogisticLoss", {},
                        [_x(B, K, scale=3), _signed(B, K)], [0]),
    "logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                        [_x(B, K, scale=3), _binary(B, K), SW], [0]),
    "triplet": ("TripletLoss", {},
                [_x(B, K), _x(B, K, seed=1), _x(B, K, seed=2)], [0, 1, 2]),
    "triplet_margin_weight": ("TripletLoss", dict(margin=4.0, weight=0.5),
                              [_x(B, 2, 3), _x(B, 6, seed=1),
                               _x(B, 6, seed=2), SW[:, 0]], [0, 1, 2]),
    "triplet_batch_axis1": ("TripletLoss", dict(batch_axis=1, margin=3.0),
                            [_x(K, B), _x(K, B, seed=1), _x(K, B, seed=2)],
                            [0, 1, 2]),
    "cosine": ("CosineEmbeddingLoss", {},
               [_x(B, K), _x(B, K, seed=1), _signed(B)], [0, 1]),
    "cosine_margin_weight": ("CosineEmbeddingLoss",
                             dict(margin=0.2, weight=1.5),
                             [_x(B, 2, 3), _x(B, 6, seed=1), _signed(B),
                              SW[:, 0]], [0, 1]),
}


def _run(pkg, mod, case, head):
    """(per-sample loss, [gradient of each differentiated input])."""
    cls, kwargs, inputs, diff = CASES[case]
    fn = getattr(mod, cls)(**kwargs)
    kw = {"ctx": CPU} if pkg is mx else {}
    arrays = [None if a is None else pkg.nd.array(a, **kw) for a in inputs]
    for i in diff:
        arrays[i].attach_grad()
    with pkg.autograd.record():
        out = fn(*arrays)
        total = (out * pkg.nd.array(head, **kw)).sum()
    total.backward()
    return out.asnumpy(), [arrays[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case):
    cls, kwargs, inputs, _ = CASES[case]
    probe = getattr(jloss, cls)(**kwargs)(
        *[None if a is None else jmx.nd.array(a) for a in inputs])
    head = _x(*probe.shape, seed=11)
    want, want_g = _run(jmx, jloss, case, head)
    got, got_g = _run(mx, loss, case, head)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **F32)


def test_every_reference_name_is_exported():
    assert set(jloss.__all__) <= set(dir(loss))
    assert sorted(loss.__all__) == sorted(jloss.__all__)
    covered = {CASES[c][0] for c in CASES}
    assert covered | {"Loss"} >= set(jloss.__all__) - {"SigmoidBCELoss",
                                                       "SoftmaxCELoss"}
    assert loss.SigmoidBCELoss is loss.SigmoidBinaryCrossEntropyLoss
    assert loss.SoftmaxCELoss is loss.SoftmaxCrossEntropyLoss


def test_logistic_loss_rejects_an_unknown_label_format():
    with pytest.raises(MXNetError, match="signed or binary"):
        loss.LogisticLoss(label_format="onehot")


def test_loss_base_and_names():
    fn = loss.SoftmaxCrossEntropyLoss()
    assert isinstance(fn, loss.Loss) and isinstance(fn, mx.gluon.HybridBlock)
    assert fn.name.startswith("softmaxcrossentropyloss")
    assert repr(loss.L1Loss(weight=2.0, batch_axis=1)) == \
        "L1Loss(batch_axis=1, w=2.0)"
    with pytest.raises(NotImplementedError):
        loss.Loss(None, 0)(mx.nd.ones((2,), ctx=CPU))


def test_losses_take_tensors_and_keyword_weights():
    """Called with tensors a loss returns a tensor; NDArray keyword
    arguments (``sample_weight=``) are unwrapped as positional ones."""
    import torch
    pred, label = _x(B, K), _binary(B, K)
    fn = loss.SigmoidBCELoss()
    t = fn(torch.from_numpy(pred), torch.from_numpy(label))
    assert isinstance(t, torch.Tensor) and t.shape == (B,)
    a = fn(mx.nd.array(pred, ctx=CPU), mx.nd.array(label, ctx=CPU),
           sample_weight=mx.nd.array(SW, ctx=CPU)).asnumpy()
    b = fn(mx.nd.array(pred, ctx=CPU), mx.nd.array(label, ctx=CPU),
           mx.nd.array(SW, ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, t.numpy() * SW[:, 0], **F32)
