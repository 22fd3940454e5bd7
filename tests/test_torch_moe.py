"""The mixture-of-experts op ``_contrib_MoEFFN`` and ``gluon.contrib.nn.
MoEFFN`` against the JAX package's (``mxnet_tpu/ops/moe.py``), from the
same numpy inputs of one seed: outputs, the aux loss and every input's
gradient (float32, rtol 1e-5 and atol 1e-6) for k = 1 and 2, with and
without dropped tokens, and ``tests/test_moe.py``'s oracles: the dense
routing oracle, capacity drops, two experts at k = 2, exact positions
under bfloat16, and the k > E error.  Expert parallel over a group of
ranks is in ``test_torch_tensor_parallel.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.contrib.nn import MoEFFN as JMoEFFN

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon.contrib.nn import MoEFFN

import torch_parity

#: the registry's op this file holds against the JAX package
MOE_OPS = {"_contrib_MoEFFN"}


def _inputs(seed, t=10, d=6, h=12, e=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, d).astype("f4"), rng.randn(d, e).astype("f4"),
            rng.randn(e, d, h).astype("f4") * 0.3,
            rng.randn(e, h).astype("f4") * 0.1,
            rng.randn(e, h, d).astype("f4") * 0.3,
            rng.randn(e, d).astype("f4") * 0.1]


def _jax(arrays, **kw):
    """The JAX op, compiled (``torch_parity._compiled``), and the
    gradients of its outputs' read-out."""
    op = torch_parity._compiled(lambda F, *xs: F._contrib_MoEFFN(*xs, **kw))
    xs = [jnd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with jag.record():
        out, aux = op(jnd, *xs)
        loss = (out * out).sum() + 3.0 * aux
    loss.backward()
    return out.asnumpy(), aux.asnumpy(), [x.grad.asnumpy() for x in xs]


def _port(arrays, **kw):
    with mx.cpu():
        xs = [nd.array(a) for a in arrays]
        for x in xs:
            x.attach_grad()
        with autograd.record():
            out, aux = nd._contrib_MoEFFN(*xs, **kw)
            loss = (out * out).sum() + 3.0 * aux
        loss.backward()
        return out.asnumpy(), aux.asnumpy(), [x.grad.asnumpy() for x in xs]


CASES = {
    "k1": dict(num_experts=3, k=1, capacity_factor=6.0),
    "k2": dict(num_experts=3, k=2, capacity_factor=3.0),
    "k1_drops": dict(num_experts=3, k=1, capacity_factor=0.5),
    "k2_drops_gelu": dict(num_experts=3, k=2, capacity_factor=0.7,
                          activation="gelu"),
    "silu": dict(num_experts=3, k=2, capacity_factor=1.25,
                 activation="silu"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_gradients_match_jax(case):
    arrays = _inputs(3)
    want = _jax(arrays, **CASES[case])
    got = _port(arrays, **CASES[case])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"input {i}")


def _numpy_expert_ffn(x, w1, b1, w2, b2):
    return np.maximum(x @ w1 + b1, 0.0) @ w2 + b2


def test_dense_oracle_without_drops():
    x, gate_w, w1, b1, w2, b2 = _inputs(0)
    with mx.cpu():
        out, aux = nd._contrib_MoEFFN(
            *[nd.array(a) for a in (x, gate_w, w1, b1, w2, b2)],
            num_experts=3, k=1, capacity_factor=6.0)
    logits = x @ gate_w
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = np.zeros_like(x)
    for i in range(len(x)):
        ei = logits[i].argmax()
        want[i] = probs[i, ei] * _numpy_expert_ffn(
            x[i], w1[ei], b1[ei], w2[ei], b2[ei])
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-4, atol=1e-5)
    assert float(aux.asnumpy()) > 0


def test_capacity_drops_tokens():
    rng = np.random.RandomState(1)
    t, d, e = 8, 4, 2
    gate_w = np.zeros((d, e), "f4")
    gate_w[:, 0] = 10.0
    with mx.cpu():
        out, _ = nd._contrib_MoEFFN(
            nd.array(np.abs(rng.randn(t, d)).astype("f4")),
            nd.array(gate_w), nd.array(np.ones((e, d, 4), "f4")),
            nd.array(np.zeros((e, 4), "f4")),
            nd.array(np.ones((e, 4, d), "f4")),
            nd.array(np.zeros((e, d), "f4")),
            num_experts=e, k=1, capacity_factor=0.5)   # capacity 2
    assert (np.abs(out.asnumpy()).sum(axis=1) > 1e-6).sum() == 2


def test_k2_uses_two_experts():
    arrays = _inputs(2, t=6, d=4, h=8, e=4)
    with mx.cpu():
        args = [nd.array(a) for a in arrays]
        out1, _ = nd._contrib_MoEFFN(*args, num_experts=4, k=1,
                                     capacity_factor=8.0)
        out2, _ = nd._contrib_MoEFFN(*args, num_experts=4, k=2,
                                     capacity_factor=8.0)
    assert np.abs(out1.asnumpy() - out2.asnumpy()).max() > 1e-4


def test_bf16_positions_stay_exact():
    """600 tokens on one expert: the routing counts in int32, so no two
    tokens share a slot (bfloat16 counts stop at 256)."""
    t, d, e = 600, 4, 2
    gate_w = np.zeros((d, e), "f4")
    gate_w[:, 0] = 5.0
    with mx.cpu():
        arrays = [np.ones((t, d), "f4"), gate_w, np.ones((e, d, 4), "f4"),
                  np.zeros((e, 4), "f4"), np.ones((e, 4, d), "f4"),
                  np.zeros((e, d), "f4")]
        out, _ = nd._contrib_MoEFFN(
            *[nd.array(a).astype("bfloat16") for a in arrays],
            num_experts=e, k=1, capacity_factor=2.0)
        got = out.astype("float32").asnumpy()
    kept = np.abs(got).sum(axis=1) > 1.0
    assert kept.sum() == 600
    np.testing.assert_allclose(
        got[kept], np.broadcast_to(got[kept][0], got[kept].shape),
        rtol=0.05)


def test_k_above_experts_raises_as_jax():
    arrays = _inputs(0)
    with pytest.raises(ValueError, match="exceeds num_experts"):
        jnd._contrib_MoEFFN(*[jnd.array(a) for a in arrays],
                            num_experts=3, k=4)
    with mx.cpu(), pytest.raises((ValueError, mx.MXNetError),
                                 match="exceeds num_experts"):
        nd._contrib_MoEFFN(*[nd.array(a) for a in arrays],
                           num_experts=3, k=4)


def test_block_matches_jax_and_names():
    """``MoEFFN`` on (B, S, d): the JAX block's weights by name, the same
    output, aux loss and weight gradients."""
    jmx.random.seed(0)
    jb = JMoEFFN(8, 16, num_experts=4, k=2, capacity_factor=1.5,
                 activation="silu", prefix="moe_")
    jb.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    x = np.random.RandomState(5).randn(2, 5, 8).astype("f4")
    jb(jnd.array(x))
    jparams = jb.collect_params()
    w = {k: p.data().asnumpy() for k, p in jparams.items()}
    jb.hybridize()      # compiled whole, not an op at a time
    with jag.record():
        jout, jaux = jb(jnd.array(x))
        jloss = (jout * jout).sum() + jaux
    jloss.backward()
    with mx.cpu():
        pb = MoEFFN(8, 16, num_experts=4, k=2, capacity_factor=1.5,
                    activation="silu", prefix="moe_")
        pb.initialize(ctx=mx.cpu())
        params = pb.collect_params()
        assert sorted(params.keys()) == sorted(w)
        for k, v in w.items():
            params[k].set_data(v)
        with autograd.record():
            out, aux = pb(nd.array(x))
            loss = (out * out).sum() + aux
        loss.backward()
        np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux.asnumpy(), jaux.asnumpy(),
                                   rtol=1e-5, atol=1e-6)
        for k in w:
            np.testing.assert_allclose(params[k].grad().asnumpy(),
                                       jparams[k].grad().asnumpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_routing_counts_in_int32_under_bfloat16():
    """The route itself: positions and the keep test in int32 and the
    combine weights in float32, whatever the probabilities' type."""
    from mxnet_tpu_torch.ops.moe import moe_route
    probs = torch.zeros(300, 2, dtype=torch.bfloat16)
    probs[:, 0] = 1.0
    combine = moe_route(probs, 1, 300)
    assert combine.dtype == torch.float32
    slots = combine[:, 0].argmax(dim=1)
    assert torch.equal(slots, torch.arange(300))
