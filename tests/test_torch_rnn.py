"""The port's ``gluon.rnn`` and ``nd.contrib`` control flow against the
JAX package's.

Seeded JAX blocks are carried into the port by gluon name
(``load_jax_gluon_params``, after one call of the port's block where its
input width is deferred), both see the same numpy-made inputs, and:

* the fused layers (``RNN`` relu and tanh, ``LSTM``, ``GRU``; 2 layers,
  TNC and NTC, one and two directions, explicit states) agree in their
  outputs, final states and the gradient of every input, state and
  parameter, to the float32 tolerance of ``test_utils`` (rtol 1e-4,
  atol 1e-5);
* so do the cells (a step and ``unroll`` with ``merge_outputs`` and
  ``valid_length``) and the ``Sequential``, ``Residual`` and
  ``Bidirectional`` cells, and ``foreach``, ``while_loop`` and ``cond``
  with gradients to data, states and a captured array;
* ``DropoutCell`` and ``ZoneoutCell`` by their statistics in training
  mode and as the identity (the base cell) in predict mode;
* a hybridized layer equals its eager self; ``nd.RNN`` raises like the
  reference's; the recurrence runs with cuDNN's TF32 flag off in its
  forward and its backward, in training mode only when a gradient is
  recorded.

Everything runs on the CPU (the port's recurrence through ATen).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import rnn as jrnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.models import load_jax_gluon_params
from mxnet_tpu_torch.ops import rnn as rnn_ops
from mxnet_tpu_torch.test_utils import assert_almost_equal

CPU = mx.cpu()


def _arr(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("f4")


def _carry(jblock, tblock):
    """The JAX block's weights into the port's, by name."""
    load_jax_gluon_params(tblock, {k: p.data().asnumpy()
                                   for k, p in jblock.collect_params().items()})


def _run(pkg, fn, arrays, params):
    """(outputs, gradients of the arrays, gradients of ``params``) of
    ``fn(F, *arrays)`` under ``record``: the gradient is that of the
    sum of squares of every output."""
    F = pkg.nd
    ctx = CPU if pkg is mx else pkg.cpu()
    xs = [F.array(a, ctx=ctx) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        outs = fn(F, *xs)
        loss = None
        for o in outs:
            term = (o * o).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs],
            grads)


def _compare(jres, tres):
    for j, t in zip(jres[0], tres[0]):
        assert j.shape == t.shape
        assert_almost_equal(t, j)
    for j, t in zip(jres[1], tres[1]):
        assert_almost_equal(t, j)
    assert sorted(jres[2]) == sorted(tres[2])
    for k in jres[2]:
        assert_almost_equal(tres[2][k], jres[2][k], names=(k, "jax"))


# -- fused layers -------------------------------------------------------------

LAYER_CASES = {
    "lstm_tnc_bi": ("LSTM", {}, "TNC", True),
    "lstm_ntc": ("LSTM", {}, "NTC", False),
    "gru_tnc": ("GRU", {}, "TNC", False),
    "gru_ntc_bi": ("GRU", {}, "NTC", True),
    "rnn_relu_ntc_bi": ("RNN", {"activation": "relu"}, "NTC", True),
    "rnn_tanh_tnc": ("RNN", {"activation": "tanh"}, "TNC", False),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    """Two layers with explicit states: outputs, final states, and the
    gradients of the input, the states and every parameter."""
    name, kw, layout, bi = LAYER_CASES[case]
    t_len, n, c, h = 5, 3, 4, 6
    jmx.random.seed(0)
    jl = getattr(jrnn, name)(h, num_layers=2, layout=layout,
                             bidirectional=bi, prefix="rl_", **kw)
    jl.initialize(jmx.init.Xavier())
    tl = getattr(rnn, name)(h, num_layers=2, layout=layout,
                            bidirectional=bi, prefix="rl_", **kw)
    tl.initialize(ctx=CPU)
    shape = (t_len, n, c) if layout == "TNC" else (n, t_len, c)
    x = _arr(shape, 1)
    jl(jmx.nd.array(x))                     # completes the deferred widths
    tl(nd.array(x, ctx=CPU))
    assert tl.collect_params()["rl_l0_i2h_weight"].shape == \
        ((4 if name == "LSTM" else 3 if name == "GRU" else 1) * h, c)
    _carry(jl, tl)
    jl.hybridize()      # the JAX layer compiled whole, not an op at a time
    n_states = 2 if name == "LSTM" else 1
    states = [_arr((2 * (2 if bi else 1), n, h), 2 + i, 0.5)
              for i in range(n_states)]

    def fn(block):
        def call(F, x, *st):
            out, new = block(x, list(st))
            assert len(new) == n_states
            return [out] + list(new)
        return call
    jres = _run(jmx, fn(jl), [x] + states, jl.collect_params())
    tres = _run(mx, fn(tl), [x] + states, tl.collect_params())
    assert tres[0][0].shape == (shape[:2] + ((2 if bi else 1) * h,))
    _compare(jres, tres)


def test_layer_begin_state_and_implicit_states():
    """Without states a call returns the outputs alone, from zero states;
    ``begin_state`` gives the (layers * dirs, N, H) zeros."""
    tl = rnn.LSTM(5, num_layers=2, bidirectional=True, input_size=3)
    tl.initialize(ctx=CPU)
    x = nd.array(_arr((4, 2, 3), 3), ctx=CPU)
    st = tl.begin_state(batch_size=2, ctx=CPU)
    assert [s.shape for s in st] == [(4, 2, 5), (4, 2, 5)]
    out = tl(x)
    out2, _ = tl(x, st)
    assert out.shape == (4, 2, 10)
    np.testing.assert_array_equal(out.asnumpy(), out2.asnumpy())


def test_layer_hybridized_equals_eager():
    """The hybridized layer (a CachedOp call) and its eager self, in
    value and in gradient."""
    tl = rnn.GRU(4, num_layers=2, layout="NTC", input_size=3,
                 prefix="hg_")
    tl.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(_arr((2, 6, 3), 4), ctx=CPU)

    def value_and_grads():
        with autograd.record():
            loss = (tl(x) ** 2).sum()
        loss.backward()
        return loss.asnumpy(), {k: p.grad().asnumpy().copy()
                                for k, p in tl.collect_params().items()}
    eager = value_and_grads()
    tl.hybridize()
    hybrid = value_and_grads()
    assert len(tl._cached_op) == 1
    np.testing.assert_array_equal(hybrid[0], eager[0])
    for k in eager[1]:
        np.testing.assert_array_equal(hybrid[1][k], eager[1][k])


def test_inter_layer_dropout_uses_mx_random():
    """``dropout`` between layers draws from the device's ``mx.random``
    stream in training mode (a seed gives the same output again), and
    is off in predict mode."""
    tl = rnn.LSTM(8, num_layers=2, dropout=0.5, input_size=3)
    ref = rnn.LSTM(8, num_layers=2, input_size=3)
    for b in (tl, ref):
        b.initialize(ctx=CPU, seed=0)
    x = nd.array(_arr((5, 4, 3), 5), ctx=CPU)

    def train_call(seed):
        mx.random.seed(seed)
        with autograd.train_mode():
            return tl(x).asnumpy()
    a, b, c = train_call(1), train_call(1), train_call(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(tl(x).asnumpy(), ref(x).asnumpy())


def test_recurrence_runs_ieee_f32_and_trains_only_when_recording(
        monkeypatch):
    """cuDNN's TF32 flag reads False in the fused call's forward and in
    its backward, whatever the caller set, and the call runs in
    training mode exactly when a gradient is recorded."""
    seen = []
    real = rnn_ops._FUSED["lstm"]

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(("backward", torch.backends.cudnn.allow_tf32))
            return g

    def spy(x, hx, weights, bias, layers, p, train, bi, batch_first):
        seen.append(("forward", torch.backends.cudnn.allow_tf32, train))
        out = real(x, hx, weights, bias, layers, p, train, bi, batch_first)
        return (Spy.apply(out[0]),) + tuple(out[1:])
    monkeypatch.setitem(rnn_ops._FUSED, "lstm", spy)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tl = rnn.LSTM(4, input_size=2)
        tl.initialize(ctx=CPU)
        x = nd.array(_arr((3, 2, 2), 6), ctx=CPU)
        tl(x)
        with autograd.record():
            loss = tl(x).sum()
        loss.backward()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen == [("forward", False, False), ("forward", False, True),
                    ("backward", False)]


def test_nd_rnn_raises_like_the_reference():
    for pkg in (jmx, mx):
        ctx = CPU if pkg is mx else pkg.cpu()
        z = pkg.nd.zeros((2, 1, 3), ctx=ctx)
        with pytest.raises(NotImplementedError, match="gluon.rnn"):
            pkg.nd.RNN(z, pkg.nd.zeros((40,), ctx=ctx), z, state_size=3)


# -- cells --------------------------------------------------------------------

CELLS = {"rnn": ("RNNCell", 1), "lstm": ("LSTMCell", 2),
         "gru": ("GRUCell", 1)}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_step_and_unroll_match_jax(kind):
    """One step, and ``unroll`` over NTC with ``merge_outputs`` and a
    ``valid_length``: outputs, states and every gradient."""
    name, n_states = CELLS[kind]
    jmx.random.seed(1)
    jc = getattr(jrnn, name)(5, prefix="c_")
    jc.initialize(jmx.init.Xavier())
    tc = getattr(rnn, name)(5, prefix="c_")
    tc.initialize(ctx=CPU)
    x = _arr((3, 4, 2), 7)
    jc(jmx.nd.array(x[:, 0]), jc.begin_state(batch_size=3))
    tc(nd.array(x[:, 0], ctx=CPU), tc.begin_state(batch_size=3, ctx=CPU))
    _carry(jc, tc)
    states = [_arr((3, 5), 8 + i, 0.5) for i in range(n_states)]

    def step(cell):
        def call(F, x, *st):
            out, new = cell(x[:, 0], list(st))
            return [out] + list(new)
        return call

    def unroll(cell):
        def call(F, x, *st):
            out, new = cell.unroll(4, x, begin_state=list(st), layout="NTC",
                                   merge_outputs=True,
                                   valid_length=F.array([4, 2, 3],
                                                        ctx=x.context))
            return [out] + list(new)
        return call
    for fn in (step, unroll):
        _compare(_run(jmx, fn(jc), [x] + states, jc.collect_params()),
                 _run(mx, fn(tc), [x] + states, tc.collect_params()))


def _composite(pkg, kind):
    r = pkg.gluon.rnn
    if kind == "sequential":
        cell = r.SequentialRNNCell(prefix="sq_")
        with cell.name_scope():
            cell.add(r.LSTMCell(5, input_size=3))
            cell.add(r.GRUCell(4, input_size=5))
    elif kind == "residual":
        cell = r.ResidualCell(r.GRUCell(3, input_size=3, prefix="res_"))
    else:
        cell = r.BidirectionalCell(r.LSTMCell(4, input_size=3, prefix="l_"),
                                   r.GRUCell(4, input_size=3, prefix="r_"))
    return cell


@pytest.mark.parametrize("kind", ["bidirectional", "residual", "sequential"])
def test_composite_cells_match_jax(kind):
    jmx.random.seed(2)
    jc = _composite(jmx, kind)
    jc.initialize(jmx.init.Xavier())
    tc = _composite(mx, kind)
    tc.initialize(ctx=CPU)
    assert sorted(tc.collect_params().keys()) == \
        sorted(jc.collect_params().keys())
    _carry(jc, tc)
    x = _arr((2, 5, 3), 9)
    valid = [5, 3] if kind == "bidirectional" else None

    def unroll(cell):
        def call(F, x):
            vl = None if valid is None else F.array(valid, ctx=x.context)
            out, states = cell.unroll(5, x, layout="NTC",
                                      merge_outputs=True, valid_length=vl)
            return [out] + list(states)
        return call
    _compare(_run(jmx, unroll(jc), [x], jc.collect_params()),
             _run(mx, unroll(tc), [x], tc.collect_params()))
    if kind == "sequential":
        # a step of the stack: the states of each cell in turn
        st = tc.begin_state(batch_size=2, ctx=CPU)
        out, new = tc(nd.array(x[:, 0], ctx=CPU), st)
        assert out.shape == (2, 4) and len(new) == 3


def test_dropout_cell_statistics_and_modes():
    cell = rnn.DropoutCell(0.4)
    x = nd.ones((200, 50), ctx=CPU)
    mx.random.seed(3)
    with autograd.train_mode():
        out, st = cell(x, [])
    y = out.asnumpy()
    assert st == []
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.6)}
    assert abs((y == 0).mean() - 0.4) < 0.02
    out, _ = cell(x, [])
    np.testing.assert_array_equal(out.asnumpy(), x.asnumpy())


def test_zoneout_cell_statistics_and_modes():
    """In training mode an output element keeps the previous output with
    probability ``zoneout_outputs`` and a state element its old value
    with ``zoneout_states``; in predict mode the base cell's step."""
    base = rnn.GRUCell(64, input_size=8, prefix="zb_")
    ref = rnn.GRUCell(64, input_size=8, prefix="zr_")
    base.initialize(ctx=CPU, seed=4)
    ref.initialize(ctx=CPU, seed=4)
    cell = rnn.ZoneoutCell(base, zoneout_outputs=0.3, zoneout_states=0.6)
    x = nd.array(_arr((256, 8), 10), ctx=CPU)
    h0 = nd.array(_arr((256, 64), 11), ctx=CPU)
    want, [want_h] = ref(x, [h0])
    got, [got_h] = cell(x, [h0])
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    mx.random.seed(5)
    with autograd.train_mode():
        cell.reset()
        out, [h1] = cell(x, [h0])
    o, w, h = out.asnumpy(), want.asnumpy(), h1.asnumpy()
    kept_out = (o == 0.0) & (w != 0.0)     # the previous output is zeros
    assert np.all(kept_out | (o == w))
    assert abs(kept_out.mean() - 0.3) < 0.02
    kept_state = (h == h0.asnumpy()) & (h != want_h.asnumpy())
    assert np.all(kept_state | (h == want_h.asnumpy()))
    assert abs(kept_state.mean() - 0.6) < 0.02
    with pytest.raises(mx.MXNetError, match="modifier"):
        base.begin_state(batch_size=2)


# -- control flow -------------------------------------------------------------

def _foreach(F, data, init, w):
    def body(x, states):
        s, t = states
        new_s = s + x * w
        return [new_s * 2, F.tanh(t)], [new_s, t + new_s]
    outs, finals = F.contrib.foreach(body, data, [init, init * 0.5])
    return list(outs) + list(finals)


def _while(F, i0, s0, x):
    def cond(i, s):
        return i < 3

    def func(i, s):
        return s * x, [i + 1, s * x + 1]
    outs, finals = F.contrib.while_loop(cond, func, [i0, s0],
                                        max_iterations=5)
    return [outs] + list(finals)


def _cond(F, a, b):
    return [F.contrib.cond(a.sum() > b.sum(), lambda: a * a,
                           lambda: b * 3),
            F.contrib.cond(a.sum() < b.sum(), lambda: a * a,
                           lambda: b * 3)]


@pytest.mark.parametrize("op", ["cond", "foreach", "while_loop"])
def test_control_flow_matches_jax(op):
    """Values and the gradients to the data, the states and a captured
    array (``w``, ``x``)."""
    if op == "foreach":
        arrays = [_arr((4, 3), 12), _arr((3,), 13), _arr((3,), 14)]
        fn = _foreach
    elif op == "while_loop":
        arrays = [np.zeros((1,), "f4"), _arr((2,), 15), _arr((2,), 16)]
        fn = _while
    else:
        arrays = [_arr((3,), 17), _arr((3,), 18)]
        fn = _cond
    _compare(_run(jmx, fn, arrays, {}), _run(mx, fn, arrays, {}))


def test_foreach_in_hybridized_block():
    """``F.contrib.foreach`` inside a ``hybrid_forward``: the hybridized
    call (the CachedOp over the unrolled loop) equals the eager one."""
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class ScanNet(HybridBlock):
        def __init__(self):
            super().__init__(prefix="scan_")
            with self.name_scope():
                self.proj = nn.Dense(4, in_units=4, flatten=False)

        def hybrid_forward(self, F, x):
            def body(xt, s):
                h = self.proj(xt) + s
                return h, h
            outs, _ = F.contrib.foreach(
                body, x, F.zeros((x.shape[1], 4), ctx=x.context))
            return outs

    net = ScanNet()
    net.initialize(ctx=CPU)
    x = nd.array(_arr((6, 2, 4), 19), ctx=CPU)
    eager = net(x).asnumpy()
    net.hybridize()
    np.testing.assert_array_equal(net(x).asnumpy(), eager)
    assert len(net._cached_op) == 1
