"""Pipelines over gloo groups of two and four ranks (``pp``) against the
JAX package's ``parallel.pipeline_apply`` (GPipe) and
``pipeline_value_and_grad`` (1F1B) on meshes of two and four virtual
CPU devices and against the sequential oracle of
``tests/test_parallel_pipeline.py``: the stacked tanh stages, more
microbatches than stages at pp=2, the loss and every stage's gradients
(float32, rtol 1e-5 and atol 1e-6 against JAX, 1e-4 and 1e-5 against the
oracle, as the JAX tests hold theirs), a stage's own rows of the GPipe
gradient, a bfloat16 stack's gradient type, and the argument errors.
The vocabulary-sharded streaming cross-entropy,
``chunked_softmax_ce(axis_name="tp")`` and
``vocab_parallel_softmax_ce(chunk=)`` at tp=2, matches the JAX function
over the whole head (loss, hidden's and the shard's gradients).
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx

import torch_dist

DIM, MB = 8, 2

_WORKER = r'''
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.ops.nn import chunked_softmax_ce


def stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def loss_fn(out, y):
    return ((out - y) ** 2).mean()


def main(rank, world, inp):
    mesh = parallel.make_mesh({"pp": world})
    out = {}
    W, b = torch.tensor(inp["W"]), torch.tensor(inp["b"])
    X, Y = torch.tensor(inp["X"]), torch.tensor(inp["Y"])
    m = inp["m"]
    loss, (gw, gb) = parallel.pipeline_value_and_grad(
        stage, (W, b), X, Y, loss_fn, m, mesh=mesh)
    out["1f1b"] = (float(loss), gw.numpy(), gb.numpy())
    # the rank's own stage given alone: its rows of the gradient
    loss1, (gw1, gb1) = parallel.pipeline_value_and_grad(
        stage, (W[rank:rank + 1], b[rank:rank + 1]), X, Y, loss_fn, m,
        mesh=mesh)
    out["local"] = (float(loss1), gw1.numpy(), gb1.numpy())
    Wg = W.clone().requires_grad_()
    ys = parallel.pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]), {"w": Wg, "b": b},
        X, m, mesh=mesh)
    (ys * ys).sum().backward()
    out["gpipe"] = (ys.detach().numpy(), Wg.grad[rank].numpy())
    lb, (gwb, _) = parallel.pipeline_value_and_grad(
        stage, (W.bfloat16(), b.bfloat16()), X.bfloat16(), Y.bfloat16(),
        loss_fn, m, mesh=mesh)
    out["bf16"] = str(gwb.dtype)
    if world == 2:
        tp = parallel.make_mesh({"tp": 2})
        parallel.set_mesh(tp)
        v = inp["head"].shape[0] // 2
        for kind in ("chunked", "vocab"):
            h = torch.tensor(inp["hidden"], requires_grad=True)
            w = torch.tensor(inp["head"][rank * v:(rank + 1) * v],
                             requires_grad=True)
            lbl = torch.tensor(inp["labels"])
            if kind == "chunked":
                per_row = chunked_softmax_ce(h, w, lbl, chunk=7,
                                             axis_name="tp")
            else:
                per_row = parallel.vocab_parallel_softmax_ce(
                    h, w, lbl, "tp", chunk=7)
            (per_row * torch.tensor(inp["row_w"])).sum().backward()
            out[kind] = (per_row.detach().numpy(), h.grad.numpy(),
                         w.grad.numpy())
        parallel.set_mesh(None)
    return out
'''


def _inputs(n, m):
    rng = np.random.RandomState(0)
    return {"W": rng.randn(n, DIM, DIM).astype("f4") * 0.4,
            "b": rng.randn(n, DIM).astype("f4") * 0.1,
            "X": rng.randn(m * MB, DIM).astype("f4"),
            "Y": rng.randn(m * MB, DIM).astype("f4"), "m": m,
            "hidden": rng.randn(6, 5).astype("f4"),
            "head": rng.randn(30, 5).astype("f4"),
            "labels": rng.randint(0, 30, 6).astype("f4"),
            "row_w": rng.rand(6).astype("f4")}


def _oracle(inp):
    """The sequential loss and gradients, in float64."""
    import torch
    W = torch.tensor(inp["W"], dtype=torch.float64, requires_grad=True)
    b = torch.tensor(inp["b"], dtype=torch.float64, requires_grad=True)
    m = inp["m"]
    xs = torch.tensor(inp["X"], dtype=torch.float64).reshape(m, MB, DIM)
    ys = torch.tensor(inp["Y"], dtype=torch.float64).reshape(m, MB, DIM)
    total = 0.0
    for i in range(m):
        h = xs[i]
        for s in range(W.shape[0]):
            h = torch.tanh(h @ W[s] + b[s])
        total = total + ((h - ys[i]) ** 2).mean()
    loss = total / m
    loss.backward()
    return float(loss.detach()), W.grad.numpy(), b.grad.numpy()


def _jax(inp, n):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    mesh = jpar.make_mesh({"pp": n})

    def stage(params, x):
        w, bb = params
        return jnp.tanh(x @ w + bb)

    def loss_fn(out, y):
        return ((out - y) ** 2).mean()

    W, b = jnp.asarray(inp["W"]), jnp.asarray(inp["b"])
    X = jnp.asarray(inp["X"])
    loss, grads = jpar.pipeline_value_and_grad(
        stage, (W, b), X, jnp.asarray(inp["Y"]), loss_fn, inp["m"],
        mesh=mesh)

    def gpipe(ps):
        y = jpar.pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                                ps, X, inp["m"], mesh=mesh)
        return jnp.sum(y * y), y

    (_, ys), g = jax.value_and_grad(gpipe, has_aux=True)({"w": W, "b": b})
    return (float(loss), np.asarray(grads[0]), np.asarray(grads[1]),
            np.asarray(ys), np.asarray(g["w"]))


@pytest.mark.parametrize("n,m", [(2, 8), (4, 4)])
def test_pipelines_match_jax_and_the_oracle(n, m, tmp_path):
    inp = _inputs(n, m)
    out = torch_dist.spawn(n, _WORKER, inp, tmp_path)
    j_loss, j_gw, j_gb, j_ys, j_gpw = _jax(inp, n)
    o_loss, o_gw, o_gb = _oracle(inp)
    np.testing.assert_allclose(j_loss, o_loss, rtol=1e-5)
    for r in range(n):
        loss, gw, gb = out[r]["1f1b"]
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(loss, o_loss, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gw, j_gw, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gb, j_gb, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gw, o_gw, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gb, o_gb, rtol=1e-4, atol=1e-5)
        loss1, gw1, gb1 = out[r]["local"]
        assert loss1 == loss and gw1.shape == (1, DIM, DIM)
        np.testing.assert_array_equal(gw1[0], gw[r])
        np.testing.assert_array_equal(gb1[0], gb[r])
        ys, gpw = out[r]["gpipe"]
        np.testing.assert_allclose(ys, j_ys, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gpw, j_gpw[r], rtol=1e-5, atol=1e-5)
        assert out[r]["bf16"] == "torch.bfloat16"


def test_vocab_sharded_streaming_ce_matches_jax_tp2(tmp_path):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.nn import chunked_softmax_ce as jce
    inp = _inputs(2, 8)
    out = torch_dist.spawn(2, _WORKER, inp, tmp_path)

    def f(h, w):
        per_row = jce(h, w, jnp.asarray(inp["labels"]), chunk=7)
        return (per_row * jnp.asarray(inp["row_w"])).sum(), per_row

    (_, want), (gh, gw) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(inp["hidden"]), jnp.asarray(inp["head"]))
    for r in range(2):
        for kind in ("chunked", "vocab"):
            per_row, h_grad, w_grad = out[r][kind]
            np.testing.assert_allclose(per_row, want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(h_grad, gh, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(w_grad, np.asarray(gw)[r * 15:
                                                              (r + 1) * 15],
                                       rtol=1e-5, atol=1e-6)


def test_pipeline_argument_errors():
    import torch
    from mxnet_tpu_torch import parallel
    w = (torch.zeros(1, 4, 4), torch.zeros(1, 4))
    x = torch.zeros(8, 4)

    def stage(p, t):
        return t

    with mx.cpu():
        mesh = parallel.make_mesh({"pp": 1})
        with pytest.raises(mx.MXNetError, match="not divisible"):
            parallel.pipeline_apply(stage, w, torch.zeros(7, 4), 2,
                                    mesh=mesh)
        with pytest.raises(mx.MXNetError, match="y batch"):
            parallel.pipeline_value_and_grad(
                stage, w, x, torch.zeros(6, 4), lambda o, y: o.sum(), 2,
                mesh=mesh)
        with pytest.raises(mx.MXNetError, match="leading dims"):
            parallel.pipeline_apply(stage, (torch.zeros(3, 4, 4),), x, 2,
                                    mesh=mesh)
        with pytest.raises(mx.MXNetError, match="no axis"):
            parallel.pipeline_apply(stage, w, x, 2, mesh=mesh, axis="tp")
        plan = parallel.ShardingPlan({"dp": 1, "stages": 1},
                                     pp_axis="stages")
        # the plan supplies the mesh and the stage axis
        ys = parallel.pipeline_apply(lambda p, t: t + 1, w, x, 2,
                                     plan=plan)
        assert float(ys.sum()) == x.numel()
