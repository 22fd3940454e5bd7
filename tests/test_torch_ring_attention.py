"""Ring attention over gloo groups of two and four ranks (``sp``) against
the JAX package's ``parallel.ring_attention`` on meshes of two and four
virtual CPU devices, from the same numpy inputs: grouped-query (4 query
heads over 2 KV heads), causal and not, the output and the gradients of
q, k and v (float32, rtol 1e-5 and atol 1e-5).  ``LlamaModel(attn_impl=
"ring")`` at sp = 2 gives the sdpa model's logits and gradients from the
same weights; the JAX package's errors (a ring with a sliding window, a
hybridized ring model) hold here too.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx

import torch_dist

B, S, H, KV, D = 2, 16, 4, 2, 8

_WORKER = r'''
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd, parallel
from mxnet_tpu_torch.models import LlamaForCausalLM, get_llama


def ring(inp, n, causal):
    mesh = parallel.make_mesh({"sp": n})
    q, k, v = (torch.tensor(inp[x], requires_grad=True)
               for x in ("q", "k", "v"))
    out = parallel.ring_attention(q, k, v, mesh=mesh, causal=causal)
    (out * torch.tensor(inp["cot"])).sum().backward()
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def llama(inp, n):
    parallel.set_mesh(parallel.make_mesh({"sp": n}))
    toks = nd.array(inp["tokens"])
    got = {}
    for impl in ("sdpa", "ring"):
        net = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=61,
                                         attn_impl=impl), ctx=mx.cpu())
        net.initialize(std=0.05, seed=3)
        params = net.collect_params()
        with autograd.record():
            logits = net(toks)
            loss = (logits * logits).mean()
        loss.backward()
        got[impl] = (logits.asnumpy(),
                     {k.split("_", 1)[1]: p.grad().asnumpy()
                      for k, p in params.items()})
    parallel.set_mesh(None)
    return got


def main(rank, world, inp):
    out = {c: ring(inp, world, c) for c in (False, True)}
    if world == 2:
        out["llama"] = llama(inp, world)
    return out
'''


def _inputs():
    rng = np.random.RandomState(0)
    return {"q": rng.randn(B, S, H, D).astype("f4"),
            "k": rng.randn(B, S, KV, D).astype("f4"),
            "v": rng.randn(B, S, KV, D).astype("f4"),
            "cot": rng.randn(B, S, H, D).astype("f4"),
            "tokens": rng.randint(0, 61, (2, 16)).astype("f4")}


def _jax_ring(inp, n, causal):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    mesh = jpar.make_mesh({"sp": n})

    def f(q, k, v):
        out = jpar.ring_attention(q, k, v, mesh=mesh, causal=causal)
        return (out * jnp.asarray(inp["cot"])).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(inp["q"]), jnp.asarray(inp["k"]),
        jnp.asarray(inp["v"]))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_jax(n, tmp_path):
    inp = _inputs()
    out = torch_dist.spawn(n, _WORKER, inp, tmp_path)
    for causal in (False, True):
        want = _jax_ring(inp, n, causal)
        for r in range(n):
            for what, g, w in zip(("out", "dq", "dk", "dv"),
                                  out[r][causal], want):
                np.testing.assert_allclose(
                    g, w, rtol=1e-5, atol=1e-5,
                    err_msg=f"sp={n} causal={causal} rank {r} {what}")
    if n == 2:
        for r in range(n):
            (l_sdpa, g_sdpa), (l_ring, g_ring) = (
                out[r]["llama"]["sdpa"], out[r]["llama"]["ring"])
            np.testing.assert_allclose(l_ring, l_sdpa, rtol=1e-5,
                                       atol=1e-5)
            for k, g in g_sdpa.items():
                np.testing.assert_allclose(g_ring[k], g, rtol=1e-4,
                                           atol=1e-6, err_msg=k)


def test_ring_with_a_sliding_window_raises():
    from mxnet_tpu_torch.models import get_llama
    with pytest.raises(mx.MXNetError, match="sliding_window"):
        get_llama("mistral_tiny", attn_impl="ring")


def test_hybridized_ring_model_raises():
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import LlamaForCausalLM, get_llama
    with mx.cpu():
        net = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=61,
                                         attn_impl="ring"), ctx=mx.cpu())
        net.hybridize()
        with pytest.raises(mx.MXNetError, match="ring attention"):
            net(nd.array(np.zeros((2, 8), "f4")))


def test_ring_attention_at_one_rank_is_attention():
    """A mesh axis of one rank: the ring is one step, the plain GQA
    attention (the card's case)."""
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops.attention import sdpa_plain
    inp = _inputs()
    with mx.cpu():
        mesh = parallel.make_mesh({"sp": 1})
        q, k, v = (torch.tensor(inp[x]) for x in ("q", "k", "v"))
        for causal in (False, True):
            got = parallel.ring_attention(q, k, v, mesh=mesh,
                                          causal=causal)
            want = sdpa_plain(q, k, v, None, 1.0 / np.sqrt(D), causal)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)
