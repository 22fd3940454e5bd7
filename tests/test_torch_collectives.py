"""The port's collectives over gloo groups of 2 and 4 ranks against the
JAX package's inside ``shard_map`` on 2 and 4 virtual CPU devices.

One spawn a group size runs every case (``_WORKER``); each test then
holds one case against the JAX function on the same seeded inputs:
values to 1e-6, the int8 and 2-bit codes exactly,
the straight-through gradient of ``quantized_psum`` and the gradients of
``vocab_parallel_softmax_ce``.
"""
import numpy as np
import pytest

import torch_dist

SIZES = (2, 4)

_WORKER = r'''
import numpy as np
import torch
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import collectives as col


def main(rank, world, inp):
    parallel.set_mesh(parallel.make_mesh({"dp": world}))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(inp["x"][rank])
    out = {}
    out["psum"] = col.psum(x, "dp").numpy()
    out["pmean"] = col.pmean(x, "dp").numpy()
    out["all_gather"] = col.all_gather(x, "dp", axis=1).numpy()
    out["all_gather_stacked"] = col.all_gather(x, "dp", axis=0,
                                               tiled=False).numpy()
    out["reduce_scatter"] = col.reduce_scatter(
        t(inp["rs"][rank]), "dp").numpy()
    out["reduce_scatter_tiled"] = col.reduce_scatter(
        x, "dp", scatter_dimension=1, tiled=True).numpy()
    perm = [(i, (i + 1) % world) for i in range(world)]
    out["ppermute"] = col.ppermute(x, "dp", perm).numpy()
    out["ppermute_partial"] = col.ppermute(x, "dp", [(0, world - 1)]).numpy()
    out["all_to_all"] = col.all_to_all(x, "dp", 1, 0).numpy()
    vals = [t(v) for v in inp["vals"][rank]]
    out["allreduce"] = [v.numpy() for v in col.allreduce(vals, "dp")]
    g = t(inp["g"][rank]).requires_grad_(True)
    y = col.quantized_psum(g, "dp")
    (y * y).sum().backward()
    out["qpsum"], out["qpsum_grad"] = y.detach().numpy(), g.grad.numpy()
    out["qpsum_many"] = [a.numpy() for a in col.quantized_psum_many(
        [t(inp["g"][rank]), t(inp["g2"][rank])], "dp")]
    out["qrs"] = col.quantized_reduce_scatter(t(inp["g"][rank]),
                                              "dp").numpy()
    res = None
    out["twobit"] = []
    for step in range(2):
        s, res = col.twobit_psum(t(inp["tb"][step][rank]), "dp",
                                 threshold=0.3, residual=res)
        out["twobit"].append((s.numpy(), res.numpy()))
    h = t(inp["h"]).requires_grad_(True)
    w = t(inp["w"][rank]).requires_grad_(True)
    loss = col.vocab_parallel_softmax_ce(h, w, t(inp["lbl"]), "dp")
    loss.sum().backward()
    out["vpce"] = (loss.detach().numpy(), h.grad.numpy(), w.grad.numpy())

    def upd(p, g, m):
        m = 0.9 * m + g
        return p - 0.1 * m, (m,)
    p = t(inp["param"])
    st = col.sharded_update_state_init(p, 1, world)
    new, (m,) = col.sharded_weight_update(p, t(inp["pg"][rank]), st, upd,
                                          "dp")
    new2, _ = col.sharded_weight_update(
        p, col.psum(t(inp["pg"][rank]), "dp"), st, upd, "dp",
        grad_reduce="local")
    out["swu"] = (new.numpy(), m.numpy(), new2.numpy())
    if world == 4:
        parallel.set_mesh(parallel.make_mesh({"dp": 2, "tp": 2}))
        out["sub_axes"] = {a: col.psum(x, a).numpy() for a in ("dp", "tp")}
        out["sub_gather"] = col.all_gather(x, "tp", axis=0).numpy()
    out["counts"] = col.counts()
    return out
'''


def _inputs(n):
    rng = np.random.RandomState(17 + n)
    f = lambda *s: rng.randn(*s).astype("f4")
    g = f(n, 37)
    g[:, 5] = 0.5 * np.abs(g).max()     # a value on an int8 tie
    return {"x": f(n, 4, 2 * n), "rs": f(n, n, 3),
            "vals": [[f(3), f(3)] for _ in range(n)],
            "g": g, "g2": f(n, 3, 5), "tb": [f(n, 2, 9), f(n, 2, 9)],
            "h": f(6, 8), "w": f(n, 5, 8),
            "lbl": rng.randint(0, 5 * n, 6).astype("i8"),
            "param": f(3, 7), "pg": f(n, 3, 7)}


_RESULTS = {}


def _spawned(n, tmp_path_factory):
    """(inputs, every rank's results) of the one spawn of n ranks."""
    if n not in _RESULTS:
        inp = _inputs(n)
        _RESULTS[n] = (inp, torch_dist.spawn(
            n, _WORKER, inp, tmp_path_factory.mktemp(f"col{n}")))
    return _RESULTS[n]


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"w{n}")
def group(request, tmp_path_factory):
    n = request.param
    return (n,) + _spawned(n, tmp_path_factory)


def _smap(n, body, *args, out_specs=None, in_specs=None, check_vma=False):
    """``body`` in ``shard_map`` over n virtual devices (axis "dp"),
    each argument split on its leading axis unless ``in_specs`` says."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from mxnet_tpu.parallel._compat import shard_map
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    in_specs = in_specs or tuple(P("dp") for _ in args)
    f = shard_map(body, mesh=mesh, in_specs=in_specs,
                  out_specs=P("dp") if out_specs is None else out_specs,
                  check_vma=check_vma)
    return f, [jnp.asarray(a) for a in args]


def _run(n, body, *args, **kw):
    import jax
    f, a = _smap(n, body, *args, **kw)
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(*a))


def _codes(values, n):
    """The int8 codes of an all-gathered quantized sum, recovered chunk
    by chunk: each chunk's largest magnitude is code 127, so its scale is
    that / 127."""
    flat = np.asarray(values, "f8").reshape(-1)
    chunk = -(-flat.size // n)
    out = []
    for i in range(0, flat.size, chunk):
        c = flat[i:i + chunk]
        scale = np.abs(c).max() / 127 if np.abs(c).max() else 1.0
        out.append(np.round(c / scale).astype("i1"))
    return np.concatenate(out)


def test_psum_pmean_all_gather(group):
    from jax import lax
    n, inp, res = group
    x = inp["x"]
    psum = _run(n, lambda v: lax.psum(v, "dp"), x)
    pmean = _run(n, lambda v: lax.pmean(v, "dp"), x)
    gath = _run(n, lambda v: lax.all_gather(v[0], "dp", axis=1,
                                            tiled=True)[None], x)
    stk = _run(n, lambda v: lax.all_gather(v[0], "dp", axis=0,
                                           tiled=False)[None], x)
    for r in range(n):
        np.testing.assert_allclose(res[r]["psum"], psum[r], atol=1e-6)
        np.testing.assert_allclose(res[r]["pmean"], pmean[r], atol=1e-6)
        np.testing.assert_array_equal(res[r]["all_gather"], gath[r])
        np.testing.assert_array_equal(res[r]["all_gather_stacked"],
                                      stk[r])


def test_reduce_scatter_ppermute_all_to_all(group):
    from jax import lax
    n, inp, res = group
    rs = _run(n, lambda v: lax.psum_scatter(v[0], "dp")[None], inp["rs"])
    rst = _run(n, lambda v: lax.psum_scatter(
        v[0], "dp", scatter_dimension=1, tiled=True)[None], inp["x"])
    perm = [(i, (i + 1) % n) for i in range(n)]
    pp = _run(n, lambda v: lax.ppermute(v, "dp", perm), inp["x"])
    pp1 = _run(n, lambda v: lax.ppermute(v, "dp", [(0, n - 1)]), inp["x"])
    a2a = _run(n, lambda v: lax.all_to_all(v[0], "dp", 1, 0,
                                           tiled=True)[None], inp["x"])
    for r in range(n):
        np.testing.assert_allclose(res[r]["reduce_scatter"], rs[r],
                                   atol=1e-6)
        np.testing.assert_allclose(res[r]["reduce_scatter_tiled"], rst[r],
                                   atol=1e-6)
        np.testing.assert_array_equal(res[r]["ppermute"], pp[r])
        np.testing.assert_array_equal(res[r]["ppermute_partial"], pp1[r])
        np.testing.assert_array_equal(res[r]["all_to_all"], a2a[r])


def test_allreduce_of_local_values(group):
    """Each rank's values and every other rank's, summed (the JAX
    package's ``allreduce`` over one value a mesh member)."""
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jpar
    n, inp, res = group
    flat = [v for vals in inp["vals"] for v in vals]
    mesh = jpar.make_mesh({"dp": len(flat)})
    want = jpar.collectives.allreduce(
        [jmx.nd.array(v, ctx=jmx.cpu(0)) for v in flat], axis="dp",
        mesh=mesh)[0].asnumpy()
    for r in range(n):
        for got in res[r]["allreduce"]:
            np.testing.assert_allclose(got, want, atol=1e-6)


def test_quantized_psum_and_its_gradient(group):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel import collectives as jcol
    n, inp, res = group
    body = lambda v: jcol.quantized_psum(v[0], "dp")[None]
    want = _run(n, body, inp["g"])
    f, (g,) = _smap(n, body, inp["g"])
    grad = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(f(v) ** 2)))(g))
    many = _run(n, lambda a, b: tuple(
        jcol.quantized_psum(v[0], "dp")[None] for v in (a, b)),
        inp["g"], inp["g2"], out_specs=(P("dp"), P("dp")))
    qrs = _run(n, lambda v: jcol.quantized_reduce_scatter(v[0], "dp")[None],
               inp["g"])
    for r in range(n):
        # XLA contracts the dequantizing sum into FMAs, so a partial sum
        # (and its scale) may sit one ulp away; the codes are equal
        np.testing.assert_allclose(res[r]["qpsum"], want[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(_codes(res[r]["qpsum"], n),
                                      _codes(want[r], n))
        np.testing.assert_allclose(res[r]["qpsum_grad"], grad[r],
                                   rtol=1e-6, atol=1e-6)
        for got, w in zip(res[r]["qpsum_many"], many):
            np.testing.assert_allclose(got, w[r], rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(_codes(got, n), _codes(w[r], n))
        np.testing.assert_allclose(res[r]["qrs"], qrs[r], rtol=1e-6,
                                   atol=1e-6)


def test_twobit_psum_with_residuals(group):
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel import collectives as jcol
    n, inp, res = group
    resid = np.zeros_like(inp["tb"][0])
    for step in range(2):
        s, resid = _run(
            n, lambda v, rr: tuple(a[None] for a in jcol.twobit_psum(
                v[0], "dp", threshold=0.3, residual=rr[0])),
            inp["tb"][step], resid, out_specs=(P("dp"), P("dp")))
        for r in range(n):
            got_s, got_res = res[r]["twobit"][step]
            np.testing.assert_array_equal(got_s, s[r])
            np.testing.assert_allclose(got_res, resid[r], atol=1e-6)


def test_vocab_parallel_softmax_ce(group):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel import collectives as jcol
    n, inp, res = group
    body = lambda h, w, l: jcol.vocab_parallel_softmax_ce(h, w, l, "dp")
    f, (h, w, lbl) = _smap(n, body, inp["h"],
                           inp["w"].reshape(-1, inp["w"].shape[-1]),
                           inp["lbl"].astype("i4"),
                           in_specs=(P(), P("dp"), P()), out_specs=P(),
                           check_vma=True)
    loss = np.asarray(jax.jit(f)(h, w, lbl))
    gh, gw = jax.jit(jax.grad(lambda a, b: jnp.sum(f(a, b, lbl)),
                              (0, 1)))(h, w)
    gw = np.asarray(gw).reshape(inp["w"].shape)
    for r in range(n):
        got_loss, got_gh, got_gw = res[r]["vpce"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_gh, np.asarray(gh), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got_gw, gw[r], rtol=1e-5, atol=1e-6)


def test_sharded_weight_update(group):
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel import collectives as jcol
    n, inp, res = group

    def upd(p, g, m):
        m = 0.9 * m + g
        return p - 0.1 * m, (m,)

    st = jcol.sharded_update_state_init(inp["param"], 1, n)
    for mode in ("scatter", "local"):
        def body(p, g, m, _mode=mode):
            grad = g[0] if _mode == "scatter" else lax.psum(g[0], "dp")
            new, (m2,) = jcol.sharded_weight_update(
                p, grad, (m[0],), upd, "dp", grad_reduce=_mode)
            return new[None], m2[None]
        new, m = _run(n, body, inp["param"], inp["pg"], st[0],
                      in_specs=(P(), P("dp"), P("dp")),
                      out_specs=(P("dp"), P("dp")))
        for r in range(n):
            got_new, got_m, got_new2 = res[r]["swu"]
            np.testing.assert_allclose(
                got_new if mode == "scatter" else got_new2, new[r],
                rtol=1e-6, atol=1e-6)
            if mode == "scatter":
                assert got_m.shape == st[0][r].shape
                np.testing.assert_allclose(got_m, m[r], rtol=1e-6,
                                           atol=1e-6)


def test_named_sub_axes(tmp_path_factory):
    """On a {"dp": 2, "tp": 2} mesh of 4 ranks (row-major), psum and
    all_gather over one named axis reduce over its sub-group, as the JAX
    functions do over that axis of a 2 x 2 device mesh."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    from mxnet_tpu.parallel._compat import shard_map
    inp, res = _spawned(4, tmp_path_factory)
    x = inp["x"].reshape((2, 2) + inp["x"].shape[1:])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    spec = P("dp", "tp")
    for a in ("dp", "tp"):
        f = shard_map(lambda v, _a=a: lax.psum(v, _a), mesh=mesh,
                      in_specs=spec, out_specs=spec, check_vma=False)
        want = np.asarray(jax.jit(f)(jnp.asarray(x))).reshape(inp["x"].shape)
        for r in range(4):
            np.testing.assert_allclose(res[r]["sub_axes"][a], want[r],
                                       atol=1e-6)
    g = shard_map(lambda v: lax.all_gather(v[0, 0], "tp", axis=0,
                                           tiled=True)[None, None],
                  mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    want = np.asarray(jax.jit(g)(jnp.asarray(x)))
    for r in range(4):
        np.testing.assert_array_equal(res[r]["sub_gather"],
                                      want[r // 2, r % 2])


def test_counts_and_wire_bytes(group):
    """Every call is counted, and the int8 and 2-bit exchanges move int8
    bytes."""
    n, _, res = group
    c = res[0]["counts"]
    assert c["calls"] > 20
    assert 0 < c["wire_bytes"] < 2 * c["payload_bytes"]
