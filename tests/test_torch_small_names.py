"""The small public names of ported modules that the port lacked
(``nd.contrib.boolean_mask``/``fft``/``ifft``, ``cpu_pinned``,
``mx.runtime``, ``test_utils``' helpers, ``base``'s type tuples,
``envs.registry``, ``serving.servers``), each held against the JAX
package on the CPU."""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

import torch_parity


@pytest.mark.parametrize("axis", [0, 1])
def test_boolean_mask(axis):
    rng = np.random.RandomState(axis)
    data = rng.randn(4, 5).astype("f4")
    mask = np.array([1, 0, 1, 1, 0][:data.shape[axis]], "i4")
    # the output's shape depends on the mask's values: no compiled run
    torch_parity.check(lambda F, d, m: F.contrib.boolean_mask(d, m,
                                                              axis=axis),
                       [data, mask], compiled=False)


def test_boolean_mask_checks_the_length():
    x = tmx.nd.zeros((3, 2), ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="mask length"):
        tmx.nd.contrib.boolean_mask(x, tmx.nd.ones((4,), ctx=tmx.cpu()))


@pytest.mark.parametrize("shape", [(3, 8), (2, 3, 4)])
def test_fft_and_ifft(shape):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype("f4")
    torch_parity.check(lambda F, a: F.contrib.fft(a), [x], rtol=1e-5,
                       atol=1e-5)
    torch_parity.check(lambda F, a: F.contrib.ifft(a),
                       [rng.randn(*shape[:-1], 2 * shape[-1]).astype("f4")],
                       rtol=1e-5,
                       atol=1e-5)
    # the reference's ifft does not divide by n
    torch_parity.check(lambda F, a: F.contrib.ifft(F.contrib.fft(a)), [x],
                       rtol=1e-5, atol=1e-4)


def test_cpu_pinned():
    for mx in (jmx, tmx):
        ctx = mx.cpu_pinned(1)
        assert str(ctx) == "cpu_pinned(1)" and ctx == mx.cpu_pinned(1)
        assert ctx != mx.cpu(1)
        assert mx.context.cpu_pinned is mx.cpu_pinned
    a = tmx.nd.array(np.arange(6, dtype="f4"), ctx=tmx.cpu_pinned())
    z = tmx.nd.zeros((2, 3), ctx=tmx.cpu_pinned())
    c = tmx.nd.ones((2,), ctx=tmx.cpu()).copyto(tmx.cpu_pinned())
    for x in (a, z, c):
        assert x.context == tmx.cpu_pinned(0)
        # page-locked when a card is present
        assert x.tensor.is_pinned() == torch.cuda.is_available()
    np.testing.assert_array_equal((a * 2).asnumpy(), np.arange(6) * 2)


def test_runtime_features():
    feats = tmx.runtime.Features()
    assert feats is tmx.runtime.Features()
    names = set(feats)
    assert {"CUDA", "CUDNN", "NCCL", "DIST_KVSTORE", "INT8", "F16"} <= names
    assert not any("TPU" in n or "PJRT" in n or "PALLAS" in n for n in names)
    assert feats.is_enabled("cuda") == torch.cuda.is_available()
    assert feats.is_enabled("DIST_KVSTORE")
    assert all(isinstance(f, tmx.runtime.Feature)
               for f in tmx.runtime.feature_list())
    # the reference's names for what both builds report
    ref = jmx.runtime.Features()
    for name in ("CUDA", "CUDNN", "NCCL", "DIST_KVSTORE", "F16C", "OPENCV"):
        assert name in ref and name in feats
    for mod in (jmx, tmx):
        with pytest.raises(RuntimeError, match="does not exist"):
            mod.runtime.Features().is_enabled("NO_SUCH_FEATURE")
        assert repr(mod.runtime.feature_list()[0]).startswith("[")


def test_test_utils_helpers():
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype("f4")
    b = a + np.float32(1e-6)
    for j, t in ((jmx.test_utils, tmx.test_utils),):
        for x, y in ((a, a), (a, b), (a, a + 1)):
            assert t.same(x, y) == j.same(x, y)
            assert t.almost_equal(x, y) == j.almost_equal(x, y)
            assert t.almost_equal(x, y, rtol=0, atol=0) == \
                j.almost_equal(x, y, rtol=0, atol=0)
        assert t.same(tmx.nd.array(a, ctx=tmx.cpu()), a)
        np.random.seed(3)
        js = j.rand_shape_nd(4, dim=6)
        np.random.seed(3)
        ts = t.rand_shape_nd(4, dim=6)
        assert js == ts and len(ts) == 4 and all(1 <= d <= 6 for d in ts)
    with tmx.cpu():
        got = tmx.test_utils.check_consistency(
            lambda x, y: x * y + 1, [a, a], [tmx.cpu(0), tmx.cpu(1)])
    want = jmx.test_utils.check_consistency(
        lambda x, y: x * y + 1, [a, a], [jmx.cpu(0), jmx.cpu(1)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-6)


def test_base_types_and_the_env_registry():
    assert tmx.base.integer_types == jmx.base.integer_types
    assert tmx.base.string_types == jmx.base.string_types
    reg = tmx.envs.registry()
    assert "MXTPU_ZERO_STAGE" in reg
    ref = jmx.envs.registry()
    for name, var in reg.items():
        assert name in ref, name
        assert var.default == ref[name].default, name
    reg.clear()
    assert tmx.envs.registry()


def test_serving_servers():
    from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from mxnet_tpu_torch.serving import Server, servers
    before = len(servers())
    lm = LlamaForCausalLM(llama_tiny(vocab_size=61), ctx=tmx.cpu())
    srv = Server(lm, buckets=[(2, 8)], max_new_tokens=2, ctx=tmx.cpu())
    assert srv in servers() and len(servers()) == before + 1
    assert callable(jmx.serving.servers)
    del srv
    gc.collect()
    assert len(servers()) == before
