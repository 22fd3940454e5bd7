"""The vision group of the registry (``BilinearResize2D``, ``UpSampling``,
``L2Normalization``, ``LRN``, ``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``Correlation``, ``Crop``, ``depth_to_space``,
``space_to_depth``, ``_contrib_AdaptiveAvgPooling2D``) against the JAX
package's, op by op.

Each case runs one callable through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the same seeded numpy inputs on the CPU
(``torch_parity.check``): outputs, dtypes and the gradients of every
floating input agree to rtol 1e-5 / atol 1e-6 (the f32 tolerance of
``mxnet_tpu/test_utils.py``).  The cases of the JAX package's own tests
(``tests/test_ops_extra.py``, ``test_segmentation.py``,
``test_contrib_ops2.py``) are among them, with their inputs.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

import torch_parity

CPU = mx.cpu()
RNG = np.random.RandomState(15)


def _n(*shape):
    return RNG.randn(*shape).astype("f4")


X = _n(2, 3, 6, 5)
SEG = _n(2, 4, 3, 4)          # a stride-32 head's logits
THETA = (np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.02]] * 2)
         + 0.05 * RNG.randn(2, 6)).astype("f4")
ROW = np.asarray([[[[1.0, 2.0, 3.0, 100.0]]]], "f4")
SHIFT = np.asarray([[1, 0, 2.0 / 5, 0, 1, 0]], "f4")
VISION = {
    # the segmentation heads' upsampling: up by 32, and a shrink by 3
    # (antialiased) with unequal axes
    "BilinearResize2D_up32": (lambda F, a: F.BilinearResize2D(
        a, height=96, width=128), [SEG]),
    "BilinearResize2D_down3": (lambda F, a: F.BilinearResize2D(
        a, height=2, width=2), [X]),
    "BilinearResize2D_scale": (lambda F, a: F.BilinearResize2D(
        a, scale_height=1.5, scale_width=0.6), [X]),
    "BilinearResize2D_one_axis": (lambda F, a: F.BilinearResize2D(
        a, height=6, width=9), [X]),
    "UpSampling_nearest": (lambda F, a: F.UpSampling(a, scale=2), [X]),
    "UpSampling_bilinear": (lambda F, a: F.UpSampling(
        a, scale=3, sample_type="bilinear"), [X]),
    "L2Normalization": (lambda F, a: F.L2Normalization(a), [X]),
    "L2Normalization_channel": (lambda F, a: F.L2Normalization(
        a, mode="channel"), [X]),
    "L2Normalization_spatial": (lambda F, a: F.L2Normalization(
        a, mode="spatial", eps=1e-3), [X]),
    "LRN": (lambda F, a: F.LRN(a, nsize=3, alpha=1e-2, beta=0.5,
                               knorm=1.0), [_n(1, 5, 3, 3)]),
    "LRN_default": (lambda F, a: F.LRN(a), [_n(2, 7, 3, 2)]),
    "GridGenerator_affine": (lambda F, t: F.GridGenerator(
        t, transform_type="affine", target_shape=(5, 7)), [THETA]),
    "GridGenerator_warp": (lambda F, t: F.GridGenerator(
        t, transform_type="warp"), [_n(2, 2, 4, 5)]),
    "BilinearSampler": (lambda F, a, g: F.BilinearSampler(a, g), [
        X, RNG.uniform(-1.2, 1.2, (2, 2, 4, 7)).astype("f4")]),
    "SpatialTransformer": (lambda F, a, t: F.SpatialTransformer(
        a, t, target_shape=(4, 6)), [X, THETA]),
    "SpatialTransformer_shift": (lambda F, a, t: F.SpatialTransformer(
        a, t, target_shape=(6, 6)), [_n(1, 2, 6, 6), SHIFT]),
    "Correlation": (lambda F, a, b: F.Correlation(
        a, b, max_displacement=1, pad_size=1), [_n(1, 3, 8, 8),
                                               _n(1, 3, 8, 8)]),
    "Correlation_kernel_stride": (lambda F, a, b: F.Correlation(
        a, b, kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
        [X, _n(2, 3, 6, 5)]),
    "Correlation_sad": (lambda F, a, b: F.Correlation(
        a, b, max_displacement=1, pad_size=1, is_multiply=False),
        [_n(1, 2, 6, 6), _n(1, 2, 6, 6)]),
    "Correlation_zero_border": (lambda F, a: F.Correlation(
        a, a, max_displacement=1, pad_size=1), [ROW]),
    "Crop": (lambda F, a: F.Crop(a, offset=(1, 2), h_w=(4, 3)), [X]),
    "Crop_center": (lambda F, a: F.Crop(a, h_w=(4, 4), center_crop=True),
                    [_n(2, 3, 8, 8)]),
    "Crop_like": (lambda F, a, b: F.Crop(a, b, num_args=2),
                  [_n(2, 3, 8, 8), _n(2, 3, 5, 5)]),
    "depth_to_space": (lambda F, a: F.depth_to_space(a, block_size=2),
                       [_n(2, 8, 3, 2)]),
    "space_to_depth": (lambda F, a: F.space_to_depth(a, block_size=2),
                       [_n(2, 3, 4, 6)]),
    "_contrib_AdaptiveAvgPooling2D": (
        lambda F, a: F.contrib.AdaptiveAvgPooling2D(a, output_size=(3, 2)),
        [_n(2, 3, 7, 5)]),
    "_contrib_AdaptiveAvgPooling2D_global": (
        lambda F, a: F._contrib_AdaptiveAvgPooling2D(a), [X]),
    "_contrib_AdaptiveAvgPooling2D_up": (
        lambda F, a: F.contrib.AdaptiveAvgPooling2D(a, output_size=8), [X]),
}
#: every op this file holds against the JAX package (test_torch_ndarray.py
#: test_every_op_has_a_case reads it)
VISION_OPS = {"BilinearResize2D", "UpSampling", "L2Normalization", "LRN",
              "GridGenerator", "BilinearSampler", "SpatialTransformer",
              "Correlation", "Crop", "depth_to_space", "space_to_depth",
              "_contrib_AdaptiveAvgPooling2D"}


# the variants compare values only: the JAX package compiles each op's
# gradient apart (about 1-3 s on one core), and each op's gradient is
# held above.  SpatialTransformer_shift samples exactly at pixel centres,
# where the gradient with respect to theta jumps.
VALUE_ONLY = {"BilinearResize2D_scale", "BilinearResize2D_one_axis",
              "L2Normalization_channel", "L2Normalization_spatial",
              "LRN_default", "SpatialTransformer_shift", "Correlation",
              "Correlation_sad", "Correlation_zero_border", "Crop_center",
              "Crop_like", "_contrib_AdaptiveAvgPooling2D_global",
              "_contrib_AdaptiveAvgPooling2D_up"}


@pytest.mark.parametrize("case", sorted(VISION))
def test_op_matches_jax(case):
    fn, arrays = VISION[case]
    torch_parity.check(fn, arrays, grad=case not in VALUE_ONLY)


def test_every_case_is_an_op():
    from mxnet_tpu_torch.ops.registry import list_ops
    assert VISION_OPS <= set(list_ops())
    for op in VISION_OPS:
        assert any(c == op or c.startswith(op + "_") for c in VISION), op


@pytest.mark.parametrize("m,n", [(15, 480), (12, 5), (7, 7)])
def test_resize_weights_are_jax_image_s(m, n):
    """The weight matrix of one axis: jax.image.resize of the identity."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu_torch.ops.nn import linear_resize_weights
    want = np.asarray(jax.image.resize(jnp.eye(m, dtype=jnp.float32),
                                       (m, n), "linear"))
    np.testing.assert_allclose(linear_resize_weights(m, n), want,
                               rtol=1e-6, atol=1e-7)


def test_bilinear_resize_bf16_matches_jax():
    """Under bf16 (the segmentation heads under AMP) the weights are
    rounded to bf16 too, as jax.image casts them to the input's type."""
    j = jmx.nd.BilinearResize2D(jmx.nd.array(SEG, dtype="bfloat16"),
                                height=96, width=128)
    t = nd.BilinearResize2D(nd.array(SEG, ctx=CPU, dtype="bfloat16"),
                            height=96, width=128)
    assert t.dtype == j.dtype
    np.testing.assert_allclose(t.astype("float32").asnumpy(),
                               j.astype("float32").asnumpy(), rtol=1e-2,
                               atol=1e-2)


def test_upsampling_rejects_unknown_and_warns_on_weight():
    x = nd.array(X, ctx=CPU)
    with pytest.raises(NotImplementedError, match="nearest"):
        nd.UpSampling(x, scale=2, sample_type="cubic")
    with pytest.warns(UserWarning, match="ignored"):
        out = nd.UpSampling(x, nd.ones((3, 1, 4, 4), ctx=CPU), scale=2,
                            sample_type="bilinear", num_args=2)
    np.testing.assert_allclose(
        out.asnumpy(), nd.BilinearResize2D(x, height=12,
                                           width=10).asnumpy())


def test_depth_to_space_is_dcr_not_pixel_shuffle():
    """The block offsets come before the channel (DCR); PyTorch's
    pixel_shuffle (CRD) orders them the other way."""
    import torch
    x = np.arange(2 * 8 * 1 * 1, dtype="f4").reshape(2, 8, 1, 1)
    got = nd.depth_to_space(nd.array(x, ctx=CPU), block_size=2).asnumpy()
    np.testing.assert_array_equal(got[0, :, 0, 0], [0, 1])
    np.testing.assert_array_equal(got[0, 0, :, :], [[0, 2], [4, 6]])
    crd = torch.nn.functional.pixel_shuffle(torch.from_numpy(x), 2)
    assert not np.array_equal(crd.numpy(), got)
    back = nd.space_to_depth(nd.array(got, ctx=CPU), block_size=2)
    np.testing.assert_array_equal(back.asnumpy(), x)


def test_separable_products_take_no_tf32(monkeypatch):
    """The resize's products run with TF32 off in the forward and the
    backward, whatever the caller set (the flag is read at each call)."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.from_numpy(SEG).requires_grad_(True)
        tnn.bilinear_resize_2d(x, height=32, width=64).sum().backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert len(seen) >= 4 and not any(seen)
