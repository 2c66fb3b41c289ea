"""The fast tier's ops, port vs JAX on the same seeded numpy inputs.

Tolerances:
- ``conv2d_f32`` / ``depthwise_conv2d_f32`` at float32 against JAX's at
  float32 (``Precision.HIGHEST``): rtol 1e-5, atol 1e-5 x the largest
  |output| (both sum exact f32 products, in other orders);
- ``conv2d_f32`` at bf16 against JAX's at bf16: within 2 bf16 ulps of each
  value, |diff| <= 2^-7 |ref| + 2^-7 x the largest |output|; and in both
  accumulation modes (``accum_dtype`` None: the bias added to the f32
  sums, one rounding, as JAX's default; ``torch.bfloat16``: the sums
  rounded to bf16 before the bias, as JAX's ``accum_dtype=bfloat16``)
  against JAX's in the same mode within 1 bf16 ulp of each value
  (measured: every value equal, on all seven cases, in both modes);
- ``space_to_depth`` (device) against ``space_to_depth_frames`` (host),
  the quantize to bf16, the decode on bf16 heads (plain version and JAX's
  ``decode_and_parse`` and Pallas ``decode_and_parse_pallas`` in
  interpret mode): classes equal, boxes within 1e-4 px, conf within 1e-6
  relative (the two frameworks' sigmoids differ by ulps).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.ops import reference as JR
from thingino_accel_tpu.ops.decode_kernel import decode_and_parse_pallas
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import decode_kernel as DK
from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.runtime.engine import EngineOptions

# (in_hw, C, O, kernel, stride, dilation, padding, explicit_pad, out_hw)
CONV_CASES = {
    "3x3-s1-explicit": ((12, 10), 8, 16, (3, 3), (1, 1), (1, 1),
                        "EXPLICIT", (1, 1, 1, 1), (12, 10)),
    "3x3-s2-explicit": ((13, 12), 8, 16, (3, 3), (2, 2), (1, 1),
                        "EXPLICIT", (1, 1, 1, 1), (7, 6)),
    "6x6-s2-explicit": ((16, 16), 3, 8, (6, 6), (2, 2), (1, 1),
                        "EXPLICIT", (2, 2, 2, 2), (8, 8)),
    "3x3-s1-same-dil2": ((11, 9), 4, 8, (3, 3), (1, 1), (2, 2), "SAME",
                         (0, 0, 0, 0), (11, 9)),
    "5x5-s2-same": ((10, 11), 4, 8, (5, 5), (2, 2), (1, 1), "SAME",
                    (0, 0, 0, 0), (5, 6)),
    "1x1-valid": ((8, 8), 16, 24, (1, 1), (1, 1), (1, 1), "VALID",
                  (0, 0, 0, 0), (8, 8)),
    "3x3-s2-short-pad": ((16, 16), 8, 8, (3, 3), (2, 2), (1, 1),
                         "EXPLICIT", (0, 0, 0, 0), (8, 8)),
}


def _conv_inputs(case, seed, depthwise=False):
    in_hw, c, o, k, *_ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2,) + in_hw + (c,)).astype(np.float32)
    if depthwise:
        w = rng.normal(0, 0.5, k + (c,)).astype(np.float32)   # [KH, KW, C]
        b = rng.normal(0, 0.1, (c,)).astype(np.float32)
    else:
        w = rng.normal(0, 0.5, k + (c, o)).astype(np.float32)   # HWIO
        b = rng.normal(0, 0.1, (o,)).astype(np.float32)
    return x, w, b


def _pads(case):
    in_hw, _, _, k, stride, dil, padding, ep, out_hw = case
    return R._conv_pads(in_hw, out_hw, k, stride, dil, padding, ep)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("name", CONV_CASES)
def test_conv2d_f32_matches_jax(name, relu):
    case = CONV_CASES[name]
    *_, stride, dil, _, _, out_hw = case
    x, w, b = _conv_inputs(case, len(name))
    pads = _pads(case)
    ref = np.asarray(JR.conv2d_f32(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), out_hw, stride, dil, pads,
                                   relu))
    got = R.conv2d_f32(torch.from_numpy(x),
                       torch.from_numpy(w.transpose(3, 0, 1, 2).copy()),
                       torch.from_numpy(b), out_hw, stride, dil, pads, relu)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", CONV_CASES)
def test_conv2d_bf16_matches_jax(name):
    case = CONV_CASES[name]
    *_, stride, dil, _, _, out_hw = case
    x, w, b = _conv_inputs(case, len(name) + 1)
    pads = _pads(case)
    ref = np.asarray(JR.conv2d_f32(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), out_hw, stride,
        dil, pads, False, jnp.bfloat16), np.float32)
    got = R.conv2d_f32(torch.from_numpy(x),
                       torch.from_numpy(w.transpose(3, 0, 1, 2).copy()),
                       torch.from_numpy(b), out_hw, stride, dil, pads,
                       False, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -7 * (np.abs(ref) + np.abs(ref).max())
    assert (np.abs(got.float().numpy() - ref) <= tol).all()


@pytest.mark.parametrize("name", ["3x3-s1-explicit", "3x3-s2-explicit",
                                  "3x3-s1-same-dil2", "5x5-s2-same"])
def test_depthwise_conv2d_f32_matches_jax(name):
    case = CONV_CASES[name]
    *_, stride, dil, _, _, out_hw = case
    x, w, b = _conv_inputs(case, len(name), depthwise=True)
    pads = _pads(case)
    ref = np.asarray(JR.depthwise_conv2d_f32(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), out_hw, stride,
        dil, pads, True))
    # a bf16 input is computed in float32, as JAX's
    got = R.depthwise_conv2d_f32(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), out_hw, stride, dil,
                                 pads, True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("accum", ["f32", "bf16"])
@pytest.mark.parametrize("name", CONV_CASES)
def test_conv2d_bf16_accum_modes_match_jax(name, accum):
    case = CONV_CASES[name]
    *_, stride, dil, _, _, out_hw = case
    x, w, b = _conv_inputs(case, len(name) + 2)
    pads = _pads(case)
    jacc, pacc = ((None, None) if accum == "f32"
                  else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(JR.conv2d_f32(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), out_hw, stride,
        dil, pads, True, jnp.bfloat16, jacc), np.float32)
    got = R.conv2d_f32(torch.from_numpy(x),
                       torch.from_numpy(w.transpose(3, 0, 1, 2).copy()),
                       torch.from_numpy(b), out_hw, stride, dil, pads,
                       True, torch.bfloat16, pacc)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -100)))
                  - 7)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


def test_accum_bf16_raises():
    """``accum_dtype`` takes the JAX option's values (None, float32 and,
    since the fast tier ports the JAX bench's mode, bfloat16); any other
    raises at ``EngineOptions`` and at ``conv2d_f32``, as does a compute
    dtype other than float32 / bfloat16. An ``fpn_split`` outside the
    modes does not: JAX takes any true value but ``"all"`` / ``"wide"`` as
    ``"upsample"`` (``TAT_FPN_SPLIT=1``; tests/test_torch_utils.py holds
    the graph)."""
    assert EngineOptions(precision="fast", accum_dtype=torch.bfloat16
                         ).accum_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="accum_dtype"):
        EngineOptions(precision="fast", accum_dtype=torch.float16)
    x, w = torch.zeros((1, 4, 4, 2)), torch.zeros((2, 1, 1, 2))
    with pytest.raises(ValueError, match="accum_dtype"):
        R.conv2d_f32(x, w, None, (4, 4), (1, 1), (1, 1), ((0, 0), (0, 0)),
                     accum_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        EngineOptions(precision="fast", compute_dtype=torch.float16)
    assert EngineOptions(precision="fast", fpn_split="1").fpn_split == "1"
    assert EngineOptions(precision="fast", accum_dtype=torch.float32,
                         fpn_split="").accum_dtype == torch.float32


def test_fast_leaky_relu_promotes_bf16_to_f32_as_jax():
    x = np.random.default_rng(2).normal(0, 3, (64,)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(JR.leaky_relu(xb, 0.1))
    got = R.leaky_relu(torch.from_numpy(x).to(torch.bfloat16), 0.1)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_space_to_depth_device_equals_host():
    frames = np.random.default_rng(3).integers(0, 256, (2, 8, 12, 3),
                                               dtype=np.uint8)
    host = Y.space_to_depth_frames(frames)
    np.testing.assert_array_equal(host, JY.space_to_depth_frames(frames))
    got = Y.space_to_depth(torch.from_numpy(frames))
    assert got.shape == (2, 4, 6, 12)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JY.space_to_depth(jnp.asarray(frames))))


def test_quantize_input_bf16_holds_the_int8_values():
    frames = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1)
    got = Y.quantize_input_int8(torch.from_numpy(frames), torch.bfloat16)
    ref = JY.quantize_input_int8(jnp.asarray(frames), dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(
        got.float().numpy(),
        Y.quantize_input_int8(torch.from_numpy(frames)).numpy())


def _bf16_heads(seed, b=2, nc=80):
    """Seeded bf16 heads at three levels, values drawn so that classes tie
    in bf16 and a few rows hold NaN."""
    rng = np.random.default_rng(seed)
    heads = []
    for hw in (8, 4, 2):
        v = rng.normal(0, 2, (b, hw, hw, 3, 5 + nc)).astype(np.float32)
        v[..., 5::3] = np.round(v[..., 5::3])   # ties among classes
        heads.append(v.reshape(b, hw, hw, -1))
    heads[1][0, 0, 0, 5:85] = np.nan   # a whole class row NaN
    heads[2][1, 1, 1, 90] = np.nan     # one class of anchor 1
    return [torch.from_numpy(h).to(torch.bfloat16) for h in heads]


def _assert_decodes_close(got, ref):
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=1e-6, atol=1e-12, equal_nan=True)


def test_plain_decode_on_bf16_heads_matches_jax():
    """The plain decode (the kernel's plain version) on bf16 heads against
    JAX's ``decode_and_parse`` on the same bf16 heads, and the wrapper on
    CPU tensors takes it, counting no launch."""
    heads = _bf16_heads(5)
    jheads = [jnp.asarray(h.float().numpy(), jnp.bfloat16) for h in heads]
    ref = JY.decode_and_parse(jheads)
    got = Y.decode_and_parse(heads)
    _assert_decodes_close([t.numpy() for t in got], ref)
    assert int(got[2][0, 192]) == 0    # the all-NaN row: the first NaN
    DK.reset_launches()
    wrapped = DK.decode_and_parse_fused(heads)
    for a, b in zip(wrapped, got):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert DK.launches == {"decode_and_parse_fused": 0,
                           "decode_and_parse_fused_bf16": 0}


def test_plain_decode_on_bf16_heads_matches_the_pallas_decode():
    """The JAX fast tier's decode with ``TAT_DECODE=pallas``:
    ``decode_and_parse_pallas`` on bf16 heads, in interpret mode (NaN-free
    heads: the Pallas kernel's all-NaN row differs, as the kernel's header
    says)."""
    heads = [h.nan_to_num() for h in _bf16_heads(6)]
    jheads = [jnp.asarray(h.float().numpy(), jnp.bfloat16) for h in heads]
    with pltpu.force_tpu_interpret_mode():
        ref = decode_and_parse_pallas(jheads, JY.YOLOV5_ANCHORS,
                                      JY.YOLOV5_STRIDES)
    got = Y.decode_and_parse(heads)
    _assert_decodes_close([t.numpy() for t in got], ref)


def test_quant_edge_matches_jax_at_the_extremes():
    """QUANT (``executor.py``'s lowering in JAX: f32 divide, PLUS_HALF_TRUNC,
    clamp) on values past int32, infinities and NaN, where XLA's
    conversion saturates and takes NaN to 0."""
    from thingino_accel_tpu.ops.quant import RoundMode as JRM
    from thingino_accel_tpu.ops.quant import clamp_i8, round_to_int
    x = np.array([np.nan, 1e12, -1e12, np.inf, -np.inf, 3.2e9, 6.35, -6.4,
                  -6.45, 0.02, -0.03, 2.5e-3, 127.4 * 0.05], np.float32)
    ref = np.asarray(clamp_i8(round_to_int(
        jnp.asarray(x) / jnp.float32(0.05), JRM.PLUS_HALF_TRUNC)))
    got = R.quantize_edge(torch.from_numpy(x), 0.05)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        R.quantize_edge(torch.from_numpy(x).to(torch.bfloat16), 0.05).numpy(),
        np.asarray(clamp_i8(round_to_int(
            jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
            / jnp.float32(0.05), JRM.PLUS_HALF_TRUNC))))
