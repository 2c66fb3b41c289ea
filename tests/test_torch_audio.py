"""The port's audio front end (``thingino_accel_tpu_torch.models.audio``)
against the JAX package's, on the same seeded inputs, on the CPU:

- the window is ``jnp.hanning(512)``'s float32 steps with a correctly
  rounded cosine: XLA's cosine differs in the last bit at 3 of the 512
  values, so 3 window values are 1 ulp from JAX's and the other 509 equal
  it; the DFT and iDFT matrices equal JAX's bytes;
- ``stft_ri`` within ``STFT_TOL`` of the largest |value| of JAX's (float32
  matmuls against XLA's HIGHEST dots), ``istft_ri`` within ``ISTFT_TOL``,
  on 257, 256 and fewer bins; on the same frames and window the
  overlap-add equals JAX's bit for bit (at most two frames a sample, added
  to a zero);
- the WAV round trip (and JAX reads the port's file as its own);
- ``test_stft_matmul_matches_fft``'s check against ``np.fft.rfft`` and the
  STFT/iSTFT round trips, as the JAX tests;
- ``process_wav`` (the AEC model from JAX's params) and
  ``process_wav_stream`` (the decompiled AEC fixture `.mgk`) against JAX's
  within ``WAV_TOL``; without a card the default device raises.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from thingino_accel_tpu.formats import mgk as JMGK
from thingino_accel_tpu.models import aec as JA
from thingino_accel_tpu.models import audio as JAU
from thingino_accel_tpu_torch.formats import mgk as MGK
from thingino_accel_tpu_torch.models import aec as A
from thingino_accel_tpu_torch.models import audio as AU
from thingino_accel_tpu_torch.models import mgk_fixtures as MF

STFT_TOL = 1e-6      # of the largest |value|: float32 DFT matmuls
ISTFT_TOL = 1e-5     # of the largest |value|, through the overlap-add
WAV_TOL = 1e-4       # of the largest |sample|: STFT, model, iSTFT


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def test_window_within_one_ulp_of_jax():
    got = AU.window_np()
    want = np.asarray(JAU._window())
    assert got.dtype == want.dtype == np.float32 and got.shape == (512,)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int((ulps != 0).sum()) == 3 and int(ulps.max()) == 1
    assert torch.equal(AU._window("cpu"), torch.from_numpy(got))


def test_dft_matrices_equal_jax_bytes():
    for mine, theirs in ((AU.dft_mats_np(), JAU._dft_mats()),
                         (AU.idft_mats_np(), JAU._idft_mats())):
        for a, b in zip(mine, theirs):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [300, 512, 4096, 5000])
def test_stft_ri_within_bound_of_jax(n):
    x = (np.random.default_rng(n).normal(size=(2, n)) * 0.5).astype(
        np.float32)
    re, im = AU.stft_ri(torch.from_numpy(x))
    jre, jim = JAU.stft_ri(jnp.asarray(x))
    assert re.shape == tuple(jre.shape) == (2, 256, max(0, (n - 512) // 256
                                                           + 1))
    if re.shape[2]:
        assert _rel(re, jre) <= STFT_TOL and _rel(im, jim) <= STFT_TOL


@pytest.mark.parametrize("bins", [257, 256, 200])
def test_istft_ri_within_bound_of_jax(bins):
    rng = np.random.default_rng(bins)
    re = rng.normal(size=(2, bins, 13)).astype(np.float32)
    im = rng.normal(size=(2, bins, 13)).astype(np.float32)
    for n in (None, 3000, 4000):     # 4000: the tail past the last frame
        got = AU.istft_ri(torch.from_numpy(re), torch.from_numpy(im), n)
        want = JAU.istft_ri(jnp.asarray(re), jnp.asarray(im), n)
        assert _rel(got, want) <= ISTFT_TOL, n
    with pytest.raises(ValueError, match="<= 257 bins"):
        AU.istft_ri(torch.zeros(1, 258, 2), torch.zeros(1, 258, 2))


def test_overlap_add_equals_jax_bit_for_bit(monkeypatch):
    """The same frames and window (JAX's function given the port's) through
    both scatter-adds: equal bytes, the 1e-2 floor of the normaliser at the
    edges, the tail pad to n_samples."""
    monkeypatch.setattr(JAU, "_window", lambda: jnp.asarray(AU.window_np()))
    frames = np.random.default_rng(3).normal(size=(2, 9, 512)).astype(
        np.float32)
    for n in (None, 2000, 3000):
        got = AU._overlap_add(torch.from_numpy(frames), n).numpy()
        want = np.asarray(JAU._overlap_add(jnp.asarray(frames), n))
        assert got.tobytes() == want.tobytes(), n
    # one frame: the normaliser is the squared window, floored at 1e-2
    one = AU._overlap_add(torch.ones(1, 1, 512), None)[0].numpy()
    w2 = AU.window_np() ** 2
    np.testing.assert_array_equal(one, np.float32(1) / np.maximum(w2, 1e-2))


def test_wav_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=16000) * 0.1).astype(np.float32)
    p = str(tmp_path / "t.wav")
    AU.write_wav(p, x)
    back = AU.read_wav(p)
    assert back.shape == x.shape
    np.testing.assert_allclose(back, x, atol=1.0 / 32768 + 1e-6)
    np.testing.assert_array_equal(back, JAU.read_wav(p))
    JAU.write_wav(str(tmp_path / "j.wav"), x)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav"
                                                 ).read_bytes()
    with pytest.raises(ValueError, match="sample rate 8000"):
        AU.write_wav(p, x, rate=8000)
        AU.read_wav(p)


def test_stft_matmul_matches_fft():
    """As JAX's: the matmul real DFT against ``np.fft.rfft`` of the same
    frames."""
    x = torch.from_numpy((np.random.default_rng(1).normal(size=(2, 4096))
                          * 0.5).astype(np.float32))
    re, im = AU.stft_ri(x)
    spec = np.fft.rfft(AU._frames(x).numpy(), axis=-1)[..., :AU.FREQ_BINS]
    np.testing.assert_allclose(re.numpy(), np.swapaxes(spec.real, 1, 2),
                               atol=2e-3)
    np.testing.assert_allclose(im.numpy(), np.swapaxes(spec.imag, 1, 2),
                               atol=2e-3)


def test_stft_istft_roundtrips():
    x = torch.from_numpy((np.random.default_rng(2).normal(size=(1, 16384))
                          * 0.3).astype(np.float32))
    mid = slice(AU.N_FFT, 16384 - AU.N_FFT)
    spec = AU.stft(x)
    assert spec.shape[1] == AU.FREQ_BINS and spec.is_complex()
    back = AU.istft(spec, n_samples=16384)
    assert float((back[0, mid] - x[0, mid]).abs().mean()) < 0.02
    re, im = AU.stft_ri(x)
    back = AU.istft_ri(re, im, n_samples=16384)
    assert float((back[0, mid] - x[0, mid]).abs().mean()) < 0.02


def test_process_wav_equals_jax():
    audio = (np.random.default_rng(4).normal(size=4000) * 0.2).astype(
        np.float32)
    jp = JA.init_params(JA.AECConfig())
    jm = JA.AECModel(JA.AECConfig(), jp)
    pm = A.AECModel(A.AECConfig(), A.params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    got = AU.process_wav(pm, audio)
    want = JAU.process_wav(jm, audio)
    assert got.shape == audio.shape and _rel(got, want) <= WAV_TOL
    short = audio[:600]              # fewer frames than a chunk
    np.testing.assert_array_equal(AU.process_wav(pm, short), short)


def test_process_wav_stream_equals_jax(tmp_path):
    path = tmp_path / "a.mgk"
    path.write_bytes(MF.build_aec_mgk(0))
    audio = (np.random.default_rng(5).normal(size=3000) * 0.2).astype(
        np.float32)          # 10 frames: 3 windows, masks on frames 7-9
    stream = A.AECStream(MGK.import_mgk(str(path), streaming=True), "cpu")
    jstream = JA.AECStream(JMGK.import_mgk(str(path), streaming=True))
    got = AU.process_wav_stream(stream, audio)
    want = JAU.process_wav_stream(jstream, audio)
    assert got.shape == audio.shape and np.isfinite(got).all()
    assert _rel(got, want) <= WAV_TOL
    np.testing.assert_array_equal(
        AU.process_wav_stream(stream, audio[:2000]), audio[:2000])


def test_entry_points_need_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    path = tmp_path / "a.mgk"
    path.write_bytes(MF.build_aec_mgk(0))
    g = MGK.import_mgk(str(path), streaming=True)
    for fn in (lambda: A.init_params(A.AECConfig()),
               lambda: A.build_aec_graph(),
               lambda: A.AECStream(g),
               lambda: A.make_stream_scanner(g)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
