"""Audio front end of the AEC model: WAV IO, STFT/iSTFT, streaming
processing.

Port of ``thingino_accel_tpu.models.audio``. WAV IO is the standard
library's ``wave`` (16 kHz mono 16-bit PCM, the AEC fixture format); the
spectral transform and the mask's application are torch on the model's
device. The DFTs are real matmuls against constant matrices (no complex
type), in float32 with TF32 off on the card (``ops.reference.no_tf32``),
where JAX runs them at ``Precision.HIGHEST``.

The constants are built on the host in numpy and moved to a device once:
the DFT matrices are JAX's bytes; the window is ``jnp.hanning(512)``'s
float32 steps with a correctly rounded cosine, where XLA's differs from
it in the last bit at 3 of the 512 values (``tests/test_torch_audio.py``
states them).

The functions take and return tensors where JAX's take and return arrays;
``process_wav`` and ``process_wav_stream`` return numpy, as JAX's.
"""

from __future__ import annotations

import functools
import wave
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops.reference import no_tf32

SAMPLE_RATE = 16000
N_FFT = 512
HOP = 256
FREQ_BINS = 256     # model consumes bins 0..255 of the 257-bin rfft


def read_wav(path: str, expect_rate: int = SAMPLE_RATE) -> np.ndarray:
    """16-bit PCM mono WAV -> float32 [-1, 1].

    ``expect_rate``: the AEC pipeline's STFT constants assume 16 kHz —
    a mismatched file would be processed at the wrong frame rate and
    written back slowed down, silently. Pass None to skip the check."""
    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2, "16-bit PCM expected"
        if expect_rate is not None and w.getframerate() != expect_rate:
            raise ValueError(
                f"{path}: sample rate {w.getframerate()} != "
                f"{expect_rate} (resample first, or pass "
                "expect_rate=None)")
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())[:, 0]
    return (data.astype(np.float32) / 32768.0).copy()


def write_wav(path: str, audio: np.ndarray,
              rate: int = SAMPLE_RATE) -> None:
    pcm = np.clip(np.asarray(audio) * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@functools.lru_cache(maxsize=1)
def window_np() -> np.ndarray:
    """``jnp.hanning(N_FFT)`` as JAX computes it, in float32:
    ``0.5 * (1 - cos(2 pi n / (N - 1)))``, the angle rounded as JAX rounds
    it, its cosine correctly rounded (taken in float64)."""
    f = np.float32
    ang = (f(2 * np.pi) * np.arange(N_FFT, dtype=f)) / f(N_FFT - 1)
    cos = np.cos(ang.astype(np.float64)).astype(f)
    return f(0.5) * (f(1) - cos)


@functools.lru_cache(maxsize=1)
def dft_mats_np() -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT analysis matrices [N_FFT, FREQ_BINS] (cos, -sin)."""
    n = np.arange(N_FFT)[:, None]
    k = np.arange(FREQ_BINS)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def idft_mats_np() -> Tuple[np.ndarray, np.ndarray]:
    """Real-iDFT synthesis matrices [FREQ_BINS, N_FFT]: x[n] =
    (1/N) * sum_k alpha_k (re_k cos - im_k sin), alpha = 1 for k=0,
    2 for 0<k<N/2 (bin N/2 is dropped — the model zeroes it)."""
    k = np.arange(FREQ_BINS)[:, None]
    n = np.arange(N_FFT)[None, :]
    ang = 2.0 * np.pi * k * n / N_FFT
    alpha = np.where(k == 0, 1.0, 2.0) / N_FFT
    return ((alpha * np.cos(ang)).astype(np.float32),
            (-alpha * np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    """The window and the DFT matrices on ``device``, moved there once."""
    win = window_np()
    (cm, sm), (icm, ism) = dft_mats_np(), idft_mats_np()
    arrs = {"win": win, "win_sq": win * win, "cm": cm, "sm": sm,
            "icm": icm, "ism": ism}
    return {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}


def _window(device="cpu") -> torch.Tensor:
    return _consts(torch.device(device))["win"]


def _dft_mats(device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    c = _consts(torch.device(device))
    return c["cm"], c["sm"]


def _idft_mats(device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    c = _consts(torch.device(device))
    return c["icm"], c["ism"]


def _frames(x: torch.Tensor) -> torch.Tensor:
    """[B, samples] -> windowed frames [B, T, N_FFT], T = (n - N_FFT) //
    HOP + 1 (none where n < N_FFT)."""
    b, n = x.shape
    if n < N_FFT:
        return x.new_zeros((b, 0, N_FFT))
    return x.unfold(1, N_FFT, HOP) * _window(x.device)[None, None, :]


def stft_ri(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, samples] -> (re, im) spectrograms [B, FREQ_BINS, T], on x's
    device: a real matmul DFT (float32, no TF32), as JAX's."""
    frames = _frames(x.to(torch.float32))
    cm, sm = _dft_mats(x.device)
    with no_tf32():
        re = frames @ cm
        im = frames @ sm
    return re.transpose(1, 2), im.transpose(1, 2)


def stft(x: torch.Tensor) -> torch.Tensor:
    """[B, samples] -> complex spectrogram [B, FREQ_BINS, T] (a host/CPU
    convenience over :func:`stft_ri`)."""
    re, im = stft_ri(x)
    return torch.complex(re, im)


def istft_ri(re: torch.Tensor, im: torch.Tensor,
             n_samples: Optional[int] = None) -> torch.Tensor:
    """(re, im) [B, f<=FREQ_BINS+1, T] -> [B, samples] via matmul iDFT +
    overlap-add. 257 bins drop the Nyquist bin (the synthesis covers bins
    0..255, the model never emits it); fewer than FREQ_BINS are
    zero-padded to the full spectrum."""
    b, f, t = re.shape
    if f == FREQ_BINS + 1:
        re, im = re[:, :FREQ_BINS], im[:, :FREQ_BINS]
    elif f < FREQ_BINS:
        pad = (0, 0, 0, FREQ_BINS - f)
        re = torch.nn.functional.pad(re, pad)
        im = torch.nn.functional.pad(im, pad)
    elif f > FREQ_BINS:
        raise ValueError(f"istft_ri expects <= {FREQ_BINS + 1} bins, got {f}")
    icm, ism = _idft_mats(re.device)
    with no_tf32():
        frames = (re.transpose(1, 2).to(torch.float32) @ icm
                  + im.transpose(1, 2).to(torch.float32) @ ism)
    frames = frames * _window(re.device)[None, None, :]
    return _overlap_add(frames, n_samples)


def istft(spec: torch.Tensor, n_samples: Optional[int] = None
          ) -> torch.Tensor:
    """[B, FREQ_BINS, T] complex -> [B, samples] via overlap-add."""
    return istft_ri(spec.real, spec.imag, n_samples)


def _overlap_add(frames: torch.Tensor,
                 n_samples: Optional[int]) -> torch.Tensor:
    """JAX's scatter-add of the frames and of the squared window, as
    ``index_add_``: a sample gets at most N_FFT / HOP = 2 frames added to
    a zero, a sum whose value does not depend on the order, so the card
    and the CPU give the same bits for the same frames."""
    b, t, _ = frames.shape
    dev = frames.device
    out_len = (t - 1) * HOP + N_FFT
    idx = (torch.arange(t, device=dev)[:, None] * HOP
           + torch.arange(N_FFT, device=dev)[None, :]).reshape(-1)
    out = torch.zeros((b, out_len), dtype=torch.float32, device=dev)
    out.index_add_(1, idx, frames.reshape(b, -1))
    norm = torch.zeros((out_len,), dtype=torch.float32, device=dev)
    norm.index_add_(0, idx, _consts(dev)["win_sq"].repeat(t))
    # floor the OLA normalizer: at the first/last hops only a window
    # tail covers each sample, and dividing masked (inconsistent)
    # frames by a near-zero window-sum amplifies edge residuals by
    # orders of magnitude — attenuate edges instead of exploding them
    out = out / torch.clamp_min(norm, 1e-2)[None, :]
    if n_samples is not None:
        if out.shape[1] < n_samples:      # tail beyond the last full frame
            out = torch.nn.functional.pad(out, (0, n_samples - out.shape[1]))
        out = out[:, :n_samples]
    return out


def _magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.sqrt(re * re + im * im))


def process_wav(model, audio: np.ndarray, chunk: int = 8) -> np.ndarray:
    """Run the AEC mask model over a waveform on the model's device: stft
    -> chunked streaming mask (carried GRU state) -> apply -> istft.
    ``model`` is a ``models.aec.AECModel``."""
    x = torch.as_tensor(np.asarray(audio, np.float32))[None].to(model.device)
    re, im = stft_ri(x)                                  # [1, 256, T] x2
    mag = _magnitude(re, im)
    n_chunks = re.shape[2] // chunk
    state = None
    masks = []
    for i in range(n_chunks):
        m, state = model.run(mag[:, :, i * chunk:(i + 1) * chunk], state)
        masks.append(m[..., 0])                          # channel 0 = mask
    if not masks:
        return np.asarray(audio)
    mask = torch.cat(masks, dim=2)                       # [1, 256, T']
    t_used = mask.shape[2]
    out = istft_ri(re[:, :, :t_used] * mask, im[:, :, :t_used] * mask,
                   n_samples=len(audio))
    return out[0].cpu().numpy()


def process_wav_stream(stream, audio: np.ndarray) -> np.ndarray:
    """Streaming AEC over a waveform with the decompiled `.mgk` model
    (``models.aec.AECStream``) on its device: sliding 8-frame
    log1p-magnitude window -> per-window [256, 2] mask, channel 0 applied
    to the window's LAST frame (ones elsewhere), hop-overlap-add — the
    reference's ``scripts/aec_inference.py`` application semantics."""
    x = torch.as_tensor(np.asarray(audio, np.float32))[None].to(
        stream.device)
    re, im = stft_ri(x)                             # [1, 256, T] x2
    mag = _magnitude(re, im)
    t = re.shape[2]
    n_frames = 8
    if t < n_frames:
        return np.asarray(audio)
    state = None
    mask_frames = torch.ones((1, FREQ_BINS, t), dtype=torch.float32,
                             device=x.device)
    for i in range(t - n_frames + 1):
        m, state = stream.run(mag[:, :, i:i + n_frames], state)  # [1, 256, 2]
        mask_frames[:, :, i + n_frames - 1] = m[0, :, 0]
    out = istft_ri(re * mask_frames, im * mask_frames, n_samples=len(audio))
    return out[0].cpu().numpy()
