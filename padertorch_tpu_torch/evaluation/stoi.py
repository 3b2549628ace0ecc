"""Short-Time Objective Intelligibility (STOI), pure numpy.

Taal, Hendriks, Heusdens, Jensen: "An Algorithm for Intelligibility
Prediction of Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011.

The port's own copy of ``padertorch_tpu/evaluation/stoi.py`` (numpy and
scipy, no framework): the reference's mask-estimator evaluation reports
stoi via ``paderbox``/pb_bss; this is a dependency-free host-side
implementation of the same algorithm (10 kHz, 15 third-octave bands,
384 ms segments, beta = -15 dB clipping).
"""
import numpy as np

__all__ = ['stoi']

FS = 10_000          # the algorithm operates at 10 kHz
N_FRAME = 256        # 25.6 ms frames
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30           # 384 ms analysis segments
BETA = -15.0         # lower SDR clipping bound (dB)
DYN_RANGE = 40.0     # silent-frame energy threshold (dB)


def _resample(x, fs):
    if fs == FS:
        return np.asarray(x, np.float64)
    from scipy.signal import resample_poly
    from math import gcd
    g = gcd(int(fs), FS)
    return resample_poly(np.asarray(x, np.float64), FS // g, fs // g)


def _third_octave_bands():
    """(NUM_BANDS, NFFT//2+1) rectangular band matrix + centers."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * MIN_FREQ
    lo = 2.0 ** ((2 * k - 1) / 6.0) * MIN_FREQ
    hi = 2.0 ** ((2 * k + 1) / 6.0) * MIN_FREQ
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm, cf


def _frame(x, inclusive=True):
    """50%-overlap framing.

    ``inclusive=False`` reproduces the published pystoi STFT quirk of
    dropping the final frame when ``(len(x) - N_FRAME) % hop == 0``
    (its silent-frame removal frames inclusively, its spectrogram
    exclusively) — kept so numbers match the pystoi oracle exactly.
    """
    hop = N_FRAME // 2
    stop = len(x) - N_FRAME + (1 if inclusive else 0)
    n = (stop + hop - 1) // hop if stop > 0 else 0  # len(range(0, stop, hop))
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = (np.arange(N_FRAME)[None, :]
           + (N_FRAME // 2) * np.arange(n)[:, None])
    return x[idx]


def _remove_silent_frames(x, y):
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frame(x) * w
    yf = _frame(y) * w
    energy = 20 * np.log10(
        np.linalg.norm(xf, axis=1) / np.sqrt(N_FRAME) + 1e-20)
    mask = energy > (energy.max() - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back to signals
    def ola(frames):
        n = len(frames)
        out = np.zeros((n + 1) * N_FRAME // 2)
        for i, fr in enumerate(frames):
            out[i * N_FRAME // 2:i * N_FRAME // 2 + N_FRAME] += fr
        return out
    return ola(xf), ola(yf)


def _band_spectrogram(x):
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frame(x, inclusive=False) * w
    spec = np.fft.rfft(frames, NFFT, axis=1)  # (T, F)
    obm, _ = _third_octave_bands()
    return np.sqrt(np.maximum(
        (np.abs(spec) ** 2) @ obm.T, 1e-20))  # (T, 15)


def stoi(reference, estimate, sample_rate=10_000):
    """STOI in [~0, 1]; higher = more intelligible.

    Args:
        reference: clean speech (1-D).
        estimate: processed/degraded speech, same length.
        sample_rate: input rate; resampled to 10 kHz internally
            (requires scipy for rates != 10000).
    """
    reference = np.asarray(reference, np.float64)
    estimate = np.asarray(estimate, np.float64)
    assert reference.shape == estimate.shape, (
        reference.shape, estimate.shape)
    x = _resample(reference, sample_rate)
    y = _resample(estimate, sample_rate)
    x, y = _remove_silent_frames(x, y)
    sx = _band_spectrogram(x)  # (T, 15)
    sy = _band_spectrogram(y)
    t = sx.shape[0]
    if t < N_SEG:
        raise ValueError(
            f'signal too short for STOI: {t} frames < {N_SEG}')
    corrs = []
    clip = 10 ** (-BETA / 20)
    for m in range(N_SEG, t + 1):
        xs = sx[m - N_SEG:m]  # (N, 15)
        ys = sy[m - N_SEG:m]
        # scale y to x's energy per band, clip at -15 dB SDR
        alpha = np.linalg.norm(xs, axis=0, keepdims=True) / (
            np.linalg.norm(ys, axis=0, keepdims=True) + 1e-20)
        ys_ = np.minimum(ys * alpha, xs * (1 + clip))
        xm = xs - xs.mean(axis=0, keepdims=True)
        ym = ys_ - ys_.mean(axis=0, keepdims=True)
        num = (xm * ym).sum(axis=0)
        den = (np.linalg.norm(xm, axis=0)
               * np.linalg.norm(ym, axis=0) + 1e-20)
        corrs.append(num / den)
    return float(np.mean(corrs))
