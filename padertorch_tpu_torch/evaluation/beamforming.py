"""Mask-driven acoustic beamforming (pb_bss replacement, numpy).

The port's own copy of ``padertorch_tpu/evaluation/beamforming.py`` (numpy
and scipy, no framework): estimate spatial PSD matrices from
time-frequency masks, compute the beamforming vector per frequency (GEV
with ``scipy.linalg``, MVDR in Souden's formulation), apply it, and
optionally BAN-postfilter, as the reference's speech-enhancement
evaluation does through ``pb_bss`` (``contrib/jensheit/evaluation.py:14``
``evaluate_masks``).

Shapes follow pb_bss conventions: STFT signals (C, T, F) channels first.
"""
import numpy as np

__all__ = [
    'get_power_spectral_density_matrix',
    'get_gev_vector',
    'phase_correction',
    'get_mvdr_vector_souden',
    'blind_analytic_normalization',
    'apply_beamforming_vector',
    'gev_beamforming',
]


def get_power_spectral_density_matrix(observation, mask=None):
    """PSD matrix per frequency: (F, C, C) from (C, T, F) [+ mask (T, F)].

    >>> obs = np.random.RandomState(0).randn(2, 10, 5) * 1j
    >>> get_power_spectral_density_matrix(np.asarray(obs)).shape
    (5, 2, 2)
    """
    c, t, f = observation.shape
    if mask is None:
        mask = np.ones((t, f))
    mask = mask / np.maximum(mask.sum(axis=0, keepdims=True), 1e-10)
    # psd[f] = sum_t m[t,f] * y[:,t,f] y[:,t,f]^H
    psd = np.einsum('tf,atf,btf->fab', mask, observation,
                    observation.conj())
    return psd


def _condition(psd, eps=1e-10):
    f, c, _ = psd.shape
    scale = np.trace(psd, axis1=-2, axis2=-1).real[:, None, None]
    return psd + eps * np.maximum(scale, 1e-10) * np.eye(c)


def phase_correction(vector):
    """Align beamformer phases across frequency bins: (F, C) -> (F, C).

    A generalized eigenvector has an arbitrary per-frequency phase; left
    uncorrected it scrambles the waveform after the iSTFT.  Rotate every
    bin so it is maximally aligned with its lower neighbor (the pb_bss
    ``phase_correction`` behavior), via a cumulative product of the
    pairwise rotations.
    """
    w = np.asarray(vector)
    pairwise = np.einsum('fc,fc->f', w[1:], w[:-1].conj())
    rotations = np.exp(-1j * np.angle(pairwise))
    corrections = np.concatenate([[1.0 + 0j], np.cumprod(rotations)])
    return w * corrections[:, None]


def get_gev_vector(target_psd, noise_psd):
    """Principal generalized eigenvector of (target_psd, noise_psd): (F, C).

    Maximizes the expected output SNR (Warsitz & Haeb-Umbach 2007);
    phases aligned across frequencies (see ``phase_correction``).
    """
    import scipy.linalg
    f, c, _ = target_psd.shape
    noise_psd = _condition(noise_psd)
    vectors = np.zeros((f, c), dtype=target_psd.dtype)
    for i in range(f):
        _, v = scipy.linalg.eigh(target_psd[i], noise_psd[i])
        vectors[i] = v[:, -1]
    return phase_correction(vectors)


def get_mvdr_vector_souden(target_psd, noise_psd, ref_channel=0):
    """MVDR (Souden formulation): (F, C)."""
    noise_psd = _condition(noise_psd)
    numerator = np.linalg.solve(noise_psd, target_psd)  # (F, C, C)
    trace = np.trace(numerator, axis1=-2, axis2=-1)[:, None, None]
    w_mat = numerator / np.maximum(np.abs(trace), 1e-10)
    return w_mat[:, :, ref_channel]


def blind_analytic_normalization(vector, noise_psd):
    """BAN postfilter gain for a GEV beamformer (per frequency)."""
    nom = np.sqrt(np.abs(np.einsum(
        'fa,fab,fbc,fc->f', vector.conj(), noise_psd, noise_psd,
        vector)))
    denom = np.abs(np.einsum(
        'fa,fab,fb->f', vector.conj(), noise_psd, vector))
    gain = nom / np.maximum(denom, 1e-10)
    return vector * gain[:, None]


def apply_beamforming_vector(vector, observation):
    """(F, C) beamformer on (C, T, F) -> (T, F)."""
    return np.einsum('fc,ctf->tf', vector.conj(), observation)


def gev_beamforming(observation, speech_mask, noise_mask, ban=True):
    """Full GEV pipeline: (C, T, F) STFT + (T, F) masks -> (T, F) output.

    Reference usage: ``contrib/jensheit/evaluation.py`` beamforming eval.
    """
    target_psd = get_power_spectral_density_matrix(
        observation, speech_mask)
    noise_psd = get_power_spectral_density_matrix(observation, noise_mask)
    w = get_gev_vector(target_psd, noise_psd)
    if ban:
        w = blind_analytic_normalization(w, noise_psd)
    return apply_beamforming_vector(w, observation)
