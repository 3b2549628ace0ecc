"""Feature extraction + data provider for source distance estimation.

Counterpart of ``padertorch_tpu/contrib/examples/source_localization/
distance_estimator/data.py`` (reference
``contrib/examples/source_localization/distance_estimator/data.py``),
copied (numpy and scipy on the host): the feature family (``stft``/
``mag``/``phase``/``ild``/``ipd``/``diffuseness``, combinable as a
space-separated string), recursive-PSD coherence and CDR-based
diffuseness, distance quantization into classes (``quant_step``/
``d_min``), the DataProvider that maps extraction + labeling over a lazy
pipeline, and ``synthetic_database``: 2-mic scenes where the distance
controls the direct-to-reverb ratio, the inter-mic delay, and the
diffuse-noise level.
"""
import numpy as np

from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.ops._stft import HostSTFT as STFT

__all__ = [
    'FeatureExtraction', 'Diffuseness', 'DataProvider',
    'synthetic_database', 'prepare', 'ALLOWED_FEATURES',
]

SAMPLE_RATE = 16000
STFT_SIZE = 256
STFT_SHIFT = 64
F = STFT_SIZE // 2 + 1

_stft = STFT(STFT_SIZE, STFT_SHIFT, fading='full',
             complex_representation='complex', dtype='float32')

ALLOWED_FEATURES = ('stft', 'mag', 'phase', 'ild', 'ipd', 'diffuseness')


def _smooth_psd(x, smoothing_factor):
    """First-order recursive smoothing over the time axis (axis 0).

    y[t] = a * y[t-1] + (1 - a) * x[t]  — the reference's
    ``lfilter([1-a], [1, -a])`` cross-PSD estimator.
    """
    from scipy.signal import lfilter
    return lfilter([1 - smoothing_factor], [1, -smoothing_factor], x, axis=0)


def coherence(x, smoothing_factor=0.95):
    """Smoothed inter-channel coherence of a (2, T, F) STFT."""
    psd_12 = _smooth_psd(x[0] * np.conj(x[1]), smoothing_factor)
    psd_11 = _smooth_psd((np.abs(x[0]) ** 2).astype(psd_12.dtype),
                         smoothing_factor)
    psd_22 = _smooth_psd((np.abs(x[1]) ** 2).astype(psd_12.dtype),
                         smoothing_factor)
    denominator = np.sqrt(np.abs(psd_11 * psd_22))
    return psd_12 / np.maximum(denominator, np.finfo(denominator.dtype).eps)


class Diffuseness:
    """Diffuseness from the coherent-to-diffuse power ratio (CDR).

    The diffuse-field coherence of a mic pair at spacing ``d_mic`` is
    ``sinc(2 f d / c)``; the CDR estimator (Schwarz & Kellermann 2015)
    compares the observed coherence against it, and diffuseness is
    ``1 / (1 + CDR)`` in [0, 1].
    """

    def __init__(self, psd_smoothing_factor=0.95, d_mic=0.05,
                 fft_length=STFT_SIZE, sample_rate=SAMPLE_RATE,
                 sound_velocity=343.0):
        frequencies = np.arange(fft_length // 2 + 1) * (
            sample_rate / fft_length)
        self.gamma_diffuse = np.sinc(
            2 * frequencies * d_mic / sound_velocity)
        self.psd_smoothing_factor = psd_smoothing_factor

    def __call__(self, x):
        gamma = coherence(x, self.psd_smoothing_factor)  # (T, F)
        threshold = 1.0 - 1e-11
        magnitude = np.abs(gamma)
        gamma = np.where(
            magnitude > threshold,
            threshold * gamma / np.maximum(magnitude, 1e-300), gamma)
        gd = self.gamma_diffuse  # (F,)
        re = np.real(gamma)
        mag2 = np.abs(gamma) ** 2
        discriminant = (
            gd ** 2 * re ** 2 - gd ** 2 * mag2 + gd ** 2
            - 2 * gd * re + mag2)
        discriminant = np.maximum(
            discriminant, np.finfo(discriminant.dtype).eps)
        cdr = (-np.sqrt(discriminant) + gd * re - mag2) / (mag2 - 1)
        cdr = np.maximum(cdr.real, 0.0)
        return 1.0 / (1.0 + cdr)


class FeatureExtraction:
    """Extract a space-separated combination of features from a 2-mic
    observation; features stack on a leading channel axis as
    (channels, T, F) float32 under key ``features``."""

    def __init__(self, feature='stft', stft=None, d_mic=0.05,
                 low_freq_bin=0, high_freq_bin=None):
        parts = feature.split()
        assert parts and all(p in ALLOWED_FEATURES for p in parts), (
            f'Wrong feature specified: {feature!r} not in '
            f'{ALLOWED_FEATURES}')
        self.feature = feature
        self.stft = stft if stft is not None else _stft
        self.d_mic = d_mic
        self.low_freq_bin = low_freq_bin
        self.high_freq_bin = high_freq_bin

    @property
    def num_channels(self):
        counts = {'stft': 4, 'mag': 1, 'phase': 2, 'ild': 1, 'ipd': 2,
                  'diffuseness': 1}
        return sum(counts[p] for p in self.feature.split())

    def __call__(self, example):
        observation = np.asarray(example['observation'])
        mic_stft = np.asarray(self.stft(observation))  # (2, T, F)
        parts = [
            getattr(self, f'extract_features_{name}')(mic_stft)
            for name in self.feature.split()
        ]
        features = np.concatenate(parts, axis=0)  # (C, T, F)
        features = features[
            ..., self.low_freq_bin:self.high_freq_bin]
        # (C, F, T): channels x frequency x time, the CNN2d image layout
        example['features'] = np.transpose(
            features, (0, 2, 1)).astype('float32')
        example['num_frames'] = mic_stft.shape[1]
        return example

    @property
    def num_frequency_bins(self):
        total = self.stft.size // 2 + 1
        high = self.high_freq_bin if self.high_freq_bin is not None \
            else total
        return high - self.low_freq_bin

    @staticmethod
    def extract_features_stft(mic_stft):
        return np.concatenate([np.abs(mic_stft), np.angle(mic_stft)])

    @staticmethod
    def extract_features_mag(mic_stft):
        return np.abs(mic_stft[0])[None]

    @staticmethod
    def extract_features_phase(mic_stft):
        return np.angle(mic_stft)

    @staticmethod
    def extract_features_ild(mic_stft):
        magnitude = np.maximum(
            np.abs(mic_stft), np.finfo(mic_stft.real.dtype).eps)
        return (20 * np.log10(magnitude[0])
                - 20 * np.log10(magnitude[1]))[None]

    @staticmethod
    def extract_features_ipd(mic_stft):
        phase_difference = np.angle(mic_stft[1]) - np.angle(mic_stft[0])
        return np.stack(
            [np.cos(phase_difference), np.sin(phase_difference)])

    def extract_features_diffuseness(self, mic_stft):
        diffuseness = Diffuseness(
            d_mic=self.d_mic, fft_length=self.stft.size)
        return diffuseness(mic_stft)[None]


class DataProvider:
    """Label creation (distance -> quantized class) + pipeline assembly."""

    def __init__(self, feature_extractor=None, batch_size=8,
                 shuffle_buffer=None, prefetch_buffer=None, max_workers=4,
                 quant_step=0.1, d_min=0.5):
        self.feature_extractor = feature_extractor
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer
        self.prefetch_buffer = prefetch_buffer
        self.num_workers = 0 if prefetch_buffer is None \
            else min(prefetch_buffer, max_workers)
        self.quant_step = quant_step
        self.d_min = d_min

    def create_label(self, example, key='label'):
        if 'distance' not in example:
            source = np.asarray(example['source_position'])
            node = np.asarray(example['node_position'])
            example['distance'] = float(
                np.sqrt(np.sum((source - node) ** 2)))
        example[key] = int(round(
            (example['distance'] - self.d_min) / self.quant_step))
        return example

    def prepare_iterable(self, dataset, shuffle=True, prefetch=True,
                         batch=True):
        dataset = dataset.map(self.create_label)
        if self.feature_extractor is not None:
            dataset = dataset.map(self.feature_extractor)
        if shuffle:
            dataset = dataset.shuffle(
                reshuffle=True, buffer_size=self.shuffle_buffer)
        if prefetch and self.num_workers:
            dataset = dataset.prefetch(
                self.num_workers, self.prefetch_buffer)
        if batch:
            dataset = dataset.batch(self.batch_size).map(_post_batch)
        return dataset


def _post_batch(batch):
    batch = collate_fn(batch)
    features, _ = pad_batch(batch['features'], axis=-1)
    return {
        'example_id': list(batch['example_id']),
        'features': features,
        'num_frames': np.asarray(batch['num_frames'], 'int32'),
        'distance': np.asarray(batch['distance'], 'float32'),
        'label': np.asarray(batch['label'], 'int64'),
    }


def synthetic_database(num_examples=48, num_samples=8000, seed=0,
                       d_mic=0.05):
    """2-mic scenes: distance controls direct-to-reverb ratio, inter-mic
    delay jitter, and diffuse noise level."""
    rng = np.random.RandomState(seed)
    examples = {}
    for i in range(num_examples):
        distance = float(rng.uniform(0.5, 3.0))
        src = rng.randn(num_samples)
        # late reverberation grows with distance (lower DRR)
        reverb_ir = rng.randn(400) * np.exp(-np.arange(400) / 80.0)
        reverb = np.convolve(src, reverb_ir)[:num_samples]
        direct = 1.0 / distance
        wet = 0.15 * (distance / 3.0)
        delay = int(distance * 4)
        ch0 = direct * src + wet * reverb + 0.1 * rng.randn(num_samples)
        ch1 = (direct * np.roll(src, delay) + wet * reverb
               + 0.1 * rng.randn(num_samples))
        examples[f'scene_{i}'] = {
            'example_id': f'scene_{i}',
            'observation': np.stack([ch0, ch1]).astype('float32'),
            'distance': distance,
        }
    return lazy.from_dict(examples)


def prepare(dataset, feature='mag ild ipd', batch_size=8, shuffle=True,
            quant_step=0.25, d_min=0.5):
    """One-call pipeline used by train.py / evaluate.py."""
    provider = DataProvider(
        feature_extractor=FeatureExtraction(feature=feature),
        batch_size=batch_size, quant_step=quant_step, d_min=d_min,
    )
    return provider.prepare_iterable(dataset, shuffle=shuffle,
                                     prefetch=False)
