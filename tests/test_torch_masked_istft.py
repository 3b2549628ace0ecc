"""The port's fused mask + iSTFT (``padertorch_tpu_torch.ops.kernels.
masked_istft``) against the JAX package: its Pallas kernel in interpret
mode and ``HostSTFT.masked_inverse(backend='jnp')``.

On CPU tensors the port runs its plain version (mirror, matmul with the
iSTFT kernels, overlap-add), which sums the same f32 products in another
order than the kernel's folded synthesis matrices: 1e-5 on signals of
unit scale.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops._stft import HostSTFT as JaxHostSTFT
from padertorch_tpu.ops.pallas.masked_istft import (
    masked_istft as jax_masked_istft)
from padertorch_tpu_torch.ops._stft import STFT, HostSTFT
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    _split, masked_istft, masked_istft_plain)

torch.set_num_threads(2)

ATOL = 1e-5
GEOMETRIES = {'recipe': (512, 128, 1500), 'small': (64, 16, 300)}


def _case(geometry, fading, rep, seed=0):
    size, shift, samples = GEOMETRIES[geometry]
    kwargs = dict(fading=fading, complex_representation=rep)
    jax_stft = JaxHostSTFT(size, shift, dtype='float32', **kwargs)
    rng = np.random.RandomState(seed)
    spec = jax_stft(rng.randn(2, samples).astype('float32'))
    frames = spec.shape[-3] if rep == 'stacked' else spec.shape[-2]
    mask = rng.rand(3, 2, frames, size // 2 + 1).astype('float32')
    # a leading source axis: (3, 2, ...) masks on a (1, 2, ...) mixture
    return jax_stft, STFT(size, shift, **kwargs), spec[None], mask


@pytest.mark.parametrize('rep', ['stacked', 'concat', 'complex'])
@pytest.mark.parametrize('fading', [None, 'half', 'full'])
@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_matches_jax(geometry, fading, rep):
    jax_stft, stft, spec, mask = _case(geometry, fading, rep)
    want_kernel = np.asarray(jax_masked_istft(
        jnp.asarray(spec), jnp.asarray(mask), stft=jax_stft,
        interpret=True))
    want_host = jax_stft.masked_inverse(spec, mask, backend='jnp')
    before = masked_istft.launches
    got = masked_istft(torch.from_numpy(spec), torch.from_numpy(mask),
                       stft=stft).numpy()
    assert masked_istft.launches == before
    assert got.shape == want_kernel.shape == want_host.shape
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_host, atol=ATOL, rtol=0)


def test_unmasked_matches_jax():
    jax_stft, stft, spec, _ = _case('recipe', 'full', 'stacked', seed=1)
    want = np.asarray(jax_masked_istft(
        jnp.asarray(spec), None, stft=jax_stft, interpret=True))
    got = masked_istft_plain(torch.from_numpy(spec), stft=stft).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('fn', [masked_istft, masked_istft_plain])
@pytest.mark.parametrize('size,shift,window_length', [
    (512, 100, None),   # shift does not divide the window
    (128, 128, None),   # no overlap
])
def test_rejects_unsupported_geometry(fn, size, shift, window_length):
    stft = STFT(size, shift, window_length=window_length,
                complex_representation='stacked')
    spec = torch.zeros((1, 4, size // 2 + 1, 2))
    with pytest.raises(ValueError):
        fn(spec, None, stft=stft)


@pytest.mark.parametrize('size,shift,window_length', [
    (512, 100, None),   # shift does not divide the window
    (128, 128, None),   # no overlap
])
def test_host_cuda_request_rejects_unsupported_geometry(
        size, shift, window_length):
    """A request for the card never falls back to the composition: the
    geometry is refused before anything is uploaded."""
    stft = HostSTFT(size, shift, window_length=window_length,
                    complex_representation='complex')
    spec = np.zeros((4, size // 2 + 1), np.complex64)
    mask = np.ones((2, 4, size // 2 + 1), np.float32)
    with pytest.raises(ValueError):
        stft.masked_inverse(spec, mask, device='cuda')


def test_source_axis_keeps_one_spectrogram():
    """Per-source masks on one mixture: the spectrogram is passed once,
    the mask once per source."""
    _, stft, spec, mask = _case('small', 'full', 'stacked')
    re, im, rows_mask, lead = _split(
        torch.from_numpy(spec), torch.from_numpy(mask), stft)
    assert tuple(lead) == (3, 2)
    assert re.shape[0] == im.shape[0] == 2
    assert rows_mask.shape[0] == 6


@pytest.mark.parametrize('spec_lead,mask_lead', [
    ((2, 1), (2, 3)),   # the mask broadcasts the spectrogram mid-shape
    ((3,), ()),         # one mask for every spectrogram
])
def test_other_broadcasts_match_jax(spec_lead, mask_lead):
    size, shift, samples = GEOMETRIES['small']
    jax_stft = JaxHostSTFT(size, shift, dtype='float32',
                           complex_representation='stacked')
    rng = np.random.RandomState(3)
    spec = jax_stft(rng.randn(*spec_lead, samples).astype('float32'))
    mask = rng.rand(*mask_lead, spec.shape[-3], size // 2 + 1).astype(
        'float32')
    want = np.asarray(jax_masked_istft(
        jnp.asarray(spec), jnp.asarray(mask), stft=jax_stft,
        interpret=True))
    got = masked_istft(torch.from_numpy(spec), torch.from_numpy(mask),
                       stft=STFT(size, shift,
                                 complex_representation='stacked')).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
