"""The port's ``STFT`` (torch) and ``HostSTFT`` (numpy) against the JAX
package's, for every complex representation and fading mode."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops._stft import STFT as JaxSTFT, HostSTFT as JaxHostSTFT
from padertorch_tpu_torch.ops._stft import STFT, HostSTFT

torch.set_num_threads(2)


def _pair(cls_jax, cls_port, fading, rep):
    kwargs = dict(window_length=96, fading=fading, complex_representation=rep)
    return (cls_jax(128, 32, dtype='float32', **kwargs),
            cls_port(128, 32, **kwargs))


@pytest.mark.parametrize('rep', ['stacked', 'concat', 'complex'])
@pytest.mark.parametrize('fading', [None, 'half', 'full'])
def test_torch_stft_matches_jax(fading, rep):
    jax_stft, stft = _pair(JaxSTFT, STFT, fading, rep)
    x = np.random.RandomState(0).randn(2, 3, 601).astype('float32')
    want = np.asarray(jax_stft(jnp.asarray(x)))
    got = stft(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    want_inv = np.asarray(jax_stft.inverse(jnp.asarray(want)))
    got_inv = stft.inverse(got).numpy()
    np.testing.assert_allclose(got_inv, want_inv, atol=1e-5, rtol=0)
    if fading == 'full':  # perfect reconstruction needs the full fade
        np.testing.assert_allclose(got_inv[..., :601], x, atol=1e-5, rtol=0)


@pytest.mark.parametrize('rep', ['stacked', 'concat', 'complex'])
def test_host_stft_matches_jax(rep):
    jax_stft, stft = _pair(JaxHostSTFT, HostSTFT, 'full', rep)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 601).astype('float32')
    spec = stft(x)
    np.testing.assert_array_equal(spec, jax_stft(x))
    np.testing.assert_array_equal(stft.inverse(spec), jax_stft.inverse(spec))
    frames = spec.shape[-3] if rep == 'stacked' else spec.shape[-2]
    mask = rng.rand(2, frames, 65).astype('float32')
    np.testing.assert_array_equal(
        stft.masked_inverse(spec, mask),
        jax_stft.masked_inverse(spec, mask, backend='jnp'))
