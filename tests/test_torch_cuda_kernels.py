"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at shapes off the main path (ragged hidden widths, one
direction, other STFT geometries).  Marked ``cuda``: they skip without a
card.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain)
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    masked_istft, masked_istft_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,masked', [
    (1, 1, 8, 5, False),
    (2, 3, 37, 40, True),
    (2, 5, 130, 64, True),
    (1, 64, 256, 33, True),
])
def test_lstm_kernel_matches_plain(cuda, n_dir, batch, hdim, t_len, masked):
    rng = np.random.RandomState(hdim)
    rows = n_dir * batch
    mask = None
    if masked:
        lens = rng.randint(1, t_len + 1, size=batch)
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        mask = np.concatenate([fwd, fwd[::-1]][:n_dir], axis=1)
    bound = 1 / np.sqrt(hdim)
    arrays = [rng.uniform(-1, 1, (t_len, rows, 4 * hdim)),
              rng.uniform(-bound, bound, (n_dir, hdim, 4 * hdim)), mask,
              rng.uniform(-0.1, 0.1, (rows, hdim)),
              rng.uniform(-0.1, 0.1, (rows, hdim))]
    args = [None if a is None else torch.tensor(a, dtype=torch.float32,
                                                device=cuda)
            for a in arrays]
    before = lstm_cell_scan.launches
    got = lstm_cell_scan(*args)
    want = lstm_cell_scan_plain(*args)
    torch.cuda.synchronize()
    assert lstm_cell_scan.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


def test_lstm_kernel_rejects_what_it_does_not_take(cuda):
    gx = torch.zeros((3, 2, 16), device=cuda)
    w = torch.zeros((1, 4, 16), device=cuda)
    h = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        lstm_cell_scan(gx.double(), w, None, h, h)
    with pytest.raises(ValueError):
        lstm_cell_scan(gx, w, None, h.t().contiguous().t(), h)
    with pytest.raises(ValueError):
        lstm_cell_scan(gx, w.cpu(), None, h, h)


@pytest.mark.parametrize('size,shift,fading,rep,lead', [
    (64, 16, None, 'stacked', (3,)),
    (128, 64, 'full', 'stacked', (2, 2)),
    (256, 64, 'half', 'concat', (1,)),
    (512, 128, 'full', 'complex', (2,)),
])
def test_masked_istft_kernel_matches_plain(cuda, size, shift, fading, rep,
                                           lead):
    stft = STFT(size, shift, fading=fading, complex_representation=rep)
    rng = np.random.RandomState(size)
    x = torch.tensor(rng.randn(*lead, 3000), dtype=torch.float32,
                     device=cuda)
    spec = stft(x)
    frames = spec.shape[-3] if rep == 'stacked' else spec.shape[-2]
    mask = torch.tensor(rng.rand(*lead, frames, size // 2 + 1),
                        dtype=torch.float32, device=cuda)
    before = masked_istft.launches
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    assert masked_istft.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    if fading == 'full':  # perfect reconstruction through the kernel
        unmasked = stft.masked_inverse(spec)
        torch.testing.assert_close(unmasked[..., :3000], x, atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize('spec_lead,mask_lead', [
    ((), (2,)),         # the recipe: K source masks on one mixture
    ((3,), (2, 3)),     # K masks per mixture of a batch
    ((2, 1), (2, 3)),   # the mask broadcasts the spectrogram mid-shape
])
def test_masked_istft_kernel_broadcasts_like_plain(cuda, spec_lead,
                                                   mask_lead):
    stft = STFT(512, 128, fading='full', complex_representation='stacked')
    rng = np.random.RandomState(len(mask_lead))
    x = torch.tensor(rng.randn(*spec_lead, 2000), dtype=torch.float32,
                     device=cuda)
    spec = stft(x)
    mask = torch.tensor(rng.rand(*mask_lead, spec.shape[-3], 257),
                        dtype=torch.float32, device=cuda)
    before = masked_istft.launches
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    assert masked_istft.launches == before + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('size,shift', [(512, 100), (128, 128)])
def test_masked_inverse_on_the_card_raises_for_unsupported_geometry(
        cuda, size, shift):
    """No fallback to the composition on the card: STFT and HostSTFT
    refuse a geometry the kernel does not take, as the JAX kernel does."""
    before = masked_istft.launches
    stft = STFT(size, shift, complex_representation='stacked')
    spec = torch.zeros((1, 4, size // 2 + 1, 2), device=cuda)
    with pytest.raises(ValueError):
        stft.masked_inverse(spec, torch.ones((2, 1, 4, size // 2 + 1),
                                             device=cuda))
    host = HostSTFT(size, shift, complex_representation='complex')
    with pytest.raises(ValueError):
        host.masked_inverse(np.zeros((4, size // 2 + 1), np.complex64),
                            np.ones((2, 4, size // 2 + 1), np.float32),
                            device=cuda)
    assert masked_istft.launches == before
