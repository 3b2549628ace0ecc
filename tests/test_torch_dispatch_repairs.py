"""Two repairs of the port's dispatch, on the CPU.

- ``use_flash='auto'`` asks ``should_use_flash`` with the head size: the
  attention kernels take heads of up to 256 (``HEAD_SIZES``), and 'auto'
  takes them up to ``AUTO_MAX_HEAD`` of the type (float32 128: at heads
  of 192 and 256 the dense path wins every float32 training row of
  ``chip_smoke.py`` phase 12's table; bf16 256: there the kernels win
  every bf16 training row), and sends a wider head to the dense path on
  the card, as the JAX package's 'auto' runs the dense path off the TPU.  Forcing the kernels runs them up to 256 and
  raises above (card tests, ``tests/test_torch_cuda_kernels.py``).
- The bf16 ``int8_matmul``'s per-tile counters are kept per (device,
  stream), so split launches on two streams never count into each other's
  tiles, and a launch captured into a CUDA graph gets zeroed counters of
  its own.  The keying is held here with the allocation and the capture
  query replaced; the two-stream launches themselves run on the card.
"""
import pytest
import torch

from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
from padertorch_tpu_torch.ops.kernels import int8_matmul as int8_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    AUTO_MAX_HEAD, HEAD_SIZES, flash_attention_plain, should_use_flash)


@pytest.mark.parametrize('head_size,fused,fused_bf16', [
    (16, True, True), (64, True, True), (128, True, True),
    (192, False, True), (256, False, True)])
def test_auto_takes_the_kernels_up_to_their_widest_head(head_size, fused,
                                                        fused_bf16):
    assert HEAD_SIZES[-1] == 256
    assert AUTO_MAX_HEAD == {torch.float32: 128, torch.bfloat16: 256}
    assert should_use_flash('cuda', torch.float32, head_size=head_size) \
        is fused
    assert should_use_flash(torch.device('cuda', 0), torch.float32,
                            head_size) is fused
    assert should_use_flash('cpu', torch.float32, head_size) is False
    assert should_use_flash('cuda', torch.bfloat16, head_size) \
        is fused_bf16
    assert should_use_flash('cpu', torch.bfloat16, head_size) is False
    assert should_use_flash('cuda', torch.bfloat16, 320) is False


def test_without_a_head_size_the_answer_is_the_device_and_type():
    assert should_use_flash('cuda') is True
    assert should_use_flash('cpu') is False


@pytest.mark.parametrize('d_model,heads', [(512, 2), (512, 4), (96, 6)])
def test_multihead_attention_asks_with_its_head_size(d_model, heads,
                                                    monkeypatch):
    """'auto' passes q's head size; the answer of the real dispatch for a
    card is applied (pretended here: the spy answers as
    ``should_use_flash`` would for 'cuda'), and a head above 128 runs the
    dense path, which equals the forced dense backend."""
    asked, fused = [], []

    def spy_dispatch(device, dtype, head_size):
        asked.append(head_size)
        return should_use_flash('cuda', dtype, head_size)

    def spy_flash(*args, **kwargs):
        fused.append(args[0].shape[-1])
        return flash_attention_plain(*args, **kwargs)

    monkeypatch.setattr(tf, 'should_use_flash', spy_dispatch)
    monkeypatch.setattr(tf, 'flash_attention', spy_flash)
    torch.manual_seed(0)
    mha = tf.MultiheadAttention(d_model, heads, use_rope=True)
    x = torch.randn(2, 7, d_model)
    auto = mha(x, causal=True)
    head = d_model // heads
    assert asked == [head]
    assert fused == ([head] if head <= AUTO_MAX_HEAD[x.dtype] else [])
    dense = tf.set_attention_backend(mha, False)(x, causal=True)
    torch.testing.assert_close(auto, dense, atol=1e-5, rtol=0)


@pytest.fixture
def counters(monkeypatch):
    """``_tile_counters`` with CPU tensors for the card's and a switch for
    the capture query; returns (the switch, the allocations made)."""
    made = []
    capturing = [False]
    real_zeros = torch.zeros

    def zeros(n, dtype, device):
        made.append((n, device))
        return real_zeros(n, dtype=dtype)

    monkeypatch.setattr(int8_kernels, '_counters', {})
    monkeypatch.setattr(int8_kernels.torch, 'zeros', zeros)
    monkeypatch.setattr(int8_kernels.torch.cuda,
                        'is_current_stream_capturing',
                        lambda: capturing[0])
    return capturing, made


def test_counters_are_kept_per_device_and_stream(counters):
    _, made = counters
    first = int8_kernels._tile_counters(0, 1111, 16)
    assert int8_kernels._tile_counters(0, 1111, 64) is first
    other_stream = int8_kernels._tile_counters(0, 2222, 16)
    other_device = int8_kernels._tile_counters(1, 1111, 16)
    assert other_stream is not first and other_device is not first
    assert other_stream is not other_device
    assert made == [(int8_kernels._COUNTERS, 'cuda:0')] * 2 \
        + [(int8_kernels._COUNTERS, 'cuda:1')]
    assert not any(bool(c.any()) for c in (first, other_stream,
                                           other_device))
    assert set(int8_kernels._counters) == {(0, 1111), (0, 2222), (1, 1111)}


def test_a_captured_launch_gets_zeroed_counters_of_its_own(counters):
    capturing, made = counters
    eager = int8_kernels._tile_counters(0, 1111, 16)
    capturing[0] = True
    one = int8_kernels._tile_counters(0, 1111, 16)
    two = int8_kernels._tile_counters(0, 1111, 16)
    assert one is not two and eager is not one
    assert tuple(one.shape) == (16,) and not bool(one.any())
    assert made[1:] == [(16, 'cuda:0'), (16, 'cuda:0')]
    assert set(int8_kernels._counters) == {(0, 1111)}
    capturing[0] = False
    assert int8_kernels._tile_counters(0, 1111, 16) is eager
