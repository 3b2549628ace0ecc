"""A dependency-free tfevents writer.

Stands in for ``tensorboardX.SummaryWriter``, which the JAX package's
trainer uses: the port writes the same event files with the standard
library and numpy alone.  A file is a sequence of records,
``[uint64 length][uint32 masked crc32c of the length][payload]
[uint32 masked crc32c of the payload]``; a payload is an ``Event``
protobuf, of which the few fields used here are encoded by hand:

- ``Event``: wall_time (1, double), step (2, int64), file_version
  (3, string), summary (5, message);
- ``Summary``: value (1, repeated message);
- ``Summary.Value``: tag (1, string), simple_value (2, float), image
  (4, message), histo (5, message), audio (6, message);
- ``Summary.Image``: height (1), width (2), colorspace (3),
  encoded_image_string (4, bytes, a PNG written with ``zlib``);
- ``Summary.Audio``: sample_rate (1, float), num_channels (2),
  length_frames (3), encoded_audio_string (4, bytes, a 16-bit mono WAV
  written with ``wave``), content_type (5, string);
- ``HistogramProto``: min, max, num, sum, sum_squares (1-5, double),
  bucket_limit (6) and bucket (7), packed doubles.

``padertorch_tpu_torch.summary.tfevents`` reads them back; so do
tensorboard and the JAX package's ``summary.tfevents``.
"""
import io
import os
import socket
import struct
import time
import wave
import zlib
from pathlib import Path

import numpy as np

__all__ = ['SummaryWriter', 'encode_png', 'encode_wav', 'masked_crc32c']


def _crc32c_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def masked_crc32c(data):
    """The record checksum of the TFRecord framing (CRC-32C, rotated and
    offset)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire format ---------------------------------------------------
def _varint(value):
    value &= (1 << 64) - 1  # negative int64 as two's complement
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field, wire_type):
    return _varint((field << 3) | wire_type)


def _int(field, value):
    return _key(field, 0) + _varint(int(value))


def _double(field, value):
    return _key(field, 1) + struct.pack('<d', float(value))


def _float(field, value):
    return _key(field, 5) + struct.pack('<f', float(value))


def _bytes(field, data):
    if isinstance(data, str):
        data = data.encode()
    return _key(field, 2) + _varint(len(data)) + data


def _packed_doubles(field, values):
    values = np.asarray(values, dtype='<f8')
    return _bytes(field, values.tobytes())


def _event(wall_time, step=None, file_version=None, summary=None):
    out = _double(1, wall_time)
    if step:
        out += _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version)
    if summary is not None:
        out += _bytes(5, summary)
    return out


# -- payloads ---------------------------------------------------------------
def encode_png(image):
    """(H, W, C) uint8 with C in (1, 3, 4) -> PNG bytes."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    height, width, channels = image.shape
    color_type = {1: 0, 3: 2, 4: 6}[channels]

    def chunk(kind, data):
        body = kind + data
        return (struct.pack('>I', len(data)) + body
                + struct.pack('>I', zlib.crc32(body) & 0xFFFFFFFF))

    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8),          # filter type 0 per row
         image.reshape(height, width * channels)], axis=1)
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                         color_type, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes()))
            + chunk(b'IEND', b''))


def encode_wav(signal, sample_rate):
    """1-D floats in [-1, 1] (clipped) -> 16-bit mono WAV bytes."""
    data = np.clip(np.asarray(signal, dtype=np.float64).reshape(-1), -1, 1)
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes((data * 32767).astype('<i2').tobytes())
    return buf.getvalue()


def _default_bins():
    """TensorFlow's default histogram buckets: +-1e-12 * 1.1 ** k, and 0."""
    value, positive = 1e-12, []
    while value < 1e20:
        positive.append(value)
        value *= 1.1
    return np.array([-v for v in reversed(positive)] + [0.0] + positive)


def _histogram(values):
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    if values.size == 0:
        raise ValueError('The input has no element.')
    counts, limits = np.histogram(values, bins=_default_bins())
    # keep the occupied buckets and one empty bucket to their left;
    # bucket_limit holds each kept bucket's right edge
    occupied = np.flatnonzero(counts)
    start, end = occupied[0], occupied[-1] + 1
    if start > 0:
        counts = counts[start - 1:end]
    else:
        counts = np.concatenate([[0], counts[:end]])
    limits = limits[start:end + 1]
    return (_double(1, values.min()) + _double(2, values.max())
            + _double(3, values.size) + _double(4, values.sum())
            + _double(5, values.dot(values))
            + _packed_doubles(6, limits) + _packed_doubles(7, counts))


class SummaryWriter:
    """Writes scalars, histograms, images and audio to one tfevents file in
    ``logdir``.  The interface is the part of tensorboardX's that the
    trainer and its hooks use."""

    def __init__(self, logdir):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        self.path = logdir / (
            f'events.out.tfevents.{int(time.time()):010d}.'
            f'{socket.gethostname()}.{os.getpid()}')
        self._file = open(self.path, 'ab')
        self._write(_event(time.time(), file_version='brain.Event:2'))
        self._file.flush()

    def _write(self, payload):
        header = struct.pack('<Q', len(payload))
        self._file.write(
            header + struct.pack('<I', masked_crc32c(header))
            + payload + struct.pack('<I', masked_crc32c(payload)))

    def _add(self, summary, step):
        self._write(_event(time.time(), step=step, summary=summary))

    def add_scalar(self, tag, scalar_value, global_step=None):
        value = float(np.asarray(scalar_value).reshape(()))
        self._add(_bytes(1, _bytes(1, tag) + _float(2, value)), global_step)

    def add_histogram(self, tag, values, global_step=None):
        self._add(_bytes(1, _bytes(1, tag) + _bytes(5, _histogram(values))),
                  global_step)

    def add_image(self, tag, img_tensor, global_step=None):
        """``img_tensor``: (C, H, W) with C in (1, 3, 4); uint8, or floats
        in [0, 1] (scaled by 255)."""
        image = np.asarray(img_tensor)
        if image.ndim != 3 or image.shape[0] not in (1, 3, 4):
            raise ValueError(
                f'add_image takes (C, H, W) with C in (1, 3, 4), got '
                f'{image.shape}')
        if image.dtype != np.uint8:
            image = np.clip(image.astype(np.float32) * 255, 0, 255).astype(
                np.uint8)
        image = np.moveaxis(image, 0, -1)
        height, width, channels = image.shape
        proto = (_int(1, height) + _int(2, width) + _int(3, channels)
                 + _bytes(4, encode_png(image)))
        self._add(_bytes(1, _bytes(1, tag) + _bytes(4, proto)), global_step)

    def add_audio(self, tag, snd_tensor, global_step=None,
                  sample_rate=44100):
        """``snd_tensor``: one channel of floats in [-1, 1], any shape
        (flattened; values outside are clipped)."""
        signal = np.asarray(snd_tensor).reshape(-1)
        proto = (_float(1, sample_rate) + _int(2, 1)
                 + _int(3, signal.size)
                 + _bytes(4, encode_wav(signal, sample_rate))
                 + _bytes(5, 'audio/wav'))
        self._add(_bytes(1, _bytes(1, tag) + _bytes(6, proto)), global_step)

    def _not_ported(self, name):
        raise NotImplementedError(
            f'SummaryWriter.{name} is not ported yet (ROADMAP Queue 7); '
            'the event writer has add_scalar, add_histogram, add_image and '
            'add_audio')

    def add_figure(self, *args, **kwargs):
        self._not_ported('add_figure')

    def add_text(self, *args, **kwargs):
        self._not_ported('add_text')

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()
