"""Read back tfevents files written by the SummaryHook.

Counterpart of ``padertorch_tpu/summary/tfevents.py`` (reference
``padertorch/summary/tfevents.py:26``).  The record framing is
``[uint64 length][uint32 masked crc32c][payload][uint32 crc]``; the
payload, an ``Event`` protobuf, is decoded by hand for the fields that
``padertorch_tpu_torch.summary.writer`` writes (scalars, histograms,
images, audio), so no protobuf package is needed.

Used by the framework's own tests to assert which tags a training wrote.
"""
import struct
from pathlib import Path

__all__ = ['load_events_as_dict', 'scalars_from_events']


def _iter_records(path):
    data = Path(path).read_bytes()
    offset = 0
    n = len(data)
    while offset + 12 <= n:
        (length,) = struct.unpack_from('<Q', data, offset)
        offset += 8 + 4  # length + length crc
        payload = data[offset:offset + length]
        offset += length + 4  # payload + payload crc
        yield payload


def _fields(data):
    """Yield (field number, wire type, value) of one protobuf message:
    ints for varints, bytes for the fixed and length-delimited types."""
    offset = 0
    while offset < len(data):
        key, offset = _read_varint(data, offset)
        field, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, offset = _read_varint(data, offset)
        elif wire_type == 1:
            value, offset = data[offset:offset + 8], offset + 8
        elif wire_type == 5:
            value, offset = data[offset:offset + 4], offset + 4
        elif wire_type == 2:
            length, offset = _read_varint(data, offset)
            value, offset = data[offset:offset + length], offset + length
        else:
            raise ValueError(f'unsupported protobuf wire type {wire_type}')
        yield field, wire_type, value


def _read_varint(data, offset):
    value, shift = 0, 0
    while True:
        byte = data[offset]
        offset += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, offset
        shift += 7


def _double(raw):
    return struct.unpack('<d', raw)[0]


def _doubles(raw):
    return list(struct.unpack(f'<{len(raw) // 8}d', raw))


def _decode_histogram(data):
    names = {1: 'min', 2: 'max', 3: 'num', 4: 'sum', 5: 'sum_squares'}
    out = {}
    for field, _, value in _fields(data):
        if field in names:
            out[names[field]] = _double(value)
        elif field == 6:
            out['bucket_limit'] = _doubles(value)
        elif field == 7:
            out['bucket'] = _doubles(value)
    return out


def _decode_image(data):
    names = {1: 'height', 2: 'width', 3: 'colorspace'}
    out = {}
    for field, _, value in _fields(data):
        if field in names:
            out[names[field]] = value
        elif field == 4:
            out['encoded_image_string'] = bytes(value)
    return out


def _decode_audio(data):
    names = {2: 'num_channels', 3: 'length_frames'}
    out = {}
    for field, _, value in _fields(data):
        if field in names:
            out[names[field]] = value
        elif field == 1:
            out['sample_rate'] = struct.unpack('<f', value)[0]
        elif field == 4:
            out['encoded_audio_string'] = bytes(value)
        elif field == 5:
            out['content_type'] = value.decode()
    return out


def _decode_value(data):
    out = {}
    for field, _, value in _fields(data):
        if field == 1:
            out['tag'] = value.decode()
        elif field == 2:
            out['simple_value'] = struct.unpack('<f', value)[0]
        elif field == 4:
            out['image'] = _decode_image(value)
        elif field == 5:
            out['histo'] = _decode_histogram(value)
        elif field == 6:
            out['audio'] = _decode_audio(value)
    return out


def _decode_event(data):
    out = {}
    for field, _, value in _fields(data):
        if field == 1:
            out['wall_time'] = _double(value)
        elif field == 2:
            # int64: undo the two's complement of a negative step
            out['step'] = value - (1 << 64) if value >> 63 else value
        elif field == 3:
            out['file_version'] = value.decode()
        elif field == 5:
            out['summary'] = {'value': [
                _decode_value(v) for f, _, v in _fields(value) if f == 1]}
    return out


def load_events_as_dict(path):
    """Return a list of event dicts (keys like wall_time, step, summary).

    A summary is ``{'value': [{'tag': ..., 'simple_value': ...}, ...]}``;
    histograms come under ``'histo'``, images under ``'image'`` and audio
    (a WAV in ``'encoded_audio_string'``) under ``'audio'``.
    """
    return [_decode_event(payload) for payload in _iter_records(path)]


def scalars_from_events(path):
    """Convenience: ``{tag: [(step, value), ...]}`` for scalar events."""
    out = {}
    for event in load_events_as_dict(path):
        for value in event.get('summary', {}).get('value', []):
            if 'simple_value' in value:
                out.setdefault(value['tag'], []).append(
                    (int(event.get('step', 0)), value['simple_value']))
    return out
