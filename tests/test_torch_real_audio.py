"""Real audio in the port against the JAX package, bit for bit, on the CPU.

The data path is numpy in both packages, so everything here is held to
exact equality (values and dtypes):

- ``native/dataprep`` (pcm16, mu-law, framing): the port's C++ copy
  against the JAX package's native build (its fallbacks too, the mu-law
  decode of the torch fallback within 1e-6);
- ``AudioReader`` on every kind of file the WAV trees hold (int16 mono of
  lengths up to two times apart, stereo, int32, 8 kHz resampled, float32),
  and every other transform of ``contrib/je/data/transforms.py``;
- ``read_audio`` of the separation recipes and of the mask estimator;
- the batches each of the eleven ``--database`` entry points builds from
  a WAV tree and JSON that ``_wav_databases`` writes from a seed, against
  the JAX recipe's data functions on the same JSON: lengths, order,
  padding, the tasnet recipe's segment cut (files shorter than
  ``segment_length`` dropped), the shuffled training sets under the same
  numpy seed.
"""
import json

import numpy as np
import pytest
from scipy.io import wavfile

from padertorch_tpu import native as jax_native
from padertorch_tpu.contrib.je.data import transforms as jax_transforms
from padertorch_tpu.data.database import JsonDatabase as JaxJsonDatabase
from padertorch_tpu_torch import native
from padertorch_tpu_torch.native import dataprep
from padertorch_tpu_torch.contrib.examples import _wav_databases as wav_dbs
from padertorch_tpu_torch.contrib.je.data import transforms
from padertorch_tpu_torch.data.database import JsonDatabase

SR = 16000


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('wav_tree')
    rng = np.random.RandomState(0)
    files = {}
    mono = (0.3 * rng.randn(3001)).clip(-1, 1)
    files['int16'] = wav_dbs.write_wav(root / 'int16.wav', mono, SR)
    files['stereo'] = wav_dbs.write_wav(
        root / 'stereo.wav', np.stack([mono, -0.5 * mono], 1), SR)
    files['int32'] = wav_dbs.write_wav(root / 'int32.wav', mono, SR,
                                       'int32')
    files['8khz'] = wav_dbs.write_wav(root / '8khz.wav', mono[:1501], 8000)
    files['float32'] = wav_dbs.write_wav(root / 'float32.wav', mono, SR,
                                         'float32')
    dbs = {
        'wsj0_2mix': wav_dbs.write_wsj0_2mix(root, min_samples=4000),
        'librispeech': wav_dbs.write_librispeech(root, min_samples=3000),
        'chime': wav_dbs.write_chime(root, min_samples=4000),
    }
    return {'root': root, 'files': files, 'dbs': dbs}


def assert_same(got, want, where=''):
    """Nested equality, arrays bit for bit with their dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for key in want:
            assert_same(got[key], want[key], f'{where}.{key}')
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (str, int, float))):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------- dataprep

def test_native_is_built_and_loaded_from_the_build_dir():
    assert native.NATIVE_AVAILABLE
    so = dataprep._so_path()
    assert so.exists() and so.parent.name == '_build'
    assert so.parent.parent.name == 'padertorch_tpu_torch'


def test_threads_that_ask_for_the_build_at_once_build_it_once(
        tmp_path, monkeypatch):
    """Prefetch threads decoding their first files together: one build,
    no private file left over, every result the numpy one."""
    import sys
    import threading
    monkeypatch.setattr(dataprep, '_BUILD_DIR', tmp_path)
    monkeypatch.setattr(dataprep, '_lib', None)
    monkeypatch.setattr(dataprep, '_load_failed', False)
    pcm = np.random.RandomState(7).randint(
        -32768, 32768, size=4000).astype(np.int16)
    results = [None] * 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            results[i] = dataprep.pcm16_to_float32(pcm)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert [p.name for p in tmp_path.iterdir()] == [dataprep._so_path().name]
    for out in results:
        np.testing.assert_array_equal(out, pcm / np.float32(32768))


@pytest.mark.parametrize('fallback', [False, True])
def test_dataprep_equals_the_jax_package(fallback, monkeypatch):
    if fallback:
        monkeypatch.setattr(dataprep, '_load', lambda: None)
    rng = np.random.RandomState(1)
    pcm = rng.randint(-32768, 32768, size=1001).astype(np.int16)
    assert_same(dataprep.pcm16_to_float32(pcm),
                jax_native.pcm16_to_float32(pcm))
    x = np.concatenate([np.linspace(-1, 1, 513),
                        rng.uniform(-1, 1, 500)]).astype(np.float32)
    encoded = dataprep.mu_law_encode(x)
    assert_same(encoded, jax_native.mu_law_encode(x))
    if fallback:
        # torch's float pow, as the JAX fallback's XLA one, may be a unit
        # of the last place off the C++ powf
        np.testing.assert_allclose(dataprep.mu_law_decode(encoded),
                                   jax_native.mu_law_decode(encoded),
                                   rtol=0, atol=1e-6)
    else:
        assert_same(dataprep.mu_law_decode(encoded),
                    jax_native.mu_law_decode(encoded))
    signal = rng.randn(1000).astype(np.float32)
    for length, shift in ((64, 32), (400, 160), (1000, 1), (1001, 1)):
        assert_same(dataprep.frame_signal(signal, length, shift),
                    jax_native.frame_signal(signal, length, shift))


# -------------------------------------------------------------- transforms

READER_CASES = [
    ('int16', {}), ('stereo', {}), ('stereo', {'average_channels': False}),
    ('int32', {}), ('8khz', {}), ('float32', {}),
    ('int16', {'normalization_domain': 'instance'}),
    ('int16', {'target_sample_rate': 8000}),
]


@pytest.mark.parametrize('kind,kwargs', READER_CASES,
                         ids=[f'{k}-{"-".join(kw) or "default"}'
                              for k, kw in READER_CASES])
def test_audio_reader_equals_the_jax_package(tree, kind, kwargs):
    path = tree['files'][kind]
    got = transforms.AudioReader(**kwargs)({'audio_path': path})
    want = jax_transforms.AudioReader(**kwargs)({'audio_path': path})
    assert_same(got, want)
    assert got['audio_data'].dtype == np.float32 or kind == '8khz'
    sr, raw = wavfile.read(path)
    if kind == 'int16' and not kwargs:
        np.testing.assert_array_equal(got['audio_data'], raw / 32768.0)
    if kind == 'int32':
        np.testing.assert_allclose(got['audio_data'], raw / 2 ** 31,
                                   rtol=1e-7)
    if kind == 'stereo' and kwargs:
        assert got['audio_data'].shape == (2, raw.shape[0])
    if kind == '8khz':
        assert got['seq_len'] == 2 * raw.shape[0] == 3002


def _stft_example(rng, n=2400):
    return {'audio_data': rng.randn(n).astype(np.float32), 'seq_len': n,
            'events': ['b', 'a', 'b'],
            'events_start_samples': [0, 500, 1200],
            'events_stop_samples': [800, 1700, 2400]}


@pytest.mark.parametrize('fading', ['full', 'half', None])
def test_stft_and_mel_transform_equal_the_jax_package(fading):
    ex = _stft_example(np.random.RandomState(2))
    kwargs = dict(shift=160, size=512, window_length=400, fading=fading,
                  alignment_keys=['events'])
    got = transforms.STFT(**kwargs)(dict(ex))
    want = jax_transforms.STFT(**kwargs)(dict(ex))
    assert_same(got, want)
    mel = dict(sample_rate=SR, stft_size=512, number_of_filters=40)
    assert_same(transforms.MelTransform(**mel)(dict(got)),
                jax_transforms.MelTransform(**mel)(dict(want)))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_time_warped_stft_equals_the_jax_package(seed):
    """Seeded anchors from the same numpy generators, in the same order,
    warp the same frames, the alignment annotations with them."""
    outs = []
    for package in (transforms, jax_transforms):
        rng = np.random.RandomState(seed)
        base = package.STFT(shift=160, size=512, window_length=400,
                            alignment_keys=['events'])
        warp = package.TimeWarpedSTFT(
            base, anchor_sampling_fn=lambda: rng.uniform(0.3, 0.7),
            anchor_shift_sampling_fn=lambda: rng.uniform(-0.1, 0.1))
        ex = _stft_example(np.random.RandomState(10 + seed))
        outs.append([warp(dict(ex)) for _ in range(3)])
    assert_same(*outs)


def test_label_encoders_equal_the_jax_package(tmp_path):
    rng = np.random.RandomState(3)
    dataset = [{'label': lab, 'events': ['b', 'a'][:1 + i % 2]}
               for i, lab in enumerate(['x', 'z', 'y', 'x'])]
    for package, sub in ((transforms, 'port'), (jax_transforms, 'jax')):
        enc = package.LabelEncoder(storage_dir=tmp_path / sub)
        enc.initialize_labels(dataset=dataset)
    assert (tmp_path / 'port' / 'labels.json').read_text() == \
        (tmp_path / 'jax' / 'labels.json').read_text()
    # a new encoder restores the stored map
    enc = transforms.LabelEncoder(storage_dir=tmp_path / 'port',
                                  to_array=True).initialize_labels()
    assert enc({'label': 'z'})['label'].tolist() == 2
    assert enc.inverse_transform([0, 2]) == ['x', 'z']
    stft = rng.randn(1, 12, 5, 2).astype(np.float32)[0]
    ex = {'events': ['b', 'a', 'b'], 'stft': stft,
          'events_start_frames': [0, 3, 7], 'events_stop_frames': [4, 9, 12]}
    for name in ('MultiHotEncoder', 'AlignmentEncoder',
                 'MultiHotAlignmentEncoder'):
        got, want = [
            getattr(package, name)(label_key='events').initialize_labels(
                dataset=dataset)(dict(ex))
            for package in (transforms, jax_transforms)]
        assert_same(got, want, name)
    assert (tmp_path / 'port' / 'labels.json').exists()


def test_eventss_json_keeps_the_reference_name(tmp_path):
    enc = transforms.MultiHotEncoder(label_key='events',
                                     storage_dir=tmp_path)
    enc.initialize_labels(dataset=[{'events': ['b', 'a']}])
    assert json.loads((tmp_path / 'eventss.json').read_text()) == ['a', 'b']


@pytest.mark.parametrize('case', ['stack', 'stack-axis1', 'stack-cut',
                                  'stack-dict', 'concatenate', 'collate',
                                  'collate-axis1'])
def test_collating_transforms_equal_the_jax_package(case):
    rng = np.random.RandomState(4)
    arrays = [rng.randn(2, n).astype(np.float32) for n in (5, 3, 7)]
    batch = [{'x': rng.randn(n, 3).astype(np.float32), 'n': n, 'id': f'e{n}'}
             for n in (4, 6, 2)]
    if case.startswith('stack'):
        kwargs = {'stack-axis1': {'axis': 1},
                  'stack-cut': {'cut_end': True}}.get(case, {})
        arg = {'a': arrays} if case == 'stack-dict' else arrays
        got = transforms.StackArrays(**kwargs)(arg)
        want = jax_transforms.StackArrays(**kwargs)(arg)
    elif case == 'concatenate':
        got = transforms.ConcatenateArrays(axis=1)(arrays)
        want = jax_transforms.ConcatenateArrays(axis=1)(arrays)
    else:
        kwargs = {'pad_axis': 1} if case == 'collate-axis1' else {}
        if kwargs:
            batch = [{**ex, 'x': ex['x'].T} for ex in batch]
        got = transforms.Collate(**kwargs)(batch)
        want = jax_transforms.Collate(**kwargs)(batch)
    assert_same(got, want)


# -------------------------------------------------------------- read_audio

def test_read_audio_equals_the_jax_package(tree):
    from padertorch_tpu.contrib.examples.source_separation.pit import (
        data as jax_pit_data)
    from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
        data as pit_data)
    from padertorch_tpu_torch.contrib.examples.source_separation.tasnet \
        import data as tasnet_data
    assert tasnet_data.read_audio is pit_data.read_audio
    db = json.loads(tree['dbs']['wsj0_2mix'].read_text())
    for split, examples in db['datasets'].items():
        for example_id, ex in examples.items():
            ex = {'example_id': example_id, **ex}
            got = pit_data.read_audio(dict(ex))
            assert_same(got, jax_pit_data.read_audio(dict(ex)))
            assert got['observation'].shape == (got['num_samples'],)
            assert got['speech_source'].shape == (2, got['num_samples'])


def test_mask_estimator_read_audio_reads_every_channel(tree):
    """The port's reader of the CHiME schema against the JAX package's
    ``AudioReader`` on each file (the JAX recipe's ``--database`` takes
    the signals inline): channels in name order, one multichannel file
    read as (C, T), everything at the recipe's 8 kHz."""
    from padertorch_tpu_torch.contrib.examples.speech_enhancement \
        .mask_estimator import evaluate as me_evaluate
    reader = jax_transforms.AudioReader(target_sample_rate=8000)
    examples = JsonDatabase(tree['dbs']['chime']).get_dataset('et05_simu')
    for ex in examples:
        got = me_evaluate.read_audio(dict(ex))
        obs = ex['audio_path']['observation']
        if isinstance(obs, dict):
            want = np.stack([reader.read_file(obs[k]) for k in sorted(obs)])
        else:
            want = reader.read_file(obs)
        assert_same(got['observation'], want)
        assert_same(got['speech_source'],
                    reader.read_file(ex['audio_path']['speech_source']))
        assert got['observation'].shape[0] == 4
    inline = {'example_id': 'x', 'observation': np.zeros((2, 5))}
    assert me_evaluate.read_audio(inline) is inline


# ------------------------------------------- the entry points' batches

def _separation(package, recipe):
    if package == 'port':
        from padertorch_tpu_torch.contrib.examples.source_separation import (
            pit, tasnet)
    else:
        from padertorch_tpu.contrib.examples.source_separation import (
            pit, tasnet)
    import importlib
    return importlib.import_module(
        f'{(pit if recipe == "pit" else tasnet).__name__}.data')


def _db(package, tree, name):
    cls = JsonDatabase if package == 'port' else JaxJsonDatabase
    return cls(tree['dbs'][name])


def _iterate(dataset, seed):
    np.random.seed(seed)
    return list(dataset)


def _pit_batches(package, tree, split, shuffle):
    data = _separation(package, 'pit')
    ds = _db(package, tree, 'wsj0_2mix').get_dataset(split).map(
        data.read_audio)
    return _iterate(data.prepare_dataset(ds, batch_size=2, shuffle=shuffle,
                                         prefetch=False), 0)


def _pit_requests(package, tree):
    """``evaluate.py --database --dataset mix_2_spk_min_tt``: one
    request a mixture, the model's input built as ``evaluate_example``
    builds it."""
    data = _separation(package, 'pit')
    ds = _db(package, tree, 'wsj0_2mix').get_dataset(
        'mix_2_spk_min_tt').map(data.read_audio)
    return [data.post_batch_transform([data.pre_batch_transform(ex)])
            for ex in ds]


def _tasnet_batches(package, tree, split, segment_length, shuffle):
    data = _separation(package, 'tasnet')
    ds = _db(package, tree, 'wsj0_2mix').get_dataset(split).map(
        data.read_audio)
    return _iterate(data.prepare_dataset(
        ds, batch_size=2, segment_length=segment_length, shuffle=shuffle,
        prefetch=False), 1)


def _tasnet_requests(package, tree):
    data = _separation(package, 'tasnet')
    ds = _db(package, tree, 'wsj0_2mix').get_dataset(
        'mix_2_spk_min_tt').map(data.read_audio)
    return [data.post_batch_transform([{
        k: ex[k] for k in ('example_id', 'observation', 'speech_source')}])
        for ex in ds]


def _wavenet(package):
    if package == 'port':
        from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet \
            import data
        return data, transforms
    from padertorch_tpu.contrib.examples.audio_synthesis.wavenet import data
    return data, jax_transforms


def _wavenet_batches(package, tree, split, segment_length, shuffle):
    data, package_transforms = _wavenet(package)
    reader = package_transforms.AudioReader(
        target_sample_rate=data.SAMPLE_RATE)
    ds = _db(package, tree, 'librispeech').get_dataset(split).map(reader)
    return _iterate(data.prepare_dataset(
        ds, batch_size=2, segment_length=segment_length, shuffle=shuffle,
        prefetch=False), 2)


def _wavenet_requests(package, tree):
    data, package_transforms = _wavenet(package)
    reader = package_transforms.AudioReader(
        target_sample_rate=data.SAMPLE_RATE)
    ds = _db(package, tree, 'librispeech').get_dataset('test_clean').map(
        reader)
    return [data.extract_features(ex) for ex in ds]


def _speaker_batches(package, tree, split, audio, shuffle, tmp):
    """The classifier's ``--database`` pipelines: labels from the JSON,
    the WAV files read by ``AudioReader`` at 16 kHz (the port's
    ``data.read_audio``; the JAX recipe's branch reads audio inline, so
    its ``AudioReader`` is mapped here), then the recipe's prepare call
    for either front end."""
    if package == 'port':
        from padertorch_tpu_torch.contrib.examples.speaker_classification \
            .supervised import data
        read = data.read_audio
    else:
        from padertorch_tpu.contrib.examples.speaker_classification \
            .supervised import data
        read = jax_transforms.AudioReader(target_sample_rate=SR)
    ds = _db(package, tree, 'librispeech').get_dataset(split)
    encoder = data.get_label_encoder(tmp / package, ds)
    prepare = data.prepare_dataset_audio if audio else data.prepare_dataset
    return _iterate(prepare(ds.map(read), encoder, batch_size=3,
                            shuffle=shuffle, prefetch=False), 3)


ENTRY_POINTS = [
    'pit.train', 'pit.train-cv', 'pit.evaluate',
    'tasnet.train', 'tasnet.train-32000', 'tasnet.train-cv',
    'tasnet.evaluate',
    'or_pit.train', 'or_pit.evaluate',
    'wavenet.train', 'wavenet.train-small', 'wavenet.evaluate',
    'supervised.train', 'supervised.train-stft', 'supervised.evaluate',
    'mask_estimator.evaluate',
]


@pytest.mark.parametrize('entry', ENTRY_POINTS)
def test_entry_point_batches_equal_the_jax_recipes(entry, tree, tmp_path):
    def build(package):
        if entry == 'pit.train':
            return _pit_batches(package, tree, 'mix_2_spk_min_tr', True)
        if entry == 'pit.train-cv':
            return _pit_batches(package, tree, 'mix_2_spk_min_cv', False)
        if entry == 'pit.evaluate':
            return _pit_requests(package, tree)
        if entry in ('tasnet.train', 'or_pit.train'):
            # a segment that some of the files are shorter than: those are
            # dropped, the others cut at a random anchor
            return _tasnet_batches(package, tree, 'mix_2_spk_min_tr',
                                   6000, True)
        if entry == 'tasnet.train-32000':
            return _tasnet_batches(package, tree, 'mix_2_spk_min_tr',
                                   32000, True)
        if entry == 'tasnet.train-cv':
            return _tasnet_batches(package, tree, 'mix_2_spk_min_cv',
                                   5000, False)
        if entry in ('tasnet.evaluate', 'or_pit.evaluate'):
            return _tasnet_requests(package, tree)
        if entry == 'wavenet.train':
            return _wavenet_batches(package, tree, 'train_clean_100', 4000,
                                    True)
        if entry == 'wavenet.train-small':
            return _wavenet_batches(package, tree, 'dev_clean', 2000, False)
        if entry == 'wavenet.evaluate':
            return _wavenet_requests(package, tree)
        if entry == 'supervised.train':
            return _speaker_batches(package, tree, 'train_clean_100', True,
                                    True, tmp_path)
        if entry == 'supervised.train-stft':
            return _speaker_batches(package, tree, 'dev_clean', False,
                                    False, tmp_path)
        if entry == 'supervised.evaluate':
            return _speaker_batches(package, tree, 'test_clean', True,
                                    False, tmp_path)
        if entry == 'mask_estimator.evaluate':
            return _mask_estimator_requests(package, tree)
        raise ValueError(entry)

    got, want = build('port'), build('jax')
    assert_same(got, want, entry)
    if entry == 'tasnet.train-32000':
        assert got == []            # every file is shorter than 2 s
    else:
        assert len(got) > 0
    if entry == 'tasnet.train':
        kept = {i for b in got for i in b['example_id']}
        assert 0 < len(kept) < 6 and all(
            int(b['num_samples'].max()) == 6000 for b in got)
    if entry == 'pit.train':
        # ragged: one batch pads its shorter mixture
        assert any(len(set(b['num_frames'].tolist())) > 1 for b in got)


def _mask_estimator_requests(package, tree):
    """The model's input of each ``evaluate_example`` request (the
    channels' STFT magnitudes and frame counts) from the same files."""
    if package == 'port':
        from padertorch_tpu_torch.contrib.examples.speech_enhancement \
            .mask_estimator import evaluate as me_evaluate, train
        examples = JsonDatabase(tree['dbs']['chime']).get_dataset(
            'et05_simu').map(me_evaluate.read_audio)
    else:
        from padertorch_tpu.contrib.examples.speech_enhancement \
            .mask_estimator import train
        reader = jax_transforms.AudioReader(target_sample_rate=8000)

        def read(ex):
            obs = ex['audio_path']['observation']
            obs = (np.stack([reader.read_file(obs[k]) for k in sorted(obs)])
                   if isinstance(obs, dict) else reader.read_file(obs))
            return {'example_id': ex['example_id'], 'observation': obs,
                    'speech_source': reader.read_file(
                        ex['audio_path']['speech_source'])}
        examples = JaxJsonDatabase(tree['dbs']['chime']).get_dataset(
            'et05_simu').map(read)
    out = []
    for ex in examples:
        spec = np.asarray(train._stft(np.asarray(ex['observation'])))
        out.append({'observation_abs': np.abs(spec).astype('float32'),
                    'num_frames': np.asarray([spec.shape[1]] * spec.shape[0],
                                             'int32')})
    return out
