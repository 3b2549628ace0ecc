"""The port's tasnet recipe with ``--variant sepformer`` end to end on the
CPU, against the JAX package.

``train.py --synthetic --small --variant sepformer --flash --device cpu``
for one epoch of a short run (the dual-path transformer separator with its
attention forced onto the fused backend, on the CPU the kernels' plain
version); both packages' ``evaluate.py`` load the storage dir and give the
same SI-SDR per example and the same means (1e-3 dB) on the first requests
of the recipe's synthetic set.
"""
import json

import numpy as np

from tests.test_torch_pit_slice import EVAL_EXAMPLES, _run_module
from tests.test_torch_tasnet_slice import RECIPE, SHORT_TRAINING


def test_sepformer_recipe_trains_and_both_packages_evaluate(tmp_path):
    proc = _run_module(
        f'padertorch_tpu_torch.{RECIPE}.train', '--storage_root',
        str(tmp_path), '--synthetic', '--small', '--epochs', '1',
        '--variant', 'sepformer', '--flash', '--device', 'cpu',
        *SHORT_TRAINING)
    assert proc.returncode == 0, proc.stderr
    assert 'Successfully finished test run' in proc.stdout
    storage_dir = tmp_path / 'tasnet' / '1'
    config = json.loads((storage_dir / 'config.json').read_text())
    separator = config['trainer']['model']['separator']
    assert separator == {
        'factory': 'padertorch_tpu.modules.dual_path_transformer'
                   '.DualPathTransformer',
        'input_size': 16, 'window_length': 10, 'hop_size': 5,
        'num_blocks': 1, 'num_layers_intra': 1, 'num_layers_inter': 1,
        'num_heads': 2, 'd_ff': None, 'dropout': 0.0, 'use_rope': True}
    assert {p.name for p in (storage_dir / 'checkpoints').iterdir()} == {
        'ckpt_0.ptt', 'ckpt_2.ptt', 'ckpt_latest.ptt',
        'ckpt_best_si-sdr.ptt', 'ckpt_ranking.json'}
    results, means = {}, {}
    for package, extra in (('padertorch_tpu_torch', ['--device', 'cpu']),
                           ('padertorch_tpu', [])):
        proc = _run_module(f'{package}.{RECIPE}.evaluate', '--model_path',
                           str(storage_dir), '--synthetic', *extra,
                           num_examples=EVAL_EXAMPLES)
        assert proc.returncode == 0, proc.stderr
        results[package] = json.loads(
            (storage_dir / 'eval' / 'result.json').read_text())
        means[package] = json.loads(
            (storage_dir / 'eval' / 'means.json').read_text())
    port, jax_ = results['padertorch_tpu_torch'], results['padertorch_tpu']
    assert len(port) == EVAL_EXAMPLES and port.keys() == jax_.keys()
    for example_id in port:
        for key in ('input_si_sdr', 'output_si_sdr'):
            np.testing.assert_allclose(
                port[example_id][key], jax_[example_id][key], atol=1e-3,
                rtol=0, err_msg=f'{example_id} {key}')
    for key, value in means['padertorch_tpu_torch'].items():
        assert np.isfinite(value), key
        np.testing.assert_allclose(value, means['padertorch_tpu'][key],
                                   atol=1e-3, rtol=0, err_msg=key)
