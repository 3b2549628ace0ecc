"""Evaluate a trained speech recognizer: decode and token error rate.

Counterpart of ``padertorch_tpu/contrib/examples/speech_recognition/ctc/
evaluate.py``: the multi-process ``split_managed`` fan-out over batches, a
master-side merge, ``eval/transcriptions.json`` (per-utterance reference
and hypothesis) and ``eval/means.json`` (``wer``: token error rate,
``ser``: sequence error rate).  Greedy decoding by default,
``--beam_width N`` for beam search, ``--lm_order`` for an n-gram LM fused
into the CTC head's beam search.  The head is the one of the storage
dir's config.

Run (on the card, the default; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.speech_recognition.ctc.evaluate \
        --model_path <storage_dir> --synthetic
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

from padertorch_tpu_torch.evaluation import (
    NGramLM, gather_merged, is_master, split_managed)

from . import data
from .model import ConformerCTC


def load_model(model_path, checkpoint='ckpt_best_loss.ptt', device='cuda'):
    """The storage dir's model (its config's head) in eval mode on
    ``device``, from ``checkpoint`` or else the latest one."""
    try:
        model = ConformerCTC.from_storage_dir(
            model_path, checkpoint_name=checkpoint)
    except FileNotFoundError:
        model = ConformerCTC.from_storage_dir(
            model_path, checkpoint_name='ckpt_latest.ptt')
    return model.to(device).eval()


def summarize(merged):
    """``means.json``'s numbers of merged per-utterance results."""
    errors = sum(v['num_errors'] for v in merged.values())
    tokens = sum(v['num_tokens'] for v in merged.values())
    exact = sum(v['num_errors'] == 0 for v in merged.values())
    return {
        'wer': errors / max(tokens, 1),
        'ser': 1.0 - exact / max(len(merged), 1),
        'num_examples': len(merged),
        'num_tokens': tokens,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='test')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--num_examples', type=int, default=None)
    parser.add_argument('--checkpoint', default='ckpt_best_loss.ptt')
    parser.add_argument('--beam_width', type=int, default=None,
                        help='beam search width (default: greedy)')
    parser.add_argument('--markov', type=float, default=0.0,
                        help='must match the training --markov')
    parser.add_argument('--lm_order', type=int, default=None,
                        help='fit an add-k n-gram LM of this order on '
                             'the training transcripts and fuse it '
                             '(CTC beam search only)')
    parser.add_argument('--lm_weight', type=float, default=0.5)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    model = load_model(model_path, args.checkpoint, args.device)
    print(f'device: {args.device}')

    synthetic = args.synthetic or args.database is None
    if synthetic:
        # held-out split: fresh seed -> unseen tone sequences
        dataset = data.synthetic_database(
            num_examples=args.num_examples or 32,
            vocab_size=model.vocab_size, seed=1, markov=args.markov)
    else:
        from padertorch_tpu_torch.data.database import JsonDatabase
        dataset = JsonDatabase(args.database).get_dataset(args.dataset)

    kwargs = {}
    if args.lm_order is not None:
        if not isinstance(model, ConformerCTC):
            raise SystemExit('--lm_order supports the CTC head only')
        if args.beam_width is None:
            raise SystemExit('--lm_order requires --beam_width')
        if synthetic:
            lm_corpus = data.synthetic_database(
                num_examples=96, vocab_size=model.vocab_size, seed=0,
                markov=args.markov)
        else:
            from padertorch_tpu_torch.data.database import JsonDatabase
            lm_corpus = JsonDatabase(args.database).get_dataset('train')
        kwargs = {'lm_fn': NGramLM(order=args.lm_order).fit(
                      [ex['labels'] for ex in lm_corpus]),
                  'lm_weight': args.lm_weight}
    dataset = data.prepare_dataset(
        dataset, batch_size=args.batch_size, shuffle=False,
        prefetch=False)

    results = {}
    for batch in split_managed(dataset, progress_bar=True):
        results.update(model.decode(
            batch, beam_width=args.beam_width, **kwargs))

    merged = gather_merged(results)
    if is_master():
        out_dir = model_path / 'eval'
        out_dir.mkdir(exist_ok=True)
        summary = summarize(merged)
        (out_dir / 'transcriptions.json').write_text(
            json.dumps(merged, indent=2, sort_keys=True))
        (out_dir / 'means.json').write_text(json.dumps(summary, indent=2))
        print(json.dumps(summary, indent=2))


if __name__ == '__main__':
    main()
