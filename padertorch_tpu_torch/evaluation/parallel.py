"""Evaluation fan-out (dlp_mpi replacement).

Copy of ``padertorch_tpu/evaluation/parallel.py``.

The reference fans evaluation out over MPI ranks
(``dlp_mpi.split_managed`` master/worker queue + ``gather``; e.g.
``tasnet/evaluate.py:159-256``).  Under JAX's single-controller model the
equivalent is host-level concurrency:

- ``split_managed(dataset)``: a dynamic work queue over examples, executed
  by a thread pool (device inference serializes on the accelerator anyway,
  and host metric code — numpy BSS eval — releases the GIL in BLAS/FFT).
- ``gather(results)``: identity on one process; with ``PT_EVAL_RANK`` /
  ``PT_EVAL_SIZE`` / ``PT_EVAL_DIR`` set by a launcher, a file-based
  gather: every rank atomically writes ``gather_<tag>.rank<k>.json`` into
  the shared ``PT_EVAL_DIR`` and rank 0 polls until all shards exist, then
  returns them as a list indexed by rank (other ranks return ``None``) —
  same semantics as ``dlp_mpi.gather`` in the reference evaluate scripts
  (``tasnet/evaluate.py:235-256``).
"""
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ['split_managed', 'gather', 'gather_merged', 'bcast',
           'is_master', 'RANK', 'SIZE', 'map_unordered']

RANK = int(os.environ.get('PT_EVAL_RANK', 0))
SIZE = int(os.environ.get('PT_EVAL_SIZE', 1))


def is_master():
    return RANK == 0


def split_managed(dataset, is_indexable=True, progress_bar=False,
                  allow_single_worker=True):
    """Yield the examples this worker should process.

    On one process: yields everything (optionally with a progress bar).
    With PT_EVAL_RANK/SIZE set: yields a strided shard.
    """
    del is_indexable, allow_single_worker
    iterator = iter(dataset)
    if SIZE > 1:
        iterator = (
            ex for i, ex in enumerate(iterator) if i % SIZE == RANK)
    if progress_bar:
        from tqdm import tqdm
        try:
            total = len(dataset)
        except TypeError:
            total = None
        iterator = tqdm(iterator, total=total)
    yield from iterator


def map_unordered(fn, dataset, num_workers=4, progress_bar=False):
    """Evaluate ``fn`` over examples with a thread pool; yields results.

    The TPU-native evaluation fan-out: device inference calls serialize on
    the accelerator queue while host-side metrics compute concurrently.
    """
    with ThreadPoolExecutor(num_workers) as pool:
        futures = [pool.submit(fn, ex) for ex in dataset]
        if progress_bar:
            from tqdm import tqdm
            futures_iter = tqdm(futures)
        else:
            futures_iter = futures
        for future in futures_iter:
            yield future.result()


def gather(results, root=0, tag=None, timeout=3600.0):
    """Gather per-rank results onto the master.

    Single-process: returns ``[results]``.  Multi-process (launcher sets
    ``PT_EVAL_RANK``, ``PT_EVAL_SIZE`` and a shared ``PT_EVAL_DIR``):
    every rank writes its results as JSON (atomic tmp+rename), rank
    ``root`` polls until all shards exist and returns them as a list
    indexed by rank; other ranks return ``None``.  ``tag`` distinguishes
    multiple gathers within one run.
    """
    if SIZE == 1:
        return [results]
    gather_dir = os.environ.get('PT_EVAL_DIR')
    if not gather_dir:
        raise RuntimeError(
            'Multi-process gather (PT_EVAL_SIZE > 1) requires PT_EVAL_DIR '
            'to point at a directory shared by all ranks.')
    os.makedirs(gather_dir, exist_ok=True)
    # A rerun with the same PT_EVAL_DIR must not pick up a previous
    # run's shard files: set PT_EVAL_RUN_ID per launch (any string all
    # ranks share) to namespace them; the master also deletes its
    # shards after a successful merge.
    run_id = os.environ.get('PT_EVAL_RUN_ID', 'run')
    if tag is None:
        # auto-unique per call: two gathers sharing one tag RACE — a
        # fast worker's second shard can be consumed (and deleted) by
        # the master's FIRST gather (wrong results) while the second
        # gather then times out waiting for the deleted file.  All
        # ranks call gather the same number of times in the same order
        # (a collective), so a per-process counter agrees across ranks.
        n = getattr(gather, '_auto_tag', 0)
        gather._auto_tag = n + 1
        tag = f'auto{n}'
    name = f'gather_{run_id}_{tag}'
    shard = os.path.join(gather_dir, f'{name}.rank{RANK}.json')
    tmp = shard + f'.tmp{os.getpid()}'
    with open(tmp, 'w') as fh:
        json.dump(results, fh)
    os.rename(tmp, shard)
    if RANK != root:
        return None
    shards = [
        os.path.join(gather_dir, f'{name}.rank{r}.json')
        for r in range(SIZE)
    ]
    deadline = time.monotonic() + timeout
    missing = list(shards)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f'gather(tag={tag!r}): still waiting for {missing} '
                f'after {timeout}s')
        time.sleep(0.1)
    out = []
    for path in shards:
        # the writer's rename is atomic, so a present file is complete
        with open(path) as fh:
            out.append(json.load(fh))
    for path in shards:  # consumed: a rerun must not see them again
        try:
            os.remove(path)
        except OSError:
            pass
    return out


def gather_merged(results, root=0, tag='0', timeout=3600.0):
    """``gather`` + merge of the per-rank dicts into one dict (master only).

    Matches the reference's ``dlp_mpi.gather`` + ``nested_merge`` idiom
    (``tasnet/evaluate.py:235-256``).  Returns ``None`` on workers.
    """
    per_rank = gather(results, root=root, tag=tag, timeout=timeout)
    if per_rank is None:
        return None
    merged = {}
    for rank_results in per_rank:
        overlap = merged.keys() & rank_results.keys()
        assert not overlap, f'duplicate example ids across ranks: {overlap}'
        merged.update(rank_results)
    return merged


def bcast(obj, root=0):
    del root
    return obj
