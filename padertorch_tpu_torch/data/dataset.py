"""Lazy dataset pipelines — native replacement for ``lazy_dataset``.

Copy of ``padertorch_tpu/data/dataset.py``.

The reference framework builds its input pipelines on the external
``lazy_dataset`` package (map/filter/shuffle/batch/prefetch over example
dicts).  This module provides the subset the framework and its recipes use,
implemented fresh:

- ``from_list`` / ``from_dict`` / ``new``
- ``map``, ``filter``, ``catch``, ``shuffle`` (reshuffle per epoch),
  ``sort``, ``batch``, ``batch_dynamic_time_series_bucket``, ``prefetch``
  (thread pool with ordered buffer), ``tile``/``cycle``, slicing/indexing
  by position or key.
- ``FilterException``: raising it inside a mapped function drops the
  example (used by e.g. the ``Segmenter`` for too-short utterances).

TPU relevance: ``prefetch`` + ``map`` run feature extraction on host
threads while the device trains (the framework's async input pipeline);
length-aware batching bounds the set of padded shapes XLA must compile.
"""
import bisect
import random as _random
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = [
    'Dataset',
    'FilterException',
    'from_list',
    'from_dict',
    'new',
]


class FilterException(Exception):
    """Raise inside a mapped function to drop the current example."""


def new(examples, immutable_warranty='pickle'):
    """Create a Dataset from a list or dict of examples."""
    if isinstance(examples, dict):
        return from_dict(examples, immutable_warranty=immutable_warranty)
    return from_list(list(examples), immutable_warranty=immutable_warranty)


def from_list(examples, immutable_warranty='pickle'):
    return ListDataset(list(examples), immutable_warranty)


def from_dict(examples, immutable_warranty='pickle'):
    return DictDataset(dict(examples), immutable_warranty)


def _copier(immutable_warranty):
    """lazy_dataset's immutable warranty: each access hands out a copy so
    in-place-mutating map transforms cannot corrupt the source examples."""
    if immutable_warranty in (None, False):
        return lambda x: x
    if immutable_warranty == 'pickle':
        import pickle

        def copy_pickle(x):
            try:
                return pickle.loads(pickle.dumps(x))
            except Exception:
                import copy
                return copy.deepcopy(x)
        return copy_pickle
    import copy
    return copy.deepcopy


class Dataset:
    """Base class: lazy, re-iterable, composable."""

    # -- core protocol -------------------------------------------------------
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise TypeError(
            f'object of type {type(self).__name__} has no len()')

    def keys(self):
        raise NotImplementedError(
            f'{type(self).__name__} does not support keys().')

    @property
    def indexable(self):
        return False

    def __getitem__(self, item):
        if isinstance(item, slice):
            return SliceDataset(self, item)
        if isinstance(item, (list, tuple, np.ndarray)):
            return ChoiceDataset(self, list(item))
        raise NotImplementedError(
            f'{type(self).__name__} does not support indexing.')

    # -- transformations ------------------------------------------------------
    def map(self, map_fn):
        return MapDataset(self, map_fn)

    def filter(self, filter_fn, lazy=True):
        if lazy:
            return FilterDataset(self, filter_fn)
        return from_list([ex for ex in self if filter_fn(ex)])

    def catch(self, exceptions=FilterException):
        return CatchDataset(self, exceptions)

    def shuffle(self, reshuffle=True, rng=None, buffer_size=None):
        if buffer_size is not None:
            return LocalShuffleDataset(self, buffer_size, rng)
        return ShuffleDataset(self, reshuffle=reshuffle, rng=rng)

    def sort(self, key_fn=None, sort_fn=sorted):
        examples = list(self)
        return from_list(sort_fn(examples, key=key_fn))

    def batch(self, batch_size, drop_last=False):
        return BatchDataset(self, batch_size, drop_last)

    def batch_dynamic_time_series_bucket(
            self, batch_size, len_key, max_padding_rate,
            max_total_size=None, expiration=None, drop_incomplete=False,
            sort_key=None, reverse_sort=False):
        """Bucket examples of similar length into batches.

        Simplified port of lazy_dataset's dynamic time series bucketing
        (used by the reference wavenet recipe, ``wavenet/data.py:52``):
        an example joins a bucket if its length is within
        ``max_padding_rate`` of the bucket's min/max length; full buckets
        are emitted as batches.
        """
        if callable(len_key):
            get_len = len_key
        else:
            def get_len(ex):
                return ex[len_key]
        return DynamicBucketDataset(
            self, batch_size=batch_size, get_len=get_len,
            max_padding_rate=max_padding_rate,
            max_total_size=max_total_size,
            expiration=expiration, drop_incomplete=drop_incomplete,
            sort_key=sort_key, reverse_sort=reverse_sort,
        )

    def unbatch(self):
        """Flatten examples that are lists (inverse of batch; used after
        segmenters that return several chunks per utterance)."""
        return UnbatchDataset(self)

    def prefetch(self, num_workers=2, buffer_size=4, catch_filter_exception=False):
        return PrefetchDataset(
            self, num_workers, buffer_size, catch_filter_exception)

    def tile(self, reps, shuffle=False):
        ds = self
        parts = [ds] * reps
        out = ConcatDataset(parts)
        if shuffle:
            out = out.shuffle()
        return out

    def cycle(self):
        return CycleDataset(self)

    def random_choice(self, size=None, replace=False, rng_state=None):
        rng = rng_state or np.random
        n = len(self)
        idx = rng.choice(n, size=size, replace=replace)
        if size is None:
            return self[int(idx)] if not isinstance(
                self, DictDataset) else list(self)[int(idx)]
        return ChoiceDataset(self, [int(i) for i in idx])

    def __add__(self, other):
        return ConcatDataset([self, other])

    def apply(self, fn):
        """fn(dataset) -> dataset; for pipeline composition."""
        return fn(self)

    def __repr__(self):
        try:
            return f'{type(self).__name__}(len={len(self)})'
        except TypeError:
            return f'{type(self).__name__}()'


class ListDataset(Dataset):
    def __init__(self, examples, immutable_warranty='pickle'):
        self.examples = examples
        self._copy = _copier(immutable_warranty)

    def __iter__(self):
        for ex in self.examples:
            yield self._copy(ex)

    def __len__(self):
        return len(self.examples)

    @property
    def indexable(self):
        return True

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self._copy(self.examples[item])
        return super().__getitem__(item)


class DictDataset(Dataset):
    def __init__(self, examples, immutable_warranty='pickle'):
        self.examples = examples
        self._keys = list(examples.keys())
        self._copy = _copier(immutable_warranty)

    def keys(self):
        return list(self._keys)

    def __iter__(self):
        for k in self._keys:
            yield self._copy(self.examples[k])

    def __len__(self):
        return len(self._keys)

    @property
    def indexable(self):
        return True

    def __getitem__(self, item):
        if isinstance(item, str):
            return self._copy(self.examples[item])
        if isinstance(item, (int, np.integer)):
            return self._copy(self.examples[self._keys[item]])
        return super().__getitem__(item)


class _Wrapper(Dataset):
    def __init__(self, source):
        self.source = source

    def __len__(self):
        return len(self.source)

    def keys(self):
        return self.source.keys()

    @property
    def indexable(self):
        return self.source.indexable


class MapDataset(_Wrapper):
    def __init__(self, source, map_fn):
        super().__init__(source)
        self.map_fn = map_fn

    def __iter__(self):
        for ex in self.source:
            yield self.map_fn(ex)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer, str)):
            return self.map_fn(self.source[item])
        return super(_Wrapper, self).__getitem__(item)


class FilterDataset(_Wrapper):
    def keys(self):
        raise TypeError(
            'FilterDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __init__(self, source, filter_fn):
        super().__init__(source)
        self.filter_fn = filter_fn

    def __len__(self):
        raise TypeError(
            'FilterDataset has no len(); use filter(..., lazy=False) if '
            'the length must be known.')

    @property
    def indexable(self):
        return False

    def __iter__(self):
        for ex in self.source:
            if self.filter_fn(ex):
                yield ex


class CatchDataset(_Wrapper):
    def keys(self):
        raise TypeError(
            'CatchDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __init__(self, source, exceptions):
        super().__init__(source)
        self.exceptions = exceptions

    def __len__(self):
        raise TypeError('CatchDataset has no len().')

    @property
    def indexable(self):
        return False

    def __iter__(self):
        # Unwrap the WHOLE chain of maps and run each example's full
        # map stack inside one try: a generator that raised is closed
        # and cannot resume, so catching around a chained-map
        # iterator's next() would silently truncate at the first drop
        # instead of dropping one example.
        fns = []
        base = self.source
        while isinstance(base, MapDataset):
            fns.append(base.map_fn)
            base = base.source
        fns.reverse()

        def apply(ex):
            for fn in fns:
                ex = fn(ex)
            return ex

        if base.indexable:
            for i in range(len(base)):
                try:
                    yield apply(base[i])
                except self.exceptions:
                    continue
        else:
            it = iter(base)
            while True:
                try:
                    ex = next(it)
                except StopIteration:
                    return
                except self.exceptions:
                    # the BASE itself raised from inside its generator
                    # frame — it is closed now; nothing more can be
                    # drawn (raising FilterException belongs in map
                    # fns, which the branch above makes resumable)
                    return
                try:
                    yield apply(ex)
                except self.exceptions:
                    continue


class ShuffleDataset(_Wrapper):
    def __init__(self, source, reshuffle=True, rng=None):
        super().__init__(source)
        self.reshuffle = reshuffle
        self.rng = rng or _random.Random(0)
        self._fixed_permutation = None
        if not reshuffle:
            idx = list(range(len(source)))
            self.rng.shuffle(idx)
            self._fixed_permutation = idx

    def keys(self):
        if self._fixed_permutation is not None:
            src = self.source.keys()
            return [src[i] for i in self._fixed_permutation]
        raise TypeError(
            'ShuffleDataset(reshuffle=True) has no stable key order; '
            'call keys() on the source instead')

    def __iter__(self):
        if self._fixed_permutation is not None:
            idx = self._fixed_permutation
        else:
            idx = list(range(len(self.source)))
            self.rng.shuffle(idx)
        for i in idx:
            yield self.source[i]

    @property
    def indexable(self):
        return self._fixed_permutation is not None

    def __getitem__(self, item):
        if self._fixed_permutation is not None and isinstance(
                item, (int, np.integer)):
            return self.source[self._fixed_permutation[item]]
        return super(_Wrapper, self).__getitem__(item)


class LocalShuffleDataset(_Wrapper):
    """Streaming shuffle with a bounded reservoir buffer."""

    def keys(self):
        raise TypeError(
            'LocalShuffleDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __init__(self, source, buffer_size, rng=None):
        super().__init__(source)
        self.buffer_size = buffer_size
        self.rng = rng or _random.Random(0)

    @property
    def indexable(self):
        return False

    def __iter__(self):
        buffer = []
        for ex in self.source:
            buffer.append(ex)
            if len(buffer) >= self.buffer_size:
                idx = self.rng.randrange(len(buffer))
                buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                yield buffer.pop()
        self.rng.shuffle(buffer)
        yield from buffer


class SliceDataset(_Wrapper):
    def __init__(self, source, sl):
        super().__init__(source)
        self.indices = list(range(len(source)))[sl]

    def __len__(self):
        return len(self.indices)

    def keys(self):
        # the inherited keys() would return the FULL source key list,
        # silently misaligned with this subset's iteration order
        src = self.source.keys()
        return [src[i] for i in self.indices]

    def __iter__(self):
        for i in self.indices:
            yield self.source[i]

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.source[self.indices[item]]
        return super(_Wrapper, self).__getitem__(item)


class ChoiceDataset(SliceDataset):
    def __init__(self, source, indices):
        _Wrapper.__init__(self, source)
        self.indices = list(indices)


class ConcatDataset(Dataset):
    def __init__(self, parts):
        self.parts = list(parts)
        self._cum = None

    def __iter__(self):
        for p in self.parts:
            yield from p

    def __len__(self):
        return sum(len(p) for p in self.parts)

    @property
    def indexable(self):
        return all(p.indexable for p in self.parts)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            if self._cum is None:
                sizes = [len(p) for p in self.parts]
                self._cum = np.cumsum([0] + sizes).tolist()
            if item < 0:
                item += self._cum[-1]
            part = bisect.bisect_right(self._cum, item) - 1
            return self.parts[part][item - self._cum[part]]
        return super().__getitem__(item)


class CycleDataset(_Wrapper):
    def keys(self):
        raise TypeError(
            'CycleDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __len__(self):
        raise TypeError('CycleDataset has no len().')

    @property
    def indexable(self):
        return False

    def __iter__(self):
        while True:
            yield from self.source


class UnbatchDataset(_Wrapper):
    def keys(self):
        raise TypeError(
            'UnbatchDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __len__(self):
        raise TypeError('UnbatchDataset has no len().')

    @property
    def indexable(self):
        return False

    def __iter__(self):
        for batch in self.source:
            yield from batch


class BatchDataset(_Wrapper):
    def keys(self):
        raise TypeError(
            'BatchDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __init__(self, source, batch_size, drop_last=False):
        super().__init__(source)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def indexable(self):
        return False

    def __iter__(self):
        batch = []
        for ex in self.source:
            batch.append(ex)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


class DynamicBucketDataset(_Wrapper):
    """Length-bucketed batching; see Dataset.batch_dynamic_time_series_bucket."""

    def keys(self):
        raise TypeError(
            'DynamicBucketDataset restructures its source; keys() would not '
            'correspond to iteration order — call keys() on the '
            'source instead')

    def __init__(self, source, batch_size, get_len, max_padding_rate,
                 max_total_size=None, expiration=None,
                 drop_incomplete=False, sort_key=None,
                 reverse_sort=False):
        super().__init__(source)
        self.batch_size = batch_size
        self.get_len = get_len
        self.max_padding_rate = max_padding_rate
        # cap on the PADDED batch size (max_len x n_examples): a bucket
        # refuses examples that would push it past the cap and emits as
        # soon as it can no longer grow within it
        self.max_total_size = max_total_size
        self.expiration = expiration
        self.drop_incomplete = drop_incomplete
        self.sort_key = sort_key
        self.reverse_sort = reverse_sort

    def __len__(self):
        raise TypeError('DynamicBucketDataset has no len().')

    @property
    def indexable(self):
        return False

    def _sorted(self, batch):
        if self.sort_key is not None:
            key = self.sort_key if callable(self.sort_key) \
                else (lambda ex: ex[self.sort_key])
            return sorted(batch, key=key, reverse=self.reverse_sort)
        return batch

    def __iter__(self):
        buckets = []  # list of (min_len, max_len, [examples], age)
        count = 0
        for ex in self.source:
            length = self.get_len(ex)
            placed = False
            for bucket in buckets:
                lo, hi, examples, _ = bucket
                new_lo = min(lo, length)
                new_hi = max(hi, length)
                fits_size = (
                    self.max_total_size is None
                    or new_hi * (len(examples) + 1)
                    <= self.max_total_size)
                if new_lo >= new_hi * (1 - self.max_padding_rate) \
                        and fits_size:
                    examples.append(ex)
                    bucket[0], bucket[1] = new_lo, new_hi
                    full = len(examples) == self.batch_size or (
                        self.max_total_size is not None
                        and new_hi * (len(examples) + 1)
                        > self.max_total_size)
                    if full:
                        yield self._sorted(examples)
                        buckets.remove(bucket)
                    placed = True
                    break
            if not placed:
                buckets.append([length, length, [ex], count])
            count += 1
            if self.expiration is not None:
                for bucket in list(buckets):
                    if count - bucket[3] > self.expiration:
                        if not self.drop_incomplete:
                            yield self._sorted(bucket[2])
                        buckets.remove(bucket)
        for bucket in buckets:
            if not self.drop_incomplete:
                yield self._sorted(bucket[2])


class PrefetchDataset(_Wrapper):
    """Thread-pool prefetch preserving order (like lazy_dataset.prefetch).

    Workers pull from the source iterator and evaluate lazily-mapped
    examples ahead of the consumer; a bounded buffer provides backpressure.
    """

    def __init__(self, source, num_workers, buffer_size,
                 catch_filter_exception=False):
        super().__init__(source)
        assert num_workers >= 1, num_workers
        assert buffer_size >= num_workers, (buffer_size, num_workers)
        self.num_workers = num_workers
        self.buffer_size = buffer_size
        self.catch_filter_exception = catch_filter_exception

    @property
    def indexable(self):
        return False

    def __iter__(self):
        source = self.source
        if source.indexable:
            # Index-parallel: workers evaluate source[i] concurrently.
            def fetch(i):
                try:
                    return True, source[i]
                except FilterException as e:
                    if self.catch_filter_exception:
                        return False, None
                    raise e

            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = []
                n = len(source)
                upcoming = iter(range(n))
                for i in upcoming:
                    futures.append(pool.submit(fetch, i))
                    if len(futures) >= self.buffer_size:
                        break
                consumed = 0
                while futures:
                    ok, value = futures.pop(0).result()
                    consumed += 1
                    for i in upcoming:
                        futures.append(pool.submit(fetch, i))
                        break
                    if ok:
                        yield value
        else:
            # Sequential source: single reader thread fills a queue.
            import queue
            import threading
            q = queue.Queue(maxsize=self.buffer_size)
            DONE = object()
            stop = threading.Event()

            def put(item):
                # bounded put that gives up when the consumer left —
                # a plain q.put would block forever if the iterator is
                # abandoned mid-epoch (early stop), leaking the thread
                # and its buffered examples
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def reader():
                # honor catch_filter_exception like the indexable path:
                # delegate the per-example dropping to CatchDataset —
                # catching around next() of a raw generator would NOT
                # work (a generator that raised is closed; iteration
                # would silently truncate at the first drop)
                src = source
                if self.catch_filter_exception:
                    src = CatchDataset(source, FilterException)
                it = iter(src)
                try:
                    while not stop.is_set():
                        try:
                            ex = next(it)
                        except StopIteration:
                            break
                        if not put(('ok', ex)):
                            return
                except BaseException as e:  # propagate to consumer
                    put(('error', e))
                finally:
                    put((DONE, None))

            t = threading.Thread(target=reader, daemon=True)
            t.start()
            try:
                while True:
                    kind, value = q.get()
                    if kind is DONE:
                        break
                    if kind == 'error':
                        raise value
                    yield value
            finally:
                stop.set()
                # unblock a reader stuck in a full-queue put
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
