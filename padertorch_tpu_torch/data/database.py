"""JSON database access (the ``lazy_dataset.database`` replacement).

Counterpart of ``padertorch_tpu/data/database.py``.  The recipes read
databases described by JSON files of the form::

    {"datasets": {"train": {"example_id1": {...}, ...}, "test": {...}}}

``JsonDatabase`` exposes them as lazy datasets with ``example_id``
injected.

>>> db = DictDatabase({'datasets': {'a': {'x': {'v': 1}}, 'b': {'y': {}}}})
>>> db.dataset_names
('a', 'b')
>>> [ex['example_id'] for ex in db.get_dataset(['a', 'b'])]
['x', 'y']
"""
import json
from pathlib import Path

from padertorch_tpu_torch.data import dataset as lazy

__all__ = ['JsonDatabase', 'DictDatabase']


class DictDatabase:
    def __init__(self, database_dict):
        self.database_dict = database_dict

    @property
    def dataset_names(self):
        return tuple(self.database_dict['datasets'].keys())

    def get_dataset(self, name):
        if isinstance(name, (list, tuple)):
            parts = [self.get_dataset(n) for n in name]
            ds = parts[0]
            for p in parts[1:]:
                ds = ds + p
            return ds
        examples = self.database_dict['datasets'][name]
        examples = {
            key: {'example_id': key, **value}
            for key, value in examples.items()
        }
        return lazy.from_dict(examples)


class JsonDatabase(DictDatabase):
    def __init__(self, json_path):
        self.json_path = Path(json_path)
        super().__init__(json.loads(self.json_path.read_text()))
