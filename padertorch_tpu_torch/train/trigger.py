"""Triggers decide when hooks fire. Reference parity: ``padertorch/train/trigger.py``.

Units are 'epoch' or 'iteration'; ``set_last`` keeps resume semantics
correct (a trigger does not re-fire for an index it has already seen).
"""
import copy

__all__ = [
    'Trigger',
    'IntervalTrigger',
    'EndTrigger',
    'NotTrigger',
    'AnyTrigger',
    'AllTrigger',
]


class Trigger:
    pass


class IntervalTrigger(Trigger):
    """Fires every ``period`` epochs/iterations (at multiples of period).

    Reference parity: ``train/trigger.py:8``.

    >>> trigger = IntervalTrigger(2, 'epoch')
    >>> [trigger(i, i // 3) for i in range(10)]
    [True, False, False, False, False, False, True, False, False, False]
    >>> trigger = IntervalTrigger(2, 'iteration')
    >>> [trigger(i, i // 3) for i in range(10)]
    [True, False, True, False, True, False, True, False, True, False]
    >>> trigger = IntervalTrigger(2, 'iteration')
    >>> trigger.set_last(4, None)
    >>> [trigger(i, i // 3) for i in range(4, 10)]
    [False, False, True, False, True, False]
    """

    @classmethod
    def new(cls, trigger):
        if isinstance(trigger, Trigger):
            return copy.deepcopy(trigger)
        period, unit = trigger
        return cls(period, unit)

    def __init__(self, period, unit):
        assert isinstance(period, int), (type(period), period)
        assert unit in ('epoch', 'iteration'), unit
        self.period = period
        self.unit = unit
        self.last = (-1, -1)

    def __repr__(self):
        return f'{type(self).__name__}({self.period}, {self.unit})'

    def __call__(self, iteration, epoch):
        if self.unit == 'epoch':
            index, last = epoch, self.last[1]
        else:
            index, last = iteration, self.last[0]
        if last == index:
            # Already queried for this index: never re-fire (resume safety).
            return False
        self.set_last(iteration, epoch)
        return index % self.period == 0

    def set_last(self, iteration, epoch):
        self.last = (iteration, epoch)


class EndTrigger(IntervalTrigger):
    """Fires from ``period`` onwards (stop criterion).

    >>> trigger = EndTrigger(2, 'epoch')
    >>> [trigger(i, i // 3) for i in range(10)]
    [False, False, False, False, False, False, True, True, True, True]
    >>> trigger = EndTrigger(5, 'iteration')
    >>> [trigger(i, i // 3) for i in range(10)]
    [False, False, False, False, False, True, True, True, True, True]
    """

    def __call__(self, iteration, epoch):
        if self.unit == 'epoch':
            return epoch >= self.period
        return iteration >= self.period


class NotTrigger(Trigger):
    """Inverts a trigger.

    >>> trigger = NotTrigger(EndTrigger(2, 'epoch'))
    >>> [trigger(i, i // 3) for i in range(9)]
    [True, True, True, True, True, True, False, False, False]
    """

    def __init__(self, trigger):
        self.trigger = IntervalTrigger.new(trigger)

    def __repr__(self):
        return f'{type(self).__name__}({self.trigger})'

    def __call__(self, iteration, epoch):
        return not self.trigger(iteration, epoch)

    def set_last(self, iteration, epoch):
        self.trigger.set_last(iteration=iteration, epoch=epoch)


class AnyTrigger(Trigger):
    """Fires when any of the sub-triggers fires.

    All sub-triggers are always evaluated (a short-circuit would corrupt
    their ``last`` bookkeeping).
    """

    def __init__(self, *triggers):
        self.triggers = tuple(IntervalTrigger.new(t) for t in triggers)

    def __repr__(self):
        inner = ', '.join(repr(t) for t in self.triggers)
        return f'{type(self).__name__}({inner})'

    def __call__(self, iteration, epoch):
        return any([t(iteration, epoch) for t in self.triggers])

    def set_last(self, iteration, epoch):
        for t in self.triggers:
            t.set_last(iteration=iteration, epoch=epoch)


class AllTrigger(AnyTrigger):
    """Fires when all of the sub-triggers fire."""

    def __call__(self, iteration, epoch):
        return all([t(iteration, epoch) for t in self.triggers])
