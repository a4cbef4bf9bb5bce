"""Counters, gauges and histogram summaries for one serving engine.

Stands in for the `serving.*` metrics the JAX package keeps in its global
observability registry: here each engine owns one `Counters`, so two
engines (or two tests) never share numbers.  Histograms keep count, sum,
min and max, and the last `SAMPLES` values for quantiles (the
generation engine's TTFT and ITL p50 / p99).
"""
import collections
import threading

import numpy as np

__all__ = ['Counters']

SAMPLES = 65536


class Counters(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}
        self._hists = {}
        self._samples = {}

    def inc(self, name, n=1):
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def set(self, name, value):
        with self._lock:
            self._values[name] = value

    def observe(self, name, value):
        value = float(value)
        with self._lock:
            self._samples.setdefault(
                name, collections.deque(maxlen=SAMPLES)).append(value)
            h = self._hists.get(name)
            if h is None:
                self._hists[name] = {'count': 1, 'sum': value, 'min': value,
                                     'max': value}
            else:
                h['count'] += 1
                h['sum'] += value
                h['min'] = min(h['min'], value)
                h['max'] = max(h['max'], value)

    def get(self, name, default=0):
        with self._lock:
            return self._values.get(name, default)

    def histogram(self, name):
        """{'count', 'sum', 'min', 'max'} of the observed values, or None."""
        with self._lock:
            h = self._hists.get(name)
            return dict(h) if h is not None else None

    def quantile(self, name, q):
        """The q-quantile (0..1, linear interpolation) of the last `SAMPLES`
        observed values, or None before the first observation."""
        with self._lock:
            vals = list(self._samples.get(name, ()))
        return float(np.quantile(vals, q)) if vals else None
