"""Seeded lock-discipline violations (exact lines asserted in tests)."""
import threading

import torch


class Online:
    def __init__(self, x: torch.Tensor):
        self._lock = threading.Lock()
        self.x = x  #: guarded by self._lock

    def capacity(self):
        return int(self.x.shape[0])  # LINE 13: lock-discipline (no lock)

    def _grow_locked(self, k):
        self.x = torch.cat([self.x, torch.zeros(k, self.x.shape[1])])

    def reserve(self, k):
        self._grow_locked(k)  # LINE 19: lock-discipline (_locked, no lock)

    def export(self):
        with self._lock:
            return self.x


class Handler:
    def __init__(self, online):
        self.online = online

    def stats(self):
        return {"rows": self.online.x.shape[0]}  # LINE 31: lock-discipline
