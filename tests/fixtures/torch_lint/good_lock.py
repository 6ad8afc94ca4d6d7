"""Lock-clean twin of bad_lock.py: guarded state behind its lock."""
import threading

import torch


class Online:
    def __init__(self, x: torch.Tensor):
        self._lock = threading.Lock()
        self.x = x  #: guarded by self._lock

    def capacity(self):
        with self._lock:
            return self._capacity_locked()

    def _capacity_locked(self):
        return int(self.x.shape[0])

    def _grow_locked(self, k):
        self.x = torch.cat([self.x, torch.zeros(k, self.x.shape[1])])

    def reserve(self, k):
        with self._lock:
            self._grow_locked(k)

    def export(self):
        with self._lock:
            return self.x


class Handler:
    def __init__(self, online):
        self.online = online

    def stats(self):
        return {"rows": self.online.capacity()}  # locked accessor
