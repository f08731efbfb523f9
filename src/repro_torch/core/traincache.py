"""Content-addressed trained-candidate cache for the DSE engine
(counterpart of ``repro.core.traincache``, over the port's
``mlalgos.TrainedModel``; the same job gives the same key in both).

The Homunculus search races one ConstrainedBO per candidate algorithm and is
re-entered by every benchmark/example/re-run; without memoization the same
(algorithm, config, seed, dataset) quadruple is retrained over and over —
seed-config anchors alone are retrained once per racer.  The cache key is
*content-addressed*:

  * the dataset contributes a sha1 over its training split
    (``Dataset.fingerprint``), not an object id, so two loaders producing
    identical arrays share entries;
  * the config contributes only its *effective* form
    (``mlalgos.effective_config``) — the parameters that actually reach
    ``train`` — so e.g. two DNN configs differing in dead ``h_i`` slots
    (beyond ``n_layers``) hit the same entry.

Feasibility reports are NOT cached: they depend on the platform, which the
multi-model scheduler resplits per search (§5.1.3), so they are recomputed
from the cached topology instead.

The key deliberately does NOT include the evaluation mode: batched and
sequential training compute the same job (that equivalence is its own
tested contract), so either may serve the other's hits.  When *comparing*
the two modes, hand each run a private ``CandidateCache()`` — with the
shared default the second run would replay the first run's models and the
comparison would be vacuous.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading

from repro_torch.core import mlalgos
from repro_torch.data.netdata import Dataset


def candidate_key(algorithm: str, config: dict, seed: int,
                  data: Dataset, device: str | None = None) -> str:
    """Stable content hash of one training job.  ``device`` (the trainer's
    device type) joins the key when given: a model trained on the card
    and one trained on the CPU differ in their last bits, and each
    predicts on its own device.  Without it the key is the JAX
    package's."""
    eff = mlalgos.effective_config(algorithm, config, data)
    job = [algorithm, int(seed), data.fingerprint(),
           {k: repr(v) for k, v in sorted(eff.items())}]
    if device is not None:
        job.append(str(device))
    blob = json.dumps(job, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()


@dataclasses.dataclass
class CandidateCache:
    """In-process trained-model store with hit/miss accounting.

    LRU-bounded: ``max_entries`` caps how many TrainedModels (full weight
    arrays) stay resident, so a long-lived process racing many datasets /
    seeds does not grow without bound.  The default comfortably holds
    several full ``generate()`` searches.

    Thread-safe: an online-learning loop may retrain on a background
    worker while the foreground runs its own searches against
    ``GLOBAL_CACHE``, so every store access holds a lock.  The
    lock protects the LRU bookkeeping (get's move-to-front mutates), not
    just the dict ops.
    """

    _store: dict[str, mlalgos.TrainedModel] = dataclasses.field(
        default_factory=dict)
    max_entries: int = 1024
    hits: int = 0
    misses: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key: str) -> mlalgos.TrainedModel | None:
        with self._lock:
            hit = self._store.get(key)
            if hit is None:
                self.misses += 1
            else:
                self.hits += 1
                self._store[key] = self._store.pop(key)   # mark most-recent
            return hit

    def put(self, key: str, trained: mlalgos.TrainedModel) -> None:
        with self._lock:
            self._store.pop(key, None)
            self._store[key] = trained
            while len(self._store) > self.max_entries:  # evict least-recent
                self._store.pop(next(iter(self._store)))

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = self.misses = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._store), "hits": self.hits,
                    "misses": self.misses}


# process-wide default: racing BOs across algorithms, repeated generate()
# calls, and the benchmarks all share it unless handed a private cache
GLOBAL_CACHE = CandidateCache()
