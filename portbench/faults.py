"""Faults planted in the program under a run, for the limits' upper readings
(``prove.py``) and for the test that a broken timed path comes out not
correct.  Each is a context manager that patches the port and restores it.

* ``state_unchanged``: each stage worker's update returns its state as it
  was;
* ``half_batch``: each replica computes on half of its micro-batches (the
  second half repeats the first), the mean taken over those;
* ``exchange_left_out``: the replicas' scatter-reduce returns each worker's
  own gradient, unreduced (cells with more than one replica);
* ``answer_altered``: the loss that the last stage produces is 1% high;
* ``replica_dropped_step``: each stage's second replica leaves out its
  second update, its state a step behind its peers' from then on (cells
  with more than one replica).
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "exchange_left_out", "answer_altered",
          "replica_dropped_step")
#: the faults that only a cell with more than one replica can have
REPLICA_FAULTS = ("exchange_left_out", "replica_dropped_step")


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def plant(fault: str):
    from repro_torch.serverless.backends import local
    from repro_torch.serverless.runtime import engine, worker

    if fault == "state_unchanged":
        with _patched(worker.StageWorker, "apply_update", lambda self, reduced, step: None):
            yield
    elif fault == "half_batch":
        real = engine._split_batch

        def split(batch, r, d, m, mu):
            return real(batch, r, d, m % max(1, mu // 2), mu)

        with _patched(engine, "_split_batch", split):
            yield
    elif fault == "exchange_left_out":
        def own(store, r, d, size, vec, **kw):
            return vec

        with _patched(local, "local_scatter_reduce", own):
            yield
    elif fault == "answer_altered":
        real = worker.softmax_cross_entropy

        def altered(logits, labels):
            return real(logits, labels) * 1.01

        with _patched(worker, "softmax_cross_entropy", altered):
            yield
    elif fault == "replica_dropped_step":
        # a call builds its workers stage by stage, replica by replica: a
        # worker built right after one of the same stage is the next replica
        last = {"stage": None, "replica": -1}
        real_init, real_update = worker.StageWorker.__init__, worker.StageWorker.apply_update

        def init(self, *a, **kw):
            real_init(self, *a, **kw)
            stage = (self.span.inst_lo, self.span.inst_hi, self.span.owns_embed)
            same = stage == last["stage"]
            last.update(stage=stage, replica=last["replica"] + 1 if same else 0)
            self._replica, self._updates = last["replica"], 0

        def update(self, reduced, step):
            self._updates += 1
            if self._replica == 1 and self._updates == 2:
                self._grad_flat = None
                return None
            return real_update(self, reduced, step)

        with _patched(worker.StageWorker, "__init__", init), \
                _patched(worker.StageWorker, "apply_update", update):
            yield
    else:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
