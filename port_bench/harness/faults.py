"""Faults planted in the timed path, to show that the check sees them.

Each fault takes the resident step and the model and returns the step
the run drives.  They are for the benchmark's tests and its readings
(readings.py), never for a measured run.
"""

from __future__ import annotations

import dataclasses

import torch


def state_unchanged(step, model):
    """A step that returns its state unchanged: every parameter, buffer
    and optimizer tensor is put back after the step runs."""
    def run(state, feed, offset, generator, steps=None):
        opt = state.optimizer
        keep = [t for t in list(model.parameters()) + list(model.buffers())]
        keep += list(getattr(opt, "moments", {}).values())
        dense = getattr(opt, "dense_opt", opt)
        keep += [v for st in dense.state.values() for v in st.values()
                 if torch.is_tensor(v)]
        saved = [t.detach().clone() for t in keep]
        out = step(state, feed, offset, generator, steps)
        with torch.no_grad():
            for t, s in zip(keep, saved):
                t.copy_(s)
        return out
    return run


def half_batch(step, model):
    """Half of each batch left out, the mean taken over the rest: the
    second half of the rows the feed gathers is marked not valid."""
    def run(state, feed, offset, generator, steps=None):
        if not getattr(feed, "_halved", False):
            gather = feed.batch

            def halved(batch_size):
                b = gather(batch_size)
                v = b.valid.clone()
                v[v.shape[0] // 2:] = 0.0
                return dataclasses.replace(b, valid=v)
            feed.batch = halved
            feed._halved = True
        return step(state, feed, offset, generator, steps)
    return run


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
