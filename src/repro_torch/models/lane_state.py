"""LaneState protocol: per-lane decode-state management (port of
``repro/models/lane_state.py``).

The serving engine admits, retires and preempts requests on a fixed set of
lanes through three operations on a nested dict of tensors, driven by a
*lane-axes tree* of the same structure whose leaves name the axis carrying
the lane dimension (``NO_LANE`` for global leaves such as the paged KV
pools, which lanes reach through their block-table rows).  The reference's
functions return new trees; here :func:`restore_lane` and
:func:`reset_lane` write into the state in place, which saves copying the
pools on every admission.
"""
from __future__ import annotations

from typing import Any

NO_LANE = -1


def _walk(state, axes, fn, *rest):
    if isinstance(state, dict):
        return {k: _walk(state[k], axes[k], fn, *(r[k] for r in rest)) for k in state}
    return fn(state, axes, *rest)


def extract_lane(state: Any, axes: Any, lane: int) -> Any:
    """Copy of lane ``lane``: every per-lane leaf narrowed to size 1 along
    its lane axis (``NO_LANE`` leaves become empty placeholders)."""

    def ex(t, ax):
        if ax == NO_LANE:
            return t.new_zeros((0,))
        return t.narrow(ax, lane, 1).clone()

    return _walk(state, axes, ex)


def restore_lane(state: Any, axes: Any, lane: int, snapshot: Any) -> Any:
    """Write a 1-lane ``snapshot`` into lane ``lane`` of ``state`` in place,
    leaving other lanes and ``NO_LANE`` leaves untouched; returns ``state``."""

    def re(t, ax, s):
        if ax != NO_LANE:
            t.narrow(ax, lane, 1).copy_(s)
        return t

    _walk(state, axes, re, snapshot)
    return state


def reset_lane(state: Any, axes: Any, lane: int, init_snapshot: Any) -> Any:
    """Return lane ``lane`` to its initial value (``init_snapshot`` is the
    lane-0 extract of a freshly initialized 1-lane state)."""
    return restore_lane(state, axes, lane, init_snapshot)
