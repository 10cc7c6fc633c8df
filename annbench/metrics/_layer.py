"""Helpers the per-layer metric readers share: a layer's device time per
step of the layers stretch, and the device's idle share over the device
stretch."""

from __future__ import annotations

import json
import os


def layer_ms(ctx, stem: str):
    """Device ms per traced step of the ops attributed to layer ``stem``;
    None when the run was not traced on a card or nothing ran there."""
    t = ctx.trace
    if t is None or t.n_steps == 0:
        return None
    us = t.layer_us(stem)
    return us / t.n_steps / 1e3 if us > 0 else None


def idle_pct(ctx):
    """Share of the device stretch's window in which no device operation
    ran."""
    t = ctx.device
    w = t.window() if t is not None else None
    if w is None or w[1] <= w[0]:
        return None
    return 100.0 * (1.0 - t.busy_us() / (w[1] - w[0]))


def load_peaks() -> dict:
    """The card's peaks the roofline shares are taken against."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        return json.load(f)
