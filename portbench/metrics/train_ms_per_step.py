"""train_ms_per_step: the window's length, ended by a device sync, over the
denoiser steps completed in it."""


def read(rec):
    return rec.window_s * 1e3 / rec.units if rec.unit == "step" and rec.units else None
