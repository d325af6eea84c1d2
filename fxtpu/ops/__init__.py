"""fxtpu.ops — pure-JAX DSP ops (the reference's L3+L2 layers,
``/root/reference/effex/effex.py:497-627``, rebuilt in JAX)."""

from fxtpu.ops.window import get_window, firwin, pfb_window
from fxtpu.ops.pfb import (
    frame_blocks,
    pfb_fir,
    spectrometer_poly,
    spectrometer_poly_stream,
    zero_history,
)
from fxtpu.ops.xengine import (
    rf_freqs,
    fstc_rotate,
    xcorr_pair,
    xcorr_baselines,
    continuum_reduce,
    baseline_pairs,
)
from fxtpu.ops.delay import estimate_delay, estimate_delay_gaussian, xcorr_mag

__all__ = [
    "get_window", "firwin", "pfb_window",
    "frame_blocks", "pfb_fir", "spectrometer_poly", "spectrometer_poly_stream",
    "zero_history",
    "rf_freqs", "fstc_rotate", "xcorr_pair", "xcorr_baselines",
    "continuum_reduce", "baseline_pairs",
    "estimate_delay", "estimate_delay_gaussian", "xcorr_mag",
]
