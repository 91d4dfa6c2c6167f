"""Autocorrelations of Monte Carlo time series, on torch.

Counterpart of ``pyisingmontecarlo_tpu/engines/observables.py``: for each
scalar series x(t) (per experiment, per channel) the mean-subtracted
normalized autocorrelation

    rho(lag) = sum_t (x(t)-xbar)(x(t+lag)-xbar) / sum_t (x(t)-xbar)^2

averaged over channels, by an FFT over the Monte Carlo time axis. A constant
series has rho = 1 at every lag.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["autocorrelation_device", "pad_autocorr"]


def pad_autocorr(corr: np.ndarray, timesteps: int) -> np.ndarray:
    """Zero-fill ``[n, timesteps]`` and copy the ``t/freq``-long series into its
    leading columns (the output shape of the stateful classes)."""
    corr = np.asarray(corr, np.float64)
    timesteps = int(timesteps)
    if corr.shape[1] == timesteps:
        return corr
    out = np.zeros((corr.shape[0], timesteps), np.float64)
    out[:, : corr.shape[1]] = corr[:, :timesteps]
    return out


def autocorrelation_device(x: torch.Tensor) -> np.ndarray:
    """``x[R, T, C]`` series -> ``rho[R, T]`` (f64 numpy), averaged over the
    channels C. Computed in f32 on ``x``'s device; only ``rho`` crosses to the
    host. f32 FFTs of O(1) series agree with an f64 computation to ~1e-6."""
    R, T, C = x.shape
    if T == 0:
        return np.zeros((R, 0))
    x = x.to(torch.float32)
    xc = x - x.mean(dim=1, keepdim=True)
    n = 1 << (2 * T - 1).bit_length()  # zero-pad to avoid circular wrap
    f = torch.fft.rfft(xc, n=n, dim=1)
    acf = torch.fft.irfft(f * f.conj(), n=n, dim=1)[:, :T]
    var = acf[:, :1, :]
    const = var <= 1e-12
    rho = torch.where(const, 1.0, acf / torch.where(const, 1.0, var))
    return rho.mean(dim=2).cpu().numpy().astype(np.float64)
