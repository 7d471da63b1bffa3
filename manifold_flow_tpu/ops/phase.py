"""Analytic-signal phases and wrap-aware angle arithmetic, on device.

Replaces scipy.signal.hilbert + np.angle in the reference
(S2_interpolate_phases.py:58-68, S5_compute_wave_v.py:214-233) with an
FFT-based Hilbert transform (jnp.fft) and vectorized angle ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def hilbert(x: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Analytic signal via FFT (same construction as scipy.signal.hilbert).

    Note: the reference calls `hilbert(potentials)` on a (time, electrode)
    array without an axis argument (S2_interpolate_phases.py:66), i.e. scipy's
    default axis=-1 — the electrode axis. Pass axis=-1 to reproduce that
    behavior; the default here is the time axis (axis=0), the standard
    instantaneous-phase construction.
    """
    x = jnp.asarray(x)
    n = x.shape[axis]
    xf = jnp.fft.fft(x, axis=axis)
    h = jnp.zeros(n, dtype=xf.real.dtype)
    if n % 2 == 0:
        h = h.at[0].set(1.0).at[n // 2].set(1.0).at[1:n // 2].set(2.0)
    else:
        h = h.at[0].set(1.0).at[1:(n + 1) // 2].set(2.0)
    shape = [1] * x.ndim
    shape[axis] = n
    return jnp.fft.ifft(xf * h.reshape(shape), axis=axis)


@partial(jax.jit, static_argnames=("axis",))
def instantaneous_phase(potentials: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """np.angle(hilbert(x)) (compute_phase_from_potentials, S2_phases:58-68),
    as one jitted program with real inputs and outputs."""
    z = hilbert(potentials, axis=axis)
    return jnp.arctan2(z.imag, z.real)


def angle_subtract(f1: jnp.ndarray, f2: jnp.ndarray,
                   angle_flag: bool = True) -> jnp.ndarray:
    """Wrap-aware difference in [-pi, pi) (angle_subtract, S5:224-233)."""
    if angle_flag:
        return jnp.mod(f1 - f2 + jnp.pi, 2.0 * jnp.pi) - jnp.pi
    return f1 - f2


def temporal_gradient_phase(data: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Wrap-aware time derivative of a (T, ...) phase movie.

    Forward difference at the first frame, central differences inside,
    backward at the last (compute_temporal_gradient_phase, S5:60-77).
    """
    fwd = angle_subtract(data[1], data[0]) / dt
    bwd = angle_subtract(data[-1], data[-2]) / dt
    mid = angle_subtract(data[2:], data[:-2]) / (2.0 * dt)
    return jnp.concatenate([fwd[None], mid, bwd[None]], axis=0)


def temporal_gradient_amplitude(data: jnp.ndarray, dt: float) -> jnp.ndarray:
    """np.gradient(data, axis=0, edge_order=2) / dt (S5:24): second-order
    central differences with second-order one-sided stencils at the ends."""
    first = (-3.0 * data[0] + 4.0 * data[1] - data[2]) / 2.0
    last = (3.0 * data[-1] - 4.0 * data[-2] + data[-3]) / 2.0
    mid = (data[2:] - data[:-2]) / 2.0
    return jnp.concatenate([first[None], mid, last[None]], axis=0) / dt
