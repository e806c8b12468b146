"""Potential protocol: the pair-interaction interface.

Counterpart of ``mdtpu/potentials/base.py``. A potential is a small frozen
dataclass with

    potential.evaluate(r, sigma_i, sigma_j)     -> (u, f)        f = -dV/dr
    potential.evaluate_r2(r2, sigma_i, sigma_j) -> (u, f_over_r)
    potential.force_r2(r2, sigma_i, sigma_j)    -> f_over_r

on tensors of any shape (scalars may be Python floats). The pair force
vector is ``f_over_r * dr`` and the pair virial ``f_over_r * r2``.

CUTOFF CONTRACT: a potential returns exact zeros ``(0, 0)`` for every pair
beyond its own cutoff, for arbitrarily large ``r``. Engines validate at
creation that their cutoff covers :meth:`Potential.max_cutoff`
(:func:`check_engine_cutoff`).

WHAT RUNS ON THE CARD. The built-in potentials (LennardJones, PseudoHS,
LennardJonesXPLOR and the packer's OverlapPotential) have functors in the
CUDA pair sweeps (``csrc/pair_potentials.cuh``) that mirror their
``evaluate_r2`` expression for expression. Any other potential, a user's
subclass of :class:`Potential` included (the choice is by type: a subclass of
a built-in is a user potential too), runs on the cell grid's pair-list
route (:mod:`mdtpu_torch.ops.cell_pairs`): a CUDA kernel lists every pair
within the engine cutoff with its r^2 and the two diameters, the
potential's own ``evaluate_r2`` (``force_r2`` on steps whose energy nobody
reads) runs in torch on that flat list, and a CUDA kernel sums the forces,
energy and virial in a fixed order. So a user potential needs only torch
operations that broadcast over 1-D tensors of r^2, sigma_i and sigma_j, in
their dtype and on their device; it must keep the cutoff contract above
(exact zeros beyond its range, including on padding entries at r^2 = the
engine cutoff squared) and must not read values back to the host.

CAPTURE CONTRACT. On the card a potential runs inside a CUDA graph, as the
JAX package traces a user's ``evaluate`` into its jitted loops: a segment
of steps and a whole FIRE minimization are each one graph launch, and the
potential's torch operations are recorded once, at the capture, and
replayed at every step (the pair list, the naive engine's tiles, the
neighbour list's tiles). So a potential on the card may use only torch
operations on the tensors it is given, with Python numbers for its
parameters; it must not read a value back to the host (``.item()``,
``float(t)``, ``bool(t)``, ``.tolist()``, ``.cpu()``), make a tensor from
host data per call (``torch.tensor(...)``, ``torch.as_tensor(...)``), call
an operation whose output size depends on the values (``nonzero``, boolean
indexing, ``unique``), or branch in Python on a tensor's value. A potential
whose ``evaluate`` did one of these ran before its routes were captured and
now raises :class:`CaptureContractError`, as a traced ``if`` on a value
raises in the JAX package. Before each capture the engines run the
potential once with torch's synchronisation check set to refuse
(:func:`potential_values`), then once more captured alone into a graph
that is dropped, which catches what that check cannot see (a device-wide
synchronisation); a failure inside a capture raises the same error.
``tests/test_torch_capture_contract.py`` checks potentials against the
contract on the CPU (a ``TorchDispatchMode`` refusing those operators).
``graph=False`` on ``make_slot_advance``, ``make_particle_advance`` or
``fire_minimize`` runs the eager route, which keeps no such rule.

Scalar parameters are rounded to the working dtype before use
(:func:`rounded`), as the JAX package casts them with ``jnp.asarray(x,
dtype)``; they then enter tensor arithmetic as Python scalars, which PyTorch
applies in the tensor's dtype without a host-to-device copy.
"""

from __future__ import annotations

import contextlib
import gc
import math

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.bfloat16: np.float32}


def rounded(x, dtype) -> float:
    """A Python float holding ``x`` rounded to ``dtype``."""
    return float(_NP_DTYPES[dtype](x))


class Potential:
    """Base class for pair potentials (subclasses are frozen dataclasses
    implementing ``evaluate``)."""

    def evaluate(self, r, sigma_i=1.0, sigma_j=1.0):
        raise NotImplementedError(
            f"evaluate not implemented for potential type: {type(self).__name__}")

    def evaluate_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Squared-distance form ``(u, f_over_r)``; the default goes through
        ``evaluate`` with one sqrt."""
        r = torch.sqrt(r2)
        u, f = self.evaluate(r, sigma_i, sigma_j)
        return u, f / torch.where(r > 0, r, torch.ones_like(r))

    def force_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Force-only squared-distance form: ``f_over_r`` alone."""
        return self.evaluate_r2(r2, sigma_i, sigma_j)[1]

    def max_cutoff(self, max_sigma=1.0):
        """Largest pair distance at which the potential is nonzero, given the
        largest particle diameter; None when unknown."""
        return None

    # Long-range (tail) corrections: total energy and pressure correction.
    def energy_lrc(self, n_particles, volume):
        return 0.0

    def pressure_lrc(self, n_particles, volume):
        return 0.0


class CaptureContractError(RuntimeError):
    """A potential broke the capture contract (see the module docstring)
    where the card runs it inside a CUDA graph."""


_checking = False


@contextlib.contextmanager
def checking_contract():
    """Within: :func:`potential_values` checks each potential it runs on
    the card against the capture contract (the warm-up before a
    capture)."""
    global _checking
    saved, _checking = _checking, True
    try:
        yield
    finally:
        _checking = saved


def contract_message(potential, method, what):
    """The message of a :class:`CaptureContractError`."""
    return (f"{type(potential).__name__}.{method} broke the capture "
            f"contract ({what}): on the card a potential runs inside a "
            f"CUDA graph, so it may use only torch operations on the "
            f"tensors it is given, read no value back to the host, make no "
            f"tensor from host data and branch in Python on no tensor's "
            f"value (mdtpu_torch/potentials/base.py). graph=False on "
            f"make_slot_advance, make_particle_advance or fire_minimize "
            f"runs the eager route")


def _without_syncs(potential, method, fn, *args):
    """``fn(*args)`` on the card with torch's synchronisation check set to
    refuse (``torch.cuda.set_sync_debug_mode("error")``): a read back to the
    host, a copy of host data to the card, ``nonzero``, a boolean mask or
    ``unique`` raises :class:`CaptureContractError` before any capture,
    with the process unharmed. (A ``TorchDispatchMode`` refusing these
    operators by name, as ``tests/test_torch_capture_contract.py`` checks
    potentials on the CPU, took ~14 s to import torch's tracing stack at
    its first use on the card.)"""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        raise CaptureContractError(contract_message(
            potential, method, f"{type(exc).__name__}: {exc}")) from exc
    finally:
        torch.cuda.set_sync_debug_mode(saved)


def _trial_capture(potential, method, fn, *args):
    """``fn(*args)`` captured alone into a CUDA graph that is then dropped:
    what :func:`_without_syncs` cannot see (a device-wide synchronisation,
    another call the runtime refuses while a stream captures) fails here,
    in a plain graph, and not inside a loop's conditional bodies, where
    ending the failed capture crashed the process (measured on the card,
    torch 2.11). A failure raises :class:`CaptureContractError`; the
    process may not capture again after it (a later garbage collection
    aborted it on the card)."""
    stream = torch.cuda.current_stream(args[0].device)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn(*args)
    except Exception as exc:
        abandon_capture(graph, stream)
        raise CaptureContractError(contract_message(
            potential, method, f"{type(exc).__name__}: {exc}")) from exc
    finally:
        if collecting:
            gc.enable()


def abandon_capture(graph, stream):
    """After a CUDA-graph capture that raised: ``stream`` current again (the
    capture's context does not restore it where ending the capture raised)
    and ``graph``'s memory pool no longer the target of allocations (its
    end is skipped then too; a pool already ended is left alone)."""
    torch.cuda.set_stream(stream)
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is None:
        return
    try:
        end(stream.device.index, graph.pool())
    except RuntimeError:
        pass


def potential_values(potential, method, r2, sigma_i, sigma_j):
    """``potential.<method>(r2, sigma_i, sigma_j)`` (``evaluate_r2`` or
    ``force_r2``) as the engines call a potential in torch. Under
    :func:`checking_contract` (the warm-up before a capture, on the card)
    with the synchronisation check refusing (:func:`_without_syncs`), then
    once more in a trial capture of its own (:func:`_trial_capture`); under
    a CUDA-graph capture a failure inside it raises
    :class:`CaptureContractError`. The error names the potential's type and
    the contract."""
    fn = getattr(potential, method)
    if _checking and r2.is_cuda:
        values = _without_syncs(potential, method, fn, r2, sigma_i, sigma_j)
        _trial_capture(potential, method, fn, r2, sigma_i, sigma_j)
        return values
    if not (r2.is_cuda and torch.cuda.is_current_stream_capturing()):
        return fn(r2, sigma_i, sigma_j)
    try:
        return fn(r2, sigma_i, sigma_j)
    except CaptureContractError:
        raise
    except Exception as exc:
        raise CaptureContractError(contract_message(
            potential, method, f"{type(exc).__name__}: {exc}")) from exc


def check_engine_cutoff(potential, cutoff, max_sigma=1.0):
    """Raise if the engine's cutoff does not cover the potential's maximum
    interaction range (pairs beyond it would be silently dropped)."""
    fn = getattr(potential, "max_cutoff", None)
    mc = fn(max_sigma) if fn is not None else None
    if mc is not None and float(cutoff) < float(mc) - 1e-9:
        raise ValueError(
            f"engine cutoff {float(cutoff):g} is smaller than the "
            f"potential's maximum interaction range {float(mc):g} "
            f"(max diameter {float(max_sigma):g}); pairs beyond the cell "
            f"reach would be silently dropped — increase the engine cutoff")


def lj_tail_corrections(epsilon, sigma, r_cut, n_particles, volume):
    """The closed-form LJ tail-correction pair (total energy, pressure)
    shared by LennardJones and LennardJonesXPLOR."""
    rho = n_particles / volume
    src3 = (sigma / r_cut) ** 3
    src9 = src3 ** 3
    pref = epsilon * sigma ** 3
    e_total = ((8.0 * math.pi * rho * pref / 3.0)
               * (src9 / 3.0 - src3)) * n_particles
    p_total = (16.0 * math.pi * rho ** 2 * pref / 3.0) * (2.0 * src9 / 3.0
                                                          - src3)
    return e_total, p_total


def lorentz_sigma(mixing, self_sigma, sigma_i, sigma_j, dtype):
    """The sigma-mixing rule shared by the built-in potentials: Lorentz
    arithmetic mean, or ``mixing="none"`` (always the potential's sigma)."""
    if mixing == "none":
        return rounded(self_sigma, dtype)
    if not isinstance(sigma_i, torch.Tensor):
        sigma_i = rounded(sigma_i, dtype)
    if not isinstance(sigma_j, torch.Tensor):
        sigma_j = rounded(sigma_j, dtype)
    return 0.5 * (sigma_i + sigma_j)


def evaluate(potential, r, sigma_i=1.0, sigma_j=1.0):
    """Free-function form of the evaluate interface."""
    return potential.evaluate(r, sigma_i, sigma_j)


def energy_lrc(potential, n_particles, volume):
    return potential.energy_lrc(n_particles, volume)


def pressure_lrc(potential, n_particles, volume):
    return potential.pressure_lrc(n_particles, volume)
