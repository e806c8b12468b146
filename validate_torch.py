#!/usr/bin/env python3
"""Physics validation of the PyTorch port against external anchors.

    python3 validate_torch.py [--scale S] [--device cuda|cpu] [--out DIR]

``validate.py``'s four state points, run through the port
(``mdtpu_torch.run_simulation`` on the cell grid's slot route, f32, NVT):

1. LJ r_c = 3.0 with tail corrections at T* = 0.85, rho* = 0.776 (N =
   4096) against the vendored NIST/Johnson saturated-liquid U/N = -5.52 and
   P = 0.007;
2. the dilute LJ gas at T* = 2.0, rho* = 0.05 against the virial expansion
   with B2 from the Mayer-integral quadrature, itself pinned to the
   published Boyle temperature;
3. the T* = 2.0 isotherm at rho* = 0.02, 0.05, 0.08 (N = 16,384): the
   fitted B2 against the quadrature;
4. the near-triple-point liquid (rho* = 0.84, T* = 0.75, r_c = 2.5): the
   first RDF peak (ten frames 200 steps apart, binned by the port's
   ``rdf_histogram``; on the card its route and each frame's time, host
   included, are printed beside), temperature, energy and pressure
   windows.

The quadratures, the fit, the block SEM, the vendored values, the windows
and the budgets are ``validate.py``'s, copied (that script imports JAX).
The engine is ``CellGridEngine.create`` (skin 0.3), not the JAX package's
TPU-tuned geometry. ``--scale`` multiplies every step count and output
cadence (default 1, about 250k steps in all): a short scale runs every
point end to end, but only scale 1 is the validation. Prints the card's
name and power limit, then one JSON line of ``validate.py``'s shape.
"""

import argparse
import json
import os
import subprocess

import numpy as np
import torch

BOYLE_T = 3.417927  # published LJ Boyle temperature (B2 = 0)
N_POINT = 4096      # particles of points 1, 2 and 4
N_ISOTHERM = 16384  # particles of point 3


def lj_b2(temp, rmax=40.0, n=200_000):
    """B2(T) of the full Lennard-Jones potential by quadrature (trapezoid
    on a fine grid plus the analytic e^{-u/T} - 1 ~ -u/T tail)."""
    r = np.linspace(1e-8, rmax, n, dtype=np.float64)
    u = 4.0 * (r ** -12 - r ** -6)
    f = np.expm1(-u / temp)  # e^{-u/T} - 1, exactly -1 at r -> 0
    integral = np.trapezoid(f * r * r, r)
    # Tail: u ~ -4 r^-6 -> f ~ -u/T; int_rmax^inf (4 r^-6 / T) r^2 dr.
    tail = (4.0 / (3.0 * temp)) * rmax ** -3
    return -2.0 * np.pi * (integral + tail)


def lj_u2(temp, rmax=40.0, n=200_000):
    """Low-density energy coefficient: U/N = 2 pi rho int u e^{-u/T} r^2 dr
    + O(rho^2) for the full LJ potential."""
    r = np.linspace(1e-8, rmax, n, dtype=np.float64)
    u = 4.0 * (r ** -12 - r ** -6)
    w = np.exp(np.clip(-u / temp, -700.0, 50.0))
    integral = np.trapezoid(u * w * r * r, r)
    tail = -4.0 / (3.0) * rmax ** -3  # u ~ -4 r^-6, e^{-u/T} ~ 1
    return 2.0 * np.pi * (integral + tail)


def block_sem(series, nblocks=10):
    """Standard error of the mean by block averaging."""
    series = np.asarray(series, np.float64)
    m = len(series) // nblocks
    if m == 0:
        return float("inf")
    blocks = series[: m * nblocks].reshape(nblocks, m).mean(axis=1)
    return float(blocks.std(ddof=1) / np.sqrt(nblocks))


def fit_b2_b3(rhos, z_means, z_sems):
    """SEM-weighted least squares of Z - 1 = b2 rho + b3 rho^2 (intercept
    pinned at the ideal-gas limit Z(0) = 1). Returns (b2, b3, err_b2)."""
    rho = np.asarray(rhos, np.float64)
    y = np.asarray(z_means, np.float64) - 1.0
    w = 1.0 / np.maximum(np.asarray(z_sems, np.float64), 1e-12) ** 2
    X = np.stack([rho, rho * rho], axis=1)
    xtw = X.T * w
    cov = np.linalg.inv(xtw @ X)
    beta = cov @ (xtw @ y)
    return float(beta[0]), float(beta[1]), float(np.sqrt(cov[0, 0]))


class Runner:
    """Runs the points on one device at one step scale, into ``out``."""

    def __init__(self, scale, device, out):
        self.scale, self.device, self.out = scale, device, out

    def steps(self, n):
        return max(1, int(round(n * self.scale)))

    def run_nvt(self, n, rho, temp, rc, steps, name, dt=0.002,
                frequency=200):
        import mdtpu_torch as mt
        from mdtpu_torch.ops.cell_grid import CellGridEngine
        from mdtpu_torch.sim.initialization import lattice_fluid_state

        state = lattice_fluid_state(n, rho, temp, dtype=torch.float32,
                                    cutoff=rc, jitter=0.01,
                                    device=self.device)
        pot = mt.LennardJones(r_cut=rc, tail_correction=True)
        params = mt.Parameters(density=rho, n_particles=n, dt=dt,
                               potential=pot)
        engine = CellGridEngine.create(pot, rc, 0.3, state.unitcell, n)
        out = os.path.join(self.out, name)
        state = mt.run_simulation(state, params, mt.NVT(temp, 0.2),
                                  self.steps(steps), self.steps(frequency),
                                  out, engine=engine, perf_log=True,
                                  device=self.device)
        return state, params, engine, out

    def thermo_tail(self, out):
        from mdtpu_torch.observables import read_thermo

        thermo = read_thermo(os.path.join(out, "thermo.txt"))
        half = len(thermo["temperature"]) // 2
        return {k: np.asarray(v[half:]) for k, v in thermo.items()}

    def point_nist_sat_liquid(self):
        n, rho, temp = N_POINT, 0.776, 0.85
        REF_U, REF_P = -5.52, 0.007          # vendored (see validate.py)
        TOL_U, TOL_P = 0.10, 0.10   # transcription + finite-size + SEM
        _, _, _, out = self.run_nvt(n, rho, temp, 3.0, 40_000, "nist")
        tail = self.thermo_tail(out)
        mean_e = float(tail["energy"].mean())
        mean_p = float(tail["pressure"].mean())
        mean_t = float(tail["temperature"].mean())
        sem_e = block_sem(tail["energy"])
        sem_p = block_sem(tail["pressure"])
        d_u, d_p = mean_e - REF_U, mean_p - REF_P
        anchor = {
            "nist_energy_within_budget": bool(abs(d_u) < TOL_U + 3 * sem_e),
            "nist_pressure_within_budget": bool(abs(d_p) < TOL_P + 3 * sem_p),
        }
        plaus = {
            "nist_temperature_on_target": bool(abs(mean_t - temp) < 0.02),
        }
        return {
            "config": f"LJ N={n} rho={rho} kT={temp} rc=3.0 (tail-corrected)",
            "ref_U_per_N": REF_U, "ref_P": REF_P,
            "mean_E_per_N": round(mean_e, 4), "mean_P": round(mean_p, 4),
            "delta_U": round(d_u, 4), "delta_P": round(d_p, 4),
            "sem_U": round(sem_e, 4), "sem_P": round(sem_p, 4),
            "anchor_checks": anchor, "plausibility_checks": plaus,
        }

    def point_virial_dilute(self):
        n, rho, temp = N_POINT, 0.05, 2.0
        boyle_resid = float(lj_b2(BOYLE_T))
        b2 = float(lj_b2(temp))
        u2 = float(lj_u2(temp))
        _, _, _, out = self.run_nvt(n, rho, temp, 3.0, 60_000, "virial",
                                    dt=0.004)
        tail = self.thermo_tail(out)
        z = tail["pressure"] / (rho * tail["temperature"])
        z_mean = float(z.mean())
        z_pred = 1.0 + b2 * rho
        sem_z = block_sem(z)
        b3_budget = 3.0 * rho ** 2  # |B3(2.0)| ~ 1.7 published; bound 3
        u_mean = float(tail["energy"].mean())
        u_pred = u2 * rho
        sem_u = block_sem(tail["energy"])
        u_budget = abs(u_pred) * 0.10 + 3 * sem_u  # O(rho^2) + stat
        anchor = {
            "boyle_pin_ok": bool(abs(boyle_resid) < 2e-3),
            "virial_Z_within_budget":
                bool(abs(z_mean - z_pred) < b3_budget + 3 * sem_z),
            "virial_U_within_budget": bool(abs(u_mean - u_pred) < u_budget),
        }
        return {
            "config": f"LJ N={n} rho={rho} kT={temp} rc=3.0 (tail-corrected)",
            "B2": round(b2, 5), "boyle_residual": round(boyle_resid, 6),
            "Z_measured": round(z_mean, 5), "Z_virial": round(z_pred, 5),
            "delta_Z": round(z_mean - z_pred, 5), "sem_Z": round(sem_z, 5),
            "U_measured": round(u_mean, 5), "U_virial": round(u_pred, 5),
            "delta_U": round(u_mean - u_pred, 5),
            "anchor_checks": anchor, "plausibility_checks": {},
        }

    def point_b2_isotherm(self):
        temp, n = 2.0, N_ISOTHERM
        rhos = (0.02, 0.05, 0.08)
        b2 = float(lj_b2(temp))
        z_means, z_sems = [], []
        for rho in rhos:
            _, _, _, out = self.run_nvt(n, rho, temp, 3.0, 40_000,
                                        f"isotherm_rho{rho}", dt=0.004)
            tail = self.thermo_tail(out)
            z = tail["pressure"] / (rho * tail["temperature"])
            z_means.append(float(z.mean()))
            z_sems.append(block_sem(z))
        b2_fit, b3_fit, err_b2 = fit_b2_b3(rhos, z_means, z_sems)
        budget = 3 * err_b2 + 0.05
        anchor = {
            "isotherm_B2_matches_quadrature": bool(abs(b2_fit - b2) < budget),
        }
        plaus = {
            "isotherm_B3_sign_and_magnitude": bool(0.0 < b3_fit < 5.0),
        }
        return {
            "config": f"LJ N={n} kT={temp} rc=3.0 isotherm, rho={list(rhos)}",
            "B2_quadrature": round(b2, 5), "B2_fit": round(b2_fit, 5),
            "delta_B2": round(b2_fit - b2, 5), "err_B2_fit": round(err_b2, 5),
            "B3_fit": round(b3_fit, 4),
            "Z_means": [round(z, 5) for z in z_means],
            "Z_sems": [round(s, 6) for s in z_sems],
            "anchor_checks": anchor, "plausibility_checks": plaus,
        }

    def point_triple_rdf(self):
        import mdtpu_torch as mt
        from mdtpu_torch.observables import rdf_histogram, rdf_normalize

        n, rho, temp = N_POINT, 0.84, 0.75
        state, params, engine, out = self.run_nvt(n, rho, temp, 2.5, 30_000,
                                                  "triple",
                                                  frequency=1_000)
        # Ten frames 200 steps apart, each a run_simulation segment
        # continuing the state (validate.py steps make_step in a loop).
        counts = torch.zeros(200, dtype=torch.int64, device=self.device)
        frames = 0
        every = self.steps(200)
        rdf_ms = []   # each frame's histogram, host included (the card)
        for _ in range(10):
            state = mt.run_simulation(state, params, mt.NVT(temp, 0.2), every,
                                      every, os.path.join(self.out,
                                                          "triple_frames"),
                                      engine=engine, device=self.device)
            args = (state.positions, state.unitcell, state.unitcell_inv, 3.0,
                    200)
            if state.positions.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                counts += rdf_histogram(*args)
                stop.record()
                torch.cuda.synchronize()
                rdf_ms.append(start.elapsed_time(stop))
            else:
                counts += rdf_histogram(*args)
            frames += 1
        rdf_route = None
        if state.positions.device.type == "cuda":
            from mdtpu_torch.ops.rdf import rdf_plan
            rdf_route = rdf_plan(*args).route
        volume = float(abs(np.linalg.det(
            state.unitcell.cpu().numpy().astype(np.float64))))
        centers, g = rdf_normalize(counts, n, volume, 3.0,
                                   n_frames=frames, dim=3)
        peak_idx = int(np.argmax(g))
        peak_r = float(centers[peak_idx])
        peak_g = float(g[peak_idx])
        tail = self.thermo_tail(out)
        mean_t = float(tail["temperature"].mean())
        mean_p = float(tail["pressure"].mean())
        mean_e = float(tail["energy"].mean())
        plaus = {
            # dense LJ liquid: first RDF peak at ~1.05-1.15 sigma, height
            # ~2.5-3.5
            "rdf_peak_r_in_range": bool(1.0 < peak_r < 1.2),
            "rdf_peak_height_in_range": bool(2.2 < peak_g < 4.0),
            "temperature_on_target": bool(abs(mean_t - temp) < 0.03),
            # LJ at rho=0.84, T=0.75 (with tail corr): U/N ~ -6.1, P ~ 0
            "energy_per_particle_plausible": bool(-6.8 < mean_e < -5.4),
            "pressure_plausible": bool(-1.5 < mean_p < 1.5),
        }
        return {
            "config": f"LJ N={n} rho={rho} kT={temp} rc=2.5 (tail-corrected)",
            "rdf_peak_r": round(peak_r, 3), "rdf_peak_g": round(peak_g, 2),
            "rdf_route": rdf_route,
            "rdf_ms_median": float(np.median(rdf_ms)) if rdf_ms else None,
            "mean_T": round(mean_t, 4), "mean_P": round(mean_p, 3),
            "mean_E_per_N": round(mean_e, 3),
            "anchor_checks": {}, "plausibility_checks": plaus,
        }


def summary(points):
    """``validate.py``'s result line from the points."""
    anchor, plaus = {}, {}
    for name, p in points.items():
        anchor.update({f"{name}.{k}": v
                       for k, v in p["anchor_checks"].items()})
        plaus.update({f"{name}.{k}": v
                      for k, v in p["plausibility_checks"].items()})
    return {
        "points": points,
        "pass_anchor": all(anchor.values()),
        "pass_plausibility": all(plaus.values()),
        "pass": all(anchor.values()) and all(plaus.values()),
        "failed_anchor": [k for k, v in anchor.items() if not v],
        "failed_plausibility": [k for k, v in plaus.items() if not v],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="step count and cadence multiplier (default 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "out_validate"),
        help="directory for the runs' files")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("validate_torch: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    runner = Runner(args.scale, args.device, args.out)
    points = {
        "nist_sat_liquid": runner.point_nist_sat_liquid(),
        "virial_dilute": runner.point_virial_dilute(),
        "b2_isotherm": runner.point_b2_isotherm(),
        "triple_point_rdf": runner.point_triple_rdf(),
    }
    print(json.dumps(summary(points)))


if __name__ == "__main__":
    main()
